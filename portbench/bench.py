"""One run of one cell: set-up, the measured window, the reading of every
metric the cell reports, and the check that decides ``correct``.

Everything a cell names is found by that name: its entry in
``BENCHMARK.json``; the configuration in ``configs/<config>.json`` and its
reference in ``reference/<config>.py``; the traffic in
``traffic/<traffic>.json`` (or, for a mix that needs code of its own,
``traffic/<traffic>.py`` with a ``Schedule`` class); each metric's reader
in ``metrics/<metric>.py``; the cell's correctness limit in
``limits/<cell>.json``.  Nothing here lists them.

The program under test is the port's serving stack:
``repro_torch.launch.frontend.ServingFrontend`` over a
``RealAgentXPUEngine`` with the configuration file's ``serve`` settings.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced run's profiler covers the window's last seconds: stopping it
# parses the trace on the engine thread, which then serves nothing, so
# that pause falls after the window
PROFILE_SPAN_S = 6.0
# requests the check runs through the reference
SAMPLE = 12
MIN_COMPARED_TOKENS = 100
# the hand-written kernels the serving path launches
SERVING_KERNELS = ("decode_attention", "flash_attention_pool", "moe_gemm")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind, name):
    return "portbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def metric_reader(name: str, root: str = HERE):
    return load_module(os.path.join(root, "metrics", f"{name}.py"),
                       _module_name("metric", name))


@dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and the files it names define it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_name: str
    end_to_end: list
    per_layer: list
    limits: dict
    root: str = HERE

    def reports(self, trace: bool):
        """The metric entries this cell prints: with ``trace`` its
        per-layer metrics, else its end-to-end ones."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def load_cell(spec: dict, name: str, root: str = HERE) -> Cell:
    w = {c["name"]: c for c in spec["workloads"]}
    if name not in w:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = w[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(os.path.join(os.path.dirname(root),
                                 configs[cell["config"]]["file"]))
    tpath = os.path.join(root, "traffic", cell["traffic"] + ".json")
    traffic = load_json(tpath)
    lpath = os.path.join(root, "limits", name + ".json")
    limits = load_json(lpath) if os.path.exists(lpath) else {}
    return Cell(name, int(cell["chips"]), cfg, traffic, cell["traffic"],
                spec["end_to_end"], spec["per_layer"], limits, root)


def schedule_class(cell: Cell):
    """The traffic's generator: its own ``traffic/<name>.py`` if it has
    one, else the general one."""
    path = os.path.join(cell.root, "traffic", cell.traffic_name + ".py")
    if os.path.exists(path):
        return load_module(path, _module_name("traffic",
                                              cell.traffic_name)).Schedule
    from portbench.loadgen import Schedule
    return Schedule


def port_config(cfg: dict):
    """The port's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg["port"].items()})


def max_len_of(cell: Cell) -> int:
    return int(cell.traffic.get("max_len") or cell.config["serve"]["max_len"])


def build_engine(cell: Cell, mcfg, params, device):
    """The engine as ``python -m repro_torch.launch.serve --real`` builds
    one, with the configuration file's ``serve`` settings."""
    import torch
    from repro_torch.core.annotation import PROFILES
    from repro_torch.core.engine import RealAgentXPUEngine
    s = cell.config["serve"]
    eng = RealAgentXPUEngine(
        mcfg, params, hw=PROFILES[s["hw"]], scheduler=s["scheduler"],
        max_len=max_len_of(cell), dtype=getattr(torch, s["dtype"]),
        device=device, pool_slots=s["pool_slots"],
        max_fused_steps=s["max_fused_steps"],
        decode_segment_steps=s["decode_segment_steps"],
        elastic_decode=s["elastic_decode"], prefix_cache=s["prefix_cache"],
        kv_dtype=s["kv_dtype"], kernel_backend=s["kernel_backend"],
        admission_queue_len=s["admission_queue_len"], dual_device=False)
    if eng.heg.chunk_size != s["prefill_chunk"] \
            or eng.heg.B_max != s["b_max"]:
        raise RuntimeError(
            f"the engine runs prefill chunks of {eng.heg.chunk_size} and "
            f"B_max {eng.heg.B_max}; the configuration states "
            f"{s['prefill_chunk']} and {s['b_max']}")
    return eng


@dataclass
class Served:
    """What a flow's handle recorded: its end, its tokens' wall instants
    (producer side) and its tokens."""
    status: str
    token_walls: list
    tokens_out: list


@dataclass
class Reading:
    """What one run measured, for the metric readers."""
    cell: Cell
    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    sent: list = field(default_factory=list)
    lags: list = field(default_factory=list)
    stats0: dict = field(default_factory=dict)
    stats1: dict = field(default_factory=dict)
    sim: tuple = (None, None)  # the engine's simulated clock at t0, t1
    recorder: object = None
    profile: Optional[dict] = None
    work_s: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, priority=None):
        return [s for s in self.sent if self.t0 <= s.due < self.t1
                and (priority is None or s.job.priority == priority)]


def submitter(frontend, max_len):
    from repro_torch.core.requests import Priority

    def submit(job):
        pri = Priority.REACTIVE if job.priority == "reactive" \
            else Priority.PROACTIVE
        return frontend.submit(job.tokens[None, :], priority=pri,
                               max_new_tokens=job.max_new_tokens)
    return submit


def _wait(handles, timeout):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if all(h.status is not None for h in handles):
            return True
        time.sleep(0.01)
    return all(h.status is not None for h in handles)


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, warmup_s: Optional[float] = None, hook=None):
    """Set up, warm up, measure for ``seconds``, drain.  Returns (the
    reading, the finished requests as (prompt, served) pairs, the weights,
    the peak device memory).  ``hook(backend)``, if given, runs once the
    engine is built (the fault tests break the timed path there)."""
    import torch
    from repro_torch.launch.frontend import ServingFrontend
    from portbench import loadgen, tracing, weights
    mcfg = port_config(cell.config)
    dtype = getattr(torch, cell.config["serve"]["dtype"])
    if torch.device(device).type == "cuda":
        # the serving path's kernels, built (a checkout's first run) and
        # loaded before any traffic
        from repro_torch.kernels import build
        for name in SERVING_KERNELS:
            build.load(name)
    w = weights.draw(mcfg, seed, device, dtype)
    params = weights.as_port_params(w)
    eng = build_engine(cell, mcfg, params, device)
    if hook is not None:
        hook(eng.backend)
    ml = max_len_of(cell)
    fe = ServingFrontend(eng, max_buffered_tokens=ml + 1)
    r = Reading(cell)
    sched = schedule_class(cell)(cell.traffic, cell.config["vocab_size"],
                                 seed, ml)
    rec = _recorder(cell) if trace else None
    with (tracing.instrument(rec, eng.backend, fe) if rec is not None
          else contextlib.nullcontext()):
        fe.start()
        submit = submitter(fe, ml)
        try:
            # set-up the traffic needs: each shared document served once
            from portbench.loadgen import Job
            docs = [submit(Job("document", "proactive", d, 1, 0.0, i))
                    for i, d in enumerate(sched.documents)]
            if not _wait(docs, 600):
                raise RuntimeError("the document fill did not finish")
            del docs
            loop = loadgen.ClosedLoop(sched, submit)
            warm = cell.traffic["warmup_s"] if warmup_s is None else warmup_s
            loop.run_until(time.perf_counter() + warm)
            r.t0 = time.perf_counter()
            r.setup_s = r.t0 - t_start
            r.stats0 = eng.stats()
            sim0 = getattr(eng._sim, "now", None)
            r.t1 = r.t0 + seconds
            if rec is not None:
                rec.switch(True)
                loop.run_until(r.t1 - min(PROFILE_SPAN_S, seconds / 2))
                rec.switch(False)
                prof, r.work_s = _profiled(loop, rec, r.t1)
            loop.run_until(r.t1)
            r.stats1 = eng.stats()
            r.sim = (sim0, getattr(eng._sim, "now", None))
            if rec is not None:
                r.profile = tracing.reduce_profile(*prof, rec.ranges)
            r.recorder = rec
            r.sent, r.lags = loop.sent, loop.lags
            # every reactive request due in the window is waited for; the
            # rest of the backlog is cancelled
            _wait([s.handle for s in r.in_window("reactive")], 120)
            for s in loop.in_flight():
                s.handle.cancel()
        finally:
            fe.close(timeout=300)
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    # the handles reach the front end and through it the engine: keep what
    # was served, so that the program's state can be freed
    for s in r.sent:
        s.handle = Served(s.handle.status, list(s.handle.token_walls),
                          list(s.handle.tokens_out))
    done = [(s.job.tokens, s.handle.tokens_out) for s in r.sent
            if s.handle.status == "completed"
            and len(s.handle.tokens_out) == s.job.max_new_tokens]
    del fe, eng, params, submit, loop, sched
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return r, done, w, peak


def _recorder(cell: Cell):
    """The traced run's recorder, with the ``ops`` wrappers (``WRAPS``) and
    the ranges (``RANGES``) that the cell's per-layer metric files name."""
    from portbench import tracing
    wraps, ranges = {}, {}
    for m in cell.reports(True):
        mod = metric_reader(m["name"], cell.root)
        if hasattr(mod, "WRAPS"):
            wraps[m["name"]] = mod.WRAPS
        ranges.update(getattr(mod, "RANGES", {}))
    return tracing.Recorder(wraps, ranges)


def _on_engine(loop, rec, fn, timeout=120.0):
    """Run ``fn`` on the engine's thread at its next turn, the loop
    serving meanwhile; re-raises what ``fn`` raised."""
    import threading
    done, box = threading.Event(), {}

    def call():
        try:
            fn()
        except BaseException as e:  # handed to the caller's thread
            box["error"] = e
        finally:
            done.set()
    rec.engine_calls.append(call)
    end = time.perf_counter() + timeout
    while not done.is_set():
        if time.perf_counter() > end:
            raise RuntimeError("the engine thread took no turn")
        loop.run_until(time.perf_counter() + 0.005)
    if "error" in box:
        raise box["error"]


def _profiled(loop, rec, until):
    """Drive the loop under ``torch.profiler`` until ``until`` (started and
    stopped on the engine's thread, whose host ops it then records; kernels
    it records from every thread), with the kernel-work recorders on.
    Returns (the profiler, the span it covered), read once the window has
    closed, and each roofline metric's summed least time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    box = {}

    def start():
        torch.cuda.synchronize()
        box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
        box["prof"].start()
        box["a"] = time.perf_counter()
        rec.work_on = True

    def stop():
        rec.work_on = False
        torch.cuda.synchronize()
        box["b"] = time.perf_counter()
        box["prof"].stop()
    _on_engine(loop, rec, start)
    loop.run_until(until)
    _on_engine(loop, rec, stop, timeout=300.0)
    work = {k: float(torch.stack(v).sum()) if v else None
            for k, v in rec.work.items()}
    for v in rec.work.values():
        v.clear()
    return (box["prof"], box["b"] - box["a"]), work


def read_metrics(cell: Cell, r: Reading, trace: bool) -> dict:
    out = {}
    for m in cell.reports(trace):
        v = metric_reader(m["name"], cell.root).read(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def check(cell: Cell, r: Reading, done, w, seed: int, device) -> dict:
    """The numbers compared, each {"value", "limit"}: the served tokens'
    mean gap under the reference in its logits' standard deviations, the
    tokens compared, and the reactive requests due in the window that
    never finished."""
    from portbench import check as chk
    sample = chk.pick_sample(done, SAMPLE, seed)
    res = chk.judge(cell.config, w, sample,
                    cell.config["serve"]["prefill_chunk"], device)
    unfinished = sum(1 for s in r.in_window("reactive")
                     if s.handle.status != "completed")
    return {"mean_gap_sd": {"value": res["mean_gap_sd"],
                            "limit": cell.limits.get("mean_gap_sd")},
            "tokens_compared": {"value": res["tokens"],
                                "limit": MIN_COMPARED_TOKENS},
            "reactive_unfinished": {"value": unfinished, "limit": 0},
            "_detail": res}


def limit_readings(cell: Cell, seed: int, seconds: float, device,
                   control: bool, warmup_s: float = 3.0) -> dict:
    """What a cell's correctness limit is set from, for one seed: the
    cell's traffic served for a short window, and a sample of the finished
    requests (as a run draws it) judged on the same prompts and served
    tokens by the program's mean gap under the float32 reference and,
    with ``control``, by the control's: the reference computed with fp8
    (e4m3) products, read as the gap of the token it puts first."""
    from portbench import check as chk
    r, done, w, _ = serve(cell, seed, seconds, False, device,
                          time.perf_counter(), warmup_s=warmup_s)
    sample = chk.pick_sample(done, SAMPLE, seed)
    chunk = cell.config["serve"]["prefill_chunk"]
    out = {"program": chk.judge(cell.config, w, sample, chunk, device)}
    if control:
        out["control"] = chk.judge(cell.config, w, sample, chunk, device,
                                   product="fp8")
    return out


def passed(checks: dict) -> bool:
    """Every number within its limit: the mean gap and the unfinished
    requests at or under theirs, the tokens compared at or over theirs."""
    g, n, u = (checks["mean_gap_sd"], checks["tokens_compared"],
               checks["reactive_unfinished"])
    return (g["limit"] is not None and g["value"] == g["value"]
            and g["value"] <= g["limit"] and n["value"] >= n["limit"]
            and u["value"] <= u["limit"])


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
