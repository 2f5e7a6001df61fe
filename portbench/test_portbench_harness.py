"""CPU tests of the port's benchmark harness: the traffic schedule, the
result line, the roofline and FLOP arithmetic, each reference against the
port's plain path at a tiny size in float32, faults planted under a run,
file discovery by name, and the imports of a run.

The tiny cells keep every configuration's form (GQA with biases, or MLA
with a dense head layer; routed and shared experts) at small widths, so a
serve takes about a second on the CPU.
"""
from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import bench, check, loadgen, roofline  # noqa: E402

SPEC = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
SEED = 2**31 + 12345
# deepseek-v2-lite-16b has no cell yet (PERF.md, Open questions); its
# reference and its doc_qa mix's prefix-cache path are tested here
DEEPSEEK = {"name": "deepseek-v2-lite-16b",
            "file": "portbench/configs/deepseek-v2-lite-16b.json"}
DOC_QA = {"name": "dsv2lite.doc_qa", "config": "deepseek-v2-lite-16b",
          "traffic": "doc_qa", "chips": 1}


def tiny_cell(name: str) -> bench.Cell:
    """The cell ``name`` at a tiny size: 2 layers of width 64, 8 experts
    top 2, a 256-token vocabulary, float32 on the plain path; short
    prompts and answers, few clients, 256-token documents."""
    spec = dict(SPEC, workloads=SPEC["workloads"] + [DOC_QA],
                configs=SPEC["configs"] + [DEEPSEEK])
    cell = bench.load_cell(spec, name)
    c = copy.deepcopy(cell.config)
    p = c["port"]
    mla = bool(p.get("use_mla"))
    c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4 if mla else 2, vocab_size=256,
             moe_intermediate_size=32, num_experts_per_tok=2)
    p.update(num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=c["num_key_value_heads"], vocab_size=256,
             moe_d_ff=32, d_ff=32, num_experts=8, moe_top_k=2,
             num_shared_experts=1)
    if mla:
        c.update(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                 v_head_dim=8, intermediate_size=128, n_routed_experts=8,
                 n_shared_experts=1)
        p.update(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                 v_head_dim=8, head_dim=16, dense_d_ff=128)
    else:
        c.update(num_experts=8, shared_expert_intermediate_size=32)
        p.update(head_dim=16)
    c["serve"].update(dtype="float32", kernel_backend="plain")
    t = copy.deepcopy(cell.traffic)
    t["max_len"] = 512 if t.get("documents") else 256
    if t.get("documents"):
        t["documents"] = {"count": 2, "tokens": 256}
    for k in t["classes"]:
        k["clients"] = 3
        k["prompt"] = {"mean": 40, "std": 20, "min": 8, "max": 160}
        k["output"] = {"mean": 14, "std": 4, "min": 8, "max": 20}
    cell.config, cell.traffic = c, t
    return cell


def tiny_run(cell, seed=SEED, hook=None, seconds=0.8):
    t = time.perf_counter()
    r, done, w, _ = bench.serve(cell, seed, seconds, False,
                                torch.device("cpu"), t, warmup_s=0.2,
                                hook=hook)
    return r, done, w


def judged(cell, done, w, seed=SEED):
    sample = check.pick_sample(done, bench.SAMPLE, seed)
    return check.judge(cell.config, w, sample,
                       cell.config["serve"]["prefill_chunk"], "cpu")


# -- traffic -------------------------------------------------------------------
@pytest.mark.parametrize("traffic", ["agent_mix", "doc_qa"])
def test_schedule_is_a_function_of_the_seed(traffic):
    t = bench.load_json(os.path.join(HERE, "traffic", traffic + ".json"))

    def jobs(seed):
        s = loadgen.Schedule(t, 102400, seed, t["max_len"])
        out = [s.next_job(c["name"]) for c in t["classes"] for _ in range(16)]
        return s, out
    a, ja = jobs(SEED)
    b, jb = jobs(SEED)
    _, jc = jobs(SEED + 1)
    for x, y in zip(ja, jb):
        assert np.array_equal(x.tokens, y.tokens)
        assert (x.max_new_tokens, x.think_s, x.doc) == \
            (y.max_new_tokens, y.think_s, y.doc)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(ja, jc))
    # every seed draws the same work: the same sizes, think times and
    # documents in the same order, each block the law's stratified set
    assert [(len(j.tokens), j.max_new_tokens, j.think_s, j.doc)
            for j in ja] == [(len(j.tokens), j.max_new_tokens, j.think_s,
                              j.doc) for j in jc]
    blk = t["block"]
    for c in t["classes"]:
        sa = [j.max_new_tokens for j in ja if j.cls == c["name"]]
        assert sorted(sa[:blk]) == sorted(sa[blk:2 * blk])
    # a class's sequence does not depend on when the others draw theirs
    s = loadgen.Schedule(t, 102400, SEED + 2, t["max_len"])
    late = [s.next_job(c["name"]) for c in reversed(t["classes"])
            for _ in range(16)]
    for c in t["classes"]:
        assert [j.max_new_tokens for j in late if j.cls == c["name"]] == \
            [j.max_new_tokens for j in ja if j.cls == c["name"]]
    # no two segments start alike, and no request exceeds the ring
    firsts = [d[0] for d in a.documents] + [
        j.tokens[len(a.documents[j.doc]) if j.doc >= 0 else 0] for j in ja]
    assert len(set(firsts)) == len(firsts)
    assert all(len(j.tokens) + j.max_new_tokens <= t["max_len"] for j in ja)


def test_moe_groups_follow_the_serving_chunks():
    g = check.moe_groups(300, 5, 128)
    assert g[:5] == [(0, 128, True), (128, 128, True), (256, 32, True),
                     (288, 8, True), (296, 4, True)]
    assert g[5:] == [(300 + i, 1, False) for i in range(4)]


# -- result line ---------------------------------------------------------------
def test_result_line_has_the_contract_keys():
    from portbench.run import result_line
    cell = bench.load_cell(SPEC, "qwen2moe.agent_mix")
    r = bench.Reading(cell, t0=0.0, t1=1.0)
    checks = {"mean_gap_sd": {"value": 0.01, "limit": 0.1},
              "tokens_compared": {"value": 200, "limit": 100},
              "reactive_unfinished": {"value": 0, "limit": 0}}
    out = result_line(cell, r, {"setup_s": {"value": 1.0, "unit": "s"}},
                      checks, 123, False, "NVIDIA H100 80GB HBM3")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    r.profile = {"busy_s": 0.5, "window_s": 1.0,
                 "breakdown": {"device_ops": [], "idle_gaps": []}}
    traced = result_line(cell, r, {}, checks, 1, True, "x")
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert {"busy_s", "window_s"} <= set(traced["device"])
    checks["mean_gap_sd"]["value"] = 0.2
    assert result_line(cell, r, {}, checks, 1, False, "x")["correct"] is False


# -- rooflines and FLOPs -------------------------------------------------------
def test_moe_gemm_bound_counts_live_rows_and_their_experts():
    x = torch.zeros(4, 3, 64, dtype=torch.bfloat16)
    x[0, :2] = 1.0
    x[2, :1] = 1.0
    w = torch.ones(4, 64, 32, dtype=torch.bfloat16)
    moved = 3 * 64 * 2 + 2 * 64 * 32 * 2 + 3 * 32 * 2
    ops = 2 * 3 * 64 * 32
    want = max(moved / roofline.PEAK_HBM_BYTES,
               ops / roofline.PEAK_BF16_FLOPS)
    assert float(roofline.moe_gemm_bound(x, w)) == pytest.approx(want,
                                                                 rel=1e-6)


def test_attention_bounds_count_valid_slots():
    B, Hq, Hkv, hd, S = 2, 4, 2, 16, 8
    q = torch.zeros(B, Hq, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, S, Hkv, hd, dtype=torch.bfloat16)
    sp = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1],
                       [0, 1, 2, 3, 4, 5, -1, -1]], dtype=torch.int32)
    cur = torch.tensor([3, 4], dtype=torch.int32)
    n = 4 + 5
    moved = q.numel() * 2 * 2 + B * S * 4 + B * 4 + n * Hkv * hd * 2 * 2
    want = max(moved / roofline.PEAK_HBM_BYTES,
               4 * Hq * hd * n / roofline.PEAK_BF16_FLOPS)
    got = roofline.decode_bound(q, k, k, sp, cur, window=None, k_scale=None)
    assert float(got) == pytest.approx(want, rel=1e-6)
    # a 2-token chunk at positions 2, 3 over the same ring
    qc = torch.zeros(1, Hq, 2, hd, dtype=torch.bfloat16)
    kc = k[:1].transpose(1, 2)
    pairs, seen = 3 + 4, 4
    moved = qc.numel() * 2 * 2 + S * 4 + 2 * 4 + seen * Hkv * hd * 2 * 2
    want = max(moved / roofline.PEAK_HBM_BYTES,
               4 * Hq * hd * pairs / roofline.PEAK_BF16_FLOPS)
    got = roofline.pool_bound(qc, kc, kc, torch.tensor([[2, 3]]), sp[:1])
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_model_flops_match_the_active_parameters(name):
    from repro_torch.configs import get_config
    cfg = bench.load_json(os.path.join(HERE, "configs", name + ".json"))
    port = get_config(name)
    assert bench.port_config(cfg) == port
    # 2 FLOPs a multiplied parameter: the port's active count without the
    # embedding table (the norms and biases it also counts are ~1e-4 of it)
    active = port.active_params() - cfg["vocab_size"] * cfg["hidden_size"]
    got = roofline.model_flops(cfg, 1, 0) / 2
    assert got == pytest.approx(active, rel=2e-3)


# -- the references against the port's plain path -----------------------------
@pytest.mark.parametrize("name", ["qwen2moe.agent_mix", "dsv2lite.doc_qa"])
def test_reference_matches_the_port_in_float32(name):
    cell = tiny_cell(name)
    r, done, w = tiny_run(cell, seconds=1.6)
    res = judged(cell, done, w)
    assert res["tokens"] >= 40
    assert res["argmax_share"] == 1.0
    assert res["widest_gap"] < 1e-4
    if cell.traffic.get("documents"):
        assert r.stats1["prefix_hit_tokens"] > 0


def _emit_altered(backend):
    real = backend._emit

    def emit(req, token):
        return real(req, (int(token) + 1) % backend.cfg.vocab_size)
    backend._emit = emit


def _state_unchanged(backend):
    """Decode calls that leave the pool and the token vector as they found
    them: every call decodes from the same state again."""
    from repro_torch.models import copy_cache
    real = backend._decode

    def decode(n_steps, rows, kvl, fused, batch=None):
        pool, toks = backend._pool, backend._toks
        backend._pool, backend._toks = copy_cache(pool), toks.clone()
        try:
            return real(n_steps, rows, kvl, fused, batch)
        finally:
            backend._pool, backend._toks = pool, toks
    backend._decode = decode


def _half_batch(backend):
    """Decode over the leading half of the live rows only; the rest keep
    their token."""
    real = backend._decode

    def decode(n_steps, rows, kvl, fused, batch=None):
        keep = backend._mask.clone()
        backend._mask[rows // 2:] = False
        try:
            return real(n_steps, rows, kvl, fused, batch)
        finally:
            backend._mask.copy_(keep)
    backend._decode = decode


@pytest.mark.parametrize("fault", [_emit_altered, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny_cell("qwen2moe.agent_mix")
    cell.limits = bench.load_cell(SPEC, "qwen2moe.agent_mix").limits
    r, done, w = tiny_run(cell, hook=fault, seconds=3.2)
    checks = bench.check(cell, r, done, w, SEED, "cpu")
    checks.pop("_detail")
    assert checks["mean_gap_sd"]["limit"] is not None
    assert checks["tokens_compared"]["value"] >= bench.MIN_COMPARED_TOKENS
    assert checks["mean_gap_sd"]["value"] > checks["mean_gap_sd"]["limit"]
    assert not bench.passed(checks), checks


# -- found by name -------------------------------------------------------------
def test_files_are_found_by_name(tmp_path):
    pb = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (pb / sub).mkdir(parents=True)
    (pb / "configs" / "m.json").write_text(json.dumps({"vocab_size": 9}))
    (pb / "traffic" / "t.json").write_text(json.dumps({"classes": []}))
    (pb / "limits" / "m.t.json").write_text(json.dumps({"mean_gap_sd": 1}))
    (pb / "metrics" / "x.y_s.py").write_text(
        "def read(r):\n    return 2 * r.window_s\n")
    spec = {"configs": [{"name": "m", "file": "portbench/configs/m.json"}],
            "workloads": [{"name": "m.t", "config": "m", "traffic": "t",
                           "chips": 1}],
            "end_to_end": [{"name": "x.y_s", "unit": "s"}],
            "per_layer": []}
    cell = bench.load_cell(spec, "m.t", root=str(pb))
    assert cell.config == {"vocab_size": 9} and cell.limits["mean_gap_sd"] == 1
    assert bench.schedule_class(cell) is loadgen.Schedule
    r = bench.Reading(cell, t0=1.0, t1=4.0)
    assert bench.read_metrics(cell, r, False) == {
        "x.y_s": {"value": 6.0, "unit": "s"}}


def test_every_named_file_exists():
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(HERE, "reference",
                                           c["name"] + ".py"))
    for w in SPEC["workloads"]:
        cell = bench.load_cell(SPEC, w["name"])
        assert cell.limits.get("mean_gap_sd") is not None
        for m in cell.reports(False) + cell.reports(True):
            assert hasattr(bench.metric_reader(m["name"]), "read")


# -- imports -------------------------------------------------------------------
_IMPORTS = """
import importlib.util, os, sys
def tops():
    return " ".join(sorted({{m.split(".")[0] for m in sys.modules}}))
ref = {ref!r}
for f in sorted(os.listdir(ref)):
    if f.endswith(".py"):
        spec = importlib.util.spec_from_file_location("r" + str(len(f)),
                                                      os.path.join(ref, f))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(tops())
sys.path[:0] = [{src!r}, {root!r}]
from portbench import test_portbench_harness as t
cell = t.tiny_cell("qwen2moe.agent_mix")
r, done, w = t.tiny_run(cell, seconds=0.2)
t.judged(cell, done, w)
import portbench.run, portbench.control
print(tops())
"""


@functools.lru_cache(maxsize=1)
def _top_level_modules():
    """Top-level module names loaded (after the references alone, after a
    tiny run with its check), in a fresh interpreter."""
    env = dict(os.environ, USE_FLAX="0", USE_JAX="0")
    code = _IMPORTS.format(ref=os.path.join(HERE, "reference"),
                           src=os.path.join(ROOT, "src"), root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    refs, run = out.stdout.strip().splitlines()[-2:]
    return set(refs.split()), set(run.split())


def test_a_run_imports_neither_jax_nor_the_jax_package():
    mods = _top_level_modules()[1]
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_import_nothing_of_the_program():
    mods = _top_level_modules()[0]
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                       "portbench"}
