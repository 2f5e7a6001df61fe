"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version at the serving paths' shapes and
times both, serves ``llama3.2-3b`` at full width (bf16, random weights from
a seeded device generator) through the port's ``RealAgentXPUEngine``,
checks every served token against the plain path on the same card, repeats
a shorter serve with an int8 KV pool, serves ``qwen2-moe-a2.7b`` (the MoE
path: 60 routed experts through the grouped expert GEMM kernel) at full
width the same way, and prints the kernel table as JSON and, as its last
line, ``{"ok": true, "device": {...}}``.  Any failed phase raises, and the
script exits non-zero without that line — also when no GPU is visible or
when run outside the repository.  Imports no JAX.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

ARCH = "llama3.2-3b"
MOE_ARCH = "qwen2-moe-a2.7b"
SEED = 0
MAX_LEN = 2048
POOL = 16
OUT_TOKENS = 32
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s
# and bf16 tensor-core operations/s (the queries are bf16 in every case, so
# int8 K/V cases are held to the bf16 rate too)
HBM_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
# kernel vs plain: both accumulate in f32 and round once to the bf16 output,
# so a sound kernel differs by at most one bf16 ulp (2^-7 relative) of an
# element; the limit is two ulps of the largest plain output.  Scaled this
# way it stays far below the change that one dropped 64-slot tile makes
# (measured for every case below, and required to exceed the limit); for
# the expert GEMM the planted fault is one 64-wide slice of the d reduction
# zeroed
KERNEL_TOL_REL = 4 * 2.0 ** -8
DROP_TILE = 64
# served token vs the plain path's argmax: the kernel and plain attention
# round differently in bf16 across 28 layers, so a served token may be a
# near-tie of the plain argmax; accept a gap of at most this many logit units
LOGIT_MARGIN = 0.25
# kernels each served path must launch with kernel_backend="cuda"
PATH_KERNELS = {ARCH: ("decode_attention", "flash_attention_pool"),
                MOE_ARCH: ("decode_attention", "flash_attention_pool",
                           "moe_gemm")}


def log(*a):
    print(*a, flush=True)


# -- device ------------------------------------------------------------------
def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; nothing run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


# -- timing ------------------------------------------------------------------
_FLUSH = None


def time_ms(fn, reps=25):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), the
    50 MB L2 flushed before each run as the serving path finds it cold."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        _FLUSH.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# -- kernels vs plain --------------------------------------------------------
def _ring_positions(B, S, live, wrap_to=None):
    """slot_pos rows: positions [0, live) in slots [0, live), or (wrap) the
    last S positions up to ``wrap_to`` at slot = pos % S."""
    sp = torch.full((B, S), -1, dtype=torch.int32)
    if wrap_to is None:
        sp[:, :live] = torch.arange(live, dtype=torch.int32)
    else:
        pos = torch.arange(wrap_to - S + 1, wrap_to + 1, dtype=torch.int32)
        sp[:, pos.long() % S] = pos
    return sp


def _kv(gen, shape, dtype, int8):
    x = torch.randn(shape, generator=gen, device="cuda")
    if not int8:
        return x.to(dtype), None
    from repro_torch.models import quantize_kv
    return quantize_kv(x)


def decode_cases(gen):
    """The C == 1 calls of the serving paths: B=16 rows, hd 128, a
    2048-slot ring read to kv_limit 1024 or 2048, bf16 or int8; 24/8 heads
    (llama3.2-3b, G = 3) or 16/16 (qwen2-moe-a2.7b, G = 1)."""
    B, hd, S = 16, 128, MAX_LEN
    cases = []
    for name, kvl, int8, window, wrap, rows, (Hq, Hkv) in [
            ("bf16 kvl=2048", 2048, False, None, None, None, (24, 8)),
            ("bf16 kvl=1024", 1024, False, None, None, None, (24, 8)),
            ("int8 kvl=2048", 2048, True, None, None, None, (24, 8)),
            ("int8 kvl=1024", 1024, True, None, None, None, (24, 8)),
            ("bf16 window=256", 2048, False, 256, None, None, (24, 8)),
            ("bf16 wrapped ring", 2048, False, None, 3000, None, (24, 8)),
            ("bf16 row view 2:10 x 1024", 1024, False, None, None, (2, 10),
             (24, 8)),
            ("G=1 bf16 kvl=2048", 2048, False, None, None, None, (16, 16)),
            ("G=1 int8 kvl=2048", 2048, True, None, None, None, (16, 16))]:
        k, ks = _kv(gen, (B, S, Hkv, hd), torch.bfloat16, int8)
        v, vs = _kv(gen, (B, S, Hkv, hd), torch.bfloat16, int8)
        q = torch.randn((B, Hq, hd), generator=gen,
                        device="cuda").bfloat16()
        live = kvl - 7
        sp = _ring_positions(B, S, live, wrap).cuda()
        cur = torch.full((B,), live - 1 if wrap is None else wrap,
                         dtype=torch.int32, device="cuda")
        if rows is not None:  # strided row/prefix views of a pool
            r0, r1 = rows
            k, v, sp = k[r0:r1, :kvl], v[r0:r1, :kvl], sp[r0:r1, :kvl]
            q, cur = q[r0:r1], cur[r0:r1]
            kvl_arg = None
        else:
            kvl_arg = kvl
        args = (q, k, v, sp, cur)
        kw = dict(window=window, kv_limit=kvl_arg,
                  k_scale=None if ks is None else ks,
                  v_scale=None if vs is None else vs)
        cases.append((name, args, kw, int8))
    return cases


def decode_work(args, kw):
    """(bytes, operations) the decode function needs on these inputs: q
    read and the output written once, every slot_pos of the read extent,
    and K/V (and scales) of the valid slots only; 4 hd operations per
    (query head, valid slot)."""
    q, k, _, sp, cur = args
    Bq, Hq, hd = q.shape
    Hkv, S = k.shape[2], kw["kv_limit"] or k.shape[1]
    sp, c = sp[:, :S], cur[:, None]
    ok = (sp >= 0) & (sp <= c)
    if kw["window"] is not None:
        ok &= sp > c - kw["window"]
    n = int(ok.sum())
    moved = (nbytes(q) * 2 + Bq * S * 4 + Bq * 4
             + n * Hkv * hd * k.element_size() * 2
             + (n * Hkv * 4 * 2 if kw["k_scale"] is not None else 0))
    return moved, 4 * Hq * hd * n


def decode_drop_tile(args):
    """The same inputs with one tile of DROP_TILE live positions, inside
    every window, emptied: what a kernel that skipped a tile would see."""
    q, k, v, sp, cur = args
    c = cur[:, None]
    drop = (sp > c - 32 - DROP_TILE) & (sp <= c - 32)
    return q, k, v, torch.where(drop, -1, sp), cur


def pool_cases(gen):
    """The C > 1 calls of the serving paths: one row, a C = 128 or 512
    chunk against a 2048-slot ring; 24 query heads on 8 kv heads (G = 3)
    or 16 on 16 (G = 1)."""
    hd, S = 128, MAX_LEN
    cases = []
    for name, C, int8, window, wrap, strided, (Hq, Hkv) in [
            ("bf16 C=512", 512, False, None, None, False, (24, 8)),
            ("bf16 C=128", 128, False, None, None, False, (24, 8)),
            ("int8 C=512", 512, True, None, None, False, (24, 8)),
            ("int8 C=128", 128, True, None, None, False, (24, 8)),
            ("bf16 C=128 window=256", 128, False, 256, None, False, (24, 8)),
            ("bf16 C=128 wrapped ring", 128, False, None, 3000, False,
             (24, 8)),
            ("bf16 C=128 row view of 4-row pool", 128, False, None, None,
             True, (24, 8)),
            ("G=1 bf16 C=512", 512, False, None, None, False, (16, 16)),
            ("G=1 bf16 C=128", 128, False, None, None, False, (16, 16))]:
        nb = 4 if strided else 1
        k, ks = _kv(gen, (nb, S, Hkv, hd), torch.bfloat16, int8)
        v, vs = _kv(gen, (nb, S, Hkv, hd), torch.bfloat16, int8)
        q = torch.randn((1, C, Hq, hd), generator=gen,
                        device="cuda").bfloat16()
        end = S - 100 if wrap is None else wrap
        sp = _ring_positions(nb, S, end + 1, wrap).cuda()
        pos_q = torch.arange(end - C + 1, end + 1, dtype=torch.int32,
                             device="cuda")[None]
        r = 2 if strided else 0
        k, v, sp = k[r:r + 1], v[r:r + 1], sp[r:r + 1]
        ks = None if ks is None else ks[r:r + 1]
        vs = None if vs is None else vs[r:r + 1]
        # model layout (B, C|S, H, hd) -> kernel layout: free views
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                pos_q, sp)
        kw = dict(window=window,
                  k_scale=None if ks is None else ks.transpose(1, 2),
                  v_scale=None if vs is None else vs.transpose(1, 2))
        cases.append((name, args, kw, int8))
    return cases


def pool_work(args, kw):
    """(bytes, operations) the pool function needs on these inputs: the
    valid (query, slot) pairs of the same mask the plain version builds
    (causality, empty slots, window), 4 hd operations per pair and query
    head; K/V (and scales) of the slots some query sees, every position."""
    q, k, _, pos_q, pos_kv = args
    _, Hq, C, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    pq, pk = pos_q[:, :, None], pos_kv[:, None, :]
    ok = (pk >= 0) & (pk <= pq)
    if kw["window"] is not None:
        ok &= pk > pq - kw["window"]
    pairs, n = int(ok.sum()), int(ok.any(1).sum())
    moved = (nbytes(q) * 2 + S * 4 + C * 4
             + n * Hkv * hd * k.element_size() * 2
             + (n * Hkv * 4 * 2 if kw["k_scale"] is not None else 0))
    return moved, 4 * Hq * hd * pairs


def pool_drop_tile(args):
    """The same inputs with the DROP_TILE positions just before the chunk
    (seen by every query, inside every window) emptied."""
    q, k, v, pos_q, pos_kv = args
    lo = pos_q.min()
    drop = (pos_kv >= lo - DROP_TILE) & (pos_kv < lo)
    return q, k, v, pos_q, torch.where(drop, -1, pos_kv)


def _library_decode(q, k, v, sp, cur, window, kv_limit):
    """One PyTorch call for the decode function (yardstick only, never
    called by the port): SDPA with the explicit boolean slot mask."""
    import torch.nn.functional as F
    S = k.shape[1] if kv_limit is None else kv_limit
    kk, vv, spp = k[:, :S].transpose(1, 2), v[:, :S].transpose(1, 2), sp[:, :S]
    c = cur[:, None]
    ok = (spp >= 0) & (spp <= c)
    if window is not None:
        ok &= spp > c - window
    mask = ok[:, None, None, :]
    qq = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)


def _library_pool(q, k, v, pos_q, pos_kv, window):
    import torch.nn.functional as F
    pq, pk = pos_q[:, :, None], pos_kv[:, None, :]
    ok = (pk >= 0) & (pk <= pq)
    if window is not None:
        ok &= pk > pq - window
    mask = ok[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def moe_cases(gen):
    """The expert GEMMs of qwen2-moe-a2.7b's MoE layers (60 experts, d
    2048, expert d_ff 1408), bf16, x on the capacity slice of the (E, C+1,
    d) spill buffer as ``moe_ffn`` passes it: a 16-row decode pool (gate /
    up projection and down projection), a 512-token prefill bucket
    (capacity int(512*4/60*1.25) = 42) and a single row."""
    E = 60
    cases = []
    for name, C, d, f in [("decode C=16 d=2048 f=1408", 16, 2048, 1408),
                          ("decode down C=16 d=1408 f=2048", 16, 1408, 2048),
                          ("prefill C=42 d=2048 f=1408", 42, 2048, 1408),
                          ("single row C=1 d=2048 f=1408", 1, 2048, 1408)]:
        x = torch.randn((E, C + 1, d), generator=gen, device="cuda")
        w = torch.randn((E, d, f), generator=gen, device="cuda") * 0.02
        cases.append((name, (x.bfloat16()[:, :C], w.bfloat16()), {}, False))
    return cases


def moe_work(args, kw):
    """(bytes, operations): x and w read once, the output written once;
    2 E C d f operations."""
    x, w = args
    E, C, d = x.shape
    f = w.shape[2]
    return nbytes(x, w) + E * C * f * x.element_size(), 2 * E * C * d * f


def moe_drop_slice(args):
    """The same inputs with one DROP_TILE-wide slice of the d reduction
    zeroed: what a kernel that skipped a depth slice would compute."""
    x, w = args
    x = x.clone()
    x[:, :, 64:64 + DROP_TILE] = 0
    return x, w


def kernel_phase():
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {}
    for kname, cases, kfn, rfn, work, drop_tile in [
            ("decode_attention", decode_cases(gen),
             ops.decode_attention, ref.decode_attention, decode_work,
             decode_drop_tile),
            ("flash_attention_pool", pool_cases(gen),
             ops.flash_attention_pool, ref.flash_attention_pool, pool_work,
             pool_drop_tile),
            ("moe_gemm", moe_cases(gen), ops.moe_gemm, ref.moe_gemm,
             moe_work, moe_drop_slice)]:
        fault_name = (f"one zeroed {DROP_TILE}-wide d slice"
                      if kname == "moe_gemm"
                      else f"one dropped {DROP_TILE}-slot tile")
        for name, args, kw, int8 in cases:
            got = kfn(*args, **kw)
            torch.cuda.synchronize()
            want = rfn(*args, **kw).float()
            err = (got.float() - want).abs().max().item()
            tol = KERNEL_TOL_REL * want.abs().max().item()
            typical = want.abs().mean().item()
            fault = (rfn(*drop_tile(args), **kw).float()
                     - want).abs().max().item()
            log(f"[check] {kname:20s} {name:34s} err {err:.2e} tol "
                f"{tol:.2e} (err/tol {err / tol:.3f}, err/mean|out| "
                f"{err / typical:.4f}); {fault_name} "
                f"{fault:.2e} ({fault / tol:.1f} x tol)")
            if not err <= tol:
                raise AssertionError(f"{kname} [{name}]: max abs err {err} "
                                     f"> {tol}")
            if not fault > tol:
                raise AssertionError(
                    f"{kname} [{name}]: the tolerance {tol} would not catch "
                    f"{fault_name} ({fault})")
            ms = time_ms(lambda: kfn(*args, **kw))
            plain_ms = time_ms(lambda: rfn(*args, **kw), reps=20)
            lib_ms = None
            if kname == "moe_gemm":
                lib_ms = time_ms(lambda: torch.bmm(*args))
            elif not int8:
                if kname == "decode_attention":
                    lib = _library_decode(*args, kw["window"],
                                          kw["kv_limit"])
                else:
                    lib = _library_pool(*args, kw["window"])
                lib_ms = time_ms(lib)
            moved, ops_n = work(args, kw)
            t_bytes = moved / HBM_BYTES_S * 1e3
            t_ops = ops_n / PEAK_BF16_OPS_S * 1e3
            bound = max(t_bytes, t_ops)
            rows[(kname, name)] = dict(
                max_abs_err=err, tol=tol, dropped_tile_err=fault, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"[kernel] {kname:20s} {name:34s} kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms library {lib_txt} ms bound "
                f"{bound:.4f} ms ({rows[(kname, name)]['bound_by']}) "
                f"share {bound / ms:.3f}")
    return rows


# -- serve -------------------------------------------------------------------
def _requests(flows, late=False):
    from repro_torch.core import Priority, Request
    return [Request(id=f["id"], priority=Priority.REACTIVE if f["reactive"]
                    else Priority.PROACTIVE, prompt_len=f["tokens"].shape[1],
                    max_new_tokens=f["out"], arrival_time=f["arrival"],
                    tokens=f["tokens"])
            for f in flows if f["late"] == late]


def make_flows(cfg, n_proactive, n_out, rng):
    """Per-flow dicts: prompts of 64-512 tokens; ``n_proactive`` proactive
    flows, then two reactive ones.  The first reactive flow arrives in the
    middle of the proactive flows' decode phase (found by a simulation-only
    run of the same scheduler, which makes the real engine's decisions), so
    it lands inside a committed fused run; the second is submitted from an
    on_token callback during the run."""
    from repro_torch.core import AgentXPUEngine
    flows = []
    lens = rng.integers(64, 513, size=n_proactive + 2)
    for i in range(n_proactive + 2):
        reactive = i >= n_proactive
        flows.append(dict(
            id=i, arrival=0.02 * i, reactive=reactive,
            late=i == n_proactive + 1, out=n_out,
            tokens=rng.integers(0, cfg.vocab_size, (1, int(lens[i])))))
    sim = AgentXPUEngine(cfg)
    sim.run_trace(_requests([f for f in flows if not f["reactive"]]))
    steps = [t for kind, _, t in sim.last_trace if kind == "decode_step"]
    flows[n_proactive]["arrival"] = steps[int(len(steps) * 0.4)]
    return flows


def _record_prefill_chunks(eng):
    """Per-flow lengths of the prompt chunks the backend prefills, in
    order (a chunk from position 0 restarts the flow's list, as a replay
    after a discarding preemption does).  Each chunk runs as its
    ``_pow2_buckets`` sub-chunks, one ``extend`` each."""
    chunks = {}
    backend = eng.backend
    run = backend._run_bucketed_in_pool

    def recording(req, start, n):
        if start == 0:
            chunks[req.id] = []
        if n > 0:
            chunks[req.id].append(n)
        return run(req, start, n)

    backend._run_bucketed_in_pool = recording
    return chunks


def serve(cfg, params, flows, *, device, dtype, kv_dtype="bf16",
          inject_after=40):
    """Serve ``flows`` through the port's engine.  Returns (engine, metrics,
    wall seconds, per-flow wall TTFT seconds, launches during the run,
    per-flow prefill chunk lengths)."""
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.kernels import ops
    eng = RealAgentXPUEngine(cfg, params, max_len=MAX_LEN, dtype=dtype,
                             device=device, pool_slots=POOL,
                             kv_dtype=kv_dtype)
    chunks = _record_prefill_chunks(eng)
    t_sub, t_first, late, streamed = {}, {}, [], [0]

    def on_token(req, tok):
        t_first.setdefault(req.id, time.perf_counter())
        streamed[0] += 1
        if late and streamed[0] >= inject_after:
            r = late.pop()
            t_sub[r.id] = time.perf_counter()
            eng.submit(r, on_token)

    for req in _requests(flows):
        eng.submit(req, on_token)
    late.extend(_requests(flows, late=True))
    _sync(device)
    ops.reset_launches()  # count the serving path's launches only
    t0 = time.perf_counter()
    for f in flows:
        if not f["late"]:
            t_sub[f["id"]] = t0
    metrics = eng.run()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if late:
        raise AssertionError("the mid-run reactive submit never fired")
    ttft = {i: t_first[i] - t_sub[i] for i in t_first}
    return eng, metrics, wall, ttft, launches, chunks


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _release():
    """Free the device memory of engines dropped so far: an engine's
    objects refer to each other in cycles, which only the collector
    frees."""
    gc.collect()
    torch.cuda.empty_cache()


def check_serve(cfg, eng, metrics, flows, launches, label, need_abort=True):
    done = {r.id: r for r in metrics.completed}
    for f in flows:
        toks = eng.output_tokens(f["id"])
        if f["id"] not in done or done[f["id"]].terminal_status \
                != "completed" or len(toks) != f["out"]:
            raise AssertionError(
                f"[{label}] flow {f['id']} did not complete with "
                f"{f['out']} tokens (got {len(toks)})")
    st = eng.stats()
    decode_tokens = sum(f["out"] - 1 for f in flows)
    want = PATH_KERNELS[cfg.name]
    if not all(launches[k] for k in want):
        raise AssertionError(f"[{label}] a kernel of {want} never launched: "
                             f"{launches}")
    # one attention launch per layer per forward call; with MoE layers,
    # three expert GEMMs per layer too
    forwards, rest = divmod(launches["decode_attention"]
                            + launches["flash_attention_pool"],
                            cfg.num_layers)
    moe_want = 3 * cfg.num_layers * forwards if cfg.is_moe else 0
    if rest or launches["moe_gemm"] != moe_want:
        raise AssertionError(
            f"[{label}] launches {launches} are not {cfg.num_layers} "
            f"attention launches and {moe_want // max(forwards, 1)} expert "
            f"GEMMs per forward call")
    if not st["host_syncs"] < decode_tokens:
        raise AssertionError(f"[{label}] host_syncs {st['host_syncs']} >= "
                             f"{decode_tokens} decode tokens")
    if need_abort and st["aborted_runs"] < 1:
        raise AssertionError(f"[{label}] no fused run was aborted")
    return st, decode_tokens


def _teacher_forced(cfg, params, f, served, chunks, *, dtype, kv_dtype,
                    backend):
    """Yield the logits that score each served token of flow ``f``: its
    prompt through ``extend`` in ``chunks`` (each as its pow-2
    sub-chunks, as the engine runs them; None: one call), then its served
    tokens one at a time."""
    from repro_torch.core.backend import _pow2_buckets
    from repro_torch.models import extend, init_cache
    cache = init_cache(cfg, params, 1, MAX_LEN, dtype, kv_dtype=kv_dtype)
    device = cache["pos"].device
    toks = torch.from_numpy(np.asarray(f["tokens"], np.int64)).to(device)
    sizes = [toks.shape[1]] if chunks is None else \
        [b for n in chunks for b in _pow2_buckets(n)]
    if sum(sizes) != toks.shape[1]:
        raise AssertionError(f"flow {f['id']}: prefill chunks {chunks} do "
                             f"not cover its {toks.shape[1]} prompt tokens")
    start = 0
    for n in sizes:
        logits, cache = extend(cfg, params, cache, toks[:, start:start + n],
                               kernel_backend=backend)
        start += n
    for i, t in enumerate(served):
        yield logits
        if i + 1 < len(served):
            step = torch.tensor([[t]], device=device)
            logits, cache = extend(cfg, params, cache, step,
                                   kernel_backend=backend)


def _routing_at(cfg, params, f, served, chunks, i, *, dtype, kv_dtype,
                backend):
    """Top-k expert set of the scored position in every MoE layer, at the
    forward call that scores served token ``i`` on path ``backend``."""
    from repro_torch.models import moe
    router, seen = moe._router, []

    def recording(x, w):
        logits = router(x, w)
        seen.append(frozenset(logits[-1].topk(cfg.moe_top_k).indices
                              .tolist()))
        return logits

    steps = _teacher_forced(cfg, params, f, served, chunks, dtype=dtype,
                            kv_dtype=kv_dtype, backend=backend)
    for _ in range(i):
        next(steps)
    moe._router = recording
    try:
        next(steps)
    finally:
        moe._router = router
    return seen[-cfg.num_layers:]


def plain_check(cfg, params, eng, flows, *, dtype, kv_dtype=None,
                chunks=None):
    """Teacher-forced plain path on the card: each flow's prompt (in the
    engine's own prefill chunks when ``chunks`` is given: MoE capacity
    depends on a call's token count), then its served tokens one at a
    time, through ``extend`` with ``kernel_backend="plain"``; every served
    token must be the plain argmax or within LOGIT_MARGIN of it.  For MoE,
    a token outside the margin is first traced to a routing flip or not.
    Returns (exact matches, tokens, largest gap)."""
    exact = total = 0
    worst, at = 0.0, None
    for f in flows:
        served = eng.output_tokens(f["id"])
        fc = None if chunks is None else chunks[f["id"]]
        steps = _teacher_forced(cfg, params, f, served, fc, dtype=dtype,
                                kv_dtype=kv_dtype, backend="plain")
        for i, (t, logits) in enumerate(zip(served, steps)):
            lg = logits[0].float()
            gap = (lg.max() - lg[t]).item()
            exact += int(gap == 0.0)
            total += 1
            if gap > worst:
                worst, at = gap, (f, served, fc, i)
            if gap > LOGIT_MARGIN:
                raise AssertionError(
                    f"flow {f['id']} token {i}: served {t} is {gap:.4f} "
                    f"below the plain argmax {int(lg.argmax())} "
                    f"(margin {LOGIT_MARGIN})"
                    + _routing_flips(cfg, params, f, served, fc, i,
                                     dtype=dtype, kv_dtype=kv_dtype))
    if at is not None:
        log(f"[check] {cfg.name}: largest gap {worst:.4f} at flow "
            f"{at[0]['id']} token {at[3]}"
            + _routing_flips(cfg, params, *at, dtype=dtype,
                             kv_dtype=kv_dtype))
    return exact, total, worst


def _routing_flips(cfg, params, f, served, chunks, i, *, dtype, kv_dtype):
    """For MoE: the layers in which the kernel path (teacher-forced, one
    row) routes the token that scores served token ``i`` to another top-k
    set than the plain path does."""
    if not cfg.is_moe:
        return ""
    kw = dict(dtype=dtype, kv_dtype=kv_dtype)
    a = _routing_at(cfg, params, f, served, chunks, i, backend="plain", **kw)
    b = _routing_at(cfg, params, f, served, chunks, i, backend="cuda", **kw)
    flips = [li for li, (x, y) in enumerate(zip(a, b)) if x != y]
    return (f"; the kernel and plain paths route it to different "
            f"top-{cfg.moe_top_k} experts in layers {flips}" if flips
            else "; the kernel and plain paths route it alike in every "
            "layer")


def profile_serve(cfg, params, flows):
    """The same bf16 serve again under ``torch.profiler``: device busy time
    by kernel, and its share of the (profiled, so slower) wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, wall, _, _, _ = serve(cfg, params, flows, device="cuda",
                                      dtype=torch.bfloat16)
    del eng
    _release()
    from torch.autograd import DeviceType
    # device-side events only (kernels, copies): CPU operator rows would
    # count their kernels' time a second time
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(t for _, t in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    if busy_ms <= 0:
        log("[profile] no device time in the trace: not measured")
        return None
    log(f"[profile] {cfg.name} bf16 serve under the profiler: wall "
        f"{wall:.3f} s, "
        f"device busy {busy_ms / 1e3:.3f} s ({busy_ms / 1e3 / wall:.3f} of "
        f"wall, idle {1 - busy_ms / 1e3 / wall:.3f})")
    for name, t in top:
        log(f"[profile]   {t:10.2f} ms  {name[:90]}")
    return dict(wall_s=wall, device_busy_s=busy_ms / 1e3,
                busy_share=busy_ms / 1e3 / wall,
                top_ms={name[:90]: t for name, t in top})


def _init(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    moe = (f", {cfg.num_experts} experts top-{cfg.moe_top_k} d_ff "
           f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared"
           if cfg.is_moe else "")
    log(f"[serve] {arch}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim}{moe} "
        f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params bf16, random "
        f"(seed {SEED}), init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def bf16_serve(cfg, params):
    """The 8-flow bf16 serve of ``cfg``: checked, held against the plain
    path, then profiled.  Returns its stats."""
    label = f"{cfg.name} bf16"
    rng = np.random.default_rng(SEED)
    flows = make_flows(cfg, 6, OUT_TOKENS, rng)
    torch.cuda.reset_peak_memory_stats()
    eng, metrics, wall, ttft, launches, chunks = serve(
        cfg, params, flows, device="cuda", dtype=torch.bfloat16)
    st, decode_tokens = check_serve(cfg, eng, metrics, flows, launches,
                                    label)
    gen_tokens = sum(len(eng.output_tokens(f["id"])) for f in flows)
    prompt_tokens = sum(f["tokens"].shape[1] for f in flows)
    # wall TTFT: the mid-run reactive flow from its submit; the trace's
    # flows only from the run's start (their arrivals are on the
    # scheduler's simulated clock, which has no wall-clock instant)
    late_id = next(f["id"] for f in flows if f["late"])
    from_start = {"reactive": [], "proactive": []}
    for f in flows:
        if not f["late"]:
            from_start["reactive" if f["reactive"] else "proactive"].append(
                ttft[f["id"]])
    summ = metrics.summary()
    serve_stats = dict(
        arch=cfg.name, flows=len(flows), completed=len(metrics.completed),
        prompt_tokens=prompt_tokens, generated_tokens=gen_tokens,
        wall_s=wall, tokens_per_s=gen_tokens / wall,
        mid_run_reactive_ttft_wall_s=ttft[late_id],
        first_token_from_start_wall_s={
            k: {"mean": float(np.mean(v)), "max": float(np.max(v))}
            for k, v in from_start.items()},
        ttft_sim_s={"reactive": summ["reactive_ttft"],
                    "proactive": summ["proactive_ttft"]},
        launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        **{k: st[k] for k in ("host_syncs", "decode_device_calls",
                              "prefill_device_calls", "fused_steps",
                              "decode_segments", "aborted_runs",
                              "jit_compilations", "decode_rows",
                              "decode_kv_limit")})
    log(f"[serve] {label}: {len(metrics.completed)}/{len(flows)} flows, "
        f"{prompt_tokens} prompt + {gen_tokens} generated tokens in "
        f"{wall:.3f} s wall ({gen_tokens / wall:.2f} tok/s), decode tokens "
        f"{decode_tokens}, host syncs {st['host_syncs']}, aborted runs "
        f"{st['aborted_runs']}, launches {launches}, peak memory "
        f"{serve_stats['peak_mem_gb']:.2f} GB")
    log(f"[serve] {label}: mid-run reactive TTFT {ttft[late_id]:.3f} s wall; "
        f"first token from run start (wall s): "
        + json.dumps(serve_stats["first_token_from_start_wall_s"])
        + "; scheduler-clock TTFT (sim s): "
        + json.dumps(serve_stats["ttft_sim_s"]))
    exact, total, worst = plain_check(
        cfg, params, eng, flows, dtype=torch.bfloat16,
        chunks=chunks if cfg.is_moe else None)
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN})"
        + (f"; prefill replayed in the engine's chunks {chunks}"
           if cfg.is_moe else ""))
    serve_stats.update(plain_exact=exact, plain_total=total,
                       plain_worst_gap=worst)
    del eng
    _release()
    serve_stats["profile"] = profile_serve(cfg, params, flows)
    return serve_stats


def serve_phase():
    """llama3.2-3b: the bf16 serve, then a shorter one on an int8 pool."""
    cfg, params = _init(ARCH)
    serve_stats = bf16_serve(cfg, params)
    flows8 = make_flows(cfg, 2, 16, np.random.default_rng(SEED + 1))
    eng8, m8, wall8, _, launches8, _ = serve(
        cfg, params, flows8, device="cuda", dtype=torch.bfloat16,
        kv_dtype="int8", inject_after=12)
    check_serve(cfg, eng8, m8, flows8, launches8, f"{ARCH} int8",
                need_abort=False)
    exact8, total8, worst8 = plain_check(cfg, params, eng8, flows8,
                                         dtype=torch.bfloat16,
                                         kv_dtype="int8")
    log(f"[check] {ARCH} int8 serve: {len(m8.completed)}/{len(flows8)} flows "
        f"in {wall8:.3f} s wall, launches {launches8}; vs plain path "
        f"{exact8}/{total8} exact ({exact8 / total8:.4f}), largest gap "
        f"{worst8:.4f}")
    serve_stats["int8"] = dict(flows=len(flows8), wall_s=wall8,
                               launches=launches8, plain_exact=exact8,
                               plain_total=total8, plain_worst_gap=worst8)
    return serve_stats


def moe_serve_phase():
    """qwen2-moe-a2.7b at full width: every MoE layer's three expert
    products through the grouped GEMM kernel."""
    cfg, params = _init(MOE_ARCH)
    return bf16_serve(cfg, params)


def main():
    t_start = time.perf_counter()

    def phase_done(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    smi = device_phase()
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"[build] nvcc sm_90a from {build.CSRC}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f" (total {time.perf_counter() - t0:.1f} s)")
    kernel_rows = kernel_phase()
    phase_done("kernels")
    serve_stats = serve_phase()
    phase_done(ARCH)
    _release()  # the llama weights and pools, before the MoE weights
    moe_stats = moe_serve_phase()
    phase_done(MOE_ARCH)
    # launches of each kernel in the main-path runs, each counted from 0
    by_path = {f"{ARCH} bf16": serve_stats["launches"],
               f"{ARCH} int8": serve_stats["int8"]["launches"],
               f"{MOE_ARCH} bf16": moe_stats["launches"]}
    replaces = {"decode_attention":
                "src/repro/kernels/decode_attention.py:79",
                "flash_attention_pool":
                "src/repro/kernels/flash_attention.py:174",
                "moe_gemm": "src/repro/kernels/moe_gemm.py:39"}
    sources = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in replaces}
    headline = {"decode_attention": "bf16 kvl=2048",
                "flash_attention_pool": "bf16 C=512",
                "moe_gemm": "decode C=16 d=2048 f=1408"}
    kernels = []
    for k in replaces:
        row = kernel_rows[(k, headline[k])]
        kernels.append(dict(
            name=k, route="cuda", source=sources[k], replaces=replaces[k],
            shape=headline[k],
            launches=sum(n[k] for n in by_path.values()),
            launches_by_path={p: n[k] for p, n in by_path.items()}, **row))
    log(json.dumps({"serve": serve_stats}))
    log(json.dumps({"serve_moe": moe_stats}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
