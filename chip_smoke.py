"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version at the serving and training
paths' shapes and times both (the training flash attention forward and
backward beside SDPA, at llama's, qwen2-moe's and recurrentgemma's
training shapes), trains ``llama3.2-3b`` at full width (f32, AdamW,
remat; one step's loss and gradients through the kernels held to the plain
path, a planted backward fault caught, one step profiled, then five steps
through the port's launcher with the loss falling), trains
``qwen2-moe-a2.7b`` (4 of 24 layers), ``recurrentgemma-9b`` (5 of 38),
``rwkv6-1.6b`` (all 24) and ``deepseek-v2-lite-16b`` (4 of 27: its dense
head layer and 3 MoE layers) at full width the same way (``[train]``: the
depth cuts that one card's memory forces, ``TRAIN_FAMILIES``; the expert
GEMM and the scans launched 0 times, training runs them on the plain
path; five steps through ``train_loop.train``, or the launcher at full
depth), serves
``llama3.2-3b`` at full width (bf16, random weights from
a seeded device generator) through the port's ``RealAgentXPUEngine``,
checks every served token against the plain path on the same card, repeats
a shorter serve with an int8 KV pool, serves ``qwen2-moe-a2.7b`` (the MoE
path: 60 routed experts through the grouped expert GEMM kernel),
``deepseek-v2-lite-16b`` (MLA attention on its plain path, which has no
kernel, a dense head layer, then 64 routed experts top-6 through the
grouped expert GEMM kernel: 78 launches a forward call),
``recurrentgemma-9b`` (RG-LRU through the ``rglru_scan`` kernel beside local
attention at head_dim 256) and ``rwkv6-1.6b`` (WKV6 through the
``rwkv6_scan`` kernel) at full width the same way (rwkv6's tokens are held
to the plain path in an f32 serve, and its bf16 serve beside serves with a
planted WKV fault: see F32_TOKEN_CHECK), profiles one ``llama3.2-3b``, one
``qwen2-moe-a2.7b``, one ``deepseek-v2-lite-16b``, one
``recurrentgemma-9b`` and one ``rwkv6-1.6b`` prefill chunk and decode
segment (the serving attention kernels', the expert GEMM's, the plain MLA
ops' and the scans' share of device time), holds the expert
GEMM's outputs bitwise equal to the kernel it replaced
(``tools/moe_gemm_fma.cu``, built beside it), and
serves ``llama3.2-3b`` through the serving modules on the same weights --
``[prefix]``: 8 flows sharing a 512-token system prompt, hot (the prefix
cache on, its hits held to a simulation's prediction, its forward tokens
to a cold twin's minus the hit tokens) and cold, then 4 flows one after
another through a 3-slot pool, each hit pasted from the snapshot store
after its donor's row was rebound (``prefix_promotions`` >= 1);
``[faults]``: 4 flows
with a transient device fault at every fifth decode check; ``[frontend]``:
4 flows from two threads through ``ServingFrontend``, one cancelled after
its 4th token -- each checked against the plain path, and runs
``python -m repro_torch.launch.serve --real`` (``[launcher]``) and the
four ``examples/*_torch.py`` files as subprocesses (``[examples]``); then
the
stage-decoupled serve (``[dual]``: prefill staged on a second stream of
the card, or on a second GPU where one is visible, the KV handed off into
the decode pool; the 8-flow trace on ``llama3.2-3b`` and 4 flows on
``recurrentgemma-9b``, beside a single-lane twin, with a profiled window
showing the two streams' kernels and their overlap) and the reference's
two baselines (``[baselines]``: the pre-donation and the scratch-cache
prefill serves, 4 flows each, beside the default), each checked against
the plain path; then runs the model API's two frontend forms, which the
serving backends refuse as the reference's do: ``[encdec]``,
``whisper-tiny`` at full width and depth (a 4-layer encoder over 1500
random frames, 4 decoder layers with cross attention), 4 rows prefilled
and decoded 32 steps, and ``[vision]``, ``llava-next-34b`` at full width
and depth (60 layers, 56/8 heads of 128: G 7), 2880 random patch
embeddings and a 128-token prompt in one prefill chunk, then 16 decode
steps, each through the attention kernels with exact launch counts and
every token held to the plain path (llava's to the plain path's own bf16
floor plus the margin, a gate that planted attention faults must fail;
its f32 weights do not fit on the card); both forms also train in
``[train]`` (whisper whole, llava cut to 4 of 60 layers, batch 1 with
the frames or patches); then ``[shard]``: ``llama3.2-3b`` at full width on
the 1x1 host mesh with DTensor parameters, batch-sharded through the
attention kernels (launches and logits equal to the unsharded run's) and
tensor-parallel on the plain path (tokens within the margin of the plain
run's), and the full-width dry run of ``llama3-405b`` x ``decode_32k`` on
the 16x16 mesh in a process of its own; then prints the kernel table
as JSON and, as its last line, ``{"ok": true, "device": {...}}``.  Any
failed phase
raises, and the script exits non-zero without that line — also when no GPU
is visible or when run outside the repository.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
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
RG_ARCH = "recurrentgemma-9b"
RWKV_ARCH = "rwkv6-1.6b"
DS_ARCH = "deepseek-v2-lite-16b"
WHISPER_ARCH = "whisper-tiny"
LLAVA_ARCH = "llava-next-34b"
SEED = 0
MAX_LEN = 2048
POOL = 16
OUT_TOKENS = 32
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s
# and bf16 tensor-core operations/s (the queries are bf16 in every case, so
# int8 K/V cases are held to the bf16 rate too)
HBM_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
# f32 outside the tensor cores: the scans' arithmetic
PEAK_F32_OPS_S = 67e12
# the fastest f32-accurate route for the f32 flash attention rows: the
# tensor cores' 495 TFLOP/s TF32, three TF32 products for each f32-precision
# product (3xTF32, as flash_attention_bwd.cu runs them), so a sound kernel
# on that route cannot show a share above 1 against the bound
PEAK_F32_TC_OPS_S = 495e12 / 3
# kernel vs plain: both accumulate in f32 and round once to the bf16 output,
# so a sound kernel differs by at most one bf16 ulp (2^-7 relative) of an
# element; the limit is two ulps of the largest plain output.  Scaled this
# way it stays far below the change that one dropped 64-slot tile makes
# (measured for every case below, and required to exceed the limit); for
# the expert GEMM the planted fault is one 64-wide slice of the d reduction
# zeroed, for the scans one token's update skipped
KERNEL_TOL_REL = 4 * 2.0 ** -8
DROP_TILE = 64
# served token vs the plain path's argmax: the kernel and plain attention
# round differently in bf16 across 28 layers, so a served token may be a
# near-tie of the plain argmax; accept a gap of at most this many logit units
LOGIT_MARGIN = 0.25
# rwkv6-1.6b at random init is too ill-conditioned in bf16 for the token
# check: two sound bf16 evaluations of it (the plain path with the prompt in
# the engine's chunks and in one call) land further apart than LOGIT_MARGIN,
# and so do its bf16 and f32 plain evaluations (PERF.md, PR 13).  Its bf16
# serve's largest gap is held to that noise floor plus LOGIT_MARGIN, a gate
# whose power is shown by serves with a planted WKV fault (WKV_FAULTS), and
# its served tokens to LOGIT_MARGIN itself in an f32 serve.
# deepseek-v2-lite-16b's bf16 serve routes near-ties of its top-6 of 64
# experts apart on the kernel and plain paths (its largest gap, 0.5156, at a
# token that layers 21 and 22 route to other experts), and the plain path's
# own bf16 floor, 1.7188, is above LOGIT_MARGIN too (PERF.md, on the H100):
# its bf16 serve is held to that floor plus the margin and its tokens to
# LOGIT_MARGIN in an f32 serve
F32_TOKEN_CHECK = (RWKV_ARCH, DS_ARCH)
# llava-next-34b's f32 weights (137.6 GB) do not fit on the card, and its
# bf16 serve (60 layers) landed one of 17 tokens 0.2812 below the plain
# argmax, where the plain path's own bf16 floor was 0.1875 (PERF.md):
# [vision] holds it to that floor plus the margin, a gate that planted
# attention faults must fail (VISION_FAULTS)
# the runs under torch.profiler: one training step, and one prefill chunk
# and decode segment of each served model (profile_serving).  The serves
# skip their profiled repeat (the trace's processing took 88-189 s a serve
# on the H100, PERF.md), which keeps the script near half its time limit
# the training phase: llama3.2-3b at full width in f32, a batch of
# TRAIN_BATCH x TRAIN_SEQ tokens, TRAIN_STEPS AdamW steps through the
# launcher.  One step at fixed weights and batch through the kernels is held
# to the plain path: the loss to TRAIN_LOSS_REL relative, every gradient
# leaf to TRAIN_GRAD_REL relative L2 (both paths are f32 with f32 matmuls;
# only the attention's summation order differs), a limit that a step with
# one dK/dV tile of FLASH_DROP keys dropped in every layer must exceed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 5
# the launcher's learning rate for the five steps.  Its default, 3e-4, has
# a one-step warmup at five steps, and Adam's first steps move every weight
# by about the rate: from random init the 3.2 B model's loss then rose
# after the first step (12.51, 10.36, 12.89, 14.38, 16.98 on the H100), and
# at 3e-5 and 1e-5 it swung (to 16.18 and 8.97 at the third and fourth
# steps); at 3e-6 it fell at every step (PERF.md, PR 14)
TRAIN_LR = 3e-6
# the other trained families: the depth cuts that one H100's 80 GB forces at
# 16 B a parameter (f32 weights, gradients, two Adam moments; full depth
# would need ~229 GB for the MoE, ~167 GB for recurrentgemma, ~251 GB for
# deepseek-v2-lite, whose cut keeps its dense head layer and 3 MoE layers),
# widths full, and each family's learning rate for the TRAIN_STEPS steps:
# the largest of the trials 3e-5, 1e-5 and 3e-6 whose loss fell at every
# step (on the H100: rwkv6's rose at the third step at 3e-5;
# tools/smoke_phases.py lr, PERF.md)
TRAIN_FAMILIES = {MOE_ARCH: dict(num_layers=4),
                  RG_ARCH: dict(num_layers=5, pattern_repeats=1),
                  RWKV_ARCH: {},
                  DS_ARCH: dict(num_layers=4),
                  WHISPER_ARCH: {},
                  LLAVA_ARCH: dict(num_layers=4)}
TRAIN_FAMILY_LR = {MOE_ARCH: 3e-5, RG_ARCH: 3e-5, RWKV_ARCH: 1e-5,
                   DS_ARCH: 3e-5, WHISPER_ARCH: 3e-5, LLAVA_ARCH: 3e-5}
# the frontend forms train at batch 1, each row with its frames or patches
# (random, from the seed): llava's 2880 patches make a 3904-token sequence
TRAIN_FRONTEND_BATCH = 1
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
FLASH_DROP = 64
# the serving attention kernels at a staged prefill's shapes: one row over
# the whole 2048-slot ring, no kv_limit (kernel_phase's last cases)
STAGED_DECODE = "bf16 B=1 staged ring, 300 live"
STAGED_POOL = "bf16 C=512 staged ring, 1024 live"
# kernels each served path must launch with kernel_backend="cuda"
PATH_KERNELS = {ARCH: ("decode_attention", "flash_attention_pool"),
                MOE_ARCH: ("decode_attention", "flash_attention_pool",
                           "moe_gemm"),
                RG_ARCH: ("decode_attention", "flash_attention_pool",
                          "rglru_scan"),
                RWKV_ARCH: ("rwkv6_scan",),
                DS_ARCH: ("moe_gemm",),
                WHISPER_ARCH: ("decode_attention", "flash_attention_pool"),
                LLAVA_ARCH: ("decode_attention", "flash_attention_pool")}
# [encdec]: whisper-tiny's rows, prompt tokens and decode steps, and its
# ring; [vision]: llava-next-34b's prompt tokens (after its 2880 patches)
# and decode steps, and its ring
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS, ENCDEC_MAX_LEN = 4, 64, 32, 128
# [shard]: llama3.2-3b on the 1x1 host mesh, a SHARD_PROMPT-token prefill of
# SHARD_BATCH rows and SHARD_STEPS decode extend calls; and one dry-run
# combination at full width (SHARD_DRYRUN: arch, shape; the 16x16 mesh)
SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS = 2, 512, 8
SHARD_DRYRUN = ("llama3-405b", "decode_32k")
VISION_PROMPT, VISION_STEPS, VISION_MAX_LEN = 128, 16, 4096
# the frontend forms' attention calls in [encdec] and [vision] (the
# kernel_phase cases): (name, rows, chunk or None for decode, ring slots,
# live slots, (Hq, Hkv, hd))
FRONTEND_DECODE = [
    ("whisper B=4 6/6 hd64 ring 128", 4, None, ENCDEC_MAX_LEN, 96,
     (6, 6, 64)),
    ("llava B=1 56/8 hd128 ring 4096", 1, None, VISION_MAX_LEN, 3016,
     (56, 8, 128))]
FRONTEND_POOL = [
    ("whisper B=4 C=64 6/6 hd64 ring 128", 4, ENCDEC_PROMPT, ENCDEC_MAX_LEN,
     ENCDEC_PROMPT, (6, 6, 64)),
    ("llava C=3008 56/8 hd128 ring 4096", 1, 2880 + VISION_PROMPT,
     VISION_MAX_LEN, 2880 + VISION_PROMPT, (56, 8, 128))]


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


# device cycles the stream spins before a timed run (~0.5 ms): the host
# enqueues the run's launches meanwhile, so the start event times the
# device's work and not the wrapper's Python
SPIN_CYCLES = 1_000_000


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
        torch.cuda._sleep(SPIN_CYCLES)
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
    """The C == 1 calls of the serving paths: B=16 rows (and B=4, B=1: the
    most splits), a 2048-slot ring read to kv_limit 1024 or 2048 (or 64, the
    elastic kv_limit of short rows: one tile), bf16 or int8; 24/8 heads of
    128 (llama3.2-3b, G = 3), 16/16 of 128 (qwen2-moe-a2.7b, G = 1) or 16/1
    of 256 in a 2048-token window (recurrentgemma-9b, G = 16)."""
    S = MAX_LEN
    cases = []
    for name, B, kvl, int8, window, wrap, rows, (Hq, Hkv, hd) in [
            ("bf16 kvl=2048", 16, 2048, False, None, None, None,
             (24, 8, 128)),
            ("bf16 kvl=1024", 16, 1024, False, None, None, None,
             (24, 8, 128)),
            ("int8 kvl=2048", 16, 2048, True, None, None, None,
             (24, 8, 128)),
            ("int8 kvl=1024", 16, 1024, True, None, None, None,
             (24, 8, 128)),
            ("bf16 window=256", 16, 2048, False, 256, None, None,
             (24, 8, 128)),
            ("bf16 wrapped ring", 16, 2048, False, None, 3000, None,
             (24, 8, 128)),
            ("bf16 row view 2:10 x 1024", 16, 1024, False, None, None,
             (2, 10), (24, 8, 128)),
            ("bf16 B=1 kvl=2048", 1, 2048, False, None, None, None,
             (24, 8, 128)),
            ("bf16 B=4 kvl=2048", 4, 2048, False, None, None, None,
             (24, 8, 128)),
            ("bf16 kvl=64", 16, 64, False, None, None, None, (24, 8, 128)),
            ("G=1 bf16 kvl=2048", 16, 2048, False, None, None, None,
             (16, 16, 128)),
            ("G=1 int8 kvl=2048", 16, 2048, True, None, None, None,
             (16, 16, 128)),
            ("hd256 G=16 bf16 kvl=2048 window=2048", 16, 2048, False, 2048,
             None, None, (16, 1, 256)),
            ("hd256 G=16 bf16 kvl=1024 window=2048", 16, 1024, False, 2048,
             None, None, (16, 1, 256))]:
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
    # a staged prefill's 1-token bucket (DualDeviceBackend, or the scratch
    # baseline): one row over its whole 2048-slot ring with no kv_limit,
    # 300 positions live
    k, _ = _kv(gen, (1, S, 8, 128), torch.bfloat16, False)
    v, _ = _kv(gen, (1, S, 8, 128), torch.bfloat16, False)
    q = torch.randn((1, 24, 128), generator=gen, device="cuda").bfloat16()
    cur = torch.full((1,), 299, dtype=torch.int32, device="cuda")
    cases.append((STAGED_DECODE, (q, k, v, _ring_positions(1, S, 300).cuda(),
                                  cur),
                  dict(window=None, kv_limit=None, k_scale=None,
                       v_scale=None), False))
    return cases + frontend_cases(gen, FRONTEND_DECODE)


def frontend_cases(gen, table):
    """The frontend forms' calls (FRONTEND_DECODE, FRONTEND_POOL): bf16 K/V
    over the whole ring (their serves pass no kv_limit) with positions
    [0, live) in slots [0, live); a decode query at position live - 1, or a
    fresh prefill's chunk of C queries at positions [0, C) in the kernel
    layout."""
    cases = []
    for name, B, C, S, live, (Hq, Hkv, hd) in table:
        k, _ = _kv(gen, (B, S, Hkv, hd), torch.bfloat16, False)
        v, _ = _kv(gen, (B, S, Hkv, hd), torch.bfloat16, False)
        sp = _ring_positions(B, S, live).cuda()
        if C is None:
            q = torch.randn((B, Hq, hd), generator=gen,
                            device="cuda").bfloat16()
            cur = torch.full((B,), live - 1, dtype=torch.int32,
                             device="cuda")
            cases.append((name, (q, k, v, sp, cur),
                          dict(window=None, kv_limit=None, k_scale=None,
                               v_scale=None), False))
            continue
        q = torch.randn((B, C, Hq, hd), generator=gen,
                        device="cuda").bfloat16()
        pos_q = torch.arange(C, dtype=torch.int32,
                             device="cuda").repeat(B, 1)
        cases.append((name, (q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), pos_q, sp),
                      dict(window=None, k_scale=None, v_scale=None), False))
    return cases


def decode_splits_of(args, kw):
    """The split count the decode wrapper takes for these inputs."""
    from repro_torch.kernels import ops
    q, k = args[0], args[1]
    S = kw["kv_limit"] or k.shape[1]
    return ops.decode_splits(q.shape[0], k.shape[2], S, q.shape[2],
                             q.shape[1] // k.shape[2], k.element_size())


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
    chunk (or 16 and 32, the pow-2 sub-chunks a prompt's tail runs as)
    against a 2048-slot ring; 24 query heads on 8 kv heads of 128 (G = 3),
    16 on 16 (G = 1), or 16 on 1 of 256 in a 2048-token window (G = 16)."""
    S = MAX_LEN
    cases = []
    for name, C, int8, window, wrap, strided, (Hq, Hkv, hd) in [
            ("bf16 C=512", 512, False, None, None, False, (24, 8, 128)),
            ("bf16 C=128", 128, False, None, None, False, (24, 8, 128)),
            ("int8 C=512", 512, True, None, None, False, (24, 8, 128)),
            ("int8 C=128", 128, True, None, None, False, (24, 8, 128)),
            ("bf16 C=128 window=256", 128, False, 256, None, False,
             (24, 8, 128)),
            ("bf16 C=128 wrapped ring", 128, False, None, 3000, False,
             (24, 8, 128)),
            ("bf16 C=128 row view of 4-row pool", 128, False, None, None,
             True, (24, 8, 128)),
            ("bf16 C=32", 32, False, None, None, False, (24, 8, 128)),
            ("bf16 C=16", 16, False, None, None, False, (24, 8, 128)),
            ("G=1 bf16 C=512", 512, False, None, None, False, (16, 16, 128)),
            ("G=1 bf16 C=128", 128, False, None, None, False, (16, 16, 128)),
            ("hd256 G=16 bf16 C=512 window=2048", 512, False, 2048, None,
             False, (16, 1, 256)),
            ("hd256 G=16 bf16 C=128 window=2048", 128, False, 2048, None,
             False, (16, 1, 256))]:
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
    # a staged prefill's chunk: positions [512, 1024) of one row's whole
    # 2048-slot ring (no kv_limit), the 512 before it live
    k, _ = _kv(gen, (1, S, 8, 128), torch.bfloat16, False)
    v, _ = _kv(gen, (1, S, 8, 128), torch.bfloat16, False)
    q = torch.randn((1, 512, 24, 128), generator=gen,
                    device="cuda").bfloat16()
    pos_q = torch.arange(512, 1024, dtype=torch.int32, device="cuda")[None]
    sp = _ring_positions(1, S, 1024).cuda()
    cases.append((STAGED_POOL, (q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), pos_q, sp),
                  dict(window=None, k_scale=None, v_scale=None), False))
    return cases + frontend_cases(gen, FRONTEND_POOL)


def pool_work(args, kw):
    """(bytes, operations) the pool function needs on these inputs: the
    valid (query, slot) pairs of the same mask the plain version builds
    (causality, empty slots, window), 4 hd operations per pair and query
    head; K/V (and scales) of the slots some query sees, every position."""
    q, k, _, pos_q, pos_kv = args
    B, Hq, C, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    pq, pk = pos_q[:, :, None], pos_kv[:, None, :]
    ok = (pk >= 0) & (pk <= pq)
    if kw["window"] is not None:
        ok &= pk > pq - kw["window"]
    pairs, n = int(ok.sum()), int(ok.any(1).sum())
    moved = (nbytes(q) * 2 + B * S * 4 + B * C * 4
             + n * Hkv * hd * k.element_size() * 2
             + (n * Hkv * 4 * 2 if kw["k_scale"] is not None else 0))
    return moved, 4 * Hq * hd * pairs


def pool_drop_tile(args):
    """The same inputs with the DROP_TILE positions just before the chunk
    (seen by every query, inside every window) emptied; for a fresh
    prefill's chunk, with no position before it, the DROP_TILE positions
    before its middle (seen by its later half)."""
    q, k, v, pos_q, pos_kv = args
    lo = int(pos_q.min())
    if lo < DROP_TILE:
        lo = (lo + int(pos_q.max()) + 1) // 2
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
    (capacity int(512*4/60*1.25) = 42), a single row, and the decode pool
    as a served call fills it: 16 rows of top-4 routing over 60 experts
    give an expert ~1 token, so each expert's rows past its 1-2 tokens
    (drawn from the seed) are zero, as ``moe_ffn`` leaves its unfilled
    slots.  Then the calls on each side of the kernel's C cuts (launch_c),
    rows filled as routed (MOE_ROUTED): an 8-row decode pool, and the
    serve's prefill pieces of 32, 64, 128 and 256 tokens (C 2, 5, 10,
    21).  Last, deepseek-v2-lite-16b's (MOE_E64: 64 experts, the same d and
    d_ff): its dropless 16-row decode pool, gate / up and down, and its
    512-token prefill bucket (capacity int(512*6/64*1.25) = 60)."""
    cases = []
    for name, C, d, f, fill in [
            ("decode C=16 d=2048 f=1408", 16, 2048, 1408, None),
            ("decode down C=16 d=1408 f=2048", 16, 1408, 2048, None),
            ("prefill C=42 d=2048 f=1408", 42, 2048, 1408, None),
            ("single row C=1 d=2048 f=1408", 1, 2048, 1408, None),
            (MOE_SERVED, 16, 2048, 1408, "served")] + MOE_ROUTED + MOE_E64:
        E = 64 if name.startswith("E=64") else 60
        x = torch.randn((E, C + 1, d), generator=gen, device="cuda")
        w = torch.randn((E, d, f), generator=gen, device="cuda") * 0.02
        if fill == "served":
            n = torch.randint(1, 3, (E, 1, 1), generator=gen, device="cuda")
            x = x * (torch.arange(C + 1, device="cuda")[:, None] < n)
        elif fill:  # fill tokens, each routed to 4 experts at random
            top = torch.rand((fill, E), generator=gen,
                             device="cuda").topk(4, dim=1).indices
            n = torch.bincount(top.flatten(), minlength=E).clamp_max(C)
            x = x * (torch.arange(C + 1, device="cuda")[:, None]
                     < n[:, None, None])
        cases.append((name, (x.bfloat16()[:, :C], w.bfloat16()), {}, False))
    return cases


# (name, C, d, f, tokens routed): a decode pool of 8 rows and the serve's
# prefill pieces of T tokens at capacity C = int(T 4/60 1.25)
MOE_ROUTED = [("decode C=8 as routed d=2048 f=1408", 8, 2048, 1408, 8)] + [
    (f"prefill T={T} C={C} as routed d=2048 f=1408", C, 2048, 1408, T)
    for T, C in ((32, 2), (64, 5), (128, 10), (256, 21))]
# the decode pool of the MoE serve as served: most rows zero
MOE_SERVED = "decode C=16 as served d=2048 f=1408"
# deepseek-v2-lite-16b's expert GEMMs (64 experts), every row live
MOE_E64 = [("E=64 decode C=16 d=2048 f=1408", 16, 2048, 1408, None),
           ("E=64 decode down C=16 d=1408 f=2048", 16, 1408, 2048, None),
           ("E=64 prefill C=60 d=2048 f=1408", 60, 2048, 1408, None)]
# the expert GEMM the shipped one replaced, built beside it: each case's
# outputs are held bitwise equal to its outputs, since the sum's rounding
# is part of the MoE serve's tokens
MOE_FMA_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "moe_gemm_fma.cu")


def moe_fma(args, lib=None):
    """``args`` through the replaced expert GEMM (uncounted), from its
    library ``lib`` if given (a timed call passes it: the lookup is host
    time)."""
    from repro_torch.kernels import build, ops
    out, rc = ops.moe_gemm_with(
        lib or build.load_variant(MOE_FMA_SRC, "moe_gemm_launch"), *args)
    if rc != 0:
        raise RuntimeError(f"moe_gemm_fma: kernel launch failed ({rc})")
    return out


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


def rglru_cases(gen):
    """The RG-LRU recurrence of recurrentgemma-9b (lru_width 4096) as
    ``ssm.rglru_block`` calls it: x and the input gate bf16, a_log f32
    (-8 softplus(lam) sigmoid(.) < 0), a nonzero f32 h0; a 512-token
    prefill chunk of one row, the serve's largest prefill bucket (128
    tokens), a 16-row decode step, and 300 tokens (a ragged last chunk)."""
    W = 4096
    cases = []
    for name, B, S in [("prefill B=1 S=512 W=4096", 1, 512),
                       ("prefill B=1 S=128 W=4096", 1, 128),
                       ("decode B=16 S=1 W=4096", 16, 1),
                       ("prefill B=1 S=300 W=4096", 1, 300)]:
        x = torch.randn((B, S, W), generator=gen, device="cuda").bfloat16()
        gate = torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                         device="cuda")).bfloat16()
        a_log = -6.4 * torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                                 device="cuda"))
        h0 = torch.randn((B, W), generator=gen, device="cuda")
        cases.append((name, (x, a_log, gate, h0), {}, False))
    return cases


def rglru_work(args, kw):
    """(bytes, operations): every input read once, h and h_final written
    once; 8 f32 operations an element (exp, a a, 1 -, max, sqrt, gate x,
    two FMAs)."""
    x, a_log, gate, h0 = args
    return nbytes(x, a_log, gate, h0) + nbytes(x, h0), 8 * x.numel()


def rglru_skip(args):
    """The same inputs with the middle token's update skipped (a = 1, x =
    0: h_t = h_{t-1}): what a kernel that dropped a step would compute."""
    x, a_log, gate, h0 = args
    t = x.shape[1] // 2
    x, a_log = x.clone(), a_log.clone()
    x[:, t], a_log[:, t] = 0, 0
    return x, a_log, gate, h0


def rwkv6_cases(gen):
    """The WKV6 recurrence of rwkv6-1.6b (32 heads of 64) as
    ``ssm.rwkv6_block`` calls it: r/k/v bf16 and w_log f32 as (B, S, H, D)
    -> (B, H, S, D) head-split views, u the (H, 1, D) bf16 bonus, a nonzero
    f32 state0; a 512-token prefill chunk of one row (B*H 32), the serve's
    largest prefill bucket (128 tokens) and a 16-row decode step (B*H
    512)."""
    H, D = 32, 64
    cases = []
    for name, B, S in [("prefill BH=32 S=512 D=64", 1, 512),
                       ("prefill BH=32 S=128 D=64", 1, 128),
                       ("decode BH=512 S=1 D=64", 16, 1)]:
        def split(x):
            return x.reshape(B, S, H, D).transpose(1, 2)
        r, k, v = (split(torch.randn((B, S, H * D), generator=gen,
                                     device="cuda").bfloat16() * 0.5)
                   for _ in range(3))
        w_log = split(-torch.exp(torch.clamp(
            0.5 + 0.5 * torch.randn((B, S, H * D), generator=gen,
                                    device="cuda"), -8.0, 1.0)))
        u = (torch.randn((H, 1, D), generator=gen, device="cuda")
             * 0.3).bfloat16()
        state0 = torch.randn((B, H, D, D), generator=gen,
                             device="cuda") * 0.3
        cases.append((name, (r, k, v, w_log, u, state0), {}, False))
    return cases


def rwkv6_work(args, kw):
    """(bytes, operations): r, k, v, w_log, u and state0 read once, the
    output and the final state written once; 5 D^2 + 6 D f32 operations a
    token per (row, head): r S (2 D^2), the state decay and update w S + k
    v (3 D^2), e^w (D), the bonus sum_d r_d u_d k_d (3 D) and its v_e
    term added to the output (2 D)."""
    r, k, v, w_log, u, state0 = args
    B, H, S, D = r.shape
    return (nbytes(r, k, v, w_log, u, state0) + nbytes(r, state0),
            B * H * S * (5 * D * D + 6 * D))


def rwkv6_skip(args):
    """The same inputs with the middle token's update skipped (k = 0, decay
    1: the state passes it unchanged)."""
    r, k, v, w_log, u, state0 = args
    t = r.shape[2] // 2
    k, w_log = k.clone(), w_log.clone()
    k[:, :, t], w_log[:, :, t] = 0, 0
    return r, k, v, w_log, u, state0


def moe_bitwise_check(kfn, name, args):
    """Hold the expert GEMM's bf16 outputs bitwise equal (``torch.equal``)
    to the replaced kernel's on ``args``, and show the check's power: the
    replaced kernel on the inputs with one zeroed d slice differs.  Returns
    the replaced kernel's time for the kernel row."""
    got = kfn(*args)
    want = moe_fma(args)
    faulty = moe_fma(moe_drop_slice(args))
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    caught = not torch.equal(got, faulty)
    log(f"[check] {'moe_gemm':20s} {name:34s} bitwise equal to the replaced "
        f"FMA kernel (tools/moe_gemm_fma.cu): {same}; with one zeroed "
        f"{DROP_TILE}-wide d slice: {not caught}")
    if not same:
        n = (got != want).sum().item()
        raise AssertionError(f"moe_gemm [{name}]: {n} outputs differ from "
                             "the replaced kernel's")
    if not caught:
        raise AssertionError(f"moe_gemm [{name}]: the bitwise check would "
                             "not catch one zeroed d slice")
    from repro_torch.kernels import build
    lib = build.load_variant(MOE_FMA_SRC, "moe_gemm_launch")
    return dict(bitwise_equal_to_replaced=same,
                replaced_ms=time_ms(lambda: moe_fma(args, lib)))


def _flat(out):
    """A kernel's output(s) as one flat f32 vector."""
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.float().flatten() for o in outs])


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
             moe_work, moe_drop_slice),
            ("rglru_scan", rglru_cases(gen), ops.rglru_scan, ref.rglru_scan,
             rglru_work, rglru_skip),
            ("rwkv6_scan", rwkv6_cases(gen), ops.rwkv6_scan, ref.rwkv6_scan,
             rwkv6_work, rwkv6_skip)]:
        fault_name = {"moe_gemm": f"one zeroed {DROP_TILE}-wide d slice",
                      "rglru_scan": "one token's update skipped",
                      "rwkv6_scan": "one token's update skipped"}.get(
                          kname, f"one dropped {DROP_TILE}-slot tile")
        scan = kname in ("rglru_scan", "rwkv6_scan")
        for name, args, kw, int8 in cases:
            got = _flat(kfn(*args, **kw))
            torch.cuda.synchronize()
            want = _flat(rfn(*args, **kw))
            err = (got - want).abs().max().item()
            tol = KERNEL_TOL_REL * want.abs().max().item()
            typical = want.abs().mean().item()
            fault = (_flat(rfn(*drop_tile(args), **kw))
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
            extra_row = {}
            if kname == "moe_gemm":
                extra_row = moe_bitwise_check(kfn, name, args)
            ms = time_ms(lambda: kfn(*args, **kw))
            plain_ms = time_ms(lambda: rfn(*args, **kw), reps=20)
            lib_ms = None  # the scans: no one PyTorch call computes them
            if kname == "moe_gemm":
                lib_ms = time_ms(lambda: torch.bmm(*args))
            elif not int8 and not scan:
                if kname == "decode_attention":
                    lib = _library_decode(*args, kw["window"],
                                          kw["kv_limit"])
                else:
                    lib = _library_pool(*args, kw["window"])
                lib_ms = time_ms(lib)
            moved, ops_n = work(args, kw)
            t_bytes = moved / HBM_BYTES_S * 1e3
            t_ops = ops_n / (PEAK_F32_OPS_S if scan else PEAK_BF16_OPS_S) \
                * 1e3
            bound = max(t_bytes, t_ops)
            rows[(kname, name)] = dict(
                max_abs_err=err, tol=tol, dropped_tile_err=fault, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                **extra_row)
            extra = ""
            if kname == "decode_attention":
                n_split = decode_splits_of(args, kw)
                rows[(kname, name)]["n_split"] = n_split
                extra = f" n_split {n_split}"
            lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"[kernel] {kname:20s} {name:34s} kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms library {lib_txt} ms bound "
                f"{bound:.4f} ms ({rows[(kname, name)]['bound_by']}) "
                f"share {bound / ms:.3f}{extra}")
    return rows


# -- the training flash attention ----------------------------------------------
def flash_cases(gen):
    """The training path's attention calls (q, K, V and d_out as the model
    passes them: (B, S, H, hd) transposed to (B, H, S, hd) views): llama3.2-3b
    at B 2, S 1024, 24/8 heads of 128, causal, f32 (the trainer's dtype) and
    bf16; a 256-token window (tile skipping by the window); S 40 at hd 32;
    qwen2-moe-a2.7b's 16/16 heads of 128 and recurrentgemma-9b's 16/1 heads
    of 256 with its 2048 window, f32."""
    cases = []
    for name, B, S, Hq, Hkv, hd, dtype, window in [
            ("f32 B=2 S=1024 24/8 hd128 causal", 2, 1024, 24, 8, 128,
             torch.float32, None),
            ("bf16 B=2 S=1024 24/8 hd128 causal", 2, 1024, 24, 8, 128,
             torch.bfloat16, None),
            ("f32 B=2 S=1024 24/8 hd128 window=256", 2, 1024, 24, 8, 128,
             torch.float32, 256),
            ("f32 B=1 S=40 4/2 hd32 causal", 1, 40, 4, 2, 32, torch.float32,
             None),
            # the trained families' attention layers: qwen2-moe-a2.7b,
            # and recurrentgemma-9b's local attention (its window passes S)
            ("f32 B=2 S=1024 16/16 hd128 causal", 2, 1024, 16, 16, 128,
             torch.float32, None),
            ("f32 B=2 S=1024 16/1 hd256 window=2048", 2, 1024, 16, 1, 256,
             torch.float32, 2048),
            # the frontend forms' decoders (batch 1, f32): whisper-tiny's
            # 6/6 heads of 64, and llava-next-34b's 56/8 heads of 128 (G 7)
            # over its 2880 patches and 1024 tokens
            ("f32 B=1 S=1024 6/6 hd64 causal", 1, 1024, 6, 6, 64,
             torch.float32, None),
            ("f32 B=1 S=3904 56/8 hd128 causal", 1, 2880 + 1024, 56, 8, 128,
             torch.float32, None)]:
        def mk(H):
            return torch.randn((B, S, H, hd), generator=gen,
                               device="cuda").to(dtype).transpose(1, 2)
        cases.append((name, (mk(Hq), mk(Hkv), mk(Hkv), mk(Hq)),
                      dict(window=window)))
    return cases


def flash_mask(Sq, Skv, window, drop=None):
    """(Sq, Skv) valid pairs of the causal (windowed) mask; ``drop`` =
    (lo, hi) also masks keys [lo, hi)."""
    i = torch.arange(Sq, device="cuda")[:, None]
    j = torch.arange(Skv, device="cuda")[None, :]
    ok = j <= i
    if window is not None:
        ok &= j > i - window
    if drop is not None:
        ok &= (j < drop[0]) | (j >= drop[1])
    return ok


def flash_drop(S):
    """The key tile a planted fault drops: FLASH_DROP keys (a quarter of a
    short sequence) ending at the middle, seen by every later query."""
    n = min(FLASH_DROP, S // 4)
    return S // 2 - n, S // 2


def flash_drop_tile(q, k, v, window):
    """The plain forward with one key tile dropped (flash_drop): what a
    kernel that skipped a tile it needs would compute."""
    G = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 1)) / q.shape[-1] ** 0.5
    ok = flash_mask(q.shape[2], k.shape[2], window, flash_drop(k.shape[2]))
    p = torch.softmax(torch.where(ok, s, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float().repeat_interleave(G, 1)).to(q.dtype)


def flash_work(q, k, window, backward):
    """(bytes, operations) on these inputs: the valid (query, key) pairs of
    the mask times the query heads and rows, 4 hd operations a pair forward
    (q k and p v), 10 hd backward (S recomputed, dP, dV, dK, dQ); forward
    q, K, V read and out and the f32 lse written once, backward q, K, V,
    out, d_out and the lse read and dq, dK, dV written once."""
    B, Hq, Sq, hd = q.shape
    pairs = int(flash_mask(Sq, k.shape[2], window).sum()) * B * Hq
    qb, kb = nbytes(q), nbytes(k)
    lse = B * Hq * Sq * 4
    if backward:
        return 3 * qb + 2 * kb + lse + qb + 2 * kb, 10 * hd * pairs
    return qb + 2 * kb + qb + lse, 4 * hd * pairs


def _sdpa(q, k, v, window):
    """One PyTorch call for the function (yardstick only, never called by
    the port): SDPA, causal, or with the windowed boolean mask."""
    import torch.nn.functional as F
    if window is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    mask = flash_mask(q.shape[2], k.shape[2], window)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def _check_row(kname, name, what, err, tol, fault=None, fault_name=""):
    """Log and hold one output: err within tol and, where a fault was
    planted, the fault's change beyond it."""
    log(f"[check] {kname:20s} {name:38s} {what:4s} err {err:.2e} tol "
        f"{tol:.2e} (err/tol {err / tol:.3f})"
        + ("" if fault is None else
           f"; {fault_name} {fault:.2e} ({fault / tol:.1f} x tol)"))
    if not err <= tol:
        raise AssertionError(f"{kname} [{name}] {what}: max abs err {err} > "
                             f"{tol}")
    if fault is not None and not fault > tol:
        raise AssertionError(f"{kname} [{name}] {what}: the tolerance {tol} "
                             f"would not catch {fault_name} ({fault})")


def flash_kernel_phase():
    """The training flash attention forward and backward kernels against
    their plain versions (two bf16 ulps of the largest plain output, as
    every kernel case; the f32 lse to 1e-5 relative), each with a planted
    fault the limit must catch (a dropped key tile in the forward, a
    dropped dK/dV tile in the backward), the backward bit-equal across two
    runs, and their times beside the plain versions' and SDPA's."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    rows = {}
    for name, (q, k, v, d_out), kw in flash_cases(gen):
        window = kw["window"]
        rate = PEAK_F32_TC_OPS_S if q.dtype == torch.float32 else \
            PEAK_BF16_OPS_S
        # forward: output and lse
        out, lse = ops.flash_attention(q, k, v, window=window,
                                       return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = ref.flash_attention_lse(q, k, v, window=window)
        err = (out.float() - want.float()).abs().max().item()
        tol = KERNEL_TOL_REL * want.float().abs().max().item()
        fault = (flash_drop_tile(q, k, v, window).float()
                 - want.float()).abs().max().item()
        _check_row("flash_attention", name, "out", err, tol, fault,
                   f"one dropped {FLASH_DROP}-key tile")
        lse_err = (lse - want_lse).abs().max().item()
        lse_tol = 1e-5 * want_lse.abs().max().item()
        log(f"[check] flash_attention      {name:38s} lse  err "
            f"{lse_err:.2e} tol {lse_tol:.2e}")
        if not lse_err <= lse_tol:
            raise AssertionError(f"flash_attention [{name}] lse: max abs err "
                                 f"{lse_err} > {lse_tol}")
        # backward on the plain forward's (out, lse), as the plain one
        args = (q, k, v, want, want_lse, d_out)
        grads = ops.flash_attention_bwd(*args, window=window)
        again = ops.flash_attention_bwd(*args, window=window)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_attention_bwd [{name}]: two runs "
                                 "differ")
        wants = ref.flash_attention_bwd(*args, window=window)
        lo, hi = flash_drop(k.shape[2])
        bwd = {}
        for what, g, w in zip(("dq", "dk", "dv"), grads, wants):
            e = (g.float() - w.float()).abs().max().item()
            t = KERNEL_TOL_REL * w.float().abs().max().item()
            # the planted fault: dK/dV's rows of one key tile zeroed
            f = None if what == "dq" else \
                w[:, :, lo:hi].float().abs().max().item()
            _check_row("flash_attention_bwd", name, what, e, t, f,
                       f"one dropped {hi - lo}-key dK/dV tile")
            bwd[what] = dict(err=e, tol=t, dropped_tile_err=f)
        # times
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        sdpa_out = _sdpa(qg, kg, vg, window)
        timed = dict(
            fwd=time_ms(lambda: ops.flash_attention(q, k, v, window=window)),
            plain_fwd=time_ms(lambda: ref.flash_attention(
                q, k, v, window=window), reps=10),
            sdpa_fwd=time_ms(lambda: _sdpa(q, k, v, window)),
            bwd=time_ms(lambda: ops.flash_attention_bwd(*args,
                                                        window=window)),
            plain_bwd=time_ms(lambda: ref.flash_attention_bwd(
                *args, window=window), reps=10),
            sdpa_bwd=time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), d_out, retain_graph=True)),
            sdpa_fwd_bwd=time_ms(lambda: torch.autograd.grad(
                _sdpa(qg, kg, vg, window), (qg, kg, vg), d_out)))
        del sdpa_out, qg, kg, vg
        for kname, backward, key in (("flash_attention", False, "fwd"),
                                     ("flash_attention_bwd", True, "bwd")):
            moved, n_ops = flash_work(q, k, window, backward)
            t_bytes = moved / HBM_BYTES_S * 1e3
            t_ops = n_ops / rate * 1e3
            bound = max(t_bytes, t_ops)
            if backward:  # the output nearest its limit; all three kept
                worst = bwd[max(bwd, key=lambda w: bwd[w]["err"]
                                / bwd[w]["tol"])]
                extra = dict(per_output=bwd, dropped_tile_err=min(
                    bwd[w]["dropped_tile_err"] for w in ("dk", "dv")))
            else:
                worst = dict(err=err, tol=tol)
                extra = dict(dropped_tile_err=fault, lse_err=lse_err)
            ms = timed[key]
            rows[(kname, name)] = dict(
                max_abs_err=worst["err"], tol=worst["tol"], **extra, ms=ms,
                plain_ms=timed[f"plain_{key}"],
                library_ms=timed[f"sdpa_{key}"],
                library_fwd_bwd_ms=timed["sdpa_fwd_bwd"], bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"[kernel] {kname:20s} {name:38s} kernel {ms:.4f} ms plain "
                f"{timed[f'plain_{key}']:.4f} ms library (SDPA) "
                f"{timed[f'sdpa_{key}']:.4f} ms (fwd+bwd "
                f"{timed['sdpa_fwd_bwd']:.4f}) bound {bound:.4f} ms "
                f"({rows[(kname, name)]['bound_by']}) share {bound / ms:.3f}")
    return rows


# -- train -------------------------------------------------------------------
def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _grad_gaps(cfg, params, toks, want, frontend=None):
    """The largest per-leaf relative L2 gap of the kernel path's gradients
    (one step at ``params`` on ``toks`` and ``frontend``) to ``want``, and
    the loss."""
    from repro_torch.train.train_loop import loss_and_grads
    loss, _, grads = loss_and_grads(cfg, params, toks, frontend,
                                    kernel_backend="cuda")
    gaps = {n: _rel_l2(g, want[n]) for n, g in grads.items()}
    for p in params.parameters():
        p.grad = None
    del grads
    return loss, gaps


def _device_times(fn, ranges=()):
    """Run ``fn`` once under ``torch.profiler``: (wall s, device-side rows
    (kernel name, ms)).  Device events only: CPU operator rows would count
    their kernels' time a second time.  Also {name: device ms of the
    kernels launched inside it} for each ``record_function`` range of
    ``ranges`` that ``fn`` opens; the ranges' own device-side rows are left
    out of the kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in events
            if e.device_type == DeviceType.CUDA and e.key not in ranges]
    inside = {e.key: getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)) / 1e3
              for e in events
              if e.device_type == DeviceType.CPU and e.key in ranges}
    return wall, rows, inside


def profile_train_step(cfg, params, toks):
    """One more step's forward and backward through the kernels (no
    optimizer update) under ``torch.profiler``: device time by kernel, the
    flash kernels' share, and the device's busy share of the step's wall
    time (the profiler's own overhead included).  Device-side events only
    (kernels, copies): CPU operator rows would count their kernels' time a
    second time."""
    from repro_torch.train.train_loop import loss_and_grads
    wall, rows, _ = _device_times(
        lambda: loss_and_grads(cfg, params, toks, kernel_backend="cuda"))
    for p in params.parameters():
        p.grad = None
    busy_ms = sum(t for _, t in rows)
    if busy_ms <= 0:
        log("[profile] no device time in the trace: not measured")
        return None
    flash = {n: t for n, t in rows if "flash_" in n}
    top = sorted(rows, key=lambda r: -r[1])[:8]
    log(f"[profile] {cfg.name} train step (forward + backward) under the "
        f"profiler: wall {wall:.3f} s, device busy {busy_ms / 1e3:.3f} s "
        f"({busy_ms / 1e3 / wall:.3f} of wall); flash kernels "
        f"{sum(flash.values()):.1f} ms ({sum(flash.values()) / busy_ms:.3f} "
        "of busy)")
    for name, t in top:
        log(f"[profile]   {t:10.2f} ms  {name[:90]}")
    return dict(wall_s=wall, device_busy_s=busy_ms / 1e3,
                busy_share=busy_ms / 1e3 / wall,
                flash_ms={n[:90]: t for n, t in flash.items()},
                top_ms={n[:90]: t for n, t in top})


# the serving kernels' device-side names, summed in a serving profile: the
# attention kernels (decode: the split kernel and its merge; prefill: the
# tensor-core and the f32 pool kernels), the expert GEMM and the scans
PROFILED_KERNELS = {
    "attention": ("decode_mma_kernel", "decode_kernel", "merge_kernel",
                  "pool_mma_kernel", "flash_pool_kernel"),
    "moe_gemm": ("moe_",),
    "rglru_scan": ("rglru_",),
    "rwkv6_scan": ("wkv6_",)}
# tokens of the profiled prefill chunks: the 512-token chunk of the llama
# and deepseek serves, that and the 128-token piece (the serve's most
# common) of the MoE serve, the 128-token bucket (the largest) of the
# recurrent serves
PROFILE_CHUNK = {MOE_ARCH: (512, 128), RG_ARCH: (128,), RWKV_ARCH: (128,)}
# MLA's plain ops, which no kernel name tells apart: the device time of the
# kernels launched inside each range (profile_serving opens them around the
# MLA attention functions and the whole MLA attention sublayer)
MLA_RANGES = ("mla_attention", "mla_sublayer")


@contextlib.contextmanager
def _mla_ranges(cfg):
    """For an MLA config, open a ``record_function`` range (MLA_RANGES)
    around every call of the MLA attention functions and of the attention
    sublayer inside the block; a no-op for any other config."""
    from repro_torch.models import transformer
    names = {"mla_decode_attention": "mla_attention",
             "mla_prefill_attention": "mla_attention",
             "_attn_mix_extend": "mla_sublayer"} if cfg.use_mla else {}
    real = {n: getattr(transformer, n) for n in names}

    def ranged(fn, label):
        def wrapped(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return wrapped
    for n, fn in real.items():
        setattr(transformer, n, ranged(fn, names[n]))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(transformer, n, fn)


def profile_serving(cfg, params):
    """Device time by kernel, and the serving kernels' share of it
    (PROFILED_KERNELS), in full-width prefill chunks (C tokens of one row
    for each C of PROFILE_CHUNK, or 512, after three earlier chunks: the
    ring holding 3 C earlier positions) and one 8-step fused decode
    segment at B 16 (rows at 1024 positions, kv_limit 2048), each run once
    under the profiler after a warm-up, through ``extend`` and
    ``decode_run`` with ``kernel_backend="cuda"``.  For MLA, also the
    device time of the plain MLA ops (MLA_RANGES)."""
    from repro_torch.models import decode_run, extend, init_cache
    rng = np.random.default_rng(SEED + 2)

    def toks(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
    chunks = PROFILE_CHUNK.get(cfg.name, (512,))
    # the first chunk's prompt, then the pool's rows, then the others'
    prompts = [toks(1, 4 * chunks[0])]
    rows = toks(POOL, 1024)
    prompts += [toks(1, 4 * C) for C in chunks[1:]]
    runs = []
    for C, prompt in zip(chunks, prompts):
        one = init_cache(cfg, params, 1, MAX_LEN, torch.bfloat16)
        for i in range(3):
            extend(cfg, params, one, prompt[:, C * i:C * (i + 1)])
        warm = init_cache(cfg, params, 1, MAX_LEN, torch.bfloat16)
        extend(cfg, params, warm, prompt[:, :C])
        del warm
        runs.append((f"prefill C={C}", lambda one=one, tail=prompt[:, 3 * C:]:
                     extend(cfg, params, one, tail)))
    pool = init_cache(cfg, params, POOL, MAX_LEN, torch.bfloat16)
    extend(cfg, params, pool, rows[:, :512])
    extend(cfg, params, pool, rows[:, 512:])
    last = rows[:, -1].to(torch.int32)
    active = torch.ones(POOL, dtype=torch.bool, device="cuda")
    decode_run(cfg, params, pool, last, active, 1, kv_limit=MAX_LEN)
    out = {}
    runs.append((f"decode B={POOL} x 8 steps", lambda: decode_run(
        cfg, params, pool, last, active, 8, kv_limit=MAX_LEN)))
    for label, fn in runs:
        with _mla_ranges(cfg):
            wall, times, inside = _device_times(fn, MLA_RANGES)
        busy = sum(t for _, t in times)
        if busy <= 0:
            log(f"[profile] {cfg.name} {label}: no device time in the trace: "
                "not measured")
            continue
        by = {k: {n[:90]: t for n, t in times if any(x in n for x in names)}
              for k, names in PROFILED_KERNELS.items()}
        top = sorted(times, key=lambda r: -r[1])[:6]
        log(f"[profile] {cfg.name} {label}: wall {wall * 1e3:.2f} ms, device "
            f"busy {busy:.2f} ms ({busy / 1e3 / wall:.3f} of wall)"
            + "".join(f"; {k} {sum(v.values()):.3f} ms "
                      f"({sum(v.values()) / busy:.3f} of busy)"
                      for k, v in by.items() if v)
            + "".join(f"; plain {k} {t:.3f} ms ({t / busy:.3f} of busy)"
                      for k, t in inside.items()))
        for name, t in top:
            log(f"[profile]   {t:10.3f} ms  {name[:90]}")
        out[label] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                          **{f"{k}_ms": v for k, v in by.items()},
                          **{f"{k}_share": sum(v.values()) / busy
                             for k, v in by.items()},
                          **{f"{k}_ms": t for k, t in inside.items()},
                          **{f"{k}_share": t / busy
                             for k, t in inside.items()},
                          top_ms={n[:90]: t for n, t in top})
    del runs, pool
    _release()
    return out


def _dropped_dkdv(real):
    """``ops.flash_attention_bwd`` with one dK/dV tile (flash_drop) zeroed:
    a backward kernel that skipped a key tile."""
    def faulty(*args, **kw):
        dq, dk, dv = real(*args, **kw)
        lo, hi = flash_drop(dk.shape[2])
        dk[:, :, lo:hi] = 0
        dv[:, :, lo:hi] = 0
        return dq, dk, dv
    return faulty


def _train_batch():
    """The fixed TRAIN_BATCH x TRAIN_SEQ batch of the synthetic corpus
    (the launcher's first batch at seed SEED), on the card."""
    from repro_torch.data.pipeline import PipelineConfig, batches
    batch = next(batches(PipelineConfig(batch_size=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ, vocab_size=259,
                                        seed=SEED)))
    return torch.from_numpy(batch["tokens"]).cuda()


def _attn_layers(cfg):
    """Attention layers that run the flash kernels in training: every one
    but MLA's, which has no kernel."""
    from repro_torch.models import layout
    if cfg.use_mla:
        return 0
    head, pattern, repeats, tail = layout(cfg)
    return (head + pattern * repeats + tail).count("attn")


def train_step_check(cfg, params, toks, label, fault, frontend=None):
    """One step at fixed weights and batch (and ``frontend``: frames or
    patches) through the kernels against the plain path: the loss to
    TRAIN_LOSS_REL, every gradient leaf to TRAIN_GRAD_REL relative L2,
    exact launches (2 ``flash_attention`` an attention layer, the forward
    and remat's recompute, 1 ``flash_attention_bwd``, every other kernel
    0); with ``fault``, a planted dK/dV tile dropped in every attention
    layer must push the gradient gap past the limit.  Returns the step's
    numbers and its launches per step."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_loop import loss_and_grads
    t0 = time.perf_counter()
    loss_p, _, want = loss_and_grads(cfg, params, toks, frontend,
                                     kernel_backend="plain")
    want = dict(want)
    for p in params.parameters():
        p.grad = None
    ops.reset_launches()
    loss_c, gaps = _grad_gaps(cfg, params, toks, want, frontend)
    step_launches = dict(ops.LAUNCHES)
    loss_f, fault_gaps = None, None
    if fault:
        real = ops.flash_attention_bwd
        ops.flash_attention_bwd = _dropped_dkdv(real)
        try:
            loss_f, fault_gaps = _grad_gaps(cfg, params, toks, want,
                                            frontend)
        finally:
            ops.flash_attention_bwd = real
    del want
    _release()
    loss_gap = abs(loss_c.item() - loss_p.item()) / abs(loss_p.item())
    worst = max(gaps, key=gaps.get)
    out = dict(loss_kernel=loss_c.item(), loss_plain=loss_p.item(),
               loss_rel_gap=loss_gap, grad_rel_l2_max=gaps[worst],
               grad_rel_l2_max_leaf=worst, launches=step_launches)
    msg = ""
    if fault:
        fault_worst = max(fault_gaps, key=fault_gaps.get)
        out.update(faulty_grad_rel_l2_max=fault_gaps[fault_worst],
                   faulty_loss=loss_f.item())
        msg = (f"; with one dK/dV tile dropped in every attention layer "
               f"{fault_gaps[fault_worst]:.2e} ({fault_worst}, "
               f"{fault_gaps[fault_worst] / TRAIN_GRAD_REL:.1f} x the limit)")
    log(f"[check] {label} train step, kernels vs plain: loss "
        f"{loss_c.item():.6f} vs {loss_p.item():.6f} (relative gap "
        f"{loss_gap:.2e}, limit {TRAIN_LOSS_REL}); gradient relative L2 "
        f"gap, largest {gaps[worst]:.2e} ({worst}), limit {TRAIN_GRAD_REL}"
        f"{msg}; launches {step_launches}; {time.perf_counter() - t0:.1f} s")
    n_attn = _attn_layers(cfg)
    per_step = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    want_launches = {k: per_step.get(k, 0) for k in ops.LAUNCHES}
    if step_launches != want_launches:
        raise AssertionError(f"{label} train step launches {step_launches} "
                             f"!= {want_launches}")
    if not loss_gap <= TRAIN_LOSS_REL:
        raise AssertionError(f"{label} train step loss gap {loss_gap} > "
                             f"{TRAIN_LOSS_REL}")
    if not gaps[worst] <= TRAIN_GRAD_REL:
        raise AssertionError(f"{label} train step gradient {worst}: "
                             f"relative L2 gap {gaps[worst]} > "
                             f"{TRAIN_GRAD_REL}")
    if fault and not out["faulty_grad_rel_l2_max"] > TRAIN_GRAD_REL:
        raise AssertionError(
            f"{label}: the gradient limit {TRAIN_GRAD_REL} would not catch "
            f"a dropped dK/dV tile ({out['faulty_grad_rel_l2_max']})")
    return out, per_step


def train_steps_report(label, hist, launches, per_step, wall, peak, smi,
                       batch=TRAIN_BATCH):
    """Log and check TRAIN_STEPS logged steps: the launches of every step
    as ``per_step``, a finite loss that falls.  Returns (losses, step
    seconds, their median after the first, tokens/s: the ``batch`` rows'
    text tokens)."""
    from repro_torch.kernels import ops
    losses = [h["loss"] for h in hist]
    ends = [h["elapsed"] for h in hist]
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    steady = statistics.median(step_s[1:])
    tok_s = batch * TRAIN_SEQ / steady
    log(f"[train] {label} {TRAIN_STEPS} steps: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step s " + ", ".join(f"{x:.3f}" for x in step_s)
        + f" (median after the first {steady:.3f} s, {tok_s:.0f} tok/s); "
        f"peak memory {peak:.2f} GB; launches {launches}; phase {wall:.1f} s"
        f"; {smi}")
    want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in ops.LAUNCHES}
    if launches != want:
        raise AssertionError(f"{label} training launches {launches} != "
                             f"{want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall over "
                             f"{TRAIN_STEPS} steps: {losses}")
    return losses, step_s, steady, tok_s


def train_phase(smi):
    """llama3.2-3b at full width in f32 (random weights, seed SEED), a
    TRAIN_BATCH x TRAIN_SEQ batch of the synthetic corpus, remat on, f32
    matmuls at "highest".  (a) One step's loss and gradients at fixed
    weights and batch through the kernels against the plain path, and with
    a planted backward fault (train_step_check), then one more under the
    profiler; (b) TRAIN_STEPS AdamW steps at TRAIN_LR through the port's
    launcher (``repro_torch.launch.train``), whose loss must fall,
    with every kernel launch counted from 0: per step 2 forward launches a
    layer (the forward and remat's recompute) and 1 backward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    torch.set_float32_matmul_precision("highest")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device="cuda")
    toks = _train_batch()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[train] {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
        f"f32, batch {TRAIN_BATCH} x {TRAIN_SEQ}, init "
        f"{time.perf_counter() - t0:.1f} s")
    # (a) one step at fixed weights and batch: plain, kernels, faulty
    step_check, per_step = train_step_check(cfg, params, toks, ARCH,
                                            fault=True)
    profile = profile_train_step(cfg, params, toks)
    del params
    _release()
    # (b) TRAIN_STEPS steps through the launcher
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # count the training path's launches only
    t0 = time.perf_counter()
    hist = launcher.main(["--arch", ARCH, "--steps", str(TRAIN_STEPS),
                          "--batch", str(TRAIN_BATCH), "--seq",
                          str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
                          "--log-every", "1", "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, step_s, steady, tok_s = train_steps_report(
        f"{ARCH} (launcher)", hist, launches, per_step, wall, peak, smi)
    _release()
    return dict(arch=ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_STEPS, losses=losses, step_s=step_s,
                median_step_s=steady, tokens_per_s=tok_s, peak_mem_gb=peak,
                launches=launches, step_check=step_check, profile=profile)


def _param_counts(cfg, full_cfg, params):
    """(parameters of ``params``, parameters of ``full_cfg`` at full
    depth): each layer kind's count read from the module's leaves (a
    stacked leaf over its repeats), so the figure is init_params's own."""
    from repro_torch.models import layout
    head, pattern, repeats, tail = layout(cfg)
    kinds = {"head": head, "blocks": pattern, "tail": tail}
    per_layer, other = {}, 0
    for name, p in params.state_dict().items():
        sec, *rest = name.split(".")
        if sec not in kinds:
            other += p.numel()
            continue
        n = p.numel() // (repeats if sec == "blocks" else 1)
        per_layer[(sec, rest[0])] = per_layer.get((sec, rest[0]), 0) + n
    # a dense head layer (its own FFN width) counts apart from its kind
    by_kind = {}
    for (sec, i), n in per_layer.items():
        by_kind.setdefault((sec == "head", kinds[sec][int(i)]),
                           set()).add(n)
    assert all(len(v) == 1 for v in by_kind.values()), by_kind
    by_kind = {k: v.pop() for k, v in by_kind.items()}
    fh, fp, fr, ft = layout(full_cfg)
    full = other + sum(by_kind[(True, k)] for k in fh) + sum(
        by_kind[(False, k)] for k in fp * fr + ft)
    return sum(p.numel() for p in params.parameters()), full


def _frontend_emb(cfg, batch, dtype, seed):
    """Random frames (whisper) or patch embeddings (llava), (batch,
    frontend_tokens, frontend_dim), std 0.5, from a device generator; None
    for a text-only config."""
    if cfg.frontend == "none":
        return None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (torch.randn((batch, cfg.frontend_tokens, cfg.frontend_dim),
                        generator=gen, device="cuda") * 0.5).to(dtype)


def _train_data(cfg, batch, frontend):
    """The synthetic corpus at ``batch`` x TRAIN_SEQ, each batch with the
    fixed ``frontend`` embeddings where the config has a frontend."""
    from repro_torch.data.pipeline import PipelineConfig, batches
    for b in batches(PipelineConfig(batch_size=batch, seq_len=TRAIN_SEQ,
                                    vocab_size=259, seed=SEED)):
        yield b if frontend is None else dict(b, frontend=frontend)


def family_train_phase(arch, smi, lr=None):
    """[train] for ``arch`` (one of TRAIN_FAMILIES) at full width in f32,
    cut in depth where TRAIN_FAMILIES says one H100's 80 GB forces it: one
    step at fixed weights and batch through the kernels against the plain
    path (train_step_check; the planted dK/dV fault where the family has
    attention), then TRAIN_STEPS AdamW steps at ``lr`` (TRAIN_FAMILY_LR by
    default) whose loss must fall -- at full depth through the port's
    launcher, cut in depth through ``train_loop.train``, the function the
    launcher calls -- with exact launches: ``flash_attention`` 2 and
    ``flash_attention_bwd`` 1 an attention layer and step, ``moe_gemm`` and
    the scans 0 (training runs them on the plain path).  The frontend forms
    train at TRAIN_FRONTEND_BATCH rows, each with fixed random frames or
    patches, through ``train_loop.train`` (the launcher's batches carry
    none, as the reference's do); whisper's encoder and cross attention
    launch nothing (``full_attention``, plain)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import train
    torch.set_float32_matmul_precision("highest")
    lr = TRAIN_FAMILY_LR[arch] if lr is None else lr
    full = get_config(arch)
    cut = TRAIN_FAMILIES[arch]
    cfg = full.with_overrides(**cut) if cut else full
    batch = TRAIN_BATCH if cfg.frontend == "none" else TRAIN_FRONTEND_BATCH
    frontend = _frontend_emb(cfg, batch, torch.float32, SEED + 4)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device="cuda")
    n_params, n_full = _param_counts(cfg, full, params)
    n_attn = _attn_layers(cfg)
    label = arch + (f" ({cfg.num_layers} of {full.num_layers} layers)"
                    if cut else "")
    log(f"[train] {label}: cut {cut or 'none'} (layers "
        f"{cfg.num_layers}, {n_attn} through the flash kernels), d_model "
        f"{cfg.d_model}, "
        f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params f32, "
        f"{16 * n_params / 1e9:.1f} GB of weights, gradients and two Adam "
        f"moments at 16 B a parameter (full depth {n_full / 1e9:.3f} B, "
        f"{16 * n_full / 1e9:.1f} GB); batch {batch} x {TRAIN_SEQ}"
        + ("" if frontend is None else
           f" after {cfg.frontend_tokens} {cfg.frontend} embeddings")
        + f", lr {lr}; init {time.perf_counter() - t0:.1f} s")
    toks = _train_batch()[:batch]
    step_check, per_step = train_step_check(cfg, params, toks, label,
                                            fault=n_attn > 0,
                                            frontend=frontend)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    if cut or frontend is not None:
        data = _train_data(cfg, batch, frontend)
        opt = AdamWConfig(lr=lr, warmup_steps=max(TRAIN_STEPS // 10, 1),
                          total_steps=TRAIN_STEPS)
        params, _, hist = train(cfg, params, data, opt, TRAIN_STEPS,
                                log_every=1, log_fn=log,
                                kernel_backend="cuda")
        how = "train_loop.train"
    else:
        del params
        _release()
        hist = launcher.main(["--arch", arch, "--steps", str(TRAIN_STEPS),
                              "--batch", str(TRAIN_BATCH), "--seq",
                              str(TRAIN_SEQ), "--lr", str(lr),
                              "--log-every", "1", "--seed", str(SEED)])
        how = "the launcher"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, step_s, steady, tok_s = train_steps_report(
        f"{label} through {how}", hist, launches, per_step, wall, peak, smi,
        batch)
    params = None
    _release()
    return dict(arch=arch, cut=cut, layers=cfg.num_layers,
                attention_layers=n_attn, params=n_params,
                full_depth_params=n_full, lr=lr, batch=batch,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS, via=how, losses=losses,
                step_s=step_s, median_step_s=steady, tokens_per_s=tok_s,
                peak_mem_gb=peak, launches=launches, step_check=step_check)


# -- serve -------------------------------------------------------------------
def _requests(flows, late=False):
    from repro_torch.core import Priority, Request
    return [Request(id=f["id"], priority=Priority.REACTIVE if f["reactive"]
                    else Priority.PROACTIVE, prompt_len=f["tokens"].shape[1],
                    max_new_tokens=f["out"], arrival_time=f["arrival"],
                    tokens=f["tokens"])
            for f in flows if f["late"] == late]


def make_flows(cfg, n_proactive, n_out, rng, hw=None):
    """Per-flow dicts: prompts of 64-512 tokens; ``n_proactive`` proactive
    flows, then two reactive ones.  The first reactive flow arrives in the
    middle of the proactive flows' decode phase (found by a simulation-only
    run of the same scheduler on hardware profile ``hw``, the engine's
    default if None, which makes the real engine's decisions), so it lands
    inside a committed fused run; the second is submitted from an on_token
    callback during the run."""
    from repro_torch.core import INTEL_CORE_ULTRA_5_125H, AgentXPUEngine
    flows = []
    lens = rng.integers(64, 513, size=n_proactive + 2)
    for i in range(n_proactive + 2):
        reactive = i >= n_proactive
        flows.append(dict(
            id=i, arrival=0.02 * i, reactive=reactive,
            late=i == n_proactive + 1, out=n_out,
            tokens=rng.integers(0, cfg.vocab_size, (1, int(lens[i])))))
    sim = AgentXPUEngine(cfg, hw or INTEL_CORE_ULTRA_5_125H)
    sim.run_trace(_requests([f for f in flows if not f["reactive"]]))
    steps = [t for kind, _, t in sim.last_trace if kind == "decode_step"]
    flows[n_proactive]["arrival"] = steps[int(len(steps) * 0.4)]
    return flows


def _record_prefill_chunks(eng):
    """Per-flow lengths of the prompt chunks the backend prefills, in
    order.  Each chunk runs as its ``_pow2_buckets`` sub-chunks, one
    ``extend`` each.  A shared prefix the backend copied in (a prefix-cache
    hit) is recorded first, as a 1-tuple ``(hit,)``.  The list restarts
    where the row restarts: at a chunk from position 0, or at a prefix
    copy (a replay after a discarding preemption re-copies the prefix and
    prefills again from the hit)."""
    chunks = {}
    backend = eng.backend
    copy = backend._copy_prefix

    def recording(run):
        def wrapped(req, start, n):
            if start == 0:
                chunks[req.id] = []
            if n > 0:
                chunks[req.id].append(n)
            return run(req, start, n)
        return wrapped

    def copying(req, hit):
        done = copy(req, hit)
        if done > 0:
            chunks[req.id] = [(done,)]
        return done

    # in-pool prefill, the scratch-cache baseline's, a staged prefill's:
    # each extends a B=1 view or cache in these chunks
    for name in ("_run_bucketed_in_pool", "_run_bucketed", "_run_staged"):
        if hasattr(backend, name):
            setattr(backend, name, recording(getattr(backend, name)))
    backend._copy_prefix = copying
    return chunks


# the scans and the axis of their first argument that holds the tokens
SCANS = {"rglru_scan": 1, "rwkv6_scan": 2}


def _tally_scans(ops, calls):
    """Wrap the scans' wrappers so each call adds one to ``calls[name]``'s
    "prefill" (more than one token) or "decode" count.  Returns the real
    wrappers, to put back."""
    real = {n: getattr(ops, n) for n in SCANS}
    for name, axis in SCANS.items():
        tally = calls.setdefault(name, {"prefill": 0, "decode": 0})

        def wrapped(x, *args, _real=real[name], _tally=tally, _axis=axis,
                    **kw):
            _tally["decode" if x.shape[_axis] == 1 else "prefill"] += 1
            return _real(x, *args, **kw)
        setattr(ops, name, wrapped)
    return real


def serve(cfg, params, flows, *, device, dtype, kv_dtype="bf16",
          inject_after=40, scan_calls=None, on_engine=None, **engine_kw):
    """Serve ``flows`` through the port's engine (its defaults, the prefix
    cache on among them, unless ``engine_kw`` says otherwise).  Returns
    (engine, metrics, wall seconds, per-flow wall TTFT seconds, launches
    during the run, per-flow prefill chunk lengths); with a ``scan_calls``
    dict, also fills it with each scan's prefill and decode calls during
    the run.  ``on_engine(engine)`` is called before anything is
    submitted."""
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.kernels import ops
    eng = RealAgentXPUEngine(cfg, params, max_len=MAX_LEN, dtype=dtype,
                             device=device, pool_slots=POOL,
                             kv_dtype=kv_dtype, **engine_kw)
    chunks = _record_prefill_chunks(eng)
    if on_engine is not None:
        on_engine(eng)
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
    real = None if scan_calls is None else _tally_scans(ops, scan_calls)
    t0 = time.perf_counter()
    for f in flows:
        if not f["late"]:
            t_sub[f["id"]] = t0
    try:
        metrics = eng.run()
        _sync(device)
    finally:
        for name, fn in (real or {}).items():
            setattr(ops, name, fn)
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


def forward_launches(cfg):
    """Kernel launches one forward call of ``cfg`` makes on the kernel path
    (``attention``: decode or pool, by the call's token count; none for
    MLA, which has no kernel), three expert GEMMs in each MoE layer (every
    layer of an MoE config past its dense head layers)."""
    from repro_torch.models import layout
    head, pattern, repeats, tail = layout(cfg)
    kinds = list(head) + list(pattern) * repeats + list(tail)
    n_attn = kinds.count("attn")
    return {"attention": 0 if cfg.use_mla else n_attn,
            "moe_gemm": 3 * (len(kinds) - len(head)) if cfg.is_moe else 0,
            "rglru_scan": kinds.count("rglru"),
            "rwkv6_scan": kinds.count("rwkv6")}


def check_serve(cfg, eng, metrics, flows, launches, label, need_abort=True,
                fused=True):
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
    # per forward call: one attention launch (decode or pool) per attention
    # layer, three expert GEMMs per MoE layer, one scan per recurrent layer
    per_call = forward_launches(cfg)
    got = dict(launches, attention=launches["decode_attention"]
               + launches["flash_attention_pool"])
    forwards = {got[k] / n for k, n in per_call.items() if n}
    if len(forwards) != 1 or any(got[k] for k, n in per_call.items()
                                 if not n):
        raise AssertionError(
            f"[{label}] launches {launches} are not {per_call} per forward "
            f"call")
    if fused and not st["host_syncs"] < decode_tokens:
        raise AssertionError(f"[{label}] host_syncs {st['host_syncs']} >= "
                             f"{decode_tokens} decode tokens")
    if need_abort and st["aborted_runs"] < 1:
        raise AssertionError(f"[{label}] no fused run was aborted")
    log(f"[prefix] {label}: {st['prefix_hits']} hit prefills, "
        f"{st['prefix_hit_tokens']} prompt tokens copied, "
        f"{st['prefix_fallbacks']} fallbacks, {st['kv_bytes_prefix_copied']} "
        f"KV bytes copied, {st['prefill_forward_tokens']} forward tokens")
    return st, decode_tokens


def _teacher_forced(cfg, params, f, served, chunks, *, dtype, kv_dtype,
                    backend):
    """Yield the logits that score each served token of flow ``f``: its
    prompt through ``extend`` in ``chunks`` (each as its pow-2
    sub-chunks, as the engine runs them, and a copied prefix ``(hit,)`` as
    one call over its tokens; None: one call), then its served tokens one
    at a time."""
    from repro_torch.core.backend import _pow2_buckets
    from repro_torch.models import extend, init_cache
    cache = init_cache(cfg, params, 1, MAX_LEN, dtype, kv_dtype=kv_dtype)
    device = cache["pos"].device
    toks = torch.from_numpy(np.asarray(f["tokens"], np.int64)).to(device)
    sizes = [toks.shape[1]] if chunks is None else \
        [b for n in chunks for b in
         (n if isinstance(n, tuple) else _pow2_buckets(n))]
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
    return seen[-(forward_launches(cfg)["moe_gemm"] // 3):]


def plain_check(cfg, params, eng, flows, chunks, *, dtype, kv_dtype=None,
                gate=True, tops=None):
    """Teacher-forced plain path on the card: each flow's prompt in the
    engine's own prefill ``chunks`` (MoE capacity depends on a call's token
    count; recurrent states cross the same chunk boundaries), then its
    served tokens one at a time, through ``extend`` with
    ``kernel_backend="plain"``; every served token must be the plain argmax
    or within LOGIT_MARGIN of it (``gate``; otherwise the gaps are only
    measured).  For MoE, a token outside the margin is first traced to a
    routing flip or not.  A ``tops`` dict is filled with the plain argmax
    of each scored position, keyed (flow id, token index).  Returns (exact
    matches, tokens, largest gap)."""
    exact = total = 0
    worst, at = 0.0, None
    for f in flows:
        served = eng.output_tokens(f["id"])
        fc = chunks[f["id"]]
        steps = _teacher_forced(cfg, params, f, served, fc, dtype=dtype,
                                kv_dtype=kv_dtype, backend="plain")
        for i, (t, logits) in enumerate(zip(served, steps)):
            lg = logits[0].float()
            gap = (lg.max() - lg[t]).item()
            if tops is not None:
                tops[(f["id"], i)] = int(lg.argmax())
            exact += int(gap == 0.0)
            total += 1
            if gap > worst:
                worst, at = gap, (f, served, fc, i)
            if gate and gap > LOGIT_MARGIN:
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


def plain_disagreement(cfg, params, params32, eng, flows, chunks, tops=None):
    """The plain path against itself, teacher-forced on each flow's served
    tokens: with the prompt in the engine's chunks (bf16) as the first
    evaluation (or its argmaxes ``tops``, as ``plain_check`` fills them),
    and as the second the prompt in one call (bf16: the same function, only
    the rounding differs, and for MoE the capacity a call's token count
    sets) or the same chunks in f32 (``params32``, weights from the same
    seed; None skips it).  Returns the largest gap of the first's argmax
    under each second's logits: (bf16 noise floor, bf16 vs f32 or None)."""
    floor, vs_f32 = 0.0, None if params32 is None else 0.0
    for f in flows:
        served, fc = eng.output_tokens(f["id"]), chunks[f["id"]]
        kw = dict(kv_dtype=None, backend="plain")
        a = [None] * len(served) if tops is not None else _teacher_forced(
            cfg, params, f, served, fc, dtype=torch.bfloat16, **kw)
        b = _teacher_forced(cfg, params, f, served, None,
                            dtype=torch.bfloat16, **kw)
        c = [None] * len(served) if params32 is None else _teacher_forced(
            cfg, params32, f, served, fc, dtype=torch.float32, **kw)
        for i, (la, lb, lc) in enumerate(zip(a, b, c)):
            top = tops[(f["id"], i)] if la is None else \
                la[0].float().argmax()
            lb = lb[0].float()
            floor = max(floor, (lb.max() - lb[top]).item())
            if lc is not None:
                lc = lc[0].float()
                vs_f32 = max(vs_f32, (lc.max() - lc[top]).item())
    return floor, vs_f32


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
    heads = (f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim}"
             if cfg.num_heads else
             f"WKV heads {cfg.d_model // cfg.ssm_head_dim} of "
             f"{cfg.ssm_head_dim}")
    if cfg.use_mla:
        heads = (f"MLA heads {cfg.num_heads}, latent {cfg.kv_lora_rank}, "
                 f"qk {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim} rope, "
                 f"v {cfg.v_head_dim}; {cfg.first_k_dense_layers} dense head "
                 f"layer(s) of d_ff {cfg.dense_d_ff}")
    if cfg.layer_pattern:
        heads += (f" window {cfg.sliding_window}, pattern "
                  f"{cfg.layer_pattern} x {cfg.pattern_repeats} + "
                  f"{cfg.tail_pattern}, lru_width {cfg.lru_width}")
    log(f"[serve] {arch}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{heads}{moe} vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
        f"bf16, random (seed {SEED}), init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def bf16_serve(cfg, params):
    """The 8-flow bf16 serve of ``cfg``: checked, held against the plain
    path.  Returns its stats."""
    label = f"{cfg.name} bf16"
    rng = np.random.default_rng(SEED)
    flows = make_flows(cfg, 6, OUT_TOKENS, rng)
    torch.cuda.reset_peak_memory_stats()
    calls = {}
    eng, metrics, wall, ttft, launches, chunks = serve(
        cfg, params, flows, device="cuda", dtype=torch.bfloat16,
        scan_calls=calls)
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
        scan_calls={k: v for k, v in calls.items() if launches[k]},
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
        f"{st['aborted_runs']}, launches {launches}"
        + (f" (scan calls {serve_stats['scan_calls']})"
           if serve_stats["scan_calls"] else "")
        + f", peak memory {serve_stats['peak_mem_gb']:.2f} GB")
    log(f"[serve] {label}: mid-run reactive TTFT {ttft[late_id]:.3f} s wall; "
        f"first token from run start (wall s): "
        + json.dumps(serve_stats["first_token_from_start_wall_s"])
        + "; scheduler-clock TTFT (sim s): "
        + json.dumps(serve_stats["ttft_sim_s"]))
    gate = cfg.name not in F32_TOKEN_CHECK
    tops = None if gate else {}
    t0 = time.perf_counter()
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.bfloat16, gate=gate,
                                      tops=tops)
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN}"
        + ("" if gate else ", not held to it in bf16: see below")
        + f"), {time.perf_counter() - t0:.1f} s; prefill replayed in the "
        f"engine's chunks {chunks}")
    serve_stats.update(plain_exact=exact, plain_total=total,
                       plain_worst_gap=worst, plain_gated=gate)
    if not gate:
        serve_stats.update(bf16_gate(cfg, params, eng, flows, chunks, worst,
                                     tops))
    del eng
    _release()
    return serve_stats


def _wkv_skip_in_prefill(args):
    """One token's update skipped in every prefill chunk (decode steps
    untouched): a kernel that drops a step inside a chunk."""
    return rwkv6_skip(args) if args[0].shape[2] > 1 else args


def _wkv_drop_state(args):
    """state0 zeroed in every call: a kernel that ignores the state it is
    handed, so no call sees the tokens of an earlier one."""
    return args[:5] + (torch.zeros_like(args[5]),)


# WKV faults planted in a bf16 serve of an F32_TOKEN_CHECK family, each of
# which the gate must catch: (name, fault of the kernel's inputs)
WKV_FAULTS = [("one token's update skipped in every prefill chunk",
               _wkv_skip_in_prefill),
              ("state0 zeroed in every call", _wkv_drop_state)]


def faulty_serve_gap(cfg, params, flows, plant):
    """The bf16 serve of ``flows`` with every ``rwkv6_scan`` launch given
    ``plant``'s faulty inputs; returns the largest gap of its served tokens
    under the plain path (prompt in the engine's chunks)."""
    from repro_torch.kernels import ops
    real = ops.rwkv6_scan

    def faulty(r, k, v, w_log, u, state0=None):
        return real(*plant((r, k, v, w_log, u, state0)))

    ops.rwkv6_scan = faulty
    try:
        eng, _, _, _, launches, chunks = serve(
            cfg, params, flows, device="cuda", dtype=torch.bfloat16)
    finally:
        ops.rwkv6_scan = real
    if not launches["rwkv6_scan"]:
        raise AssertionError("the faulty serve launched no rwkv6_scan")
    _, _, worst = plain_check(cfg, params, eng, flows, chunks,
                              dtype=torch.bfloat16, gate=False)
    del eng
    _release()
    return worst


def bf16_gate(cfg, params, eng, flows, chunks, worst, tops):
    """The bf16 gate of an F32_TOKEN_CHECK family: the kernel path's
    largest gap must be within the plain path's own noise floor (the prompt
    in the engine's chunks vs in one call) plus LOGIT_MARGIN.  A second
    witness of the ill-conditioning is measured (the plain path in bf16
    against the plain path in f32 on the same tokens) where the f32 weights
    fit beside the bf16 ones (not deepseek-v2-lite's 63 GB beside 31), and
    for rwkv6 the gate's power: serves with a planted WKV fault
    (WKV_FAULTS), whose largest gap must exceed what the gate accepts (the
    expert GEMM's planted faults are the kernel cases')."""
    from repro_torch.models import init_params
    label = f"{cfg.name} bf16"
    params32 = None if cfg.name == DS_ARCH else init_params(
        cfg, seed=SEED, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    floor, vs_f32 = plain_disagreement(cfg, params, params32, eng, flows,
                                       chunks, tops)
    del params32
    _release()
    limit = floor + LOGIT_MARGIN
    log(f"[check] {label}: the plain path against itself lands {floor:.4f} "
        f"apart at its largest gap (prompt in the engine's chunks vs in one "
        f"call), and "
        + ("(not measured)" if vs_f32 is None else f"{vs_f32:.4f}")
        + f" apart in bf16 vs f32 (the same chunks); the kernel path's "
        f"{worst:.4f} must be within {floor:.4f} plus the margin "
        f"({limit:.4f}); {time.perf_counter() - t0:.1f} s")
    if worst > limit:
        raise AssertionError(
            f"[{label}] the kernel path's largest gap {worst:.4f} exceeds "
            f"the plain path's own {floor:.4f} plus the margin "
            f"{LOGIT_MARGIN}")
    if cfg.name != RWKV_ARCH:
        return dict(plain_noise_floor_gap=floor, plain_bf16_vs_f32_gap=vs_f32)
    faults = {}
    for name, plant in WKV_FAULTS:
        t0 = time.perf_counter()
        faults[name] = gap = faulty_serve_gap(cfg, params, flows, plant)
        log(f"[check] {label} with a planted WKV fault ({name}): largest "
            f"gap {gap:.4f}, {gap / limit:.2f} x the gate's {limit:.4f}: "
            + ("caught" if gap > limit else "NOT caught")
            + f", {time.perf_counter() - t0:.1f} s")
    missed = [n for n, gap in faults.items() if not gap > limit]
    if missed:
        raise AssertionError(f"[{label}] the bf16 gate {limit:.4f} would "
                             f"not catch {missed}: {faults}")
    return dict(plain_noise_floor_gap=floor, plain_bf16_vs_f32_gap=vs_f32,
                planted_fault_gaps=faults)


# -- the serving modules: prefix cache, fault seam, front end, launcher --------
# [prefix]: a shared system prompt of PREFIX_SYSTEM tokens before each flow's
# 64-512-token tail
PREFIX_SYSTEM = 512


def prefix_flows(cfg, rng):
    """8 flows (6 proactive, 2 reactive) shaped like make_flows, each
    prompt a shared PREFIX_SYSTEM-token system prompt (drawn once) and a
    64-512-token tail, none submitted mid-run.  Flow 0 arrives at 0; the
    others after its prefill ends on the scheduler's clock (a
    simulation-only run of flow 0 finds the instant), so every later flow
    can hit the prefix flow 0 donates.  Returns the flows and the
    prediction of a simulation-only run of them with the prefix cache on:
    the port's ``AgentXPUEngine`` with ``SimBackend(prefix_cache=True,
    max_len=MAX_LEN)``, which makes the real engine's decisions."""
    from repro_torch.core import AgentXPUEngine
    from repro_torch.core.backend import SimBackend
    system = rng.integers(0, cfg.vocab_size, (1, PREFIX_SYSTEM))
    lens = rng.integers(64, 513, size=8)
    flows = [dict(id=i, arrival=0.0, reactive=i >= 6, late=False,
                  out=OUT_TOKENS, tokens=np.concatenate(
                      [system, rng.integers(0, cfg.vocab_size,
                                            (1, int(lens[i])))], axis=1))
             for i in range(8)]
    first = AgentXPUEngine(cfg).run_trace(_requests(flows[:1])).completed[0]
    for f in flows[1:]:
        f["arrival"] = first.ttft + 0.02 * f["id"]
    sim = AgentXPUEngine(cfg)
    sim.backend = SimBackend(prefix_cache=True, max_len=MAX_LEN)
    sim.run_trace(_requests(flows))
    st = sim.backend.stats()
    return flows, {k: st[k] for k in ("prefix_hits", "prefix_hit_tokens")}


def _free_at_exit(eng, label):
    st = eng.stats()
    problems = eng.backend.validate()
    if problems or st["free_slots"] != st["pool_slots"]:
        raise AssertionError(f"[{label}] {st['free_slots']}/"
                             f"{st['pool_slots']} slots free at exit, "
                             f"validate(): {problems}")


def prefix_phase(cfg, params):
    """[prefix]: the shared-prefix trace served cold (``prefix_cache=False``)
    and then hot (the default, prefix cache on; second, so that any
    first-run cost of its shapes falls on the cold serve, though the serves
    before this phase ran such shapes already).  The hot serve's hits
    must equal the simulation's prediction (every flow after the first),
    with no fallback, its forward tokens the cold serve's minus the hit
    tokens, every token within LOGIT_MARGIN of the plain path, and every
    slot free at exit.  Prints each flow's wall TTFT hot and cold and the
    token agreement of the two serves (not gated: bf16 rounds a copied
    prefix's tail differently from a cold chunking)."""
    label = f"{cfg.name} prefix"
    flows, want = prefix_flows(cfg, np.random.default_rng(SEED + 2))
    if want["prefix_hits"] != len(flows) - 1:
        raise AssertionError(f"[{label}] the simulation predicts "
                             f"{want['prefix_hits']} hits, not one for "
                             f"every flow after the first")
    log(f"[prefix] {label}: {len(flows)} flows, a {PREFIX_SYSTEM}-token "
        f"system prompt + tails of "
        f"{[f['tokens'].shape[1] - PREFIX_SYSTEM for f in flows]} tokens, "
        f"simulation predicts {want}")
    runs = {}
    for hot in (False, True):
        runs[hot] = serve(cfg, params, flows, device="cuda",
                          dtype=torch.bfloat16, prefix_cache=hot)
        eng, metrics, wall, ttft, launches, chunks = runs[hot]
        check_serve(cfg, eng, metrics, flows, launches,
                    label + ("" if hot else " cold"), need_abort=False)
        _free_at_exit(eng, label)
    (eng, m, wall, ttft, launches, chunks), cold = runs[True], runs[False]
    st, st_cold = eng.stats(), cold[0].stats()
    got = {k: st[k] for k in want}
    if got != want or st["prefix_fallbacks"]:
        raise AssertionError(f"[{label}] hits {got} (simulation {want}), "
                             f"{st['prefix_fallbacks']} fallbacks")
    if st["prefill_forward_tokens"] != st_cold["prefill_forward_tokens"] \
            - st["prefix_hit_tokens"]:
        raise AssertionError(
            f"[{label}] {st['prefill_forward_tokens']} forward tokens, not "
            f"the cold serve's {st_cold['prefill_forward_tokens']} minus "
            f"{st['prefix_hit_tokens']} hit tokens")
    t0 = time.perf_counter()
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.bfloat16)
    agree = sum(a == b for f in flows for a, b in zip(
        eng.output_tokens(f["id"]), cold[0].output_tokens(f["id"])))
    hit_ids = [f["id"] for f in flows[1:]]
    ttft_hot = [ttft[i] for i in hit_ids]
    ttft_cold = [cold[3][i] for i in hit_ids]
    log(f"[prefix] {label}: hot {wall:.3f} s wall, cold {cold[2]:.3f} s; "
        f"hits {got['prefix_hits']} ({got['prefix_hit_tokens']} tokens, "
        f"{st['kv_bytes_prefix_copied']} KV bytes in "
        f"{st['prefix_copy_device_calls']} copies), forward tokens "
        f"{st['prefill_forward_tokens']} hot / "
        f"{st_cold['prefill_forward_tokens']} cold; wall TTFT from run "
        f"start by flow (s), hot "
        + json.dumps({i: round(ttft[i], 4) for i in sorted(ttft)})
        + " cold "
        + json.dumps({i: round(cold[3][i], 4) for i in sorted(cold[3])})
        + f"; hit flows' mean {np.mean(ttft_hot):.4f} hot / "
        f"{np.mean(ttft_cold):.4f} cold; tokens equal to the cold serve's "
        f"{agree}/{total}")
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN}), {time.perf_counter() - t0:.1f} s; "
        f"prefill replayed as {chunks}")
    out = dict(flows=len(flows), wall_s=wall, cold_wall_s=cold[2],
               launches=launches, cold_launches=cold[4],
               hit_ttft_wall_s=ttft_hot, cold_ttft_wall_s=ttft_cold,
               hit_ttft_mean_s=float(np.mean(ttft_hot)),
               cold_ttft_mean_s=float(np.mean(ttft_cold)),
               tokens_equal_to_cold=agree, plain_exact=exact,
               plain_total=total, plain_worst_gap=worst,
               **{k: st[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                     "prefix_fallbacks",
                                     "kv_bytes_prefix_copied",
                                     "prefix_copy_device_calls",
                                     "prefill_forward_tokens")},
               cold_prefill_forward_tokens=st_cold["prefill_forward_tokens"])
    del eng, cold, runs
    _release()
    return out


# the snapshot store's serve: flows sharing the system prompt one after
# another through a pool capped at 3 slots, each hit pasted from a promoted
# snapshot.  Store rows count toward the cap when a flow arrives (live rows
# plus store entries), which the simulation's SimBackend does not model: at
# a cap of 2 the fourth flow's arrival evicts the unpinned prefixes and
# misses the hit the simulation predicts, so the cap leaves room for the two
# entries that flow finds
PREFIX_STORE_FLOWS, PREFIX_STORE_OUT, PREFIX_STORE_SLOTS = 4, 16, 3


def prefix_store_flows(cfg, rng):
    """PREFIX_STORE_FLOWS proactive flows, each prompt a shared
    PREFIX_SYSTEM-token system prompt (drawn once) and a 64-512-token tail,
    arriving one after another: each after the one before completes on the
    scheduler's clock, as a simulation-only run of the earlier flows with
    the prefix cache off (the slower serve) and the pool capped at
    PREFIX_STORE_SLOTS finds it.  Each flow after the first binds the
    lowest free slot, the one the flow before it held and donated its
    prefix from, so the donor is promoted to the snapshot store first and
    the hit is pasted from there.
    Returns the flows and the prediction of a simulation-only run of them
    with the prefix cache on (``SimBackend(prefix_cache=True,
    max_len=MAX_LEN)``, which makes the real engine's decisions)."""
    from repro_torch.core import AgentXPUEngine
    from repro_torch.core.backend import SimBackend

    def sim(flows, hot):
        eng = AgentXPUEngine(cfg, pool_slots_max=PREFIX_STORE_SLOTS)
        eng.backend = SimBackend(prefix_cache=hot, max_len=MAX_LEN)
        return eng, eng.run_trace(_requests(flows))
    system = rng.integers(0, cfg.vocab_size, (1, PREFIX_SYSTEM))
    lens = rng.integers(64, 513, size=PREFIX_STORE_FLOWS)
    flows = [dict(id=i, arrival=0.0, reactive=False, late=False,
                  out=PREFIX_STORE_OUT, tokens=np.concatenate(
                      [system, rng.integers(0, cfg.vocab_size,
                                            (1, int(lens[i])))], axis=1))
             for i in range(PREFIX_STORE_FLOWS)]
    for k in range(1, len(flows)):
        _, m = sim(flows[:k], hot=False)
        flows[k]["arrival"] = max(r.finish_t for r in m.completed) + 0.01
    eng, _ = sim(flows, hot=True)
    st = eng.backend.stats()
    return flows, {k: st[k] for k in ("prefix_hits", "prefix_hit_tokens")}


def prefix_store_phase(cfg, params):
    """[prefix] snapshot store: the flows of prefix_store_flows served hot
    and cold with ``pool_slots_max=PREFIX_STORE_SLOTS``.  The hot serve
    must promote its donors (``prefix_promotions`` >= 1: ``_promote_donor``
    snapshots the rebound row, and ``kvcache.paste_prefix`` serves each hit
    from the store), its hits must equal the simulation's prediction with
    no fallback, its forward tokens the cold serve's minus the hit tokens,
    every token within LOGIT_MARGIN of the plain path (which replays each
    pasted prefix as one ``extend``), and every slot must be free at exit
    in both serves."""
    label = f"{cfg.name} prefix store"
    flows, want = prefix_store_flows(cfg, np.random.default_rng(SEED + 3))
    if want["prefix_hits"] != len(flows) - 1:
        raise AssertionError(f"[{label}] the simulation predicts "
                             f"{want['prefix_hits']} hits, not one for "
                             f"every flow after the first")
    log(f"[prefix] {label}: {len(flows)} flows one after another (arrivals "
        f"{[round(f['arrival'], 4) for f in flows]} s on the scheduler's "
        f"clock) through a {PREFIX_STORE_SLOTS}-slot pool, a "
        f"{PREFIX_SYSTEM}-token system prompt + tails of "
        f"{[f['tokens'].shape[1] - PREFIX_SYSTEM for f in flows]} tokens, "
        f"simulation predicts {want}")
    runs = {}
    for hot in (False, True):
        runs[hot] = serve(cfg, params, flows, device="cuda",
                          dtype=torch.bfloat16, prefix_cache=hot,
                          pool_slots_max=PREFIX_STORE_SLOTS)
        eng, metrics, wall, ttft, launches, chunks = runs[hot]
        check_serve(cfg, eng, metrics, flows, launches,
                    label + ("" if hot else " cold"), need_abort=False)
        _free_at_exit(eng, label)
    (eng, m, wall, ttft, launches, chunks), cold = runs[True], runs[False]
    st, st_cold = eng.stats(), cold[0].stats()
    got = {k: st[k] for k in want}
    if got != want or st["prefix_fallbacks"]:
        raise AssertionError(f"[{label}] hits {got} (simulation {want}), "
                             f"{st['prefix_fallbacks']} fallbacks")
    if not st["prefix_promotions"] >= 1:
        raise AssertionError(f"[{label}] no donor was promoted to the "
                             f"snapshot store: {st['prefix_promotions']}")
    if st["prefill_forward_tokens"] != st_cold["prefill_forward_tokens"] \
            - st["prefix_hit_tokens"]:
        raise AssertionError(
            f"[{label}] {st['prefill_forward_tokens']} forward tokens, not "
            f"the cold serve's {st_cold['prefill_forward_tokens']} minus "
            f"{st['prefix_hit_tokens']} hit tokens")
    t0 = time.perf_counter()
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.bfloat16)
    log(f"[prefix] {label}: hot {wall:.3f} s wall, cold {cold[2]:.3f} s; "
        f"{st['pool_slots']} pool slots; hits {got['prefix_hits']} "
        f"({got['prefix_hit_tokens']} tokens), {st['prefix_promotions']} "
        f"donors promoted, {st['prefix_store_entries']} store entries at "
        f"exit, {st['kv_bytes_prefix_copied']} KV bytes in "
        f"{st['prefix_copy_device_calls']} pastes, forward tokens "
        f"{st['prefill_forward_tokens']} hot / "
        f"{st_cold['prefill_forward_tokens']} cold; launches {launches}")
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN}), {time.perf_counter() - t0:.1f} s; "
        f"prefill replayed as {chunks}")
    out = dict(flows=len(flows), wall_s=wall, cold_wall_s=cold[2],
               launches=launches, cold_launches=cold[4], plain_exact=exact,
               plain_total=total, plain_worst_gap=worst,
               **{k: st[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                     "prefix_fallbacks", "prefix_promotions",
                                     "prefix_store_entries",
                                     "kv_bytes_prefix_copied",
                                     "prefix_copy_device_calls",
                                     "prefill_forward_tokens")},
               cold_prefill_forward_tokens=st_cold["prefill_forward_tokens"])
    del eng, cold, runs
    _release()
    return out


def faults_phase(cfg, params):
    """[faults]: 4 flows with a transient device fault at every fifth
    decode check (the reference's ``faulty`` mode of the reactive
    benchmark): every flow completes, its tokens within LOGIT_MARGIN of the
    plain path, with retries counted, no flow quarantined and every slot
    free at exit."""
    from repro_torch.core.faults import Fault, FaultInjector
    label = f"{cfg.name} faults"
    flows = make_flows(cfg, 2, OUT_TOKENS, np.random.default_rng(SEED + 3))
    faults = FaultInjector([Fault(site="device", stage="decode", nth=1,
                                  period=5)])
    eng, metrics, wall, _, launches, chunks = serve(
        cfg, params, flows, device="cuda", dtype=torch.bfloat16,
        inject_after=12, faults=faults)
    st, _ = check_serve(cfg, eng, metrics, flows, launches, label,
                        need_abort=False)
    _free_at_exit(eng, label)
    if not st["device_fault_retries"] or st["quarantined_flows"]:
        raise AssertionError(f"[{label}] {st['device_fault_retries']} "
                             f"retries, {st['quarantined_flows']} flows "
                             f"quarantined")
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.bfloat16)
    log(f"[faults] {label}: {len(metrics.completed)}/{len(flows)} flows "
        f"completed in {wall:.3f} s wall, {st['device_fault_retries']} "
        f"transient device retries ({st['faults_fired']} of "
        f"{st['fault_checks']} checks fired), {st['quarantined_flows']} "
        f"quarantined; vs plain path {exact}/{total} exact, largest gap "
        f"{worst:.4f}")
    out = dict(flows=len(flows), wall_s=wall, launches=launches,
               plain_exact=exact, plain_total=total, plain_worst_gap=worst,
               **{k: st[k] for k in ("device_fault_retries", "faults_fired",
                                     "fault_checks", "quarantined_flows")})
    del eng
    _release()
    return out


def frontend_phase(cfg, params):
    """[frontend]: ``ServingFrontend`` over a full-width engine, 4 flows
    submitted from two threads (one reactive); flow 1 is cancelled by its
    consumer after its 4th token.  Every handle must reach its terminal
    status (``cancelled`` for flow 1, ``completed`` with OUT_TOKENS tokens
    for the rest), the completed flows' tokens within LOGIT_MARGIN of the
    plain path, and after ``drain()`` every slot free."""
    import threading
    from repro_torch.core import Priority
    from repro_torch.core.engine import RealAgentXPUEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.frontend import ServingFrontend
    label = f"{cfg.name} frontend"
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(64, 513, size=4)
    flows = [dict(id=i, out=OUT_TOKENS * (3 if i == 1 else 1),
                  reactive=i == 3, tokens=rng.integers(
                      0, cfg.vocab_size, (1, int(lens[i]))))
             for i in range(4)]
    eng = RealAgentXPUEngine(cfg, params, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda",
                             pool_slots=POOL)
    chunks = _record_prefill_chunks(eng)
    handles, results = {}, {}
    fe = ServingFrontend(eng)

    def client(mine):
        for f in mine:
            handles[f["id"]] = fe.submit(
                f["tokens"], flow_id=f["id"], max_new_tokens=f["out"],
                priority=Priority.REACTIVE if f["reactive"]
                else Priority.PROACTIVE)
        for f in mine:
            h = handles[f["id"]]
            if f["id"] == 1:
                for _ in range(4):
                    h.next_token(timeout=600)
                h.cancel()
            results[f["id"]] = h.result(timeout=600)

    _sync("cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    fe.start()
    threads = [threading.Thread(target=client, args=(flows[i::2],))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    fe.drain(timeout=600)
    fe.close(timeout=600)
    _sync("cuda")
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    status = {i: r["status"] for i, r in sorted(results.items())}
    want = {0: "completed", 1: "cancelled", 2: "completed", 3: "completed"}
    if status != want or any(results[i]["n_tokens"] != OUT_TOKENS
                             for i in (0, 2, 3)):
        raise AssertionError(f"[{label}] statuses {status}, tokens "
                             f"{ {i: r['n_tokens'] for i, r in results.items()} }")
    if not all(launches[k] for k in PATH_KERNELS[cfg.name]):
        raise AssertionError(f"[{label}] a kernel of "
                             f"{PATH_KERNELS[cfg.name]} never launched: "
                             f"{launches}")
    _free_at_exit(eng, label)
    done = [f for f in flows if f["id"] != 1]
    exact, total, worst = plain_check(cfg, params, eng, done, chunks,
                                      dtype=torch.bfloat16)
    ttft = {i: r["token_walls"][0] - r["submit_wall"]
            for i, r in sorted(results.items())}
    st = fe.stats()
    log(f"[frontend] {label}: statuses {status}, tokens "
        f"{ {i: r['n_tokens'] for i, r in sorted(results.items())} } in "
        f"{wall:.3f} s wall, {st['runs']} engine runs, cancelled flows "
        f"{st['cancelled_flows']}; wall TTFT from submit by flow (s) "
        + json.dumps({i: round(t, 4) for i, t in ttft.items()})
        + f"; vs plain path {exact}/{total} exact, largest gap {worst:.4f}; "
        f"launches {launches}")
    out = dict(flows=len(flows), wall_s=wall, launches=launches,
               statuses=status, ttft_wall_s=ttft, plain_exact=exact,
               plain_total=total, plain_worst_gap=worst)
    del eng, fe
    _release()
    return out


def launcher_phase():
    """[launcher]: ``python -m repro_torch.launch.serve --real --horizon 30
    --json`` on the card (the tiny config, as the reference's ``--real``):
    it must exit 0 with every request of the trace completed and prefix
    hits in its summary."""
    from repro_torch.core import WorkloadConfig, generate_workload
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--real",
         "--horizon", "30", "--json"], capture_output=True, text=True,
        env=env, cwd=root, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"[launcher] exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    summ = json.loads(out.stdout)
    n = len(generate_workload(WorkloadConfig(proactive_rate=0.5,
                                             horizon=30.0)))
    bad = {k: summ[k] for k in ("n_failed", "n_timed_out", "n_rejected",
                                "n_cancelled") if summ[k]}
    if summ["n_completed"] != n or bad or not summ["prefix_hit_tokens"] > 0:
        raise AssertionError(f"[launcher] {summ['n_completed']}/{n} "
                             f"completed, {bad}, prefix_hit_tokens "
                             f"{summ['prefix_hit_tokens']}")
    log(f"[launcher] repro_torch.launch.serve --real --horizon 30: exit 0 "
        f"in {wall:.1f} s wall (process included), {summ['n_completed']}/{n}"
        f" requests completed, prefix_hit_tokens "
        f"{summ['prefix_hit_tokens']} (hit rate "
        f"{summ['prefix_hit_rate']:.4f})")
    return dict(wall_s=wall, requests=n, **summ)


# the examples over the port, each run as a user runs it, at tiny size with
# few steps: (file, arguments); all four at once, each its own process
EXAMPLE_RUNS = [
    ("quickstart_torch", ["--steps", "40", "--batch", "4", "--seq", "96"]),
    ("serve_agentic_torch", []),
    ("mixed_workload_demo_torch", []),
    ("train_tiny_torch", ["--arch", MOE_ARCH, "--steps", "5",
                          "--log-every", "1"])]


def _report_ints(out, label):
    """The integers of the report line that starts with ``label``."""
    import re
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return [int(x) for x in re.findall(r"(?<![\d.])\d+(?![\d.])", line)]


def examples_phase():
    """[examples]: the four ``examples/*_torch.py`` files on the card, each
    a subprocess with its defaults (``--device cuda``, ``--kernel-backend
    cuda``) at tiny size; each must exit 0.  ``serve_agentic_torch``'s
    fused default must keep its decode device calls and host syncs below
    its decode tokens, with every slot free at exit; ``train_tiny_torch``
    writes its checkpoint to a temporary directory."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, ends, files = {}, {}, []
        try:
            for name, args in EXAMPLE_RUNS:
                if name == "train_tiny_torch":
                    args = args + ["--ckpt-dir", os.path.join(tmp, "ck")]
                files += [open(os.path.join(tmp, name + ext), "w")
                          for ext in (".out", ".err")]
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.join("examples", f"{name}.py"),
                     *args], stdout=files[-2], stderr=files[-1], env=env,
                    cwd=root)
            while len(ends) < len(procs):
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"[examples] still running after "
                                         f"300 s: {set(procs) - set(ends)}")
                for name, proc in procs.items():
                    if name not in ends and proc.poll() is not None:
                        ends[name] = time.perf_counter() - t0
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
            for f in files:
                f.close()
        outs = {}
        for name, proc in procs.items():
            with open(os.path.join(tmp, name + ".out")) as f_out, \
                    open(os.path.join(tmp, name + ".err")) as f_err:
                outs[name] = (proc.returncode, f_out.read(), f_err.read(),
                              ends[name])
    stats = {}
    for name, (rc, out, err, wall) in outs.items():
        last = [ln for ln in out.splitlines() if ln.strip()][-1:]
        log(f"[examples] {name}: exit {rc} after {wall:.1f} s; last line "
            f"{last}")
        if rc != 0:
            raise AssertionError(f"[examples] {name} exit {rc}: "
                                 f"{err[-2000:]}")
        stats[name] = dict(exit=rc, wall_s=wall)
    out = outs["serve_agentic_torch"][1]
    calls, tokens, slots = _report_ints(out, "decode device calls")
    syncs = _report_ints(out, "host syncs")[0]
    retired = _report_ints(out, "retired")
    log("[examples] serve_agentic_torch report: " + "; ".join(
        ln.strip() for ln in out.splitlines()
        if ln.startswith(("retired", "decode device calls", "host syncs",
                          "fused decode steps", "prefix reuse",
                          "prefix KV copied", "kv pool", "fault isolation"))))
    if not (calls < tokens and syncs < tokens) or retired[0] != retired[1] \
            or f"{slots}/{slots} slots free at exit" not in out:
        raise AssertionError(f"[examples] serve_agentic_torch: {calls} decode "
                             f"device calls, {syncs} host syncs for {tokens} "
                             f"decode tokens; retired {retired}")
    stats["serve_agentic_torch"].update(decode_device_calls=calls,
                                        decode_tokens=tokens,
                                        host_syncs=syncs)
    qs = outs["quickstart_torch"][1]
    first, last = (float(x) for x in next(
        ln for ln in qs.splitlines() if ln.startswith("loss:")
    )[len("loss:"):].split("->"))
    if not last < first:
        raise AssertionError(f"[examples] quickstart_torch loss {first} -> "
                             f"{last}")
    stats["quickstart_torch"].update(loss_first=first, loss_last=last)
    log(f"[examples] all four exit 0 in {time.perf_counter() - t0:.1f} s")
    return stats


# -- stage-decoupled serving and the reference's baselines ----------------------
def _watch_staging(decisions):
    """An ``on_engine`` hook recording each flow's staging decision (True:
    prefilled on the prefill lane) of a ``DualDeviceBackend``."""
    def watch(eng):
        backend = eng.backend
        decide = backend._stage_for

        def stage_for(req, seq_start):
            staged = decide(req, seq_start)
            decisions.setdefault(req.id, staged)
            return staged
        backend._stage_for = stage_for
    return watch


def _segment_walls(backend):
    """Per-step decode-segment wall (ms) with no prefill in flight and with
    one (the backend's contention buckets, paper §6.4)."""
    def per(t, n):
        return t / n * 1e3 if n else None
    return (per(backend._seg_solo_time, backend._seg_solo_steps),
            per(backend._seg_co_time, backend._seg_co_steps))


def _busy(intervals):
    """Merged (start, end) intervals of one stream's kernels."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(x, y):
    """Microseconds during which both merged interval lists are busy."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def dual_profile(cfg, params, prefill_device, label):
    """A window of the stage-decoupled serve under ``torch.profiler``: 4
    flows decoding on the decode lane while a fifth prefills 1024 tokens on
    the prefill lane (two 512-token staged chunks, each followed by an
    8-step decode segment issued from the same thread), then the handoff.
    From the chrome trace's kernel events: the pool attention (and, for
    recurrentgemma, the chunked RG-LRU) kernels' streams, the decode
    kernels' streams, and the device time during which the two lanes'
    streams were busy at once."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import H100_LANES, Priority, Request
    from repro_torch.core.engine import RealAgentXPUEngine
    eng = RealAgentXPUEngine(cfg, params, H100_LANES, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda",
                             pool_slots=POOL, dual_device=True,
                             prefill_device=prefill_device)
    be = eng.backend
    rng = np.random.default_rng(SEED + 6)

    def req(i, n):
        return Request(id=i, priority=Priority.PROACTIVE, prompt_len=n,
                       max_new_tokens=64, arrival_time=0.0,
                       tokens=rng.integers(0, cfg.vocab_size, (1, n)))
    live = [req(i, 256) for i in range(4)]
    for r in live:  # staged and handed off (the decode rows)
        be.register(r)
        be.prefill_chunk(r, 0, 256, 0.0)
        be.prefill_done(r, 0.0)
    be.decode_run(live, 8, 0.0)  # warm the decode shapes
    pf = req(9, 1024)
    be.register(pf)
    _sync("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for start in (0, 512):
            be.prefill_chunk(pf, start, 512, 0.0)  # prefill lane, async
            be.decode_run(live, 8, 0.0)  # decode lane: waits on its own
        be.prefill_done(pf, 0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dual.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    events = events["traceEvents"] if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"[dual] {label}: no kernel in the profile")

    def lane(e):
        a = e.get("args", {})
        return (a.get("device"), a.get("stream"))

    def streams_of(names):
        return {lane(e) for e in kernels
                if any(n in e["name"] for n in names)}
    pool = streams_of(("pool_mma_kernel", "flash_pool_kernel"))
    dec = streams_of(("decode_mma_kernel", "decode_kernel"))
    scans = streams_of(("rglru_",)) if cfg.layer_pattern else set()
    pf_lanes = pool - dec
    if not pool or not dec or not pf_lanes:
        raise AssertionError(
            f"[dual] {label}: pool attention on streams {sorted(pool)}, "
            f"decode attention on {sorted(dec)}: no pool kernel on a "
            f"stream of its own")
    if cfg.layer_pattern and not scans & pf_lanes:
        raise AssertionError(f"[dual] {label}: the chunked rglru_scan ran "
                             f"on {sorted(scans)}, not on the prefill "
                             f"lane {sorted(pf_lanes)}")
    busy = {}
    for e in kernels:
        busy.setdefault(lane(e), []).append((e["ts"], e["ts"] + e["dur"]))
    busy = {k: _busy(v) for k, v in busy.items()}
    pf_busy = _busy([iv for k in pf_lanes for iv in busy[k]])
    dec_busy = _busy([iv for k in dec for iv in busy[k]])
    both = _overlap_us(pf_busy, dec_busy)
    out = dict(
        wall_ms=wall * 1e3,
        prefill_lane_busy_ms=sum(b - a for a, b in pf_busy) / 1e3,
        decode_lane_busy_ms=sum(b - a for a, b in dec_busy) / 1e3,
        both_busy_ms=both / 1e3,
        streams={"pool attention": sorted(map(str, pool)),
                 "decode attention": sorted(map(str, dec)),
                 **({"rglru_scan": sorted(map(str, scans))} if scans
                    else {})})
    log(f"[dual] {label} profile: two 512-token staged chunks beside two "
        f"8-step decode segments at B 4: wall {out['wall_ms']:.2f} ms, "
        f"prefill lane busy {out['prefill_lane_busy_ms']:.3f} ms, decode "
        f"lane busy {out['decode_lane_busy_ms']:.3f} ms, both at once "
        f"{out['both_busy_ms']:.3f} ms; kernel streams (device, stream) "
        + json.dumps(out["streams"]))
    del eng, be, prof
    _release()
    return out


def dual_phase(cfg, params, n_proactive, prefill_device, lane_name):
    """[dual]: the serving trace of ``n_proactive`` proactive flows and two
    reactive ones (one submitted mid-run) through
    ``RealAgentXPUEngine(dual_device=True)`` with prefill staged on
    ``prefill_device``'s lane, and through a single-lane twin.  The staged
    serve must stage at least one prefill, hand off each (handoff calls =
    staged prefills, KV bytes = the sum of each staged prompt's pow-2 cap
    times the bytes a token adds), free every slot, and serve every token
    within LOGIT_MARGIN of the plain path (which replays each flow's
    chunks: a staged prefill's run over a B=1 full ring, as the plain
    path's cache is).  Prints wall, tok/s, the mid-run reactive TTFT and
    the decode segments' per-step wall with and without a prefill in flight
    for both, then profiles a window of the staged path (dual_profile).
    Both serves schedule for H100_LANES, the hardware profile of two lanes
    of one H100: the paper's SoC profile prices its NPU lane 1.10-1.16x its
    iGPU lane at these models' widths, past the HEG affinity test's 1.05,
    so it would move every prefill back to the decode lane."""
    from repro_torch.core import H100_LANES
    from repro_torch.core.backend import _next_pow2
    label = f"{cfg.name} dual ({lane_name})"
    flows = make_flows(cfg, n_proactive, OUT_TOKENS,
                       np.random.default_rng(SEED), hw=H100_LANES)
    late_id = next(f["id"] for f in flows if f["late"])
    runs, decisions = {}, {}
    for dual in (True, False):
        kw = dict(dual_device=True, prefill_device=prefill_device,
                  on_engine=_watch_staging(decisions)) if dual \
            else dict(dual_device=False)
        runs[dual] = serve(cfg, params, flows, device="cuda",
                           dtype=torch.bfloat16, hw=H100_LANES, **kw)
        eng, metrics, wall, ttft, launches, chunks = runs[dual]
        check_serve(cfg, eng, metrics, flows, launches,
                    label if dual else f"{cfg.name} single-lane twin",
                    need_abort=False)
        _free_at_exit(eng, label)
    eng, metrics, wall, ttft, launches, chunks = runs[True]
    st, be = eng.stats(), eng.backend
    staged = sorted(i for i, d in decisions.items() if d)
    plen = {f["id"]: f["tokens"].shape[1] for f in flows}
    want_bytes = sum(min(_next_pow2(plen[i]), MAX_LEN) for i in staged) \
        * be._kv_token_bytes
    if not (st["dual_device"] and st["staged_prefills"] >= 1
            and st["staged_prefills"] == len(staged)
            and st["handoff_device_calls"] == st["staged_prefills"]
            and st["kv_bytes_handoff"] == want_bytes):
        raise AssertionError(
            f"[{label}] dual_device {st['dual_device']}, staged "
            f"{st['staged_prefills']} (flows {staged}), handoffs "
            f"{st['handoff_device_calls']}, KV bytes "
            f"{st['kv_bytes_handoff']} (want {want_bytes})")
    t0 = time.perf_counter()
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.bfloat16)
    check_s = time.perf_counter() - t0
    gen = sum(len(eng.output_tokens(f["id"])) for f in flows)
    out = {}
    for dual, name in ((True, "dual"), (False, "single_lane")):
        e, _, w, tt, ln, _ = runs[dual]
        solo, co = _segment_walls(e.backend)
        est = e.stats()
        out[name] = dict(wall_s=w, tokens_per_s=gen / w,
                         mid_run_reactive_ttft_wall_s=tt[late_id],
                         launches=ln,
                         co_executed_segments=est["co_executed_segments"],
                         decode_segments=est["decode_segments"],
                         segment_step_ms_solo=solo, segment_step_ms_co=co,
                         host_syncs=est["host_syncs"])
        log(f"[dual] {label}: {name}: {w:.3f} s wall ({gen / w:.2f} tok/s), "
            f"mid-run reactive TTFT {tt[late_id]:.3f} s, "
            f"{est['co_executed_segments']} of {est['decode_segments']} "
            f"decode segments co-executed with a prefill, per-step segment "
            f"wall solo {solo if solo is None else round(solo, 3)} ms / "
            f"co-executed {co if co is None else round(co, 3)} ms, host "
            f"syncs {est['host_syncs']}, launches {ln}")
    out.update(flows=len(flows), lane=st["prefill_device"],
               staged_flows=staged,
               **{k: st[k] for k in ("staged_prefills",
                                     "prefill_inflight_peak",
                                     "handoff_device_calls",
                                     "kv_bytes_handoff", "colocated_hits",
                                     "colocated_backpressure",
                                     "colocated_affinity")},
               plain_exact=exact, plain_total=total, plain_worst_gap=worst)
    log(f"[dual] {label}: prefill on {st['prefill_device']}, decode on "
        f"{st['decode_device']}: {st['staged_prefills']} staged prefills "
        f"(flows {staged}, {st['prefill_inflight_peak']} peak in flight), "
        f"{st['handoff_device_calls']} handoffs ({st['kv_bytes_handoff']} KV "
        f"bytes), co-located {st['colocated_hits']} hit / "
        f"{st['colocated_backpressure']} backpressure / "
        f"{st['colocated_affinity']} affinity")
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN}), {check_s:.1f} s; prefill replayed as "
        f"{chunks}")
    del eng, be, runs
    _release()
    out["profile"] = dual_profile(cfg, params, prefill_device, label)
    return out


def baselines_phase(cfg, params):
    """[baselines]: the reference's two measurable baselines, 4 flows (2
    proactive, 2 reactive, one submitted mid-run) each, beside the default
    on the same flows: ``device_resident=False`` (the pre-donation path:
    no fused run, full-pool decode, the batch rebuilt and uploaded every
    iteration, each program writing a fresh copy of the pool, scratch
    prefill) must fuse no step; ``in_pool_prefill=False`` (scratch prefill
    and one full-row bind a flow) must bind every flow and write more
    prefill KV bytes than the default.  Every token within LOGIT_MARGIN of
    the plain path."""
    flows = make_flows(cfg, 2, OUT_TOKENS, np.random.default_rng(SEED + 5))
    out = {}
    for name, kw in (("default", {}),
                     ("device_resident=False", dict(device_resident=False)),
                     ("in_pool_prefill=False", dict(in_pool_prefill=False))):
        label = f"{cfg.name} {name}"
        eng, metrics, wall, ttft, launches, chunks = serve(
            cfg, params, flows, device="cuda", dtype=torch.bfloat16,
            inject_after=12, **kw)
        st, _ = check_serve(cfg, eng, metrics, flows, launches, label,
                            need_abort=False, fused=not kw)
        _free_at_exit(eng, label)
        exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                          dtype=torch.bfloat16)
        gen = sum(len(eng.output_tokens(f["id"])) for f in flows)
        late = next(f["id"] for f in flows if f["late"])
        out[name] = dict(wall_s=wall, tokens_per_s=gen / wall,
                         mid_run_reactive_ttft_wall_s=ttft[late],
                         launches=launches, plain_exact=exact,
                         plain_total=total, plain_worst_gap=worst,
                         **{k: st[k] for k in (
                             "fused_steps", "bind_device_calls",
                             "kv_bytes_prefill", "kv_bytes_decode",
                             "host_syncs", "decode_device_calls",
                             "prefill_device_calls")})
        log(f"[baselines] {label}: {wall:.3f} s wall ({gen / wall:.2f} "
            f"tok/s), fused steps {st['fused_steps']}, binds "
            f"{st['bind_device_calls']}, prefill KV bytes "
            f"{st['kv_bytes_prefill']}, decode KV bytes "
            f"{st['kv_bytes_decode']}, host syncs {st['host_syncs']}, "
            f"launches {launches}; vs plain path {exact}/{total} exact, "
            f"largest gap {worst:.4f}")
        del eng
        _release()
    legacy, scratch = out["device_resident=False"], out["in_pool_prefill=False"]
    if legacy["fused_steps"] != 0 or legacy["bind_device_calls"] != len(flows):
        raise AssertionError(f"[baselines] device_resident=False: "
                             f"{legacy['fused_steps']} fused steps, "
                             f"{legacy['bind_device_calls']} binds")
    if scratch["bind_device_calls"] != len(flows) or \
            not scratch["kv_bytes_prefill"] > out["default"]["kv_bytes_prefill"]:
        raise AssertionError(
            f"[baselines] in_pool_prefill=False: "
            f"{scratch['bind_device_calls']} binds for {len(flows)} flows, "
            f"{scratch['kv_bytes_prefill']} prefill KV bytes vs the "
            f"default's {out['default']['kv_bytes_prefill']}")
    return out


def serve_phase():
    """llama3.2-3b: the bf16 serve, then a shorter one on an int8 pool, the
    serving modules' phases on the same weights ([prefix], [faults],
    [frontend]), then the serving profile (profile_serving)."""
    cfg, params = _init(ARCH)
    serve_stats = bf16_serve(cfg, params)
    flows8 = make_flows(cfg, 2, 16, np.random.default_rng(SEED + 1))
    eng8, m8, wall8, _, launches8, chunks8 = serve(
        cfg, params, flows8, device="cuda", dtype=torch.bfloat16,
        kv_dtype="int8", inject_after=12)
    check_serve(cfg, eng8, m8, flows8, launches8, f"{ARCH} int8",
                need_abort=False)
    exact8, total8, worst8 = plain_check(cfg, params, eng8, flows8,
                                         chunks8, dtype=torch.bfloat16,
                                         kv_dtype="int8")
    log(f"[check] {ARCH} int8 serve: {len(m8.completed)}/{len(flows8)} flows "
        f"in {wall8:.3f} s wall, launches {launches8}; vs plain path "
        f"{exact8}/{total8} exact ({exact8 / total8:.4f}), largest gap "
        f"{worst8:.4f}")
    serve_stats["int8"] = dict(flows=len(flows8), wall_s=wall8,
                               launches=launches8, plain_exact=exact8,
                               plain_total=total8, plain_worst_gap=worst8)
    del eng8
    _release()
    serve_stats["prefix"] = prefix_phase(cfg, params)
    serve_stats["prefix_store"] = prefix_store_phase(cfg, params)
    serve_stats["faults"] = faults_phase(cfg, params)
    serve_stats["frontend"] = frontend_phase(cfg, params)
    serve_stats["profile"] = profile_serving(cfg, params)
    serve_stats["dual"] = dual_phases(cfg, params, 6)
    serve_stats["baselines"] = baselines_phase(cfg, params)
    return serve_stats


def dual_phases(cfg, params, n_proactive):
    """[dual] on the stream lane (a second stream of GPU 0, asked for by
    naming GPU 0, the decode device, as the prefill device) and, where a
    second GPU is visible, on it."""
    out = {"stream": dual_phase(cfg, params, n_proactive,
                                torch.device("cuda", 0), "stream lane")}
    if torch.cuda.device_count() >= 2:
        out["gpu"] = dual_phase(cfg, params, n_proactive,
                                torch.device("cuda", 1), "second GPU")
    else:
        log(f"[dual] {cfg.name}: one GPU visible "
            f"({torch.cuda.device_count()}): the two-GPU lane not run")
    return out


def full_width_serve_phase(arch):
    """``arch`` at full width, bf16: qwen2-moe-a2.7b (every MoE layer's
    three expert products through the grouped GEMM kernel),
    deepseek-v2-lite-16b (MLA on its plain path, a dense head layer, then
    26 MoE layers through the grouped GEMM kernel), recurrentgemma-9b
    (RG-LRU layers through ``rglru_scan``, local attention at head_dim 256;
    then [dual] with 4 flows) or rwkv6-1.6b (WKV6 through ``rwkv6_scan``);
    for the families of F32_TOKEN_CHECK, the f32 serve whose tokens are
    held to the plain path."""
    cfg, params = _init(arch)
    stats = bf16_serve(cfg, params)
    if arch in (MOE_ARCH, DS_ARCH, RG_ARCH, RWKV_ARCH):  # GEMM's, scans'
        stats["profile"] = profile_serving(cfg, params)
    if arch == RG_ARCH:  # the RG-LRU state and the window's handoff
        stats["dual"] = dual_phases(cfg, params, 2)
    if arch in F32_TOKEN_CHECK:
        del params
        _release()
        stats["f32"] = f32_token_check(cfg)
    return stats


def f32_token_check(cfg):
    """The same trace served in f32 (weights from the same seed, the
    kernels in f32), every served token held to LOGIT_MARGIN of the plain
    path."""
    from repro_torch.models import init_params
    label = f"{cfg.name} f32"
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device="cuda")
    flows = make_flows(cfg, 6, OUT_TOKENS, np.random.default_rng(SEED))
    calls = {}
    eng, metrics, wall, _, launches, chunks = serve(
        cfg, params, flows, device="cuda", dtype=torch.float32,
        scan_calls=calls)
    check_serve(cfg, eng, metrics, flows, launches, label)
    t0 = time.perf_counter()
    exact, total, worst = plain_check(cfg, params, eng, flows, chunks,
                                      dtype=torch.float32)
    log(f"[check] {label} served tokens vs plain path: {exact}/{total} "
        f"exact argmax ({exact / total:.4f}), largest gap {worst:.4f} "
        f"(margin {LOGIT_MARGIN}), serve {wall:.3f} s, launches "
        f"{launches}, check {time.perf_counter() - t0:.1f} s")
    del eng
    return dict(wall_s=wall, launches=launches,
                scan_calls={k: v for k, v in calls.items() if launches[k]},
                plain_exact=exact, plain_total=total, plain_worst_gap=worst)


# -- the frontend forms -------------------------------------------------------
def _frontend_teacher_forced(cfg, params, toks, fe, served, *, backend,
                             max_len, dtype, split=False):
    """Yield the (B, V) f32 logits that score each served position: the
    prefill (an encoder-decoder's frames into the cache, then the prompt;
    a vision config's patches before the prompt in one call, or with
    ``split`` in two: the patches alone, then the prompt), then the served
    tokens (B, n) fed one step at a time through ``extend``."""
    from repro_torch.models import extend, init_cache, prefill
    if split:
        cache = init_cache(cfg, params, toks.shape[0], max_len, dtype)
        extend(cfg, params, cache, toks[:, :0], frontend_emb=fe,
               kernel_backend=backend)
        logits, cache = extend(cfg, params, cache, toks,
                               kernel_backend=backend)
    else:
        logits, cache = prefill(cfg, params, toks, frontend_emb=fe,
                                max_len=max_len, dtype=dtype,
                                kernel_backend=backend)
    for i in range(served.shape[1]):
        yield logits.float()
        if i + 1 < served.shape[1]:
            logits, cache = extend(cfg, params, cache,
                                   served[:, i:i + 1].long(),
                                   kernel_backend=backend)


def _gaps(logits, tok):
    """Each row's gap of its token ``tok`` below its largest logit."""
    return (logits.max(-1).values
            - logits.gather(-1, tok[:, None].long())[:, 0])


def _frontend_tokens_check(cfg, params, toks, fe, served, label, gate=True,
                           **kw):
    """The plain path on the card, teacher-forced on ``served`` (B, n: the
    prefill's argmax, then the decoded tokens) with the prefill in one
    call, scoring every served token.  With ``gate``, each must be the
    plain argmax or within LOGIT_MARGIN of it.  Returns (exact, total,
    largest gap, the plain argmaxes (B, n))."""
    exact = total = 0
    worst = 0.0
    tops = []
    for i, lg in enumerate(_frontend_teacher_forced(
            cfg, params, toks, fe, served, backend="plain", **kw)):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"[{label}] plain logits not finite at "
                                 f"token {i}")
        gap = _gaps(lg, served[:, i])
        tops.append(lg.argmax(-1))
        exact += int((gap == 0).sum())
        total += gap.numel()
        worst = max(worst, gap.max().item())
        if gate and gap.max().item() > LOGIT_MARGIN:
            row = int(gap.argmax())
            raise AssertionError(
                f"[{label}] row {row} token {i}: served "
                f"{int(served[row, i])} is {gap[row].item():.4f} below the "
                f"plain argmax {int(tops[-1][row])} (margin {LOGIT_MARGIN})")
    return exact, total, worst, torch.stack(tops, dim=1)


def _plain_floor(cfg, params, toks, fe, served, tops, **kw):
    """The plain path against itself, both teacher-forced on ``served``:
    the largest gap of the one-call prefill's argmaxes ``tops`` under the
    logits of the prefill split into the patches and the prompt (the same
    function; only the chunks' rounding differs)."""
    floor = 0.0
    for i, lg in enumerate(_frontend_teacher_forced(
            cfg, params, toks, fe, served, backend="plain", split=True,
            **kw)):
        floor = max(floor, _gaps(lg, tops[:, i]).max().item())
    return floor


def _frontend_serve(cfg, params, toks, fe, steps, label, **kw):
    """``prefill`` then a ``decode_run`` of ``steps`` fused steps, every row
    active, through the kernels; launches counted from 0 over both and
    held exact: one ``flash_attention_pool`` an attention layer for the
    prefill, one ``decode_attention`` an attention layer and step, nothing
    else (the encoder and the cross attention run ``full_attention``,
    plain).  Returns (served tokens (B, 1 + steps), launches, prefill s,
    decode s)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_run, layout, prefill
    head, pattern, repeats, tail = layout(cfg)
    n_attn = (head + pattern * repeats + tail).count("attn")
    active = torch.ones(toks.shape[0], dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, toks, frontend_emb=fe,
                            kernel_backend="cuda", **kw)
    first = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    block, _, cache = decode_run(cfg, params, cache, first, active, steps,
                                 kernel_backend="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(flash_attention_pool=n_attn, decode_attention=n_attn * steps)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches} != {want}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"[{label}] prefill logits not finite")
    served = torch.cat([first[:, None], block.t()], dim=1)
    del cache
    return served, launches, t1 - t0, t2 - t1


def encdec_phase(smi):
    """[encdec]: whisper-tiny at full width and depth in bf16 (random
    weights, seed SEED): ENCDEC_BATCH rows of random frames (1500 x 384)
    and ENCDEC_PROMPT-token prompts, ``prefill`` into an
    ENCDEC_MAX_LEN-slot ring (the encoder, then the cross K/V of every
    decoder layer, then the prompt), then ENCDEC_STEPS fused decode steps,
    through the kernels (launches exact: 4 pool launches, 4 decode
    launches a step, none in the encoder); every token held to the plain
    path on the same weights."""
    cfg, params = _init(WHISPER_ARCH)
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT))).cuda()
    fe = _frontend_emb(cfg, ENCDEC_BATCH, torch.bfloat16, SEED + 3)
    kw = dict(max_len=ENCDEC_MAX_LEN, dtype=torch.bfloat16)
    _frontend_serve(cfg, params, toks, fe, 2, WHISPER_ARCH, **kw)  # warm
    served, launches, t_pre, t_dec = _frontend_serve(
        cfg, params, toks, fe, ENCDEC_STEPS, WHISPER_ARCH, **kw)
    t0 = time.perf_counter()
    exact, total, worst, _ = _frontend_tokens_check(
        cfg, params, toks, fe, served, WHISPER_ARCH, **kw)
    gen_tok = ENCDEC_BATCH * ENCDEC_STEPS
    log(f"[encdec] {WHISPER_ARCH}: {ENCDEC_BATCH} rows, {cfg.frontend_tokens} "
        f"frames through {cfg.num_encoder_layers} encoder layers, "
        f"{ENCDEC_PROMPT}-token prompts, {ENCDEC_STEPS} decode steps: "
        f"prefill {t_pre:.4f} s, decode {t_dec:.4f} s "
        f"({gen_tok / t_dec:.1f} tok/s); launches {launches}; vs plain path "
        f"{exact}/{total} exact ({exact / total:.4f}), largest gap "
        f"{worst:.4f} (margin {LOGIT_MARGIN}), check "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    del params
    _release()
    return dict(rows=ENCDEC_BATCH, prompt=ENCDEC_PROMPT, steps=ENCDEC_STEPS,
                prefill_s=t_pre, decode_s=t_dec, decode_tok_s=gen_tok / t_dec,
                launches=launches, plain_exact=exact, plain_total=total,
                plain_worst_gap=worst)


# planted faults of the [vision] gate: one DROP_TILE-slot tile of live
# positions dropped in every decode or prefill attention call of a serve
VISION_FAULTS = [
    (f"one {DROP_TILE}-slot tile dropped in every decode attention call",
     "decode_attention", decode_drop_tile),
    (f"one {DROP_TILE}-slot tile dropped in every prefill attention call",
     "flash_attention_pool", pool_drop_tile)]


def _planted_serve(cfg, params, toks, fe, steps, label, kernel, drop, **kw):
    """``_frontend_serve`` with ``ops.<kernel>`` fed ``drop(args)``: the
    served tokens of a kernel that skipped a tile in every call."""
    from repro_torch.kernels import ops
    real = getattr(ops, kernel)

    def faulty(*args, **kwargs):
        return real(*drop(args), **kwargs)
    setattr(ops, kernel, faulty)
    try:
        return _frontend_serve(cfg, params, toks, fe, steps, label, **kw)[0]
    finally:
        setattr(ops, kernel, real)


def _profile_vision(cfg, params, toks, fe, **kw):
    """The prefill and a 4-step decode segment once more, each under the
    profiler: wall, device busy and its share of wall, the attention
    kernels' device time and share of busy (PROFILED_KERNELS)."""
    from repro_torch.models import decode_run, prefill
    out = {}
    logits, cache = prefill(cfg, params, toks, frontend_emb=fe,
                            kernel_backend="cuda", **kw)
    first = logits.argmax(-1).to(torch.int32)
    active = torch.ones(toks.shape[0], dtype=torch.bool, device="cuda")
    for label, fn in (
            (f"prefill C={cfg.frontend_tokens + toks.shape[1]}",
             lambda: prefill(cfg, params, toks, frontend_emb=fe,
                             kernel_backend="cuda", **kw)),
            ("decode B=1 x 4 steps", lambda: decode_run(
                cfg, params, cache, first, active, 4,
                kernel_backend="cuda"))):
        wall, times, _ = _device_times(fn)
        busy = sum(t for _, t in times)
        if busy <= 0:
            log(f"[profile] {cfg.name} {label}: no device time in the "
                "trace: not measured")
            continue
        attn = sum(t for n, t in times
                   if any(x in n for x in PROFILED_KERNELS["attention"]))
        top = sorted(times, key=lambda r: -r[1])[:6]
        out[label] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                          busy_share=busy / 1e3 / wall, attention_ms=attn,
                          attention_share=attn / busy,
                          top_ms={n[:90]: t for n, t in top})
        log(f"[profile] {cfg.name} {label}: wall {wall * 1e3:.2f} ms, device "
            f"busy {busy:.2f} ms ({busy / 1e3 / wall:.3f} of wall); "
            f"attention {attn:.3f} ms ({attn / busy:.3f} of busy)")
        for name, t in top:
            log(f"[profile]   {t:10.3f} ms  {name[:90]}")
    del cache
    return out


def vision_phase(smi):
    """[vision]: llava-next-34b at full width and depth in bf16 (random
    weights, seed SEED; 34.4 B parameters, 68.8 GB): one row of 2880
    random patch embeddings and a VISION_PROMPT-token prompt in one
    prefill chunk into a VISION_MAX_LEN-slot ring, then VISION_STEPS fused
    decode steps, through the kernels (launches exact: 60 pool launches,
    60 decode launches a step), and peak memory.  Its f32 weights (137.6
    GB) cannot be on the card, so its tokens are held to the bf16 plain
    path on the same weights: every served token within the plain path's
    own noise floor (its argmaxes under the same plain path with the
    prefill split into the patches and the prompt) plus LOGIT_MARGIN, a
    gate that serves with a planted attention fault (VISION_FAULTS) must
    fail.  Then the prefill and a decode segment under the profiler."""
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _init(LLAVA_ARCH)
    rng = np.random.default_rng(SEED + 5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, VISION_PROMPT))).cuda()
    fe = _frontend_emb(cfg, 1, torch.bfloat16, SEED + 5)
    kw = dict(max_len=VISION_MAX_LEN, dtype=torch.bfloat16)
    _frontend_serve(cfg, params, toks, fe, 2, LLAVA_ARCH, **kw)  # warm
    served, launches, t_pre, t_dec = _frontend_serve(
        cfg, params, toks, fe, VISION_STEPS, LLAVA_ARCH, **kw)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[vision] {LLAVA_ARCH}: {cfg.frontend_tokens} patches + "
        f"{VISION_PROMPT} prompt tokens in one chunk, {VISION_STEPS} decode "
        f"steps: prefill {t_pre:.4f} s, decode {t_dec:.4f} s "
        f"({VISION_STEPS / t_dec:.2f} tok/s); peak memory {peak:.2f} GB; "
        f"launches {launches}; {smi}")
    t0 = time.perf_counter()
    exact, total, worst, tops = _frontend_tokens_check(
        cfg, params, toks, fe, served, LLAVA_ARCH, gate=False, **kw)
    floor = _plain_floor(cfg, params, toks, fe, served, tops, **kw)
    limit = floor + LOGIT_MARGIN
    log(f"[check] {LLAVA_ARCH} bf16 served tokens vs plain path: "
        f"{exact}/{total} exact ({exact / total:.4f}), largest gap "
        f"{worst:.4f}; the plain path against itself (the prefill in one "
        f"call vs split into the patches and the prompt) {floor:.4f}: the "
        f"kernel path's gap must be within {floor:.4f} plus the margin "
        f"{LOGIT_MARGIN} ({limit:.4f}); {time.perf_counter() - t0:.1f} s")
    if worst > limit:
        raise AssertionError(
            f"[{LLAVA_ARCH}] the kernel path's largest gap {worst:.4f} "
            f"exceeds the plain path's own {floor:.4f} plus the margin "
            f"{LOGIT_MARGIN}")
    faults = {}
    for name, kernel, drop in VISION_FAULTS:
        bad = _planted_serve(cfg, params, toks, fe, VISION_STEPS, LLAVA_ARCH,
                             kernel, drop, **kw)
        faults[name] = gap = _frontend_tokens_check(
            cfg, params, toks, fe, bad, LLAVA_ARCH, gate=False, **kw)[2]
        log(f"[check] {LLAVA_ARCH} bf16 with a planted fault ({name}): "
            f"largest gap {gap:.4f}, {gap / limit:.2f} x the gate's "
            f"{limit:.4f}: " + ("caught" if gap > limit else "NOT caught"))
    missed = [n for n, gap in faults.items() if not gap > limit]
    if missed:
        raise AssertionError(f"[{LLAVA_ARCH}] the gate {limit:.4f} would not "
                             f"catch {missed}: {faults}")
    prof = _profile_vision(cfg, params, toks, fe, **kw)
    del params
    _release()
    return dict(prompt=VISION_PROMPT, patches=cfg.frontend_tokens,
                steps=VISION_STEPS, prefill_s=t_pre, decode_s=t_dec,
                decode_tok_s=VISION_STEPS / t_dec, peak_mem_gb=peak,
                launches=launches, plain_exact=exact, plain_total=total,
                plain_worst_gap=worst, plain_noise_floor_gap=floor,
                gate=limit, planted_fault_gaps=faults, profile=prof)


def _shard_run(cfg, params, toks, feed, **kw):
    """A SHARD_PROMPT-token prefill and SHARD_STEPS decode ``extend``
    calls, each step fed ``feed``'s token (teacher-forced, so every run
    sees the same inputs) or, without one, its own argmax: (the logits of
    every call, whole, the greedy tokens, the kernel launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models import extend, prefill

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).float()
    ops.reset_launches()
    with torch.no_grad():
        lg, cache = prefill(cfg, params, toks, max_len=SHARD_PROMPT
                            + SHARD_STEPS, dtype=torch.bfloat16, **kw)
        logits, greedy = [whole(lg)], []
        for i in range(SHARD_STEPS):
            greedy.append(logits[-1].argmax(-1).to(torch.int32))
            nxt = greedy[-1] if feed is None else feed[i]
            lg, cache = extend(cfg, params, cache, nxt[:, None], **kw)
            logits.append(whole(lg))
    torch.cuda.synchronize()
    return logits, torch.stack(greedy), dict(ops.LAUNCHES)


def shard_dryrun():
    """One dry-run combination at full width (``SHARD_DRYRUN`` on the 16x16
    mesh) in a process of its own (it starts a fake 512-rank group): its
    record."""
    arch, shape = SHARD_DRYRUN
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "dryrun_smoke")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--out", out],
                       env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"[shard] dry run failed:\n{r.stdout[-3000:]}"
                             f"\n{r.stderr[-3000:]}")
    with open(os.path.join(out, f"{arch}_{shape}_16x16.json")) as f:
        rec = json.load(f)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def shard_phase(smi):
    """[shard]: ``llama3.2-3b`` at full width in bf16 on the 1x1 host mesh
    (``make_host_mesh``: a world-1 NCCL group), its parameters DTensors
    (``param_shardings``).  (a) ``batch_axes="data"`` with the kernels: the
    attention kernels run on the rank's rows through ``local_map``, so the
    launches equal the unsharded run's and the logits are bit-equal to it.
    (b) with ``tp_axis="model"`` too: attention on the plain path (0
    launches), split-KV decode over the model axis; the greedy tokens are
    the unsharded plain run's, or within LOGIT_MARGIN of its argmax.  Then
    the full-width dry run of ``SHARD_DRYRUN``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import param_shardings
    cfg, params = _init(ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    toks = torch.randint(0, cfg.vocab_size, (SHARD_BATCH, SHARD_PROMPT),
                         generator=gen, device="cuda")
    t0 = time.perf_counter()
    ref_cuda, greedy_cuda, n_cuda = _shard_run(cfg, params, toks, None,
                                               kernel_backend="cuda")
    ref_plain, greedy_plain, _ = _shard_run(cfg, params, toks, None,
                                            kernel_backend="plain")
    t_plain = time.perf_counter() - t0
    mesh = make_host_mesh()
    param_shardings(params, mesh)
    t0 = time.perf_counter()
    got, _, n_rows = _shard_run(cfg, params, toks, greedy_cuda,
                                batch_axes="data", kernel_backend="cuda")
    t_rows = time.perf_counter() - t0
    attn = ("decode_attention", "flash_attention_pool")
    want_launches = {k: n_cuda[k] for k in attn}
    assert {k: n_rows[k] for k in attn} == want_launches, (n_rows,
                                                           want_launches)
    assert want_launches["flash_attention_pool"] > 0 and \
        want_launches["decode_attention"] > 0, want_launches
    unequal = [i for i, (a, b) in enumerate(zip(got, ref_cuda))
               if not torch.equal(a, b)]
    assert not unequal, f"[shard] batch-sharded logits differ at {unequal}"
    log(f"[shard] {ARCH} batch_axes=data, cuda kernels on 1x1 "
        f"{mesh.mesh_dim_names}: launches {n_rows['flash_attention_pool']} "
        f"pool + {n_rows['decode_attention']} decode (unsharded "
        f"{want_launches['flash_attention_pool']} + "
        f"{want_launches['decode_attention']}), logits of "
        f"{len(got)} calls bit-equal to the unsharded run; "
        f"{t_rows:.2f} s (unsharded cuda + plain {t_plain:.2f} s)")
    t0 = time.perf_counter()
    got_tp, greedy_tp, n_tp = _shard_run(cfg, params, toks, greedy_plain,
                                         batch_axes="data", tp_axis="model",
                                         kernel_backend="cuda")
    t_tp = time.perf_counter() - t0
    assert all(n_tp[k] == 0 for k in attn), n_tp
    gaps = []
    for i in range(SHARD_STEPS):
        lg = got_tp[i]
        want = greedy_plain[i].long()
        gaps.append(float((lg.max(-1).values
                           - lg.gather(-1, want[:, None])[:, 0]).max()))
    same = int((greedy_tp == greedy_plain).sum())
    worst = max(gaps)
    assert worst <= LOGIT_MARGIN, (gaps, LOGIT_MARGIN)
    log(f"[shard] {ARCH} batch_axes=data tp_axis=model: attention launches "
        f"{sum(n_tp[k] for k in attn)} (plain path), greedy tokens "
        f"{same}/{greedy_plain.numel()} equal to the unsharded plain run's, "
        f"largest gap {worst:.4f} (margin {LOGIT_MARGIN}); {t_tp:.2f} s")
    del params, got, got_tp, ref_cuda, ref_plain
    dist.destroy_process_group()
    _release()
    rec = shard_dryrun()
    rf = rec["roofline"]
    dom = rf["dominant"]
    log(f"[shard] dryrun {rec['arch']} x {rec['shape']} x {rec['mesh']} "
        f"(full width, {rec['chips']} chips): flops/chip "
        f"{rec['hlo_flops_per_chip']:.4e}, bytes/chip "
        f"{rec['hlo_bytes_per_chip']:.4e}, collective bytes/chip "
        f"{rec['collective_bytes_per_chip']:.4e}, dominant {dom} "
        f"{rf[dom]:.6f} s, useful flops {rf['useful_flops_ratio']}; traced "
        f"in {rec['lower_s']:.1f} s, {rec['wall_s']:.1f} s with its process")
    log(f"[shard] {smi}")
    return {"launches": n_rows, "tp_launches": n_tp,
            "rows_bit_equal": True, "tp_tokens_equal": same,
            "tp_tokens": greedy_plain.numel(), "tp_gap": worst,
            "rows_s": t_rows, "tp_s": t_tp, "dryrun": {
                k: rec[k] for k in ("arch", "shape", "mesh", "chips",
                                    "hlo_flops_per_chip",
                                    "hlo_bytes_per_chip",
                                    "collective_bytes_per_chip",
                                    "collectives", "roofline", "memory",
                                    "lower_s", "wall_s")}}


def main():
    t_start = time.perf_counter()

    def phase_done(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    smi = device_phase()
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build(variants=[MOE_FMA_SRC])
    log(f"[build] nvcc sm_90a from {build.CSRC}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f" (total {time.perf_counter() - t0:.1f} s)")
    kernel_rows = kernel_phase()
    kernel_rows.update(flash_kernel_phase())
    phase_done("kernels")
    train_stats = train_phase(smi)
    phase_done(f"{ARCH} train")
    family_train = {}
    for arch in TRAIN_FAMILIES:
        family_train[arch] = family_train_phase(arch, smi)
        phase_done(f"{arch} train")
    serve_stats = serve_phase()
    phase_done(ARCH)
    launcher = launcher_phase()
    phase_done("launcher")
    examples = examples_phase()
    phase_done("examples")
    other = {}
    for arch in (MOE_ARCH, DS_ARCH, RG_ARCH, RWKV_ARCH):
        _release()  # the previous path's weights and pools
        other[arch] = full_width_serve_phase(arch)
        phase_done(arch)
    _release()
    encdec = encdec_phase(smi)
    phase_done(f"{WHISPER_ARCH} encdec")
    vision = vision_phase(smi)
    phase_done(f"{LLAVA_ARCH} vision")
    _release()
    shard = shard_phase(smi)
    phase_done(f"{ARCH} shard")
    # launches of each kernel in the main-path runs, each counted from 0
    by_path = {f"{ARCH} train": train_stats["launches"],
               **{f"{a} train": st["launches"]
                  for a, st in family_train.items()},
               f"{ARCH} bf16": serve_stats["launches"],
               f"{ARCH} int8": serve_stats["int8"]["launches"],
               f"{ARCH} prefix": serve_stats["prefix"]["launches"],
               f"{ARCH} prefix cold": serve_stats["prefix"]["cold_launches"],
               f"{ARCH} prefix store":
                   serve_stats["prefix_store"]["launches"],
               f"{ARCH} prefix store cold":
                   serve_stats["prefix_store"]["cold_launches"],
               f"{ARCH} faults": serve_stats["faults"]["launches"],
               f"{ARCH} frontend": serve_stats["frontend"]["launches"],
               **{f"{a} dual {lane} {run}": st["dual"][lane][run]["launches"]
                  for a, st in ((ARCH, serve_stats), (RG_ARCH, other[RG_ARCH]))
                  for lane in st["dual"]
                  for run in ("dual", "single_lane")},
               **{f"{ARCH} {k}": v["launches"]
                  for k, v in serve_stats["baselines"].items()},
               **{f"{a} bf16": st["launches"] for a, st in other.items()},
               **{f"{a} f32": st["f32"]["launches"]
                  for a, st in other.items() if "f32" in st},
               f"{WHISPER_ARCH} encdec": encdec["launches"],
               f"{LLAVA_ARCH} vision": vision["launches"],
               f"{ARCH} shard": shard["launches"]}
    replaces = {"decode_attention":
                "src/repro/kernels/decode_attention.py:79",
                "flash_attention_pool":
                "src/repro/kernels/flash_attention.py:174",
                "flash_attention": "src/repro/kernels/flash_attention.py:81",
                "moe_gemm": "src/repro/kernels/moe_gemm.py:39",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:56",
                "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:71"}
    sources = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in replaces}
    headline = {"decode_attention": "bf16 kvl=2048",
                "flash_attention_pool": "bf16 C=512",
                "flash_attention": "f32 B=2 S=1024 24/8 hd128 causal",
                "moe_gemm": "decode C=16 d=2048 f=1408",
                "rglru_scan": "prefill B=1 S=512 W=4096",
                "rwkv6_scan": "prefill BH=32 S=512 D=64"}
    kernels = []
    for k in replaces:
        row = kernel_rows[(k, headline[k])]
        kernels.append(dict(
            name=k, route="cuda", source=sources[k], replaces=replaces[k],
            shape=headline[k],
            launches=sum(n[k] for n in by_path.values()),
            launches_by_path={p: n[k] for p, n in by_path.items()}, **row))
        if k == "moe_gemm":  # every expert GEMM shape of the MoE path
            kernels[-1]["cases"] = [dict(shape=n, **r) for (kn, n), r in
                                    kernel_rows.items() if kn == k]
        if k == "flash_attention":
            # its gradient, a kernel of the training path with no TPU
            # counterpart (the Pallas kernel has no VJP)
            b = "flash_attention_bwd"
            kernels[-1]["backward"] = dict(
                name=b, route="cuda", source=f"src/repro_torch/kernels/csrc/"
                f"{b}.cu", replaces=replaces[k], shape=headline[k],
                launches=sum(n[b] for n in by_path.values()),
                launches_by_path={p: n[b] for p, n in by_path.items()},
                **kernel_rows[(b, headline[k])])
    log(json.dumps({"train": train_stats}))
    for arch, st in family_train.items():
        log(json.dumps({f"train {arch}": st}))
    log(json.dumps({"examples": examples}))
    log(json.dumps({"serve": serve_stats}))
    log(json.dumps({"launcher": launcher}))
    for arch, st in other.items():
        log(json.dumps({f"serve {arch}": st}))
    log(json.dumps({"encdec": encdec, "vision": vision}))
    log(json.dumps({"shard": shard}))
    log(json.dumps({"kernel_cases": [
        dict(name=k, shape=n, **row) for (k, n), row in kernel_rows.items()]}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
