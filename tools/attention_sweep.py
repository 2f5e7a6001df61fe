"""Sweeps behind the tuning of the attention kernels and the expert GEMM,
on one NVIDIA GPU.

    python3 tools/attention_sweep.py

Times, at ``chip_smoke.py``'s kernel cases and with its ``time_ms`` (median
of 25 CUDA-event runs, the L2 flushed by a 64 MB ``zero_`` before each):

* ``decode``: the split decode kernel and its merge at every split count
  (``ops._decode_launch``), beside the count ``ops.decode_splits`` takes;
* ``pool``: the bf16 pool kernel at every split count (``ops._pool_launch``),
  beside ``ops.pool_splits``' count;
* ``flush``: the decode kernel and SDPA with the L2 flushed by ``zero_``
  (which leaves the flush buffer's dirty lines to be written back during
  the timed run) and by a read of the same 64 MB (clean lines);
* ``variants``: the pool kernel built from edited copies of its sources in
  ``build/sweep/``: the position mask knocked out; the mask and both
  products knocked out, leaving the tile loads and the softmax's
  bookkeeping (both give wrong results: timing only); a 3-stage ring; and
  8-warp blocks of 128 rows;
* ``precision``: the decode kernel's f32 output (its n_split 1 partials,
  acc / l, before the bf16 rounding) and the plain version's f32 output,
  each against the same function in float64 (mean signed and RMS error
  relative to mean |out|), and the times of the pool kernel at C 512 and
  of the decode kernel at llama's B 16, for the kernels as they are and
  for edited copies: P in one or two bf16 parts instead of three, and the
  PV products added straight into the output accumulator;
* ``gaps``: the qwen2-moe-a2.7b bf16 serve of ``chip_smoke.py`` through
  the kernels as they are and through each precision variant, its served
  tokens scored by the plain path (``chip_smoke.plain_check``, ungated):
  exact argmax count, tokens past LOGIT_MARGIN, the largest gap;
* ``bwd_precision``: the training flash attention backward at
  ``chip_smoke.py``'s f32 training shape (B 2, S 1024, 24/8 heads of 128,
  causal): dq, dk and dv of the plain f32 version and of the kernel
  against the same function in float64 (mean signed and RMS error relative
  to mean |grad|), with each one's time, for the kernel as built (3xTF32)
  and for edited copies: one TF32 product (1xTF32), the three products
  added straight into the sum, 32-row streamed tiles, S and dP through a
  fresh fragment every 16 deep, expf; then the times of knock-outs of its
  parts (wrong results: timing only), its two kernels' device times, and
  SDPA's backward;
* ``fwd_precision``: the training flash attention forward at the same
  shape: out and lse of the plain f32 version and of the kernel against
  the same function in float64 (as ``bwd_precision``), with each one's
  time, for the kernel as built (3xTF32) and for edited copies: 1xTF32,
  the three products added straight into the sum, S through a fresh
  fragment every 16 deep, 32-row key tiles; then the times of knock-outs
  of its parts (timing only) and SDPA's forward;
* ``moe``: the bf16 expert GEMM at ``chip_smoke.py``'s cases
  (qwen2-moe-a2.7b's decode gate / up and down, prefill C 42, one row, and
  the decode pool as served, most rows zero): the f32 sums of the kernel
  as built (CUDA cores, the weights through a ring in shared memory), of
  the kernel it replaced (``tools/moe_gemm_fma.cu``) and of the
  tensor-core variant (``tools/moe_gemm_mma.cu``) in three accumulation
  forms, each built in place of ``moe_gemm.cu``, against float64 (as
  ``bwd_precision``), with the share of bf16 outputs that differ from the
  plain version's and from the replaced kernel's; the times of each, of
  the ring's other stage counts and slice depths, with its skip of zero
  rows off or widened, of the replaced kernel with 32-deep bf16 slices and
  of the tensor-core variant's other rings, beside ``torch.bmm``; each
  case's device time by kernel;
* ``moe_gaps``: the MoE serve's tokens (as ``gaps``) through the kernel as
  built and the tensor-core forms;
* ``rglru``: the RG-LRU scan at ``chip_smoke.py``'s cases at each chunk
  length, with knock-outs of its parts (timing only: the wait for the
  earlier chunks' pairs, the re-run of the chunk), each case's device time
  by kernel, and the precision against float64 of each chunk length and
  of the plain version at the serve's decays and extreme ones;
* ``rwkv6``: the WKV6 scan at ``chip_smoke.py``'s cases (rwkv6-1.6b's
  512- and 128-token prefills of one row, a decode step at B 16) as built,
  built for three blocks an SM, and with knock-outs of its parts (timing only): the fold of the earlier
  chunks' states, the pairwise weights, the wait for the earlier chunks'
  pairs; then each case's device time by kernel; and the precision against
  float64 at extreme decays of the kernel, its (hi, lo) variant and both
  plain forms (``rwkv6_precision``);
* ``rwkv6_gate``: the rwkv6-1.6b serve through the WKV6 kernel as built and
  through sound variants of its arithmetic (L as (hi, lo) pairs, from
  ``tools/rwkv6_scan_pair_l.cu``; exp2f for ex2.approx): the bf16 gate's
  two numbers (the kernel path's largest gap, the plain path's own noise
  floor) and the f32 serve's exact tokens and largest gap.

Each line names the case and prints one number per setting.  Run all
sections, or name some: ``python3 tools/attention_sweep.py precision gaps``.
Needs the repository (it imports ``chip_smoke`` and ``repro_torch``) and a
GPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
DECODE = ("bf16 kvl=2048", "int8 kvl=2048", "G=1 bf16 kvl=2048",
          "hd256 G=16 bf16 kvl=2048 window=2048", "bf16 B=4 kvl=2048")
POOL = ("bf16 C=512", "int8 C=512", "bf16 C=128", "bf16 C=16",
        "G=1 bf16 C=512", "G=1 bf16 C=128",
        "hd256 G=16 bf16 C=512 window=2048",
        "hd256 G=16 bf16 C=128 window=2048")
# (name, [(file, text, replacement)]) edits of the pool kernel's sources
MASK = ("      if (!whole) {", "      if (false) {")
VARIANTS = [
    ("no position mask", [("attn_mma.cuh", *MASK)]),
    ("loads and softmax only", [
        ("attn_mma.cuh", "for (int kk = 0; kk < HD / 16; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {"),
        ("attn_mma.cuh", "for (int kt = 0; kt < NS / 16; ++kt) {",
         "for (int kt = 0; kt < 0; ++kt) {"),
        ("attn_mma.cuh", *MASK)]),
    ("3-stage ring", [("flash_attention_pool.cu", "kStages = 2;",
                       "kStages = HD >= 256 ? 2 : 3;")]),
    ("8 warps, 128 rows", [
        ("flash_attention_pool.cu", "constexpr int kNT = 128;",
         "constexpr int kNT = 256;"),
        ("flash_attention_pool.cu", "__launch_bounds__(kNT, 2)",
         "__launch_bounds__(kNT, 1)")])]


# (name, [(file, text, replacement)]) edits of the PV product in the shared
# warp step (attn_mma.cuh): both serving kernels are built from them
PARTS = "for (int c = 2; c >= 0; --c) {"
PRECISION = [
    ("P in one bf16 part", [("attn_mma.cuh", PARTS,
                             "for (int c = 0; c >= 0; --c) {")]),
    ("P in two bf16 parts", [("attn_mma.cuh", PARTS,
                              "for (int c = 1; c >= 0; --c) {")]),
    ("PV straight into O", [
        ("attn_mma.cuh",
         "float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};",
         "float(&t0)[4] = st.o[2 * dt];\n      float(&t1)[4] = "
         "st.o[2 * dt + 1];"),
        ("attn_mma.cuh", "      add4(st.o[2 * dt], t0);\n"
         "      add4(st.o[2 * dt + 1], t1);\n", "")])]


# edits of the 3xTF32 products (flash_mma.cuh: both flash kernels are built
# from them) and of the backward's tiles
ONE_TF32 = [("flash_mma.cuh",
             "  mma_tf32(t, a.lo, b.hi[0], b.hi[1]);\n"
             "  mma_tf32(t, a.hi, b.lo[0], b.lo[1]);\n", "")]
STRAIGHT = [("flash_mma.cuh", "mma3(t, a[j], bb);", "mma3(acc[n], a[j], bb);"),
            ("flash_mma.cuh", "mma3(t, a[kq], bb);",
             "mma3(acc[n], a[kq], bb);"),
            ("flash_mma.cuh", "add_rn(acc[n], t);", "")]
FRESH16 = [("flash_mma.cuh", "constexpr int kScoreDepth = 32;",
            "constexpr int kScoreDepth = 16;")]
BWD_VARIANTS = [
    ("1xTF32", ONE_TF32),
    ("3xTF32 straight into the sum", STRAIGHT),
    ("32-row streamed tiles", [("flash_attention_bwd.cu",
                                "static constexpr int BS = 16;",
                                "static constexpr int BS = 32;")]),
    ("S and dP through a fresh fragment every 16 deep", FRESH16),
    ("expf for exp2f", [
        ("flash_attention_bwd.cu",
         "(s[n][e] * a.scale - ls[il]) * kLog2e;\n"
         "        const float p = ok ? exp2f(x)",
         "(s[n][e] * a.scale - ls[il]);\n"
         "        const float p = ok ? expf(x)"),
        ("flash_attention_bwd.cu",
         "(s[n][e] * a.scale - lse_r[r]) * kLog2e;\n"
         "        const float p = ok ? exp2f(x)",
         "(s[n][e] * a.scale - lse_r[r]);\n"
         "        const float p = ok ? expf(x)")])]
# knock-outs of the flash kernels' parts (wrong results: timing only)
NO_SPLIT = ("flash_mma.cuh",
            "void split_own(float2* dst, const float* raw) {",
            "void split_own(float2* dst, const float* raw) {\n  return;")
NO_SCORES = ("flash_attention_bwd.cu",
             "for (int kk = 0; kk < HD; kk += kScoreDepth) {",
             "for (int kk = 0; kk < 0; kk += kScoreDepth) {")
NO_PRODUCTS = [("flash_attention_bwd.cu", f"    acc_product<HD, BS, AW>({x}",
                f"    if (0) acc_product<HD, BS, AW>({x}")
               for x in ("dv, s,", "dk, dp,", "dq, s,")]
BWD_PARTS = [
    ("no exp", [("flash_attention_bwd.cu", "ok ? exp2f(x) : 0.f;",
                 "ok ? x : 0.f;")]),  # both kernels
    ("no S and dP products", [NO_SCORES]),
    ("no dV, dK and dQ products", NO_PRODUCTS),
    ("no streamed-tile split", [NO_SPLIT]),
    ("loads, split and masks only", [NO_SCORES] + NO_PRODUCTS)]
# edits of the forward (flash_attention.cu): its products' precision as the
# backward's, and 32-row key tiles; then knock-outs of its parts
FWD_VARIANTS = [
    ("1xTF32", ONE_TF32),
    ("3xTF32 straight into the sum", STRAIGHT),
    ("S through a fresh fragment every 16 deep", FRESH16),
    ("32-row key tiles", [("flash_attention.cu",
                           "static constexpr int BS = 16;",
                           "static constexpr int BS = 32;")])]
FWD_NO_S = ("flash_attention.cu",
            "for (int kk = 0; kk < HD; kk += kScoreDepth)\n",
            "for (int kk = 0; kk < 0; kk += kScoreDepth)\n")
FWD_NO_PV = ("flash_attention.cu", "    acc_product<HD, BS, AW>(acc, s,",
             "    if (0) acc_product<HD, BS, AW>(acc, s,")
FWD_PARTS = [
    ("no exp", [("flash_attention.cu",
                 "const float p = exp2f(s[n][e] - base[e >> 1]);",
                 "const float p = s[n][e] - base[e >> 1];")]),
    ("no S product", [FWD_NO_S]),
    ("no PV product", [FWD_NO_PV]),
    ("no key-tile split", [NO_SPLIT]),
    ("loads, split, masks and softmax only", [FWD_NO_S, FWD_NO_PV])]
# a variant of the WKV6 kernel (three blocks an SM: at most 42 registers a
# thread), then knock-outs of its parts (wrong results: timing only)
RWKV_VARIANTS = [("3 blocks an SM", [
    ("rwkv6_scan.cu", "__launch_bounds__(8 * D) wkv6_kernel",
     "__launch_bounds__(8 * D, 3) wkv6_kernel")])]
# the chunk-order wait both scans share (csrc/chunk_order.cuh)
NO_WAIT = ("chunk_order.cuh", "while (*f != epoch) {", "while (false) {")
RWKV_PARTS = [
    ("no fold of the earlier chunks' states", [
        ("rwkv6_scan.cu", "for (int j2 = 0; j2 < c; ++j2) {",
         "for (int j2 = 0; j2 < 0; ++j2) {")]),
    ("no pairwise weights", [
        ("rwkv6_scan.cu", "    if (t < n) {\n      // row t's r",
         "    if (false) {\n      // row t's r")]),
    ("no wait for the earlier chunks' pairs", [NO_WAIT])]
# edits of the bf16 expert GEMM: FMA and TC build the replaced kernel
# (tools/moe_gemm_fma.cu) and the tensor-core variant in place of
# moe_gemm.cu, the latter in three accumulation forms and with other ring
# and slice depths; the shipped kernel with other ring and slice depths,
# its skip of zero rows off or widened, and other kernels or layouts at the
# cuts of its C table; with out_f32 a build writes its f32 sums instead of
# rounding them to bf16 (for the precision lines)
STAGES = "constexpr int kStages = 4;"
DEPTH = "constexpr int kDepth = 32;"
FRESH = "constexpr int kFreshDepth = 16;"
SPARSE = "constexpr int kSparseRows = 2;"
SKIP = "    if (__popc(live) <= kLive) {"
TC = ("moe_gemm.cu", None, os.path.join(ROOT, "tools", "moe_gemm_mma.cu"))
FMA = ("moe_gemm.cu", None, os.path.join(ROOT, "tools", "moe_gemm_fma.cu"))


def out_f32(edits):
    """The edits that make a build of ``edits`` write its f32 sums."""
    fma = ("moe_gemm.cu", "      if (col < a.f) ob[row * a.o_sc + col] "
           "= rt::from_f<T>(acc[r][c]);",
           "      if (col < a.f) reinterpret_cast<float*>(a.out)[e * "
           "a.o_se + row * a.o_sc + col] = acc[r][c];")
    if TC in edits:
        return [("moe_gemm.cu", "          ob[row * a.o_sc + col] = "
                "__float2bfloat16(acc[m][n][i]);",
                "          reinterpret_cast<float*>(a.out)[e * a.o_se + "
                "row * a.o_sc + col] = acc[m][n][i];")]
    if FMA in edits:
        return [fma]
    # the shipped kernel: its ring and its 16-row tile (C 9-15)
    return [fma, ("moe_gemm.cu", "      if (cc < a.f) ob[row * a.o_sc + cc]"
                  " = rt::from_f<T>(acc[r][j]);",
                  "      if (cc < a.f) reinterpret_cast<float*>(a.out)[e * "
                  "a.o_se + row * a.o_sc + cc] = acc[r][j];")]


MOE_FORMS = [  # precision, time and the MoE serve's tokens
    ("replaced FMA kernel", [FMA]),
    ("tensor cores, each 16 deep rounded into the sum", [TC]),
    ("tensor cores, each 32 deep rounded into the sum", [
        TC, ("moe_gemm.cu", FRESH, "constexpr int kFreshDepth = 32;")]),
    ("tensor cores, straight into the sum", [
        TC, ("moe_gemm.cu", FRESH, "constexpr int kFreshDepth = 0;")])]
# a line of the shipped kernel's C-tile table (launch_c), and the same C
# at another layout: R rows a warp, G groups, CW columns a lane
C15 = "  if (a.C < 16) return launch_tile<T>(a, E, st);"
C16 = "  if (a.C == 16) return launch<T, 8, 2, 2>(a, E, st);"
C24 = "  if (a.C <= 24) return launch<T, 8, 3, 4>(a, E, st);"
C48 = "  if (a.C <= 48) return launch<T, 8, 6, 2>(a, E, st);"


def layout(line, r, g, cw):
    """The edit that sends ``line``'s C to layout (r, g, cw)."""
    return ("moe_gemm.cu", line,
            line.split("return")[0] + f"return launch<T, {r}, {g}, {cw}>"
            "(a, E, st);")


MOE_VARIANTS = [  # the ring's stages and depth, the zero-row skip, the
    # C-tile layouts; the replaced kernel's slice depth; the tensor-core ring
    ("ring, 2 stages", [("moe_gemm.cu", STAGES, "constexpr int kStages = 2;")]),
    ("ring, 3 stages", [("moe_gemm.cu", STAGES, "constexpr int kStages = 3;")]),
    ("ring, 6 stages", [("moe_gemm.cu", STAGES, "constexpr int kStages = 6;")]),
    ("ring, 8 stages", [("moe_gemm.cu", STAGES, "constexpr int kStages = 8;")]),
    ("ring, 16-deep slices, 8 stages", [
        ("moe_gemm.cu", DEPTH, "constexpr int kDepth = 16;"),
        ("moe_gemm.cu", STAGES, "constexpr int kStages = 8;")]),
    ("ring, 64-deep slices", [
        ("moe_gemm.cu", DEPTH, "constexpr int kDepth = 64;")]),
    ("ring, 64-deep slices, 2 stages", [
        ("moe_gemm.cu", DEPTH, "constexpr int kDepth = 64;"),
        ("moe_gemm.cu", STAGES, "constexpr int kStages = 2;")]),
    ("ring, zero-row skip off", [("moe_gemm.cu", SKIP, "    if (false) {")]),
    ("ring, zero-row skip up to 4 rows at every R", [
        ("moe_gemm.cu", SKIP, "    if (__popc(live) <= 4) {")]),
    ("ring, zero-row skip up to 8 rows", [
        ("moe_gemm.cu", SKIP, "    if (__popc(live) <= 8) {")]),
    ("ring, zero-row skip below half the warp's rows", [
        ("moe_gemm.cu", SKIP, "    if (2 * __popc(live) < R) {")]),
    ("C 9-15 through the ring (2 groups of 8 rows)", [
        layout(C15, 8, 2, 2)]),
    ("C 17-24 at two columns a lane", [layout(C24, 8, 3, 2)]),
    ("ring, C 16 as one group of 16 rows", [layout(C16, 16, 1, 2)]),
    ("ring, C 16 at four columns a lane", [layout(C16, 8, 2, 4)]),
    ("ring, C 16 as four groups of 4 rows, four columns a lane", [
        layout(C16, 4, 4, 4)]),
    ("ring, C 42 at four columns a lane", [layout(C48, 8, 6, 4)]),
    ("ring, C 42 as three groups of 16 rows", [layout(C48, 16, 3, 2)]),
    ("replaced kernel, 32-deep bf16 slices", [  # bf16 only: f32's X slice
        FMA,
        ("moe_gemm.cu", "constexpr int kBD = 16;", "constexpr int kBD = 32;"),
        ("moe_gemm.cu", "  if (dtype == 0) launch_bc<float>(a, E, st);\n"
         "  else launch_bc",
         "  if (dtype == 0) return static_cast<int>(cudaErrorInvalidValue);\n"
         "  launch_bc")]),
    ("tensor cores, 2 stages", [
        TC, ("moe_gemm.cu", STAGES, "constexpr int kStages = 2;")]),
    ("tensor cores, 6 stages", [
        TC, ("moe_gemm.cu", STAGES, "constexpr int kStages = 6;")]),
    ("tensor cores, 64-deep slices", [
        TC, ("moe_gemm.cu", DEPTH, "constexpr int kDepth = 64;")])]
MOE = ("decode C=16 d=2048 f=1408", "decode down C=16 d=1408 f=2048",
       "prefill C=42 d=2048 f=1408", "single row C=1 d=2048 f=1408",
       cs.MOE_SERVED) + tuple(n for n, *_ in cs.MOE_ROUTED)
# knock-outs of the RG-LRU kernel's parts (wrong results: timing only)
RGLRU_PARTS = [
    ("no wait for the earlier chunks' pairs", [NO_WAIT]),
    ("no re-run of the chunk (outputs from the carry)", [
        ("rglru_scan.cu", "      h = av[i] * h + uv[i];\n      if (ok) ob",
         "      if (ok) ob")])]
RGLRU_CHUNKS = (8, 16, 32)  # chunk lengths timed, kL patched
RGLRU_L = "constexpr int kL = 16;"


def log(*a):
    print(*a, flush=True)


def by_name(cases, names):
    return [c for c in cases if c[0] in names]


def decode_sweep(gen):
    from repro_torch.kernels import ops
    for name, args, kw, _ in by_name(cs.decode_cases(gen), DECODE):
        q, k, v, sp, cur = args
        S = kw["kv_limit"] or k.shape[1]
        out = torch.empty_like(q)
        res = []
        for n in SPLITS:
            if n > -(-S // ops.DECODE_TILE):
                continue
            parts = None if n == 1 else ops._empty_partials(
                q.shape[:2], n, q.shape[2], q.device)

            def fn():
                ops._decode_launch(q, k, v, sp, cur, kw["window"],
                                   kw["k_scale"], kw["v_scale"], S, n, out,
                                   parts)
            res.append(f"n{n} {cs.time_ms(fn):.4f}")
        log(f"[decode] {name:38s} takes n{cs.decode_splits_of(args, kw)}: "
            + "  ".join(res))


def pool_sweep(gen, tag="", cases=None):
    from repro_torch.kernels import ops
    for name, args, kw, _ in cases or by_name(cs.pool_cases(gen), POOL):
        q, k, v, pq, pk = args
        S = k.shape[2]
        res = []
        for n in SPLITS:
            if n > -(-S // ops.pool_tile(q.shape[-1])):
                continue

            def fn():
                return ops._pool_launch(q, k, v, pq, pk, kw["window"],
                                        kw["k_scale"], kw["v_scale"], S, n)
            res.append(f"n{n} {cs.time_ms(fn):.4f}")
        n0 = ops.pool_splits(q.shape[0], k.shape[1], q.shape[2], S,
                             q.shape[3], q.shape[1] // k.shape[1])
        log(f"[pool{tag}] {name:36s} takes n{n0}: " + "  ".join(res))


def flush_compare(gen):
    from repro_torch.kernels import ops
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def read_flushed(fn, reps=25):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            buf.max()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)
    for name, args, kw, int8 in by_name(cs.decode_cases(gen), DECODE[:4]):
        def fn():
            return ops.decode_attention(*args, **kw)
        line = (f"[flush] {name:38s} kernel: zero_ {cs.time_ms(fn):.4f} "
                f"read {read_flushed(fn):.4f}")
        if not int8:
            lib = cs._library_decode(*args, kw["window"], kw["kv_limit"])
            line += (f"; SDPA: zero_ {cs.time_ms(lib):.4f} read "
                     f"{read_flushed(lib):.4f}")
        log(line)


def _variant_dir(tag, edits):
    """A copy of the kernel sources in ``build/sweep/`` with ``edits``:
    (file, text, replacement), or (file, None, path) to put the file at
    ``path`` in its place."""
    from repro_torch.kernels import build
    d = os.path.join(ROOT, "build", "sweep", tag.replace(" ", "_")
                     .replace(",", "").replace("'", ""))
    if not os.path.isdir(d):
        shutil.copytree(build.CSRC, d)
        for fname, a, b in edits:
            p = os.path.join(d, fname)
            if a is None:
                shutil.copyfile(b, p)
                continue
            with open(p) as f:
                src = f.read()
            if a not in src:
                raise AssertionError(f"{tag}: {a!r} not in {fname}")
            with open(p, "w") as f:
                f.write(src.replace(a, b))
    return d


def variant_libs(specs, name):
    """{tag: kernel ``name`` built from the copy of the sources with its
    edits (_variant_dir)} for each (tag, edits) of ``specs``, one ``nvcc``
    each, all started together."""
    from repro_torch.kernels import build
    procs = {}
    for tag, edits in specs:
        d = _variant_dir(tag, edits)
        so = os.path.join(d, f"{name}.so")
        procs[tag] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(d, f"{name}.cu")]), so)
    libs = {}
    for tag, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name} [{tag}]")
        lib = ctypes.CDLL(so)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = build.ARGTYPES[f"{name}_launch"]
        fn.restype = ctypes.c_int
        libs[tag] = lib
    return libs


def variant_lib(tag, edits, name="flash_attention_pool"):
    """Kernel ``name`` built from a copy of the sources with ``edits``
    (_variant_dir)."""
    return variant_libs([(tag, edits)], name)[tag]


def with_libs(libs, run):
    """``run()`` with the kernels of ``libs`` (name -> library) loaded."""
    from repro_torch.kernels import build
    real = {n: build.load(n) for n in libs}
    build._LIBS.update(libs)
    try:
        return run()
    finally:
        build._LIBS.update(real)


def variants(gen):
    cases = by_name(cs.pool_cases(gen), ("bf16 C=512", "bf16 C=16",
                                         "hd256 G=16 bf16 C=512 window=2048"))
    for tag, edits in VARIANTS:
        lib = variant_lib(tag, edits)
        with_libs({"flash_attention_pool": lib},
                  lambda: pool_sweep(gen, f" {tag}", cases))


def precision_libs():
    """(tag, {kernel name: library}) for the kernels as they are and for
    each precision variant."""
    out = [("as built", {})]
    for tag, edits in PRECISION:
        out.append((tag, {n: variant_lib(tag, edits, n) for n in
                          ("decode_attention", "flash_attention_pool")}))
    return out


def _rel(got, want):
    """Mean signed and RMS error of ``got`` against float64 ``want``,
    relative to mean |want|."""
    e = got.double() - want
    scale = want.abs().mean().item()
    return (f"mean {(e * want.sign()).mean().item() / scale:+.2e} rms "
            f"{e.pow(2).mean().sqrt().item() / scale:.2e}")


def _dense(q, k, v, sp, cur, window, kv_limit, dtype):
    """The decode function computed densely in ``dtype``."""
    S = kv_limit or k.shape[1]
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.to(dtype).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k[:, :S].to(dtype)) / hd ** 0.5
    spp, c = sp[:, :S], cur[:, None]
    ok = (spp >= 0) & (spp <= c)
    if window is not None:
        ok &= spp > c - window
    s = torch.where(ok[:, None, None], s, -1e30)
    return torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1),
                        v[:, :S].to(dtype)).reshape(B, Hq, hd)


def precision(gen, libs):
    from repro_torch.kernels import ops
    cases = by_name(cs.decode_cases(gen), (
        "bf16 kvl=2048", "G=1 bf16 kvl=2048",
        "hd256 G=16 bf16 kvl=2048 window=2048"))

    for name, args, kw, _ in cases:
        want = _dense(*args, kw["window"], kw["kv_limit"], torch.float64)
        plain = _dense(*args, kw["window"], kw["kv_limit"], torch.float32)
        res = [f"plain f32 {_rel(plain, want)}"]
        for tag, lib in libs:
            def run():
                _, l, acc = ops.decode_attention_partials(*args, n_split=1,
                                                          **kw)
                return acc[:, :, 0] / l[:, :, 0, None]
            res.append(f"{tag} {_rel(with_libs(lib, run), want)}")
        log(f"[precision] {name:38s} " + "; ".join(res))
    timed = by_name(cs.pool_cases(gen), ("bf16 C=512",)) + by_name(
        cs.decode_cases(gen), ("bf16 kvl=2048",))
    for tag, lib in libs:
        res = []
        for name, args, kw, _ in timed:
            fn = (ops.flash_attention_pool if name.startswith("bf16 C")
                  else ops.decode_attention)
            ms = with_libs(lib, lambda: cs.time_ms(lambda: fn(*args, **kw)))
            res.append(f"{name} {ms:.4f} ms")
        log(f"[precision] {tag}: " + ", ".join(res))


def gaps(libs):
    import numpy as np
    cfg, params = cs._init(cs.MOE_ARCH)
    for tag, lib in libs:
        def run():
            flows = cs.make_flows(cfg, 6, cs.OUT_TOKENS,
                                  np.random.default_rng(cs.SEED))
            eng, _, _, _, _, chunks = cs.serve(cfg, params, flows,
                                               device="cuda",
                                               dtype=torch.bfloat16)
            served = {f["id"]: eng.output_tokens(f["id"]) for f in flows}
            worst, past = 0.0, 0
            exact = total = 0
            for f in flows:
                steps = cs._teacher_forced(cfg, params, f, served[f["id"]],
                                           chunks[f["id"]],
                                           dtype=torch.bfloat16,
                                           kv_dtype=None, backend="plain")
                for t, logits in zip(served[f["id"]], steps):
                    lg = logits[0].float()
                    gap = (lg.max() - lg[t]).item()
                    exact += int(gap == 0.0)
                    past += int(gap > cs.LOGIT_MARGIN)
                    total += 1
                    worst = max(worst, gap)
            del eng
            cs._release()
            return exact, total, past, worst
        exact, total, past, worst = with_libs(lib, run)
        log(f"[gaps] {cs.MOE_ARCH} bf16 serve, {tag}: {exact}/{total} exact "
            f"argmax, {past} past the margin {cs.LOGIT_MARGIN}, largest gap "
            f"{worst:.4f}")


# sound variants of the WKV6 kernel's arithmetic, for the rwkv6 serve's
# bf16 gate: L kept as (hi, lo) pairs (tools/rwkv6_scan_pair_l.cu, built in
# place of rwkv6_scan.cu), and exp2 to libdevice's precision
PAIR_L = ("rwkv6_scan.cu", None,
          os.path.join(ROOT, "tools", "rwkv6_scan_pair_l.cu"))
EX2F = ("rwkv6_scan.cu", """  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;""", "  return exp2f(x);")
RWKV_FORMS = [("L as (hi, lo) pairs", [PAIR_L]), ("exp2f", [EX2F])]


def rwkv6_gate():
    """The rwkv6-1.6b serve of chip_smoke.py through the WKV6 kernel as
    built and through each of RWKV_FORMS: in bf16 the kernel path's largest
    gap under the plain path and the plain path's own noise floor on the
    same served tokens (chip_smoke.bf16_gate's two numbers), and the f32
    serve's tokens (chip_smoke.f32_token_check's)."""
    import numpy as np
    from repro_torch.models import init_params
    libs = [("as built", None)] + list(variant_libs(
        [(f"rwkv6 {t}", e) for t, e in RWKV_FORMS], "rwkv6_scan").items())
    cfg, params = cs._init(cs.RWKV_ARCH)
    params32 = init_params(cfg, seed=cs.SEED, dtype=torch.float32,
                           device="cuda")
    for tag, lib in libs:
        def run():
            out = {}
            for dtype, p in ((torch.bfloat16, params),
                             (torch.float32, params32)):
                flows = cs.make_flows(cfg, 6, cs.OUT_TOKENS,
                                      np.random.default_rng(cs.SEED))
                eng, _, _, _, _, chunks = cs.serve(cfg, p, flows,
                                                   device="cuda",
                                                   dtype=dtype)
                exact, total, worst = cs.plain_check(
                    cfg, p, eng, flows, chunks, dtype=dtype, gate=False)
                floor = cs.plain_disagreement(cfg, params, params32, eng,
                                              flows, chunks)[0] \
                    if dtype == torch.bfloat16 else None
                out[dtype] = (exact, total, worst, floor)
                del eng
                cs._release()
            return out
        out = with_libs({"rwkv6_scan": lib} if lib else {}, run)
        e, n, worst, floor = out[torch.bfloat16]
        e32, n32, worst32, _ = out[torch.float32]
        log(f"[rwkv6_gate] {tag}: bf16 {e}/{n} exact, largest gap "
            f"{worst:.4f}, plain noise floor {floor:.4f} (gate "
            f"{floor + cs.LOGIT_MARGIN:.4f}: "
            + ("held" if worst <= floor + cs.LOGIT_MARGIN else "missed")
            + f"); f32 {e32}/{n32} exact, largest gap {worst32:.4f} (margin "
            f"{cs.LOGIT_MARGIN})")


def _bwd64(q, k, v, d_out, window):
    """dq, dk, dv of causal (windowed) GQA attention in float64."""
    hd, G = q.shape[-1], q.shape[1] // k.shape[1]
    qd, dod = q.double(), d_out.double()
    kd, vd = (x.double().repeat_interleave(G, 1) for x in (k, v))
    ok = cs.flash_mask(q.shape[2], k.shape[2], window)
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) / hd ** 0.5
    p = torch.softmax(torch.where(ok, s, -1e30), -1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vd)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dod, vd)
              - (dod * out).sum(-1, keepdim=True))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qd) / hd ** 0.5
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dod)
    B, Hkv, Skv = k.shape[:3]
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kd) / hd ** 0.5,
            dk.reshape(B, Hkv, G, Skv, hd).sum(2),
            dv.reshape(B, Hkv, G, Skv, hd).sum(2))


def bwd_precision(gen):
    from repro_torch.kernels import ops, ref
    name, (q, k, v, d_out), kw = cs.flash_cases(gen)[0]
    window = kw["window"]
    out, lse = ref.flash_attention_lse(q, k, v, window=window)
    args = (q, k, v, out, lse, d_out)
    want = _bwd64(q, k, v, d_out, window)

    def line(tag, fn, reps=25):
        grads = fn()
        errs = "; ".join(f"{n} {_rel(g, w)}" for n, g, w in
                         zip(("dq", "dk", "dv"), grads, want))
        log(f"[bwd_precision] {name} {tag}: {errs}; "
            f"{cs.time_ms(fn, reps=reps):.4f} ms")
    line("plain f32", lambda: ref.flash_attention_bwd(*args, window=window),
         reps=10)
    libs = [("as built (3xTF32)", {})] + [
        (tag, {"flash_attention_bwd": variant_lib(tag, edits,
                                                  "flash_attention_bwd")})
        for tag, edits in BWD_VARIANTS]
    for tag, lib in libs:
        with_libs(lib, lambda: line(tag, lambda: ops.flash_attention_bwd(
            *args, window=window)))
    for tag, edits in BWD_PARTS:  # where the time goes
        lib = variant_lib(tag, edits, "flash_attention_bwd")
        ms = with_libs({"flash_attention_bwd": lib}, lambda: cs.time_ms(
            lambda: ops.flash_attention_bwd(*args, window=window)))
        log(f"[bwd_precision] {name} {tag} (timing only): {ms:.4f} ms")
    _, rows, _ = cs._device_times(lambda: ops.flash_attention_bwd(
        *args, window=window))
    log(f"[bwd_precision] {name} as built, by kernel: " + "; ".join(
        f"{k[:40]} {ms:.4f} ms" for k, ms in rows if "flash" in k))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = cs._sdpa(qg, kg, vg, window)
    ms = cs.time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), d_out,
                                                retain_graph=True))
    log(f"[bwd_precision] {name} SDPA backward: {ms:.4f} ms")


def _fwd64(q, k, v, window):
    """out and lse of causal (windowed) GQA attention in float64."""
    hd, G = q.shape[-1], q.shape[1] // k.shape[1]
    kd, vd = (x.double().repeat_interleave(G, 1) for x in (k, v))
    ok = cs.flash_mask(q.shape[2], k.shape[2], window)
    s = torch.where(ok, torch.einsum("bhqd,bhkd->bhqk", q.double(), kd)
                    / hd ** 0.5, -1e30)
    return (torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vd),
            torch.logsumexp(s, -1))


def fwd_precision(gen):
    from repro_torch.kernels import ops, ref
    name, (q, k, v, _), kw = cs.flash_cases(gen)[0]
    window = kw["window"]
    want, want_lse = _fwd64(q, k, v, window)

    def line(tag, fn, reps=25):
        out, lse = fn()
        log(f"[fwd_precision] {name} {tag}: out {_rel(out, want)}; lse "
            f"{_rel(lse, want_lse)}; {cs.time_ms(fn, reps=reps):.4f} ms")

    def kernel():
        return ops.flash_attention(q, k, v, window=window, return_lse=True)
    line("plain f32", lambda: ref.flash_attention_lse(q, k, v, window=window),
         reps=10)
    libs = variant_libs([(f"fwd {t}", e) for t, e in FWD_VARIANTS
                         + FWD_PARTS], "flash_attention")
    line("as built (3xTF32)", kernel)
    for tag, _ in FWD_VARIANTS:
        with_libs({"flash_attention": libs[f"fwd {tag}"]},
                  lambda: line(tag, kernel))
    for tag, _ in FWD_PARTS:  # where the time goes
        ms = with_libs({"flash_attention": libs[f"fwd {tag}"]},
                       lambda: cs.time_ms(kernel))
        log(f"[fwd_precision] {name} {tag} (timing only): {ms:.4f} ms")
    log(f"[fwd_precision] {name} SDPA forward: "
        f"{cs.time_ms(lambda: cs._sdpa(q, k, v, window)):.4f} ms")


def _wkv64(r, k, v, w, u, s0):
    """Per-token WKV6 in float64 on (BH, S, D) inputs: (out, state)."""
    r, k, v, w, u, st = (x.double() for x in (r, k, v, w, u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bd,bde->be", r[:, t],
                                 st + u[:, 0, :, None] * kv))
        st = st * torch.exp(w[:, t])[..., None] + kv
    return torch.stack(outs, 1), st


def rwkv6_precision(gen):
    """Max abs error against float64 (relative to the largest |value|) of
    out and the final state at B H 32, S 512, D 64, f32, with every third
    token's log decay at -20 (strong) or every log decay near -1e-3 (weak):
    the kernel as built and with L as (hi, lo) pairs, the per-token plain
    version (ref.rwkv6_scan) and the chunked plain form the model's plain
    path runs (models/ssm.py rwkv6_scan_chunked)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm
    pair = variant_libs([(f"rwkv6 {RWKV_FORMS[0][0]}", RWKV_FORMS[0][1])],
                        "rwkv6_scan")
    BH, S, D = 32, 512, 64

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    for decay in ("strong", "weak"):
        r, k, v = (randn(1, BH, S, D, scale=0.5) for _ in range(3))
        w = -torch.exp(randn(1, BH, S, D, scale=0.5))
        if decay == "strong":
            w[:, :, ::3] = -20.0
        else:
            w = w * 1e-3
        u, s0 = randn(1, BH, 1, D, scale=0.3), randn(1, BH, D, D, scale=0.3)
        want = _wkv64(r[0], k[0], v[0], w[0], u[0], s0[0])
        forms = {
            "kernel": lambda: ops.rwkv6_scan(r, k, v, w, u, s0),
            "kernel, L as (hi, lo) pairs": lambda: with_libs(
                {"rwkv6_scan": next(iter(pair.values()))},
                lambda: ops.rwkv6_scan(r, k, v, w, u, s0)),
            "per-token plain": lambda: ref.rwkv6_scan(r, k, v, w, u, s0),
            "chunked plain": lambda: ssm.rwkv6_scan_chunked(
                r, k, v, w, u[0, :, 0], s0)}
        res = []
        for tag, fn in forms.items():
            o, st = fn()
            errs = [((g[0].double() - x).abs().max() / x.abs().max()).item()
                    for g, x in ((o, want[0]), (st, want[1]))]
            res.append(f"{tag} out {errs[0]:.2e} state {errs[1]:.2e}")
        log(f"[rwkv6_precision] {decay} decay: " + "; ".join(res))


def rwkv6_sweep(gen):
    from repro_torch.kernels import ops
    cases = [(n, a) for n, a, _, _ in cs.rwkv6_cases(gen)]
    libs = variant_libs(RWKV_VARIANTS + RWKV_PARTS, "rwkv6_scan")
    parts = {t for t, _ in RWKV_PARTS}
    for tag, lib in [("as built", None)] + list(libs.items()):
        res = with_libs({"rwkv6_scan": lib} if lib else {}, lambda: [
            f"{n} {cs.time_ms(lambda: ops.rwkv6_scan(*a)):.4f}"
            for n, a in cases])
        log(f"[rwkv6] {tag}" + (" (timing only)" if tag in parts else "")
            + ": " + "; ".join(res) + " ms")
    for n, a in cases:
        _, rows, _ = cs._device_times(lambda: ops.rwkv6_scan(*a))
        log(f"[rwkv6] {n} as built, by kernel: " + "; ".join(
            f"{k[:40]} {ms:.4f} ms" for k, ms in rows if "wkv6" in k))


def _moe_f32(lib, x, w):
    """The bf16 expert GEMM of ``lib`` (an out_f32 build) on x, w: its f32
    sums (E, C, f)."""
    from repro_torch.kernels import ops
    out, rc = ops.moe_gemm_with(lib, x, w, torch.float32)
    if rc != 0:
        raise RuntimeError(f"moe_gemm_launch: cudaError {rc}")
    return out


def moe_sweep(gen):
    from repro_torch.kernels import ops, ref
    cases = [(n, a) for n, a, _, _ in by_name(cs.moe_cases(gen), MOE)]
    forms = [("as built", [])] + MOE_FORMS
    f32_libs = variant_libs([(f"{tag} f32 out", edits + out_f32(edits))
                             for tag, edits in forms], "moe_gemm")
    libs = [("as built", {})] + [
        (tag, {"moe_gemm": lib}) for tag, lib in variant_libs(
            MOE_FORMS + MOE_VARIANTS, "moe_gemm").items()]
    # precision: f32 sums against float64, bf16 outputs that differ from
    # the plain version's and from the replaced kernel's
    for n, (x, w) in cases:
        want = torch.einsum("ecd,edf->ecf", x.double(), w.double())
        plain = ref.moe_gemm(x, w)
        fma = with_libs(libs[1][1], lambda: ops.moe_gemm(x, w))
        f32 = torch.einsum("ecd,edf->ecf", x.float(), w.float())
        res = [f"plain f32 {_rel(f32, want)}"]
        for (tag, lib), (_, f32_lib) in zip(libs, f32_libs.items()):
            f32 = _moe_f32(f32_lib, x, w)
            out = with_libs(lib, lambda: ops.moe_gemm(x, w))
            res.append(f"{tag} {_rel(f32, want)}, bf16 != plain "
                       f"{(out != plain).float().mean().item():.2e}, != "
                       f"replaced {(out != fma).float().mean().item():.2e}")
        log(f"[moe_precision] {n}: " + "; ".join(res))
    log("[moe] torch.bmm: " + "; ".join(
        f"{n} {cs.time_ms(lambda: torch.bmm(*a)):.4f}" for n, a in cases)
        + " ms")
    for tag, lib in libs:
        res = with_libs(lib, lambda: [
            f"{n} {cs.time_ms(lambda: ops.moe_gemm(*a)):.4f}"
            for n, a in cases])
        log(f"[moe] {tag}: " + "; ".join(res) + " ms")
    for n, a in cases:
        _, rows, _ = cs._device_times(lambda: ops.moe_gemm(*a))
        log(f"[moe] {n} as built, by kernel: " + "; ".join(
            f"{k[:50]} {ms:.4f} ms" for k, ms in rows if "moe" in k))


def moe_gaps():
    """The MoE serve's tokens (as ``gaps``) through the kernel as built and
    the tensor-core forms (the replaced kernel's are the same bits)."""
    gaps([("as built", {})] + [
        (tag, {"moe_gemm": lib}) for tag, lib in variant_libs(
            MOE_FORMS[1:], "moe_gemm").items()])


def _rglru64(x, a_log, gate, h0):
    """Per-step RG-LRU in float64: (h, h_final)."""
    a = torch.exp(a_log.double())
    u = torch.sqrt(torch.clamp_min(1 - a * a, 0)) * (gate.double()
                                                     * x.double())
    h, hs = h0.double(), []
    for t in range(x.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


def with_chunk(L, lib, run):
    """``run()`` with the RG-LRU kernel built for chunks of ``L`` tokens
    (``lib``; None: as built), the wrapper sizing its scratch and flags by
    ``L``."""
    from repro_torch.kernels import ops
    real = ops.RGLRU_CHUNK
    ops.RGLRU_CHUNK = L
    try:
        return with_libs({"rglru_scan": lib} if lib else {}, run)
    finally:
        ops.RGLRU_CHUNK = real


def rglru_sweep(gen):
    """The RG-LRU scan at chip_smoke.py's cases (recurrentgemma-9b's 512-
    and 128-token prefills of one row, a decode step at B 16, 300 tokens):
    the times at each chunk length (builds with kL patched), and with
    knock-outs of the kernel's parts at the shipped length (timing only);
    each case's device time by kernel; then the max abs error against
    float64 (relative to the largest |value|) of h and h_final, f32 inputs
    at B 1, S 512, W 4096, with the serve's decays (a_log = -6.4 sigmoid),
    log decays near -8 and near 0: the kernel at each chunk length and the
    per-step plain version."""
    from repro_torch.kernels import ops, ref
    cases = [(n, a) for n, a, _, _ in cs.rglru_cases(gen)]
    libs = variant_libs([(f"rglru chunk {L}", [(
        "rglru_scan.cu", RGLRU_L, f"constexpr int kL = {L};")])
        for L in RGLRU_CHUNKS if L != ops.RGLRU_CHUNK], "rglru_scan")
    chunks = {L: libs.get(f"rglru chunk {L}") for L in RGLRU_CHUNKS}
    for L, lib in chunks.items():
        log(f"[rglru] chunk {L}" + (" (shipped)" if lib is None else "")
            + ": " + "; ".join(with_chunk(L, lib, lambda: [
                f"{n} {cs.time_ms(lambda: ops.rglru_scan(*a)):.4f}"
                for n, a in cases])) + " ms")
    for tag, lib in variant_libs(RGLRU_PARTS, "rglru_scan").items():
        res = with_libs({"rglru_scan": lib}, lambda: [
            f"{n} {cs.time_ms(lambda: ops.rglru_scan(*a)):.4f}"
            for n, a in cases])
        log(f"[rglru] {tag} (timing only): " + "; ".join(res) + " ms")
    for n, a in cases:
        _, rows, _ = cs._device_times(lambda: ops.rglru_scan(*a))
        log(f"[rglru] {n} as built, by kernel: " + "; ".join(
            f"{k[:40]} {ms:.4f} ms" for k, ms in rows if "rglru" in k))
    B, S, W = 1, 512, 4096

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    for decay in ("served", "strong", "weak"):
        x, gate, h0 = randn(B, S, W), torch.sigmoid(randn(B, S, W)), \
            randn(B, W)
        a_log = -6.4 * torch.sigmoid(randn(B, S, W))
        if decay == "strong":
            a_log = a_log * 1e-3 - 8.0
        elif decay == "weak":
            a_log = a_log * 1e-4
        want = _rglru64(x, a_log, gate, h0)
        args = (x, a_log, gate, h0)
        forms = {f"kernel chunk {L}": lambda L=L, lib=lib: with_chunk(
            L, lib, lambda: ops.rglru_scan(*args))
            for L, lib in chunks.items()}
        forms["per-step plain"] = lambda: ref.rglru_scan(*args)
        res = []
        for tag, fn in forms.items():
            errs = [((g.double() - t).abs().max() / t.abs().max()).item()
                    for g, t in zip(fn(), want)]
            res.append(f"{tag} h {errs[0]:.2e} h_final {errs[1]:.2e}")
        log(f"[rglru_precision] {decay} decay: " + "; ".join(res))


SECTIONS = ("decode", "pool", "flush", "variants", "precision", "gaps",
            "bwd_precision", "fwd_precision", "moe", "moe_gaps", "rglru",
            "rwkv6", "rwkv6_gate")


def main(argv=None):
    want = (argv if argv is not None else sys.argv[1:]) or SECTIONS
    smi = cs.device_phase()
    from repro_torch.kernels import build
    build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    if "decode" in want:
        decode_sweep(gen)
    if "pool" in want:
        pool_sweep(gen)
    if "flush" in want:
        flush_compare(gen)
    if "variants" in want:
        variants(gen)
    if "precision" in want or "gaps" in want:
        libs = precision_libs()
        if "precision" in want:
            precision(gen, libs)
        if "gaps" in want:
            gaps(libs)
    if "bwd_precision" in want:
        bwd_precision(gen)
    if "fwd_precision" in want:
        fwd_precision(gen)
    if "moe" in want:
        moe_sweep(gen)
    if "moe_gaps" in want:
        moe_gaps()
    if "rglru" in want:
        rglru_sweep(gen)
    if "rwkv6" in want:
        rwkv6_sweep(gen)
        rwkv6_precision(gen)
    if "rwkv6_gate" in want:
        rwkv6_gate()
    log(smi)


if __name__ == "__main__":
    main()
