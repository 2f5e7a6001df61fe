"""Sweeps behind the serving attention kernels' tuning, on one NVIDIA GPU.

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
  exact argmax count, tokens past LOGIT_MARGIN, the largest gap.

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


def variant_lib(tag, edits, name="flash_attention_pool"):
    """Kernel ``name`` built from a copy of the sources with ``edits``."""
    from repro_torch.kernels import build
    d = os.path.join(ROOT, "build", "sweep", tag.replace(" ", "_")
                     .replace(",", ""))
    if not os.path.isdir(d):
        shutil.copytree(build.CSRC, d)
        for fname, a, b in edits:
            p = os.path.join(d, fname)
            with open(p) as f:
                src = f.read()
            if a not in src:
                raise AssertionError(f"{tag}: {a!r} not in {fname}")
            with open(p, "w") as f:
                f.write(src.replace(a, b))
    so = os.path.join(d, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(d, f"{name}.cu")], check=True)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = build.ARGTYPES[f"{name}_launch"]
    fn.restype = ctypes.c_int
    return lib


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

    def rel(got, want):
        e = got.double() - want
        scale = want.abs().mean().item()
        return (f"mean {(e * want.sign()).mean().item() / scale:+.2e} rms "
                f"{e.pow(2).mean().sqrt().item() / scale:.2e}")
    for name, args, kw, _ in cases:
        want = _dense(*args, kw["window"], kw["kv_limit"], torch.float64)
        plain = _dense(*args, kw["window"], kw["kv_limit"], torch.float32)
        res = [f"plain f32 {rel(plain, want)}"]
        for tag, lib in libs:
            def run():
                _, l, acc = ops.decode_attention_partials(*args, n_split=1,
                                                          **kw)
                return acc[:, :, 0] / l[:, :, 0, None]
            res.append(f"{tag} {rel(with_libs(lib, run), want)}")
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


SECTIONS = ("decode", "pool", "flush", "variants", "precision", "gaps")


def main(argv=None):
    want = (argv if argv is not None else sys.argv[1:]) or SECTIONS
    smi = cs.device_phase()
    from repro_torch.kernels import build
    build.build(["decode_attention", "flash_attention_pool"])
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
    log(smi)


if __name__ == "__main__":
    main()
