"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared libraries,
loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use, for ``sm_90a`` (Hopper),
into ``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed
by a hash of the sources (the ``.cu`` and the shared ``.cuh`` headers), so
an edited source rebuilds and an unchanged one is loaded as built.  A
variant kept outside ``csrc/`` (``tools/moe_gemm_fma.cu``, the expert GEMM
that the shipped one is held bitwise equal to) builds the same way, with
``csrc/`` on the include path (``build(variants=...)``, ``load_variant``).
Nothing is built or imported when this module is imported.  A failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_attention", "flash_attention_pool", "moe_gemm",
           "rglru_scan", "rwkv6_scan", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of each C entry point (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to an int)
ARGTYPES = {
    "decode_attention_launch":
        [_I] * 9 + [_F]
        + [_P, _L, _L]              # q
        + [_P, _L, _L, _L] * 2      # k, v
        + [_P, _L, _L, _L] * 2      # k_scale, v_scale
        + [_P, _L, _L]              # slot_pos
        + [_P, _L]                  # cur_pos
        + [_P, _L, _L]              # out
        + [_P, _P, _P]              # partials m, l, acc
        + [_P],                     # stream
    "flash_attention_pool_launch":
        [_I] * 10 + [_F]
        + [_P, _L, _L, _L] * 3      # q, k, v
        + [_P, _L, _L, _L] * 2      # k_scale, v_scale
        + [_P, _L, _L] * 2          # pos_q, pos_kv
        + [_P, _L, _L, _L]          # out
        + [_P, _P, _P]              # partials m, l, acc
        + [_P],                     # stream
    "moe_gemm_launch":
        [_I] * 5
        + [_P, _L, _L] * 3          # x, w, out
        + [_I, _I]                  # x_vec, w_vec
        + [_P],                     # stream
    "rglru_scan_launch":
        [_I] * 4
        + [_P, _L, _L] * 3          # x, a_log, gate
        + [_P, _L]                  # h0
        + [_P, _P, _P]              # out, h_final, scratch
        + [_P, _L, _P, _I]          # tile counter, tiles taken, flags, epoch
        + [_P],                     # stream
    "rwkv6_scan_launch":
        [_I] * 5
        + [_P, _L, _L, _L] * 4      # r, k, v, w_log
        + [_P, _L, _L]              # u
        + [_P, _L, _L, _L]          # state0
        + [_P, _L, _L, _L]          # out
        + [_P, _P]                  # state out, scratch
        + [_P, _L, _P, _I]          # tile counter, tiles taken, flags, epoch
        + [_I, _I]                  # u_f32, s0_vec
        + [_P],                     # stream
    "flash_attention_launch":
        [_I] * 9 + [_F]
        + [_P, _L, _L, _L] * 4      # q, k, v, out
        + [_P]                      # lse
        + [_P],                     # stream
    "flash_attention_bwd_launch":
        [_I] * 9 + [_F]
        + [_P, _L, _L, _L] * 4      # q, k, v, d_out
        + [_P, _P]                  # lse, delta
        + [_P, _L, _L, _L] * 3      # dq, dk, dv
        + [_P],                     # stream
}

_LIBS: Dict[str, ctypes.CDLL] = {}  # loaded once per process


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from source on the machine with the card")
    return found


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return variant_path(CSRC / f"{name}.cu")


def variant_path(src) -> Path:
    """Where the library built from source file ``src`` goes (a kernel's
    ``csrc/<name>.cu``, or a variant kept elsewhere that includes the
    ``csrc/`` headers)."""
    src = Path(src)
    return BUILD_DIR / f"{src.stem}-{_source_hash(src)}.so"


def build(names: Iterable[str] = KERNELS,
          variants: Iterable = ()) -> Dict[str, float]:
    """Compile every named kernel, and every variant source file in
    ``variants``, that is not built yet, one ``nvcc`` per source, all
    started together.  Returns each compiled source's build seconds (by
    kernel name, or a variant's file stem; an already built one is
    absent).  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {name: CSRC / f"{name}.cu" for name in names}
    jobs.update({Path(v).stem: Path(v) for v in variants})
    procs = {}
    t0 = time.perf_counter()
    for name, src in jobs.items():
        out = variant_path(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        secs[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def _open(path: Path, entry: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return lib


def load_variant(src, entry: str) -> ctypes.CDLL:
    """The library built from variant source ``src`` (built first if
    needed), its C entry point ``entry`` (one of ``ARGTYPES``) typed."""
    key = str(src)
    lib = _LIBS.get(key)
    if lib is None:
        path = variant_path(src)
        if not path.exists():
            build([], [src])
        lib = _LIBS[key] = _open(path, entry)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = _open(path, f"{name}_launch")
    return lib
