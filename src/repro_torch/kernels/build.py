"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared libraries,
loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use, for ``sm_90a`` (Hopper),
into ``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed
by a hash of the sources (the ``.cu`` and the shared ``.cuh`` headers), so
an edited source rebuilds and an unchanged one is loaded as built.  Nothing
is built or imported when this module is imported.  A failed build raises.
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
KERNELS = ("decode_attention", "flash_attention_pool", "moe_gemm")
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
        [_I] * 8 + [_F]
        + [_P, _L, _L]              # q
        + [_P, _L, _L, _L] * 2      # k, v
        + [_P, _L, _L, _L] * 2      # k_scale, v_scale
        + [_P, _L, _L]              # slot_pos
        + [_P, _L]                  # cur_pos
        + [_P, _L, _L]              # out
        + [_P],                     # stream
    "flash_attention_pool_launch":
        [_I] * 9 + [_F]
        + [_P, _L, _L, _L] * 3      # q, k, v
        + [_P, _L, _L, _L] * 2      # k_scale, v_scale
        + [_P, _L, _L] * 2          # pos_q, pos_kv
        + [_P, _L, _L, _L]          # out
        + [_P],                     # stream
    "moe_gemm_launch":
        [_I] * 5
        + [_P, _L, _L] * 3          # x, w, out
        + [_I, _I]                  # x_vec, w_vec
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


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns each compiled kernel's build
    seconds (an already built one is absent).  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ARGTYPES[f"{name}_launch"]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
