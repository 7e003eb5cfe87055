"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` at first use, then
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
All sources are compiled by parallel ``nvcc`` processes. Nothing here runs
at import time: the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("decode_attn_int8_tail", "head_argmax_int8", "tail_flush_int8",
           "matmul_int8_wo")
# No -use_fast_math: the flush must reproduce IEEE division and
# round-half-even bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(verbose=False) -> float:
    """Compile every stale source, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises on any failure."""
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, BUILD_DIR / f"lib{name}.so")
        if verbose:
            print(f"[nvcc {name}]\n{out.strip()}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib_name: str, symbol: str, argtypes: str):
    """The C function ``symbol`` of ``lib<lib_name>.so``, building the
    kernels first if needed. ``argtypes`` spells the C signature, one
    letter per argument: ``p`` a pointer or the stream (``c_void_p``, so
    no 64-bit value is cut to an int), ``i`` an int, ``f`` a float. The C
    function returns ``cudaGetLastError()``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    if lib_name not in _LIBS:
        build_all()
        _LIBS[lib_name] = ctypes.CDLL(str(BUILD_DIR / f"lib{lib_name}.so"))
    fn = getattr(_LIBS[lib_name], symbol)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in argtypes]
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """The wrappers' dispatch rule: True when every tensor lies on the CPU
    (the plain version runs), False when every tensor lies on CUDA (the
    kernel launches). Anything else raises; there is no fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: tensors must all lie on the CPU or all on "
                     f"CUDA, got {sorted(kinds)}")


def require(cond: bool, name: str, what: str):
    if not cond:
        raise ValueError(f"{name}: {what}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
