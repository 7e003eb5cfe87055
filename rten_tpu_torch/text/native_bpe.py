"""ctypes bridge to the C++ BPE merge loop (native/bpe_encoder.cpp).

Token strings are interned to int32 ids; the merge table maps id pairs to
the merged token's id by rank. ``apply`` runs the full merge loop in C++.

A copy of ``rten_tpu/text/native_bpe.py`` that builds the same source into
a library of the port's own, ``rten_tpu_torch/build/native/`` (gitignored),
the way :mod:`rten_tpu_torch.fmt.native_loader` builds the reader: on first
use, never on import. :class:`NativeBpe` raises when the library cannot be
built, and the BPE model then keeps its Python merge loop.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SOURCE = os.path.join(_ROOT, "native", "bpe_encoder.cpp")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "build", "native")
_LIB_PATH = os.path.join(_LIB_DIR, "libbpe_encoder.so")


def build(force=False) -> bool:
    """Compile the merge loop (requires g++). Returns success."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        os.makedirs(_LIB_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-Wall",
                        "-shared", "-o", tmp, _SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def _load():
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_int32, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.bpe_apply.restype = ctypes.c_int32
    lib.bpe_apply.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int32, ctypes.c_void_p,
                              ctypes.c_int32]
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBpe:
    def __init__(self, merge_ranks: dict):
        if not build():
            raise FileNotFoundError(_LIB_PATH)
        self._lib = _load()
        self._intern: dict[str, int] = {}
        self._tokens: list[str] = []

        def intern(token: str) -> int:
            idx = self._intern.get(token)
            if idx is None:
                idx = len(self._tokens)
                self._intern[token] = idx
                self._tokens.append(token)
            return idx

        ordered = sorted(merge_ranks.items(), key=lambda kv: kv[1])
        left = np.asarray([intern(a) for (a, b), _ in ordered], np.int32)
        right = np.asarray([intern(b) for (a, b), _ in ordered], np.int32)
        merged = np.asarray([intern(a + b) for (a, b), _ in ordered],
                            np.int32)
        self._handle = self._lib.bpe_create(
            len(ordered), left.ctypes.data, right.ctypes.data,
            merged.ctypes.data)
        self._out = np.empty(512, np.int32)

    def apply(self, parts: list[str]) -> tuple[str, ...]:
        ids = np.empty(len(parts), np.int32)
        for i, part in enumerate(parts):
            idx = self._intern.get(part)
            if idx is None:
                # Symbol unknown to the merge table: it can never merge,
                # but must round-trip; intern it on the fly.
                idx = len(self._tokens)
                self._intern[part] = idx
                self._tokens.append(part)
            ids[i] = idx
        while True:
            n = self._lib.bpe_apply(self._handle, ids.ctypes.data,
                                    len(ids), self._out.ctypes.data,
                                    len(self._out))
            if n >= 0:
                break
            self._out = np.empty(-n, np.int32)
        return tuple(self._tokens[i] for i in self._out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                self._lib.bpe_destroy(self._handle)
            except Exception:
                pass
