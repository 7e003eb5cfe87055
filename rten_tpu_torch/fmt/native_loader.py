"""ctypes bridge to the native C++ container reader
(native/rten_reader.cpp): parses header + FlatBuffers graph in C++,
returns node metadata as JSON; Python materializes zero-copy numpy views
for tensor data and re-decodes (tiny) attrs tables with the schema layer.

A copy of ``rten_tpu/fmt/native_loader.py`` that builds the same source
into a library of the port's own, ``rten_tpu_torch/build/native/``
(gitignored). Falls back silently when the library hasn't been built;
build it on demand with :func:`build`.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SOURCE = os.path.join(_ROOT, "native", "rten_reader.cpp")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "build", "native")
_LIB_PATH = os.path.join(_LIB_DIR, "librten_reader.so")

_lib = None


def build(force=False) -> bool:
    """Compile the native reader (requires g++). Returns success."""
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


def available(auto_build=True) -> bool:
    global _lib
    if _lib is not None:
        return True
    if not os.path.exists(_LIB_PATH):
        if not (auto_build and build()):
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.rten_read_model.restype = ctypes.c_void_p
        lib.rten_read_model.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rten_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return True
    except OSError:
        return False


def read_model_json(buf) -> dict:
    """Parse container bytes via the native reader (zero-copy: an mmap or
    bytes buffer is handed to C++ by pointer)."""
    if not available():
        raise RuntimeError("native reader not available")
    arr = np.frombuffer(buf, dtype=np.uint8)
    ptr = _lib.rten_read_model(
        arr.ctypes.data_as(ctypes.c_char_p), arr.size)
    try:
        out = ctypes.string_at(ptr).decode("utf-8")
    finally:
        _lib.rten_free(ptr)
    parsed = json.loads(out)
    if "error" in parsed:
        raise ValueError(f"native reader: {parsed['error']}")
    return parsed


def graph_from_native(buf, parsed: dict):
    """Build a Graph IR from the native reader's output (the fast analog
    of ``ir.graph.graph_from_model_file``)."""
    from ..ir.graph import Graph
    from . import container, schema

    raw = np.frombuffer(buf, dtype=np.uint8)

    def build(graph_dict) -> Graph:
        g = Graph()
        for nd in graph_dict.get("nodes", []):
            name = nd.get("name")
            kind = nd.get("kind", 0)
            data = nd.get("data")
            if kind == 3:      # ValueNode
                shape = data.get("shape") if data else None
                g.add_value(name, shape)
            elif kind == 2:    # ConstantNode
                g.add_constant(name, _constant_array(data))
            elif kind == 1:    # OperatorNode
                op_type = schema.OP_TYPES[data["type"]]
                attrs = {}
                subgraphs = {}
                attrs_type = data.get("attrs_type")
                if attrs_type:
                    member = schema.UNIONS["OperatorAttrs"][attrs_type - 1]
                    attrs = schema.read_table(buf, data["attrs_pos"], member)
                    for key in ("then_branch", "else_branch"):
                        sub = attrs.pop(key, None)
                        if isinstance(sub, dict):
                            # Subgraph decoded by the schema layer; convert
                            # through the Python IR builder.
                            from ..ir.graph import graph_from_model_file
                            mf = container.ModelFile(
                                {"graph": sub}, buf,
                                _tensor_offset(buf))
                            subgraphs[key] = graph_from_model_file(mf)
                inputs = [None if i < 0 else int(i)
                          for i in data.get("inputs", [])]
                outputs = [None if o < 0 else int(o)
                           for o in data.get("outputs", [])]
                g.add_operator(name, op_type, inputs, outputs, attrs,
                               subgraphs)
            else:
                g.add_value(name, None)
        g.inputs = [int(i) for i in graph_dict.get("inputs", [])]
        g.outputs = [int(o) for o in graph_dict.get("outputs", [])]
        g.captures = [int(c) for c in graph_dict.get("captures", [])]
        return g

    def _constant_array(data) -> np.ndarray:
        shape = tuple(int(d) for d in data.get("shape", []))
        n = int(np.prod(shape)) if shape else 1
        dtype_code = data.get("dtype")
        if "data_offset" in data:
            np_dtype = container._NP_BY_DTYPE[dtype_code]
            return np.frombuffer(buf, dtype=np_dtype, count=n,
                                 offset=data["data_offset"]).reshape(shape)
        kind = data.get("inline_kind")
        if kind is None:
            raise ValueError("constant without data")
        np_dtype = np.float32 if kind == 1 else np.int32
        return np.frombuffer(buf, dtype=np_dtype,
                             count=data["inline_len"],
                             offset=data["inline_offset"]).reshape(shape)

    return build(parsed["graph"])


def _tensor_offset(buf) -> int:
    from .header import Header, detect_version
    if detect_version(buf) == 2:
        return Header.from_buf(buf).tensor_data_offset
    return 0
