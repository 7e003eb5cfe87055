"""Reading and writing the `.rten` container (header + FlatBuffers model
data + 64-byte-aligned tensor data segment).

Mirrors the behavior of the reference loader (``src/model.rs:265-522``) and
the converter's segment writer (``rten-convert/rten_convert/tensor_data.py``):
tensors referenced by ``data_offset`` are read zero-copy out of an mmap of
the file when alignment permits.
"""

from __future__ import annotations

import mmap
from dataclasses import dataclass

import numpy as np

from .header import HEADER_LEN, VERSION, Header, detect_version
from . import schema

TENSOR_ALIGN = 64

DTYPE_FLOAT32 = schema.ENUMS["ConstantDataType"].index("Float32")
DTYPE_INT32 = schema.ENUMS["ConstantDataType"].index("Int32")
DTYPE_INT8 = schema.ENUMS["ConstantDataType"].index("Int8")
DTYPE_UINT8 = schema.ENUMS["ConstantDataType"].index("UInt8")

_NP_BY_DTYPE = {DTYPE_FLOAT32: np.float32, DTYPE_INT32: np.int32,
                DTYPE_INT8: np.int8, DTYPE_UINT8: np.uint8}


@dataclass
class ModelFile:
    """A parsed `.rten` file: decoded model dict + raw tensor segment."""

    model: dict
    buf: object = None             # whole-file buffer (bytes or mmap)
    tensor_data_offset: int = 0

    def constant_array(self, const_node: dict) -> np.ndarray:
        """Materialize a ConstantNode's data as a numpy array (zero-copy
        from the underlying buffer where possible)."""
        shape = tuple(int(d) for d in (const_node["shape"] if const_node["shape"]
                                       is not None else []))
        n_elements = int(np.prod(shape, dtype=np.int64)) if shape else 1
        data_offset = const_node.get("data_offset")
        if data_offset is not None:
            dtype_code = const_node.get("dtype")
            if dtype_code is None:
                raise ValueError("constant with external data but no dtype")
            np_dtype = _NP_BY_DTYPE[dtype_code]
            start = self.tensor_data_offset + int(data_offset)
            arr = np.frombuffer(self.buf, dtype=np_dtype, count=n_elements,
                                offset=start)
            return arr.reshape(shape)
        data = const_node.get("data")
        if data is None:
            raise ValueError("constant node has neither inline nor external data")
        member, payload = data
        arr = np.asarray(payload["data"])
        return arr.reshape(shape)


def load_bytes(buf) -> ModelFile:
    version = detect_version(buf)
    if version == 2:
        header = Header.from_buf(buf)
        model = schema.read_model(buf, header.model_offset)
        return ModelFile(model, buf, header.tensor_data_offset)
    model = schema.read_model(buf, 0)
    return ModelFile(model, buf, 0)


def load_file(path, use_mmap=True) -> ModelFile:
    if use_mmap:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    else:
        with open(path, "rb") as f:
            buf = f.read()
    return load_bytes(buf)


class TensorDataBuilder:
    """Accumulates tensors for the external tensor-data segment; each
    tensor's data is aligned to 64 bytes relative to segment start."""

    def __init__(self):
        self.chunks: list[bytes] = []
        self.offset = 0

    def add(self, array: np.ndarray) -> int:
        if array.dtype not in (np.float32, np.int32, np.int8, np.uint8):
            raise ValueError(f"unsupported tensor dtype {array.dtype}")
        pad = (-self.offset) % TENSOR_ALIGN
        if pad:
            self.chunks.append(b"\x00" * pad)
            self.offset += pad
        start = self.offset
        data = np.ascontiguousarray(array).tobytes()
        self.chunks.append(data)
        self.offset += len(data)
        return start

    def to_bytes(self) -> bytes:
        return b"".join(self.chunks)


def save_bytes(model: dict, tensor_data: bytes = b"") -> bytes:
    """Serialize a model dict (+ optional external tensor segment) as a V2
    container."""
    model_data = schema.write_model(model)
    model_offset = HEADER_LEN
    # Tensor segment must be 64-byte-aligned in the file so that aligned
    # offsets within the segment stay aligned absolutely.
    end = model_offset + len(model_data)
    tensor_offset = 0
    pad = b""
    if tensor_data:
        tensor_offset = end + ((-end) % TENSOR_ALIGN)
        pad = b"\x00" * (tensor_offset - end)
    header = Header(VERSION, model_offset, len(model_data), tensor_offset)
    return header.to_bytes() + model_data + pad + tensor_data


def save_file(path, model: dict, tensor_data: bytes = b""):
    with open(path, "wb") as f:
        f.write(save_bytes(model, tensor_data))
