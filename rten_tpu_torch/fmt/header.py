"""RTen V2 container header.

Layout (32 bytes, little-endian; reference ``src/header.rs:57-80`` and
``docs/rten-file-format.md:33-56``)::

    [magic "RTEN":4] [version:u32] [model_offset:u64] [model_len:u64]
    [tensor_data_offset:u64]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"RTEN"
VERSION = 2
HEADER_LEN = 32
_STRUCT = struct.Struct("<4sIQQQ")


class HeaderError(ValueError):
    pass


@dataclass
class Header:
    version: int
    model_offset: int
    model_len: int
    tensor_data_offset: int

    @staticmethod
    def from_buf(buf) -> "Header":
        if len(buf) < HEADER_LEN:
            raise HeaderError("header too short")
        magic, version, model_offset, model_len, tensor_offset = \
            _STRUCT.unpack_from(buf, 0)
        if magic != MAGIC:
            raise HeaderError(f"invalid magic {magic!r}")
        if version != VERSION:
            raise HeaderError(f"unsupported version {version}")
        size = len(buf)
        if model_offset < HEADER_LEN or model_offset > size:
            raise HeaderError("invalid model offset")
        if model_offset + model_len > size:
            raise HeaderError("invalid model length")
        if tensor_offset and (tensor_offset < HEADER_LEN or tensor_offset > size):
            raise HeaderError("invalid tensor data offset")
        return Header(version, model_offset, model_len, tensor_offset)

    def to_bytes(self) -> bytes:
        return _STRUCT.pack(MAGIC, self.version, self.model_offset,
                            self.model_len, self.tensor_data_offset)


def detect_version(buf) -> int:
    """Distinguish a V2 container (leading header) from a bare V1
    FlatBuffers file (identifier at bytes 4..8 of the root buffer)."""
    if len(buf) >= 8 and bytes(buf[:4]) == MAGIC and bytes(buf[4:8]) != MAGIC:
        return 2
    return 1
