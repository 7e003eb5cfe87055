"""Minimal generic FlatBuffers reader/writer.

This is an original, from-scratch implementation of the subset of the
FlatBuffers wire format needed by the RTen model format
(see reference ``src/schema.fbs`` — tables, unions, strings, scalar and
offset vectors; no structs). It is deliberately schema-driven: the schema
is declared as data in :mod:`rten_tpu_torch.fmt.schema` and this module provides
the generic binary plumbing.

Wire format essentials (little-endian throughout):

* The buffer starts with a ``u32`` offset to the root table, optionally
  followed by a 4-byte file identifier.
* A table starts with an ``i32`` whose value is ``table_pos - vtable_pos``.
  The vtable holds ``u16 vtable_len, u16 table_len`` then one ``u16``
  per field slot giving the field's offset within the table (0 = absent).
* Field slot ``i`` lives at vtable byte ``4 + 2*i``. Union fields consume
  two consecutive slots (type byte, then table offset).
* Strings/vectors/tables are referenced by ``u32`` relative forward
  offsets; vectors and strings are prefixed with a ``u32`` length.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = [
    "read_u8", "read_u16", "read_u32", "read_i32", "read_u64", "read_f32",
    "root_table", "field_pos", "table_scalar", "table_string", "table_vector_pos",
    "indirect", "vector_len", "scalar_vector", "offset_vector", "string_at",
    "Builder",
]

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_F32 = struct.Struct("<f")

_FMTS = {
    "u8": _U8, "bool": _U8, "u16": _U16, "u32": _U32,
    "i32": _I32, "u64": _U64, "f32": _F32,
}

_NP_DTYPES = {
    "u8": np.uint8, "bool": np.uint8, "u16": np.uint16, "u32": np.uint32,
    "i32": np.int32, "u64": np.uint64, "f32": np.float32,
}

SCALAR_SIZE = {"u8": 1, "bool": 1, "u16": 2, "u32": 4, "i32": 4, "u64": 8, "f32": 4}


def read_u8(buf, pos):
    return _U8.unpack_from(buf, pos)[0]


def read_u16(buf, pos):
    return _U16.unpack_from(buf, pos)[0]


def read_u32(buf, pos):
    return _U32.unpack_from(buf, pos)[0]


def read_i32(buf, pos):
    return _I32.unpack_from(buf, pos)[0]


def read_u64(buf, pos):
    return _U64.unpack_from(buf, pos)[0]


def read_f32(buf, pos):
    return _F32.unpack_from(buf, pos)[0]


def root_table(buf, base=0):
    """Position of the root table in ``buf`` (``base`` = start of the
    FlatBuffers region within a larger file)."""
    return base + read_u32(buf, base)


def indirect(buf, pos):
    """Follow a u32 forward reference stored at ``pos``."""
    return pos + read_u32(buf, pos)


def field_pos(buf, table, slot):
    """Absolute position of field ``slot`` of the table at ``table``,
    or None if the field is absent."""
    vtable = table - read_i32(buf, table)
    vt_len = read_u16(buf, vtable)
    entry = 4 + 2 * slot
    if entry >= vt_len:
        return None
    off = read_u16(buf, vtable + entry)
    if off == 0:
        return None
    return table + off


def table_scalar(buf, table, slot, kind, default=None):
    pos = field_pos(buf, table, slot)
    if pos is None:
        return default
    value = _FMTS[kind].unpack_from(buf, pos)[0]
    if kind == "bool":
        return bool(value)
    return value


def string_at(buf, pos):
    """Decode the string referenced from ``pos``."""
    spos = indirect(buf, pos)
    n = read_u32(buf, spos)
    return bytes(buf[spos + 4:spos + 4 + n]).decode("utf-8")


def table_string(buf, table, slot, default=None):
    pos = field_pos(buf, table, slot)
    if pos is None:
        return default
    return string_at(buf, pos)


def table_vector_pos(buf, table, slot):
    """Position of the length prefix of a vector field, or None."""
    pos = field_pos(buf, table, slot)
    if pos is None:
        return None
    return indirect(buf, pos)


def vector_len(buf, vec_pos):
    return read_u32(buf, vec_pos)


def scalar_vector(buf, vec_pos, kind):
    """Read a scalar vector at ``vec_pos`` as a (zero-copy) numpy array."""
    n = read_u32(buf, vec_pos)
    return np.frombuffer(buf, dtype=_NP_DTYPES[kind], count=n, offset=vec_pos + 4)


def offset_vector(buf, vec_pos):
    """Positions of the tables/strings referenced by an offset vector."""
    n = read_u32(buf, vec_pos)
    base = vec_pos + 4
    return [indirect(buf, base + 4 * i) for i in range(n)]


class Builder:
    """FlatBuffers builder. The buffer is assembled back-to-front; all
    positions are tracked as distances from the *end* of the buffer, so a
    forward reference written at distance ``h`` pointing at an object that
    finished at distance ``o`` has wire value ``h - o``."""

    def __init__(self):
        self._chunks: list[bytes] = []   # chunks in prepend order (reversed at finish)
        self._size = 0                   # bytes emitted so far (== distance-from-end)
        self.min_align = 4
        self._table_fields = None        # [(slot, end_distance, size)] while a table is open
        self._table_start = None
        self._finished = None

    # -- low-level emission ------------------------------------------------

    def _emit(self, data: bytes):
        self._chunks.append(data)
        self._size += len(data)

    def _prep(self, align, extra=0):
        """Pad so that after writing ``extra`` more bytes the position is
        ``align``-aligned."""
        if align > self.min_align:
            self.min_align = align
        pad = (-(self._size + extra)) % align
        if pad:
            self._emit(b"\x00" * pad)

    def _push_scalar(self, kind, value):
        size = SCALAR_SIZE[kind]
        self._prep(size)
        if kind == "bool":
            value = 1 if value else 0
        self._emit(_FMTS[kind].pack(value))
        return self._size

    # -- strings / vectors -------------------------------------------------

    def string(self, text: str) -> int:
        data = text.encode("utf-8")
        self._prep(4, len(data) + 1)
        self._emit(data + b"\x00")
        self._emit(_U32.pack(len(data)))
        return self._size

    def scalar_vector(self, kind, values) -> int:
        arr = np.ascontiguousarray(values, dtype=_NP_DTYPES[kind])
        elem = SCALAR_SIZE[kind]
        self._prep(max(4, elem), arr.nbytes)
        self._emit(arr.tobytes())
        self._emit(_U32.pack(arr.size))
        return self._size

    def offset_vector(self, offsets) -> int:
        offsets = list(offsets)
        self._prep(4, 4 * len(offsets))
        refs = bytearray()
        # Element i of the vector sits at distance D - 4*i - 4 from the data
        # start once the block is emitted; compute each forward ref directly.
        base = self._size + 4 * len(offsets)
        for i, target in enumerate(offsets):
            elem_dist = base - 4 * i
            refs += _U32.pack(elem_dist - target)
        self._emit(bytes(refs))
        self._emit(_U32.pack(len(offsets)))
        return self._size

    # -- tables ------------------------------------------------------------

    def start_table(self):
        assert self._table_fields is None, "table already open"
        self._table_fields = []
        self._table_start = self._size

    def add_scalar(self, slot, kind, value, default=None):
        if value is None or (default is not None and value == default):
            return
        dist = self._push_scalar(kind, value)
        self._table_fields.append((slot, dist))

    def add_offset(self, slot, target):
        if target is None:
            return
        self._prep(4)
        dist = self._size + 4
        self._emit(_U32.pack(dist - target))
        self._size += 0  # _emit already updated
        self._table_fields.append((slot, dist))

    def end_table(self) -> int:
        fields = self._table_fields
        start = self._table_start
        self._table_fields = None
        self._table_start = None
        # Reserve the i32 soffset slot at the head of the table.
        self._prep(4)
        self._emit(b"\x00\x00\x00\x00")
        table_dist = self._size
        table_len = table_dist - start
        n_slots = 1 + max((s for s, _ in fields), default=-1)
        vt_len = 4 + 2 * n_slots
        vt = bytearray(_U16.pack(vt_len) + _U16.pack(table_len) + b"\x00" * (2 * n_slots))
        for slot, dist in fields:
            _U16.pack_into(vt, 4 + 2 * slot, table_dist - dist)
        self._prep(2, len(vt))
        self._emit(bytes(vt))
        vtable_dist = self._size
        # Patch the soffset: vtable is *before* the table in memory
        # (larger distance-from-end), so the stored value is positive.
        patched = _I32.pack(vtable_dist - table_dist)
        self._patch(table_dist, patched)
        return table_dist

    def _patch(self, dist, data):
        """Overwrite ``len(data)`` bytes whose end-distance is ``dist``."""
        remaining = self._size
        for i, chunk in enumerate(reversed(self._chunks)):
            idx = len(self._chunks) - 1 - i
            chunk_start = remaining - len(chunk)  # distance of chunk end
            if chunk_start < dist <= remaining:
                inner = remaining - dist
                assert inner + len(data) <= len(chunk)
                mutable = bytearray(chunk)
                mutable[inner:inner + len(data)] = data
                self._chunks[idx] = bytes(mutable)
                return
            remaining = chunk_start
        raise AssertionError("patch position not found")

    # -- finish ------------------------------------------------------------

    def finish(self, root_dist, file_identifier: bytes | None = None) -> bytes:
        extra = 4 + (4 if file_identifier else 0)
        self._prep(self.min_align, extra)
        if file_identifier:
            assert len(file_identifier) == 4
            self._emit(file_identifier)
        dist = self._size + 4
        self._emit(_U32.pack(dist - root_dist))
        out = b"".join(reversed(self._chunks))
        return out
