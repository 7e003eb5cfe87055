"""Block-paged KV cache, vLLM-style (port of
``rten_tpu/generate/paged_cache.py``).

Fixed-size pages come from a pool shared by every sequence and are mapped
per sequence through a page table, so device memory holds only the pages
in use and long and short requests share the pool.

Layout per layer, byte-addressable like :mod:`.kv_cache` (the reference's
token-packed int32 pages and bf16 pair-packed scale pages have no
counterpart):

* float pool ``[n_pages, page, 2, KVH*D]`` f32 (plane 0 K, plane 1 V);
* int8 pool ``[n_pages, page, 2, KVH*D]`` int8 with bf16 scales
  ``[n_pages, page, 2, KVH]``, one per (token, plane, head);
* ``page_table`` int32 [B, max_pages_per_seq] (-1 = unmapped) and
  ``lengths`` int32 [B], on the pool's device.

Decode appends run through ``kv_append_paged`` / ``kv_append_paged_int8``,
which resolve each sequence's (page, offset) from the table in the kernel;
decode attention reads the pages directly (``kernels/attention.py``).
The buffers are updated IN PLACE, as in :class:`.kv_cache.KVCache`; the
methods return the cache so call sites read like the reference.

Page allocation is host bookkeeping (:class:`_PageAllocator`). It keeps a
numpy mirror of the table, so mapping pages for a burst reads nothing back
from the device, and the caller uploads the table once when it changed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.cache import kv_append_paged, kv_append_paged_int8
from ..kernels.quant import quantize_tokens


@dataclass
class PagedKVCache:
    pools: list              # per layer [n_pages, page, 2, KVH*D]
    page_table: torch.Tensor  # [B, max_pages_per_seq] int32
    lengths: torch.Tensor    # [B] int32
    page_size: int
    kv_heads: int = 1
    head_dim: int = 1
    scales: list = None      # per layer bf16 [n_pages, page, 2, KVH], or None

    paged = True             # the marker the model's decode dispatch reads

    @staticmethod
    def create(n_layers, n_pages, page_size, kv_heads, head_dim, batch,
               max_pages_per_seq, dtype=torch.float32, quantized=False,
               device="cuda"):
        """The pool's buffers on ``device``: the card by default, the CPU
        only when asked (``resolve_device`` raises without a card)."""
        device = resolve_device(device)
        f = kv_heads * head_dim
        table = torch.full((batch, max_pages_per_seq), -1, dtype=torch.int32,
                           device=device)
        lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        shape = (n_pages, page_size, 2, f)
        if not quantized:
            pools = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(n_layers)]
            return PagedKVCache(pools, table, lengths, page_size, kv_heads,
                                head_dim)
        pools = [torch.zeros(shape, dtype=torch.int8, device=device)
                 for _ in range(n_layers)]
        scales = [torch.ones((n_pages, page_size, 2, kv_heads),
                             dtype=torch.bfloat16, device=device)
                  for _ in range(n_layers)]
        return PagedKVCache(pools, table, lengths, page_size, kv_heads,
                            head_dim, scales)

    @property
    def n_layers(self):
        return len(self.pools)

    @property
    def n_pages(self):
        return self.pools[0].shape[0]

    @property
    def max_pages_per_seq(self):
        return self.page_table.shape[1]

    @property
    def capacity(self):
        return self.max_pages_per_seq * self.page_size

    @property
    def quantized(self):
        return self.scales is not None

    def with_lengths(self, lengths):
        """The same pools and table with new lengths (shared buffers)."""
        return replace(self, lengths=torch.as_tensor(
            lengths, dtype=torch.int32, device=self.lengths.device))

    def fused_layer(self, layer):
        return self.pools[layer]

    # -- updates -----------------------------------------------------------

    def append(self, layer, k_new, v_new, position=None):
        """Write k/v [B, KVH, T, D] into layer ``layer``.

        ``position`` None with T == 1: a decode append at each sequence's
        length through the table (``kv_append_paged`` or
        ``kv_append_paged_int8``; an unmapped entry writes into page 0, the
        allocator's garbage page). ``position`` 0: prefill — T is padded to
        whole pages (zeros, which quantize to zero bytes and scale 1.0, as
        the reference pads) and the pages are scattered into each
        sequence's first ceil(T / page) table entries."""
        b, kvh, t, d = k_new.shape
        pool = self.pools[layer]
        if position is None:
            if t != 1:
                raise NotImplementedError(
                    "multi-token appends at per-sequence depths (chunked "
                    "verify) on a paged cache are not ported yet "
                    "(ROADMAP.md Queue 1, serving breadth: chunked verify "
                    "on paged caches)")
            if self.quantized:
                kv_append_paged_int8(pool, self.scales[layer], k_new, v_new,
                                     self.page_table, self.lengths)
            else:
                kv_append_paged(pool, k_new, v_new, self.page_table,
                                self.lengths)
            return self
        if position != 0:
            raise ValueError("paged prefill writes from position 0")
        page = self.page_size
        n_p = -(-t // page)
        if n_p > self.max_pages_per_seq:
            raise ValueError(f"prefill of {t} tokens exceeds the table's "
                             f"{self.max_pages_per_seq} pages")
        pad = n_p * page - t
        ids = self.page_table[:, :n_p].to(torch.int64).clamp(min=0)
        rows = torch.stack([k_new.transpose(1, 2), v_new.transpose(1, 2)],
                           dim=2)                       # [B, T, 2, KVH, D]
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, 0, 0, pad))
        if self.quantized:
            q, s = quantize_tokens(rows)
            pool[ids.reshape(-1)] = q.reshape(b * n_p, page, 2, kvh * d)
            self.scales[layer][ids.reshape(-1)] = s.reshape(b * n_p, page,
                                                            2, kvh)
        else:
            pool[ids.reshape(-1)] = rows.reshape(b * n_p, page, 2,
                                                 kvh * d).to(pool.dtype)
        return self

    def insert_group(self, other: "PagedKVCache", slots, lengths):
        """Adopt sequences ``0..G-1`` of a prefilled group cache into batch
        ``slots`` [G] with ``lengths`` [G]: the contents of each source
        sequence's ``other.max_pages_per_seq`` pages go to the slot's first
        pages, one indexed copy per layer (the reference's insert_group
        program, engine.py:511-524). The slots' pages must be mapped and
        the table uploaded."""
        slots = torch.as_tensor(slots, dtype=torch.int64,
                                device=self.lengths.device)
        n_p = other.max_pages_per_seq
        self._copy_pages(other, other.page_table[:slots.shape[0], :n_p],
                         self.page_table[slots, :n_p])
        self.lengths[slots] = torch.as_tensor(
            lengths, dtype=torch.int32, device=self.lengths.device)
        return self

    def insert_sequence(self, other: "PagedKVCache", slot, length,
                        src_slot=0):
        """Adopt sequence ``src_slot`` of a prefilled paged cache into batch
        slot ``slot`` with length ``length`` (both tables must map
        ``other.max_pages_per_seq`` pages)."""
        n_p = other.max_pages_per_seq
        self._copy_pages(other, other.page_table[src_slot],
                         self.page_table[slot, :n_p])
        self.lengths[slot] = int(length)
        return self

    def _copy_pages(self, other, src, dst):
        """Copy ``other``'s pages ``src`` into this pool's pages ``dst``
        (page-id tensors of one shape; unmapped ids mean page 0, as in the
        reference's insert)."""
        src = src.to(torch.int64).clamp(min=0).reshape(-1)
        dst = dst.to(torch.int64).clamp(min=0).reshape(-1)
        for li in range(self.n_layers):
            self.pools[li][dst] = other.pools[li][src]
            if self.scales is not None:
                self.scales[li][dst] = other.scales[li][src]

    def advance(self, n=1):
        self.lengths += n
        return self

    # -- reads ---------------------------------------------------------------

    def layer_kv(self, layer):
        """K/V [B, KVH, cap, D] gathered through the table (unmapped ids
        read page 0; f32 for int8 pools) — the reference and test path; the
        kernels read the pages directly."""
        safe = self.page_table.to(torch.int64).clamp(min=0)      # [B, P]
        b, cap = safe.shape[0], self.capacity
        kvh, d = self.kv_heads, self.head_dim
        x = self.pools[layer][safe].reshape(b, cap, 2, kvh, d)
        if self.quantized:
            s = self.scales[layer][safe].reshape(b, cap, 2, kvh)
            x = x.to(torch.float32) * s.to(torch.float32)[..., None]
        return x[:, :, 0].transpose(1, 2), x[:, :, 1].transpose(1, 2)

    # -- host-side page allocator -----------------------------------------

    @staticmethod
    def make_allocator(n_pages, partitions=1):
        return _PageAllocator(n_pages, partitions)


class _PageAllocator:
    """Host bookkeeping: a free list of pool pages; the engine maps pages
    into sequences' tables before the steps that need them.

    Page 0 is RESERVED as the garbage page: the decode step runs every
    batch slot, and a finished or released slot's appends land there, so
    it never holds live data.

    The allocator serves one cache at a time and keeps a numpy mirror of
    its table (read from the device once, when it first sees the table).
    :meth:`ensure_capacity` and :meth:`release_slot` change the mirror
    only, so they never wait for the device; the caller uploads a changed
    table with :meth:`upload` before the device next reads it. Only
    ``partitions=1``: pools partitioned over a mesh are not ported yet."""

    def __init__(self, n_pages, partitions=1):
        if partitions != 1:
            raise NotImplementedError(
                "partitioned page pools (meshes) are not ported yet "
                "(ROADMAP.md Queue 1, parallel/)")
        if n_pages < 2:
            raise ValueError("the pool needs its reserved garbage page and "
                             "a data page")
        self.free = list(range(n_pages - 1, 0, -1))
        self.table = None          # host mirror of the cache's page table
        self._source = None        # the device table it mirrors
        self._dirty = False

    def alloc(self) -> int:
        if not self.free:
            raise MemoryError("KV page pool exhausted")
        return self.free.pop()

    def release(self, pages):
        self.free.extend(int(p) for p in pages if p >= 0)

    def _mirror(self, cache: PagedKVCache):
        if self._source is not cache.page_table:
            self.table = cache.page_table.cpu().numpy().copy()
            self._source = cache.page_table
            self._dirty = False
        return self.table

    def upload(self, cache: PagedKVCache):
        """Copy the host table to the device if it changed."""
        self._mirror(cache)
        if self._dirty:
            cache.page_table.copy_(torch.from_numpy(self.table))
            self._dirty = False

    def ensure_capacity(self, cache: PagedKVCache, slot: int,
                        tokens_ahead: int, length: int):
        """Map enough pages on ``slot``'s host table for ``tokens_ahead``
        more tokens past ``length``. Raises MemoryError when the pool is
        exhausted or the sequence would outgrow the table."""
        table = self._mirror(cache)
        needed = -(-(length + tokens_ahead) // cache.page_size)
        mapped = int((table[slot] >= 0).sum())
        for i in range(mapped, needed):
            if i >= cache.max_pages_per_seq:
                raise MemoryError("sequence exceeds max pages")
            table[slot, i] = self.alloc()
            self._dirty = True

    def release_slot(self, cache: PagedKVCache, slot: int):
        """Return ``slot``'s pages to the pool and unmap its host table row;
        set its length to 0 on the device (no read back)."""
        table = self._mirror(cache)
        if (table[slot] >= 0).any():
            self.release(table[slot])
            table[slot] = -1
            self._dirty = True
        cache.lengths[slot] = 0
