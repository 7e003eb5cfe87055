"""Preallocated KV cache (port of ``rten_tpu/generate/kv_cache.py``).

Layout per layer, byte-addressable (the card stores single int8 bytes, so
the reference's token-packed int32 rows, bf16 pair-packed scale rows and
carry rows have no counterpart):

* float cache: ``kv`` [B, cap, 2, KVH*D] in the compute dtype (plane 0 K,
  plane 1 V; a token's K/V for all heads is one contiguous row);
* int8 cache: ``kv`` int8 [B, cap, 2, KVH*D] and ``scales`` bf16
  [B, cap, 2, KVH], one symmetric scale per (token, plane, head);
* tail window (int8 caches, serving decode): ``tail`` bf16 [B, R, 2, KVH*D]
  holding the newest ``tail_count`` tokens unquantized, written at a
  global slot (every live sequence is at the same window depth because the
  engine flushes before admissions) and quantized into the cache by
  :meth:`KVCache.flush_tail`.

Unlike the JAX arrays, these buffers are updated IN PLACE (no copy per
token); the methods still return the cache so call sites read like the
reference. ``tail_count`` is a host int: PyTorch runs eagerly, so the window
fill needs no device scalar.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..kernels.cache import kv_append, kv_append_int8, tail_flush_int8
from ..kernels.quant import quantize_tokens


@dataclass
class KVCache:
    kv: list                 # per layer [B, cap, 2, KVH*D]
    lengths: torch.Tensor    # [B] int32, on the cache's device
    scales: list = None      # per layer bf16 [B, cap, 2, KVH], or None
    kv_heads: int = 1
    head_dim: int = 1
    tail: list = None        # per layer bf16 [B, R, 2, KVH*D], or None
    tail_count: int = 0      # tokens in the tail window

    @staticmethod
    def create(batch, n_layers, kv_heads, capacity, head_dim,
               dtype=torch.float32, quantized=False, tail_window=0,
               device="cuda"):
        """The cache's buffers on ``device``: the card by default, the CPU
        only when asked (``resolve_device`` raises without a card)."""
        device = resolve_device(device)
        f = kv_heads * head_dim
        lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        if not quantized:
            if tail_window:
                raise ValueError("tail buffer requires a quantized cache")
            kv = [torch.zeros((batch, capacity, 2, f), dtype=dtype,
                              device=device) for _ in range(n_layers)]
            return KVCache(kv, lengths, None, kv_heads, head_dim)
        kv = [torch.zeros((batch, capacity, 2, f), dtype=torch.int8,
                          device=device) for _ in range(n_layers)]
        scales = [torch.ones((batch, capacity, 2, kv_heads),
                             dtype=torch.bfloat16, device=device)
                  for _ in range(n_layers)]
        tail = None
        if tail_window:
            tail = [torch.zeros((batch, tail_window, 2, f),
                                dtype=torch.bfloat16, device=device)
                    for _ in range(n_layers)]
        return KVCache(kv, lengths, scales, kv_heads, head_dim, tail, 0)

    @property
    def capacity(self):
        return self.kv[0].shape[1]

    @property
    def n_layers(self):
        return len(self.kv)

    @property
    def quantized(self):
        return self.scales is not None

    def with_lengths(self, lengths):
        """The same buffers with new lengths (the buffers are shared)."""
        return replace(self, lengths=torch.as_tensor(
            lengths, dtype=torch.int32, device=self.lengths.device))

    # -- updates -----------------------------------------------------------

    def append(self, layer, k_new, v_new, position=None):
        """Write k/v [B, KVH, T, D] into layer ``layer``.

        ``position``: an int → the same offset for every sequence
        (prefill, a tensor write, as the reference leaves it to XLA);
        None with T == 1 → a decode append at per-sequence offsets from
        ``lengths``, clamped so a finished slot that keeps decoding writes
        inside the buffer (``min(lengths, cap - 1)``, as
        kv_cache.py:188,537): into the window at slot ``tail_count`` for a
        tail cache, else through ``kv_append`` (float caches) or
        ``kv_append_int8``; None with T > 1 → a chunk (speculative verify)
        at per-sequence offsets ``min(lengths, cap - T)``, where the
        reference's ``dynamic_update_slice`` clamps (kv_cache.py:194,
        539-543), written into the cache itself, a tail cache's too."""
        b, kvh, t, d = k_new.shape
        buf = self.kv[layer]
        if position is None and t > 1:
            start = torch.clamp(self.lengths.to(torch.int64), 0,
                                buf.shape[1] - t)
            position = (torch.arange(b, device=buf.device)[:, None],
                        start[:, None] + torch.arange(t, device=buf.device))
        elif position is None:
            if self.tail is not None:
                if self.tail_count >= self.tail[layer].shape[1]:
                    raise RuntimeError("tail window full: flush_tail first")
                row = torch.stack([k_new.reshape(b, kvh * d),
                                   v_new.reshape(b, kvh * d)], dim=1)
                self.tail[layer][:, self.tail_count] = row.to(torch.bfloat16)
            elif self.quantized:
                kv_append_int8(buf, self.scales[layer], k_new, v_new,
                               self.lengths)
            else:
                kv_append(buf, k_new, v_new, self.lengths)
            return self
        # ``position``: an int, or the (sequence, token) index pair of a
        # chunk at per-sequence depths.
        where = ((slice(None), slice(position, position + t))
                 if isinstance(position, int) else position)
        k_t = k_new.transpose(1, 2)                     # [B, T, KVH, D]
        v_t = v_new.transpose(1, 2)
        if self.quantized:
            kq, ks = quantize_tokens(k_t)
            vq, vs = quantize_tokens(v_t)
            rows = torch.stack([kq.reshape(b, t, kvh * d),
                                vq.reshape(b, t, kvh * d)], dim=2)
            self.scales[layer][where] = torch.stack([ks, vs], dim=2)
        else:
            rows = torch.stack([k_t.reshape(b, t, kvh * d),
                                v_t.reshape(b, t, kvh * d)],
                               dim=2).to(buf.dtype)
        buf[where] = rows
        return self

    def insert_group(self, other: "KVCache", slots, lengths):
        """Copy sequences ``0..G-1`` of ``other`` (a prefilled admission
        group, capacity <= this cache's) into batch ``slots`` [G] and set
        their lengths [G] — the reference's insert_group program
        (engine.py:511-524). The tail window is untouched: admissions run
        after a flush, so its rows are dead."""
        slots = torch.as_tensor(slots, dtype=torch.int64,
                                device=self.lengths.device)
        g, cap_o = slots.shape[0], other.capacity
        for li in range(self.n_layers):
            self.kv[li][slots, :cap_o] = other.kv[li][:g]
            if self.scales is not None:
                self.scales[li][slots, :cap_o] = other.scales[li][:g]
        self.lengths[slots] = torch.as_tensor(
            lengths, dtype=torch.int32, device=self.lengths.device)
        return self

    def insert_sequence(self, other: "KVCache", slot, length, src_slot=0):
        """Copy sequence ``src_slot`` of ``other`` into batch slot ``slot``
        with length ``length`` (the continuous-batching admission
        primitive)."""
        cap_o = other.capacity
        for li in range(self.n_layers):
            self.kv[li][slot, :cap_o] = other.kv[li][src_slot]
            if self.scales is not None:
                self.scales[li][slot, :cap_o] = other.scales[li][src_slot]
        self.lengths[slot] = int(length)
        return self

    def advance(self, n):
        """Advance every sequence by ``n`` committed tokens. A single-token
        advance of a tail cache is a decode step whose token entered the
        window, so the window fill advances with it — once per step, after
        every layer has appended (kv_cache.py:605-617)."""
        self.lengths += n
        if self.tail is not None and n == 1:
            self.tail_count += 1
        return self

    def flush_tail(self, t: int):
        """Quantize the first ``t`` window rows of every layer into the int8
        cache at each sequence's depth ``lengths - t`` (one
        ``tail_flush_int8`` launch per layer) and empty the window."""
        if self.tail is None:
            raise ValueError("flush_tail needs a tail cache")
        t = int(t)
        if t:
            for li in range(self.n_layers):
                tail_flush_int8(self.tail[li], self.kv[li], self.scales[li],
                                self.lengths, t)
        self.tail_count = 0
        return self

    # -- reads ---------------------------------------------------------------

    def layer_kv(self, layer):
        """Dequantized K/V [B, KVH, cap, D] (f32 for int8 caches)."""
        buf = self.kv[layer]
        b, cap = buf.shape[:2]
        kvh, d = self.kv_heads, self.head_dim
        x = buf.reshape(b, cap, 2, kvh, d)
        if self.quantized:
            x = x.to(torch.float32) * self.scales[layer].to(
                torch.float32)[..., None]
        return x[:, :, 0].transpose(1, 2), x[:, :, 1].transpose(1, 2)
