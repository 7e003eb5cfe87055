"""Serving engine with continuous batching (single-device core of
``rten_tpu/generate/engine.py::ServingEngine``).

The batch is a set of slots. Queued requests are prefilled in admission
groups per prompt-length bucket (padded to a power of two) and scattered
into free slots; every decode step runs all slots, and a finished slot is
reused by the next admission, so the decode batch stays full.

With an int8 cache the bf16 tail window is on by default where the
reference's gate allows it: each decode step appends one bf16 row per layer
to the window, the tail kernel reads it, and the window is quantized into
the cache every ``_tail_flush`` steps inside a burst and before any
admission (``_host_flush``). Float (f32 or bf16) caches and int8 caches
without the window append one row per layer and step into the cache
itself; a configuration whose decode kernel is not ported yet raises from
the model, on the card and on the CPU alike.

With ``paged=True`` the cache is block-paged (``paged_cache.py``): a pool
of ``page_size``-token pages shared by every slot, mapped through a page
table by a host allocator. Admission maps each slot's prefill pages before
the prefill, every decode step or burst first maps the pages its tokens
will need, and a finished or cancelled slot returns its pages; the table
is uploaded once per admission group and once per step or burst, and only
when it changed. Paged caches have no tail window.

With ``spec_draft=k`` (speculative decoding, ``speculative.py``) every
step drafts k tokens per slot by n-gram lookup in the slot's token history,
verifies them in one chunked forward, and commits the agreeing prefix plus
the model's next token, so greedy output is plain decoding's with fewer
steps. Only ``spec_adaptive=False`` (always draft) is ported.

Sampling: the default :class:`ArgMaxSampler` takes the fused int8 head +
argmax kernel where the weights allow it. A :class:`PerRequestSampler`
carries each slot's temperature, top-k and top-p as per-row tensors,
uploaded once per admission, so greedy and stochastic requests share one
decode step. Every draw comes from the engine's ``torch.Generator``
(``seed``). ``logprobs=True`` records each emitted token's log-probability
(at admission and at every decode step) and, like a non-greedy sampler,
turns the fused head off (it forms no logits).

Prefix cache (:meth:`register_prefix`): a registered prompt prefix is
prefilled once into a fragment cache of full capacity; an admitted prompt
that strictly extends it runs one chunked forward over its suffix at the
fragment's depth (``forward(chunk=True)``, whose attention is the verify
kernel) and is scattered into its slot like any admission.

PyTorch runs eagerly, so a burst is a Python loop of decode steps whose
tokens stay on the device until the burst ends (one host sync per burst).
Slot bookkeeping is the reference's Python path; the ``native/scheduler``
bridge and CUDA-graph bursts are later work (ROADMAP.md).
"""

from __future__ import annotations

import json
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.attention import (E_MATRIX_BUDGET, FLAT_VMEM_BUDGET,
                                 flat_group_for, flat_long_ctx, flat_q_bf16,
                                 flat_vmem_bytes)
from .metrics import Metrics
from .paged_cache import PagedKVCache
from .sampler import (ArgMaxSampler, PerRequestSampler, Sampler,
                      SamplingParams)
from .speculative import make_spec_burst


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class Request:
    prompt_ids: list
    max_new_tokens: int = 128
    stop_ids: tuple = ()
    # per-request sampling (used when the engine's sampler is a
    # PerRequestSampler; None = greedy)
    sampling: Optional[SamplingParams] = None
    # filled by the engine:
    request_id: int = -1
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)  # per emitted token,
    # filled when the engine runs with logprobs=True
    done: bool = False
    metrics: Metrics = field(default_factory=Metrics)


class ServingEngine:
    def __init__(self, model, params, max_batch=8, capacity=1024,
                 sampler: Optional[Sampler] = None, quantized_cache=False,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 cache_dtype=None, fused_head=None, tail_window=None,
                 device="cuda", mesh=None, paged=False, page_size=64,
                 pool_pages=None, spec_draft=0, spec_ngram=3,
                 spec_adaptive="auto", spec_k_adaptive=True, seed=0,
                 cache=None, logprobs=False, log_stats_every=None):
        """``cache``: a storage policy ("auto" | "int8" | "bf16" | "f32")
        instead of ``quantized_cache``/``cache_dtype``; "auto" resolves as
        the reference's (engine.py:88-114): int8 where the config uses the
        decode kernels (``use_pallas``, no ``scan_layers``), the capacity
        is a multiple of 4 and there are at most 64 KV heads, bf16
        otherwise. ``seed`` seeds the engine's ``torch.Generator``.
        ``logprobs``: record each emitted token's log-probability in
        ``Request.logprobs``. ``log_stats_every=N``: one JSON line of
        :meth:`stats` to stderr every N bursts or steps.

        ``tail_window``: None picks the window by the reference's gate
        (16 for an int8 cache where it applies), 0 disables it, n > 0
        forces depth n (int8 caches only). ``paged``: a block-paged cache
        of ``page_size``-token pages, ``pool_pages`` of them (default one
        slot's worth per slot plus the garbage page). ``device``: "cuda"
        (default) or "cpu"; ``params`` must lie on it.

        ``spec_draft`` > 0: speculative decoding, drafting ``spec_draft``
        tokens by ``spec_ngram``-gram lookup, greedy only, on a contiguous
        cache without a tail window; with ``spec_k_adaptive`` the draft
        length follows the acceptance (:meth:`_adapt_k`). Only
        ``spec_adaptive=False`` (draft at every step) is ported. The
        reference's default ``"auto"`` and ``True`` (the acceptance gate,
        its probe budget and estimator) raise ``NotImplementedError``, so
        a caller who does not ask for always-draft never gets a policy
        other than the reference's."""
        if mesh:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md Queue 1, parallel/)")
        if cache is not None:
            if cache not in ("auto", "int8", "bf16", "f32"):
                raise ValueError(f"cache={cache!r}: expected 'auto', "
                                 f"'int8', 'bf16' or 'f32'")
            if cache_dtype is not None or quantized_cache:
                raise ValueError("pass either cache= or "
                                 "quantized_cache/cache_dtype")
            if cache == "auto":
                cfg_c = model.config
                int8_ok = (cfg_c.use_pallas and not cfg_c.scan_layers
                           and capacity % 4 == 0
                           and cfg_c.n_kv_heads <= 64)
                cache = "int8" if int8_ok else "bf16"
            quantized_cache = cache == "int8"
            cache_dtype = {"bf16": "bfloat16", "f32": "float32"}.get(cache)
        self.sampler = sampler or ArgMaxSampler()
        self._per_request = isinstance(self.sampler, PerRequestSampler)
        self.logprobs = bool(logprobs)
        if spec_draft:
            if not isinstance(self.sampler, ArgMaxSampler):
                raise ValueError("speculative decoding is greedy-only")
            if self.logprobs:
                raise ValueError("speculative decoding does not emit "
                                 "logprobs")
            if spec_adaptive is not False:
                raise NotImplementedError(
                    f"spec_adaptive={spec_adaptive!r}: the speculation gate "
                    f"is not ported yet (ROADMAP.md Queue 1, speculative "
                    f"gate); pass spec_adaptive=False to draft at every "
                    f"step")
            if paged:
                raise ValueError("speculative mode needs a contiguous cache "
                                 "(the reference's is unpaged too)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # Per-slot temperature, top-k and top-p rows (PerRequestSampler),
        # and their device copy, uploaded again after an admission changes
        # them.
        self._samp = np.zeros((3, max_batch), np.float32)
        self._samp_dev = None
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.capacity = capacity
        self.quantized_cache = quantized_cache
        self.cache_dtype = cache_dtype
        self.paged = bool(paged)
        self.page_size = page_size
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= capacity) or (capacity,)

        cfg = model.config

        def tail_shape_ok(window=16):
            # The reference's gate (engine.py:241-279) on one device.
            h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            group = flat_group_for(max_batch)
            if not group:
                return False
            if capacity >= 2048:
                if max_batch % 8 == 0 and max_batch >= 16:
                    group = 8
                # The flat long-capacity dispatch needs both knobs on,
                # read at call time as the reference reads them.
                if (capacity % 128 or not flat_q_bf16()
                        or not flat_long_ctx()
                        or flat_vmem_bytes(h, d, kvh, group, 128, window)
                        > FLAT_VMEM_BUDGET):
                    return False
            return (capacity % 64 == 0 and (kvh * d) % 128 == 0
                    and (-(-h // 8) * 8) * d * kvh * d * 4
                    <= E_MATRIX_BUDGET)

        self._tail_flush = 0
        if self.paged:
            if tail_window:
                raise ValueError("paged caches have no tail window")
            n_pages = pool_pages or (max_batch * -(-capacity // page_size)
                                     + 1)
            self.cache = model.new_paged_cache(max_batch, capacity,
                                               page_size, n_pages,
                                               quantized=quantized_cache,
                                               device=self.device)
            self.allocator = PagedKVCache.make_allocator(n_pages)
        else:
            if tail_window is not None:
                if tail_window and (not quantized_cache or spec_draft):
                    raise ValueError("tail_window requires a quantized "
                                     "cache and spec_draft == 0")
                self._tail_flush = int(tail_window)
            elif (quantized_cache and not spec_draft and cfg.use_pallas
                  and cfg.decode_attn in ("auto", "flat")
                  and tail_shape_ok()):
                self._tail_flush = 16
            self.cache = model.new_cache(max_batch, capacity,
                                         quantized=quantized_cache,
                                         cache_dtype=cache_dtype,
                                         tail_window=self._tail_flush,
                                         device=self.device)
        # Host mirror of cache.tail_count (+1 per decode step, 0 after a
        # flush).
        self._tail_fill = 0
        # The fused head forms no logits: only for a greedy sampler and
        # without logprobs (engine.py:420-426).
        greedy = (isinstance(self.sampler, ArgMaxSampler)
                  or getattr(self.sampler, "temperature", None) == 0.0)
        self._fused_head = (fused_head if fused_head is not None
                            else greedy
                            and hasattr(model, "decode_step_argmax"))
        if self.logprobs:
            self._fused_head = False

        self.slot_request: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self._next_id = 0
        self.current_tokens = np.zeros(max_batch, np.int32)
        # Host mirror of cache.lengths (inserts set them, each decode step
        # advances every slot by one), so no step reads them back.
        self._host_lengths = np.zeros(max_batch, np.int64)
        # Device-resident last tokens: consecutive bursts chain on the
        # device without a host round trip.
        self._device_tokens = None
        self.counters = {"submitted": 0, "completed": 0, "tokens": 0,
                         "bursts": 0, "decode_steps": 0, "prefix_hits": 0,
                         "cancelled": 0}
        self._t_start = time.perf_counter()
        self._log_every = log_stats_every
        # Prefix cache: (token tuple, fragment cache), longest first.
        self._prefixes: list = []
        self._ttfts = deque(maxlen=2048)
        self._itls = deque(maxlen=8192)
        self._admit_stalls = deque(maxlen=2048)

        # Speculative decoding (engine.py:540-583): each slot's committed
        # tokens, written at admission and by every step or burst.
        self.spec_draft = spec_draft
        self.spec_ngram = spec_ngram
        if spec_draft:
            self.spec_adaptive = spec_adaptive
            self._spec_history = torch.zeros((max_batch, capacity),
                                             dtype=torch.int32,
                                             device=self.device)
            self._k_adaptive = bool(spec_k_adaptive)
            self._spec_k = spec_draft
            self._spec_tps = None      # EMA of tokens per step and slot

    # -- device programs -----------------------------------------------------

    def _prefill(self, tokens, lengths, cap):
        """Batched prefill of an admission group: tokens [G, bucket],
        lengths [G] (numpy). Returns (last-token logits [G, V], the group
        cache of capacity ``cap``)."""
        group = tokens.shape[0]
        if self.paged:
            # A group cache with an identity table: each sequence owns
            # ceil(bucket / page) pages, adopted into the serving pool by
            # the insert.
            bucket = tokens.shape[1]
            cache = self.model.new_paged_cache(
                group, bucket, self.page_size,
                group * -(-bucket // self.page_size), identity_table=True,
                quantized=self.quantized_cache, device=self.device)
        else:
            cache = self.model.new_cache(group, cap,
                                         quantized=self.quantized_cache,
                                         cache_dtype=self.cache_dtype,
                                         device=self.device)
        tok = torch.from_numpy(tokens).to(self.device)
        lens = torch.from_numpy(lengths).to(self.device)
        last, cache = self.model.prefill_last(self.params, tok, cache,
                                              lens.to(torch.int64) - 1)
        return last, cache.with_lengths(lens)

    def _suffix_prefill(self, tokens, frag, plen, slens):
        """The prefix cache's admission (engine.py:526-537): a chunked
        forward over the suffixes ``tokens`` [G, bucket] (numpy) at depth
        ``plen`` of the fragment cache ``frag``; ``slens`` [G] the true
        suffix lengths. Returns (last-suffix-token logits [G, V], the
        fragment's buffers with lengths ``plen + slens``). The chunk writes
        rows from ``plen`` on, which the next hit writes again before it
        reads them, so the fragment's prefix rows stay as registered."""
        tok = torch.from_numpy(tokens).to(self.device)
        cache = frag.with_lengths(np.full(len(slens), plen, np.int32))
        logits, cache = self.model.forward(self.params, tok, cache,
                                           chunk=True)
        rows = torch.arange(tok.shape[0], device=self.device)
        last = logits[rows, torch.from_numpy(slens.astype(np.int64) - 1).to(
            self.device)]
        return last, cache.with_lengths(plen + slens)

    def _samp_args(self):
        """The per-slot sampling rows as device tensors (temperature, top-k,
        top-p), uploaded once after each admission; None unless the sampler
        is per-request."""
        if not self._per_request:
            return None
        if self._samp_dev is None:
            self._samp_dev = torch.from_numpy(self._samp).to(self.device)
        return tuple(self._samp_dev)

    def _sample(self, logits, samp):
        if self._per_request:
            return self.sampler.sample(logits, *samp, generator=self._gen)
        return self.sampler.sample(logits, generator=self._gen)

    def _decode_one(self, tokens, samp):
        """One decode step for every slot; returns (next tokens int32 [B],
        their log-probabilities f32 [B] or None) on the device."""
        if self._fused_head:
            nxt, self.cache = self.model.decode_step_argmax(
                self.params, tokens, self.cache)
            return nxt, None
        logits, self.cache = self.model.decode_step(self.params, tokens,
                                                    self.cache)
        nxt = self._sample(logits, samp)
        lp = None
        if self.logprobs:
            lp = (logits.gather(1, nxt[:, None].to(torch.int64))[:, 0]
                  - torch.logsumexp(logits, dim=-1))
        return nxt, lp

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=128, stop_ids=(),
               sampling: Optional[SamplingParams] = None) -> Request:
        req = Request(list(map(int, prompt_ids)), max_new_tokens,
                      tuple(stop_ids), sampling=sampling)
        if len(req.prompt_ids) >= self.capacity:
            raise ValueError(f"prompt length {len(req.prompt_ids)} exceeds "
                             f"cache capacity")
        # The prompt (or its suffix after a prefix-cache hit) must fit a
        # prefill bucket (engine.py:710-720).
        hit = self._match_prefix(req.prompt_ids) if self._prefixes else None
        effective = (len(req.prompt_ids) - len(hit[0]) if hit
                     else len(req.prompt_ids))
        if effective > max(self.prefill_buckets):
            raise ValueError(
                f"prompt length {len(req.prompt_ids)} exceeds the largest "
                f"prefill bucket ({max(self.prefill_buckets)}); raise "
                f"prefill_buckets or register a covering prefix")
        req.request_id = self._next_id
        self._next_id += 1
        self.counters["submitted"] += 1
        req.metrics.start()
        self.queue.append(req)
        return req

    def _admit(self):
        """Fill free slots from the queue (batched prefill per bucket).
        Admission stalls every live slot; the stall is recorded for
        :meth:`stats`."""
        had_active = any(r is not None for r in self.slot_request)
        t0 = time.perf_counter()
        try:
            return self._admit_inner()
        finally:
            dt = time.perf_counter() - t0
            if had_active and dt > 1e-4:
                self._admit_stalls.append(dt)

    def _host_flush(self):
        """Flush a partially filled tail window. Runs before anything that
        rewrites the cache outside the decode step: admission inserts, and
        bursts whose in-burst flush points assume an empty window."""
        if self._tail_flush and self._tail_fill:
            self.cache = self.cache.flush_tail(self._tail_fill)
            self._tail_fill = 0

    def _admit_inner(self):
        self._host_flush()
        free = [s for s in range(self.max_batch)
                if self.slot_request[s] is None]
        if not free or not self.queue:
            return
        batch_reqs = self.queue[:len(free)]
        del self.queue[:len(batch_reqs)]
        pairs = list(zip(batch_reqs, free))
        if self._prefixes:
            pairs = self._admit_prefix_hits(pairs)
        by_bucket: dict = {}
        for req, slot in pairs:
            by_bucket.setdefault(_bucket(len(req.prompt_ids),
                                         self.prefill_buckets),
                                 []).append((req, slot))
        for bucket, group_pairs in by_bucket.items():
            # Power-of-two group sizes, as the reference compiles per
            # group size; pad rows prefill one token and are dropped.
            gpad = 1
            while gpad < len(group_pairs):
                gpad *= 2
            tokens = np.zeros((gpad, bucket), np.int64)
            lengths = np.ones(gpad, np.int32)
            for gi, (req, _) in enumerate(group_pairs):
                tokens[gi, :len(req.prompt_ids)] = req.prompt_ids
                lengths[gi] = len(req.prompt_ids)
            if self.paged:
                self._map_admission(group_pairs, bucket)
            last_logits, prefilled = self._prefill(
                tokens, lengths, min(bucket, self.capacity))
            self._finish_admission(group_pairs, lengths, last_logits,
                                   prefilled)

    def _admit_prefix_hits(self, pairs):
        """Admit each request whose prompt strictly extends a registered
        prefix through the suffix prefill, one at a time as the reference
        does (engine.py:778-806); returns the pairs left for a cold
        prefill (misses, and hits whose suffix bucket would not fit)."""
        rest = []
        for req, slot in pairs:
            hit = self._match_prefix(req.prompt_ids)
            if hit is None:
                rest.append((req, slot))
                continue
            ptoks, frag = hit
            suffix = req.prompt_ids[len(ptoks):]
            sbucket = _bucket(len(suffix), self.prefill_buckets)
            if len(ptoks) + sbucket >= self.capacity:
                rest.append((req, slot))   # no room for the chunk
                continue
            tok = np.zeros((1, sbucket), np.int64)
            tok[0, :len(suffix)] = suffix
            last_logits, filled = self._suffix_prefill(
                tok, frag, len(ptoks), np.asarray([len(suffix)], np.int32))
            self.counters["prefix_hits"] += 1
            self._finish_admission([(req, slot)],
                                   np.asarray([len(req.prompt_ids)],
                                              np.int32),
                                   last_logits, filled)
        return rest

    def register_prefix(self, tokens) -> int:
        """Prefill and pin the KV of a shared prompt prefix (e.g. a system
        prompt). Submissions whose prompt strictly extends it skip
        prefilling those tokens: admission runs one chunked forward over
        just the suffix (counted in ``stats()['prefix_hits']``). Returns
        the prefix length. Memory: one full-capacity cache row per
        registered prefix."""
        if self.paged:
            raise ValueError("the prefix cache is unpaged (the reference's "
                             "is too)")
        toks = tuple(int(t) for t in tokens)
        if not toks or len(toks) >= self.capacity:
            raise ValueError("prefix must be non-empty and below capacity")
        bucket = _bucket(len(toks), self.prefill_buckets)
        arr = np.zeros((1, bucket), np.int64)
        arr[0, :len(toks)] = toks
        _, frag = self._prefill(arr, np.asarray([len(toks)], np.int32),
                                self.capacity)
        self._prefixes.append((toks, frag))
        self._prefixes.sort(key=lambda kv: -len(kv[0]))
        return len(toks)

    def _match_prefix(self, prompt):
        """Longest registered prefix that the prompt STRICTLY extends (at
        least one suffix token must remain to prefill)."""
        for toks, frag in self._prefixes:
            if len(toks) < len(prompt) \
                    and tuple(prompt[:len(toks)]) == toks:
                return toks, frag
        return None

    def _map_admission(self, group_pairs, bucket):
        """Map the pages an admitted slot's insert copies
        (ceil(bucket / page)) plus the first decode token's, clamped to the
        capacity (engine.py:829-842), and upload the table once."""
        pages = -(-bucket // self.page_size)
        for _, slot in group_pairs:
            self.allocator.ensure_capacity(
                self.cache, slot,
                min(pages * self.page_size + 1, self.capacity), 0)
        self.allocator.upload(self.cache)

    def _map_decode(self, active, lengths_np, tokens_ahead):
        """Map the pages every active slot needs for ``tokens_ahead`` more
        tokens (engine.py:1068-1071,1102-1105) from the host lengths, and
        upload the table once if it changed (or a slot was released)."""
        for slot in active:
            self.allocator.ensure_capacity(self.cache, slot, tokens_ahead,
                                           int(lengths_np[slot]))
        self.allocator.upload(self.cache)

    def _finish_admission(self, group_pairs, lengths, last_logits,
                          prefilled):
        """Sample each admitted request's first token and scatter the
        group's prefilled KV rows into its slots (engine.py:849-914)."""
        g_n = len(group_pairs)
        last_logits = last_logits[:g_n]
        slots = [slot for _, slot in group_pairs]
        samp = None
        if self._per_request:
            for req, slot in group_pairs:
                sp = req.sampling or SamplingParams.GREEDY
                self._samp[:, slot] = (sp.temperature, sp.top_k, sp.top_p)
            self._samp_dev = None
            rows = torch.from_numpy(self._samp[:, slots]).to(self.device)
            samp = tuple(rows)
        firsts = self._sample(last_logits, samp)
        first_lps = None
        if self.logprobs:
            first_lps = torch.log_softmax(last_logits, dim=-1).gather(
                1, firsts[:, None].to(torch.int64))[:, 0].cpu().numpy()
        self.cache = self.cache.insert_group(prefilled, slots,
                                             lengths[:g_n])
        if self._device_tokens is not None:
            self._device_tokens[torch.as_tensor(
                slots, device=self.device)] = firsts
        firsts_np = firsts.cpu().numpy()
        if self.spec_draft:
            # Each admitted slot's history: the prompt, then its first
            # token (engine.py:896-903).
            rows = np.zeros((g_n, self.capacity), np.int32)
            for gi, (req, _) in enumerate(group_pairs):
                rows[gi, :len(req.prompt_ids)] = req.prompt_ids
                rows[gi, len(req.prompt_ids)] = firsts_np[gi]
            self._spec_history[torch.as_tensor(
                slots, device=self.device)] = torch.from_numpy(rows).to(
                    self.device)
        for gi, (req, slot) in enumerate(group_pairs):
            first = int(firsts_np[gi])
            req.tokens.append(first)
            if first_lps is not None:
                req.logprobs.append(float(first_lps[gi]))
            req.metrics.step()
            self.current_tokens[slot] = first
            self._host_lengths[slot] = int(lengths[gi])
            self.slot_request[slot] = req
            self._finish_if_done(slot, first, length=int(lengths[gi]))

    def _free_slot(self, slot):
        req = self.slot_request[slot]
        if req is not None:
            if req.metrics.ttft_s is not None:
                self._ttfts.append(req.metrics.ttft_s)
            self._itls.extend(req.metrics.step_times[1:])
        self.counters["completed"] += 1
        self.slot_request[slot] = None
        if self.paged:
            self.allocator.release_slot(self.cache, slot)

    def cancel(self, req) -> bool:
        """Abort a request: drop it from the queue if waiting, free its slot
        (and its pages) if decoding. The slot is re-admitted by the next
        step; its column of an earlier burst is rejected by the snapshot
        identity check."""
        if req.done:
            return False
        req.done = True
        self.counters["cancelled"] += 1
        if req in self.queue:
            self.queue.remove(req)
        for slot, r in enumerate(self.slot_request):
            if r is req:
                self.slot_request[slot] = None
                if self.paged:
                    self.allocator.release_slot(self.cache, slot)
                break
        return True

    def _finish_if_done(self, slot, token, length):
        req = self.slot_request[slot]
        if req is None:
            return
        if token in req.stop_ids or len(req.tokens) >= req.max_new_tokens \
                or length + 1 >= self.capacity:
            req.done = True
            self._free_slot(slot)

    def _commit_tokens(self, toks_np, lengths_np, snapshot,
                       lps_np=None) -> int:
        """Deliver a [n, B] burst of tokens (and their [n, B] logprobs) to
        the requests that were active at dispatch (``snapshot``), honouring
        stop conditions."""
        emitted = 0
        for slot, req in snapshot:
            if self.slot_request[slot] is not req:
                continue
            for i in range(toks_np.shape[0]):
                token = int(toks_np[i, slot])
                req.tokens.append(token)
                if lps_np is not None:
                    req.logprobs.append(float(lps_np[i, slot]))
                req.metrics.step()
                emitted += 1
                self.current_tokens[slot] = token
                self._finish_if_done(slot, token,
                                     length=int(lengths_np[slot]) + i + 1)
                if self.slot_request[slot] is None:
                    break
        return emitted

    def _active(self):
        return [s for s in range(self.max_batch)
                if self.slot_request[s] is not None]

    def step(self) -> int:
        """Admit queued requests, then one decode step for every slot.
        Returns the number of active slots."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        lengths_np = self._host_lengths.copy()
        if self.paged:
            self._map_decode(active, lengths_np, 2)
        nxt, lp = self._decode_one(torch.from_numpy(self.current_tokens).to(
            self.device), self._samp_args())
        self._host_lengths += 1
        if self._tail_flush:
            self._tail_fill += 1
            if self._tail_fill >= self._tail_flush:
                self._host_flush()
        self._device_tokens = None
        if self.spec_draft:
            self._hist_write(nxt[None, :], lengths_np)
        emitted = self._commit_tokens(
            nxt.cpu().numpy()[None, :], lengths_np,
            [(s, self.slot_request[s]) for s in active],
            None if lp is None else lp.cpu().numpy()[None, :])
        self._count(emitted, 1)
        return len(active)

    def _dispatch_burst(self, n):
        """Run ``n`` decode steps with the tokens chained on the device and
        the window flushed after every ``_tail_flush`` steps. Returns
        (tokens [n, B] on the device, their logprobs [n, B] or None, slot
        snapshot, pre-burst lengths, n), or None when no slot is active."""
        active = self._active()
        if not active:
            return None
        lengths_np = self._host_lengths.copy()
        headroom = self.capacity - 1 - max(int(lengths_np[s])
                                           for s in active)
        n = min(n, max(1, headroom))
        if self.paged:
            self._map_decode(active, lengths_np, n + 1)
        if self._tail_flush and self._tail_fill:
            self._host_flush()
        if self._device_tokens is None:
            self._device_tokens = torch.from_numpy(
                self.current_tokens).to(self.device)
        tokens, outs, lps = self._device_tokens, [], []
        samp = self._samp_args()
        fl = self._tail_flush
        for i in range(n):
            tokens, lp = self._decode_one(tokens, samp)
            outs.append(tokens)
            lps.append(lp)
            if fl and (i + 1) % fl == 0:
                self.cache = self.cache.flush_tail(fl)
        self._device_tokens = tokens
        outs = torch.stack(outs)
        lps = torch.stack(lps) if self.logprobs else None
        if self.spec_draft:
            self._hist_write(outs, lengths_np)
        self._host_lengths += n
        if fl:
            self._tail_fill = n % fl
        snapshot = [(s, self.slot_request[s]) for s in active]
        return outs, lps, snapshot, lengths_np, n

    def _hist_write(self, toks, lengths_np):
        """Write a plain step's or burst's tokens [n, B] into the
        speculative history after each slot's pre-burst depth
        (engine.py:585-593), so a later speculative burst drafts from, and
        verifies after, the committed stream."""
        n, b = toks.shape
        start = torch.clamp(torch.from_numpy(lengths_np + 1), 0,
                            self.capacity - n).to(self.device)
        cols = start[:, None] + torch.arange(n, device=self.device)[None, :]
        self._spec_history[torch.arange(b, device=self.device)[:, None],
                           cols] = toks.T.to(torch.int32)

    def step_burst(self, n: int) -> int:
        """Admit, run ``n`` decode steps on the device, then do the host
        bookkeeping once. Returns tokens emitted to live requests."""
        self._admit()
        inflight = self._dispatch_burst(n)
        if inflight is None:
            return 0
        toks, lps, snapshot, lengths_np, n = inflight
        emitted = self._commit_tokens(
            toks.cpu().numpy(), lengths_np, snapshot,
            None if lps is None else lps.cpu().numpy())
        self._count(emitted, n)
        return emitted

    # -- speculative decoding ----------------------------------------------

    def _commit_spec(self, toks_np, counts_np, lengths_np, snapshot) -> int:
        """Deliver a speculative burst (engine.py:1198-1225): ``toks_np``
        [n, B, k+1] greedy rows, ``counts_np`` [n, B] accepted counts with
        the bonus token; each step commits the first ``counts`` entries of
        its row."""
        emitted = 0
        for slot, req in snapshot:
            if self.slot_request[slot] is not req:
                continue
            base, off = int(lengths_np[slot]), 0
            for i in range(toks_np.shape[0]):
                c = int(counts_np[i, slot])
                for j in range(c):
                    token = int(toks_np[i, slot, j])
                    req.tokens.append(token)
                    req.metrics.step()
                    emitted += 1
                    self.current_tokens[slot] = token
                    self._finish_if_done(slot, token,
                                         length=base + off + j + 1)
                    if self.slot_request[slot] is None:
                        break
                off += c
                if self.slot_request[slot] is None:
                    break
        return emitted

    def step_spec_burst(self, n: int) -> int:
        """Admit, then run ``n`` speculative steps on the device (each
        emits 1..k+1 tokens per slot) with one host sync
        (engine.py:1227-1293). Returns the tokens emitted to live
        requests."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        lengths_np = self._host_lengths.copy()
        k = self._spec_k if self._k_adaptive else self.spec_draft
        # Every step may accept everything: keep (k + 1) * n inside the
        # cache (the chunk append clamps, so tokens past it are garbage).
        headroom = self.capacity - 1 - max(int(lengths_np[s])
                                           for s in active)
        n = min(n, max(1, headroom // (k + 1)))
        burst = make_spec_burst(self.model, self.spec_ngram, k)
        t0 = time.perf_counter()
        self._spec_history, self.cache, toks, counts, last = burst(
            self.params, self._spec_history, self.cache, n)
        self._device_tokens = last
        counts_np = counts.cpu().numpy()
        toks_np = toks.cpu().numpy()
        wall = time.perf_counter() - t0
        c = self.counters
        c["spec_bursts"] = c.get("spec_bursts", 0) + 1
        c["spec_steps"] = c.get("spec_steps", 0) + n
        c["spec_wall_s"] = round(c.get("spec_wall_s", 0.0) + wall, 4)
        self._host_lengths += counts_np.sum(axis=0)
        emitted = self._commit_spec(toks_np, counts_np, lengths_np,
                                    [(s, self.slot_request[s])
                                     for s in active])
        # Acceptance from live emissions only: a finished slot keeps
        # accepting its own stale drafts.
        tps = emitted / (n * len(active))
        self._spec_tps = (tps if self._spec_tps is None
                          else 0.6 * self._spec_tps + 0.4 * tps)
        self._adapt_k()
        self._count(emitted, n)
        return emitted

    def _adapt_k(self):
        """The draft-length ladder (engine.py:1463-1477): shrink below 35%
        of the drafts accepted, regrow above 70%."""
        if not (self._k_adaptive and self.spec_draft > 1) \
                or self._spec_tps is None:
            return
        frac = (self._spec_tps - 1.0) / max(self._spec_k, 1)
        if frac < 0.35 and self._spec_k > 1:
            self._spec_k -= 1
        elif frac > 0.70 and self._spec_k < self.spec_draft:
            self._spec_k += 1

    def _count(self, emitted, steps):
        c = self.counters
        c["tokens"] += emitted
        c["decode_steps"] += steps
        c["bursts"] += 1
        if self._log_every and c["bursts"] % self._log_every == 0:
            print(json.dumps({"engine_stats": self.stats()}),
                  file=sys.stderr, flush=True)

    @staticmethod
    def _pctl(samples, q):
        if not samples:
            return None
        s = sorted(samples)
        return s[min(len(s) - 1, int(q * len(s)))]

    def stats(self) -> dict:
        """Serving counters: queue depth, batch occupancy, cumulative
        tokens/s, and TTFT / inter-token / admission-stall percentiles."""
        active = sum(r is not None for r in self.slot_request)
        uptime = time.perf_counter() - self._t_start
        out = {**self.counters, "active": active, "queued": len(self.queue),
               "occupancy": active / self.max_batch,
               "uptime_s": round(uptime, 3),
               "tokens_per_s": round(self.counters["tokens"]
                                     / max(uptime, 1e-9), 1)}
        for name, res in (("ttft", self._ttfts), ("itl", self._itls),
                          ("admit_stall", self._admit_stalls)):
            for q, label in ((0.5, "p50"), (0.99, "p99")):
                v = self._pctl(res, q)
                if v is not None:
                    out[f"{name}_{label}_ms"] = round(1000 * v, 2)
        if self._admit_stalls:
            out["admit_stall_max_ms"] = round(
                1000 * max(self._admit_stalls), 2)
        if self.spec_draft:
            out["spec_on"] = True       # always-draft: no gate turns it off
            out["spec_adaptive"] = self.spec_adaptive
            out["spec_k"] = self._spec_k
            if self._spec_tps is not None:
                out["spec_tokens_per_step"] = round(self._spec_tps, 2)
        return out

    def _pending(self) -> bool:
        return bool(self.queue
                    or any(r is not None for r in self.slot_request))

    def run(self, requests=None, max_steps=100000, burst=1):
        """Drive the engine until every request completes; ``burst`` > 1
        decodes that many tokens per host sync. A speculative engine runs
        speculative bursts of ``burst`` steps (engine.py:1556-1606 with
        ``spec_adaptive=False``)."""
        for req in requests or ():
            if req not in self.queue and not req.done:
                self.queue.append(req)
        steps = 0
        while self._pending() and steps < max_steps:
            if self.spec_draft:
                self.step_spec_burst(max(burst, 1))
            elif burst > 1:
                self.step_burst(burst)
            else:
                self.step()
            steps += 1
        return steps

    def generate(self, prompts, max_new_tokens=32, stop_ids=(), burst=1):
        """Synchronous batch API: returns a list of generated-token lists."""
        reqs = [self.submit(p, max_new_tokens, stop_ids) for p in prompts]
        self.run(burst=burst)
        return [r.tokens for r in reqs]
