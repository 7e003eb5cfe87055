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
admission (``_host_flush``).

PyTorch runs eagerly, so a burst is a Python loop of decode steps whose
tokens stay on the device until the burst ends (one host sync per burst).
Slot bookkeeping is the reference's Python path; the ``native/scheduler``
bridge and CUDA-graph bursts are later work (ROADMAP.md).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.attention import fits_shared_memory
from .metrics import Metrics
from .sampler import ArgMaxSampler, Sampler


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def flat_group_for(batch):
    """The reference's decode group width for a quantized batch
    (transformer.py:355-360); 0 means the batch has no valid group and the
    tail window stays off, as in the reference's gate."""
    return next((g for g in (16, 8, 4, 2)
                 if batch % g == 0 and batch >= 2 * g), 0)


@dataclass
class Request:
    prompt_ids: list
    max_new_tokens: int = 128
    stop_ids: tuple = ()
    # filled by the engine:
    request_id: int = -1
    tokens: list = field(default_factory=list)
    done: bool = False
    metrics: Metrics = field(default_factory=Metrics)


class ServingEngine:
    def __init__(self, model, params, max_batch=8, capacity=1024,
                 sampler: Optional[Sampler] = None, quantized_cache=False,
                 prefill_buckets=(64, 128, 256, 512, 1024),
                 cache_dtype=None, fused_head=None, tail_window=None,
                 device="cuda", mesh=None, paged=False, spec_draft=0):
        """``tail_window``: None picks the window by the reference's gate
        (16 for an int8 cache where it applies), 0 disables it, n > 0
        forces depth n (int8 caches only). ``device``: "cuda" (default) or
        "cpu"; ``params`` must lie on it."""
        for value, what, item in (
                (mesh, "meshes", "Queue 1 item 14, parallel/"),
                (paged, "paged caches", "Queue 1 item 11"),
                (spec_draft, "speculative decoding", "Queue 1 item 11")):
            if value:
                raise NotImplementedError(
                    f"{what} are not ported yet (ROADMAP.md {item})")
        self.sampler = sampler or ArgMaxSampler()
        if not isinstance(self.sampler, ArgMaxSampler):
            raise NotImplementedError(
                "only greedy sampling is ported (ROADMAP.md Queue 1 item 11, "
                "per-request samplers)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.capacity = capacity
        self.quantized_cache = quantized_cache
        self.cache_dtype = cache_dtype
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= capacity) or (capacity,)

        cfg = model.config

        def tail_shape_ok():
            # The reference's gate (engine.py:241-303) minus its TPU VMEM
            # terms; the port's own limit is the tail kernel's shared
            # memory (one score row of capacity + window floats).
            if not flat_group_for(max_batch):
                return False
            if capacity >= 2048 and capacity % 128:
                return False
            return (capacity % 64 == 0
                    and (cfg.n_kv_heads * cfg.head_dim) % 128 == 0
                    and fits_shared_memory(cfg.head_dim, capacity, 16))

        self._tail_flush = 0
        if tail_window is not None:
            if tail_window and not quantized_cache:
                raise ValueError("tail_window requires a quantized cache")
            self._tail_flush = int(tail_window)
        elif (quantized_cache and cfg.use_pallas
              and cfg.decode_attn in ("auto", "flat") and tail_shape_ok()):
            self._tail_flush = 16
        if self.device.type == "cuda" and not self._tail_flush:
            raise NotImplementedError(
                "decode without the tail window is not ported to CUDA yet "
                "(ROADMAP.md Queue 1 items 5 and 6: the f32/bf16-cache "
                "path and the no-tail int8 path)")
        self.cache = model.new_cache(max_batch, capacity,
                                     quantized=quantized_cache,
                                     cache_dtype=cache_dtype,
                                     tail_window=self._tail_flush,
                                     device=self.device)
        # Host mirror of cache.tail_count (+1 per decode step, 0 after a
        # flush).
        self._tail_fill = 0
        self._fused_head = (fused_head if fused_head is not None
                            else hasattr(model, "decode_step_argmax"))

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
                         "bursts": 0, "decode_steps": 0}
        self._t_start = time.perf_counter()
        self._ttfts = deque(maxlen=2048)
        self._itls = deque(maxlen=8192)
        self._admit_stalls = deque(maxlen=2048)

    # -- device programs -----------------------------------------------------

    def _prefill(self, tokens, lengths, cap):
        """Batched prefill of an admission group: tokens [G, bucket],
        lengths [G] (numpy). Returns (last-token logits [G, V], the group
        cache of capacity ``cap``)."""
        group = tokens.shape[0]
        cache = self.model.new_cache(group, cap,
                                     quantized=self.quantized_cache,
                                     cache_dtype=self.cache_dtype,
                                     device=self.device)
        tok = torch.from_numpy(tokens).to(self.device)
        lens = torch.from_numpy(lengths).to(self.device)
        last, cache = self.model.prefill_last(self.params, tok, cache,
                                              lens.to(torch.int64) - 1)
        return last, cache.with_lengths(lens)

    def _decode_one(self, tokens):
        """One decode step for every slot; returns next tokens int32 [B]
        on the device."""
        if self._fused_head:
            nxt, self.cache = self.model.decode_step_argmax(
                self.params, tokens, self.cache)
            return nxt
        logits, self.cache = self.model.decode_step(self.params, tokens,
                                                    self.cache)
        return self.sampler.sample(logits)

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=128,
               stop_ids=()) -> Request:
        req = Request(list(map(int, prompt_ids)), max_new_tokens,
                      tuple(stop_ids))
        if len(req.prompt_ids) >= self.capacity:
            raise ValueError(f"prompt length {len(req.prompt_ids)} exceeds "
                             f"cache capacity")
        if len(req.prompt_ids) > max(self.prefill_buckets):
            raise ValueError(
                f"prompt length {len(req.prompt_ids)} exceeds the largest "
                f"prefill bucket ({max(self.prefill_buckets)})")
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
        by_bucket: dict = {}
        for req, slot in zip(batch_reqs, free):
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
            last_logits, prefilled = self._prefill(
                tokens, lengths, min(bucket, self.capacity))
            self._finish_admission(group_pairs, lengths, last_logits,
                                   prefilled)

    def _finish_admission(self, group_pairs, lengths, last_logits,
                          prefilled):
        """Sample each admitted request's first token and scatter the
        group's prefilled KV rows into its slots."""
        g_n = len(group_pairs)
        firsts = self.sampler.sample(last_logits[:g_n])
        slots = [slot for _, slot in group_pairs]
        self.cache = self.cache.insert_group(prefilled, slots,
                                             lengths[:g_n])
        if self._device_tokens is not None:
            self._device_tokens[torch.as_tensor(
                slots, device=self.device)] = firsts
        firsts_np = firsts.cpu().numpy()
        for gi, (req, slot) in enumerate(group_pairs):
            first = int(firsts_np[gi])
            req.tokens.append(first)
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

    def _finish_if_done(self, slot, token, length):
        req = self.slot_request[slot]
        if req is None:
            return
        if token in req.stop_ids or len(req.tokens) >= req.max_new_tokens \
                or length + 1 >= self.capacity:
            req.done = True
            self._free_slot(slot)

    def _commit_tokens(self, toks_np, lengths_np, snapshot) -> int:
        """Deliver a [n, B] burst of tokens to the requests that were
        active at dispatch (``snapshot``), honouring stop conditions."""
        emitted = 0
        for slot, req in snapshot:
            if self.slot_request[slot] is not req:
                continue
            for i in range(toks_np.shape[0]):
                token = int(toks_np[i, slot])
                req.tokens.append(token)
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
        nxt = self._decode_one(torch.from_numpy(self.current_tokens).to(
            self.device))
        self._host_lengths += 1
        if self._tail_flush:
            self._tail_fill += 1
            if self._tail_fill >= self._tail_flush:
                self._host_flush()
        self._device_tokens = None
        emitted = self._commit_tokens(nxt.cpu().numpy()[None, :],
                                      lengths_np,
                                      [(s, self.slot_request[s])
                                       for s in active])
        self._count(emitted, 1)
        return len(active)

    def _dispatch_burst(self, n):
        """Run ``n`` decode steps with the tokens chained on the device and
        the window flushed after every ``_tail_flush`` steps. Returns
        (tokens [n, B] on the device, slot snapshot, pre-burst lengths, n),
        or None when no slot is active."""
        active = self._active()
        if not active:
            return None
        lengths_np = self._host_lengths.copy()
        headroom = self.capacity - 1 - max(int(lengths_np[s])
                                           for s in active)
        n = min(n, max(1, headroom))
        if self._tail_flush and self._tail_fill:
            self._host_flush()
        if self._device_tokens is None:
            self._device_tokens = torch.from_numpy(
                self.current_tokens).to(self.device)
        tokens, outs = self._device_tokens, []
        fl = self._tail_flush
        for i in range(n):
            tokens = self._decode_one(tokens)
            outs.append(tokens)
            if fl and (i + 1) % fl == 0:
                self.cache = self.cache.flush_tail(fl)
        self._device_tokens = tokens
        self._host_lengths += n
        if fl:
            self._tail_fill = n % fl
        snapshot = [(s, self.slot_request[s]) for s in active]
        return torch.stack(outs), snapshot, lengths_np, n

    def step_burst(self, n: int) -> int:
        """Admit, run ``n`` decode steps on the device, then do the host
        bookkeeping once. Returns tokens emitted to live requests."""
        self._admit()
        inflight = self._dispatch_burst(n)
        if inflight is None:
            return 0
        toks, snapshot, lengths_np, n = inflight
        emitted = self._commit_tokens(toks.cpu().numpy(), lengths_np,
                                      snapshot)
        self._count(emitted, n)
        return emitted

    def _count(self, emitted, steps):
        c = self.counters
        c["tokens"] += emitted
        c["decode_steps"] += steps
        c["bursts"] += 1

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
        return out

    def _pending(self) -> bool:
        return bool(self.queue
                    or any(r is not None for r in self.slot_request))

    def run(self, requests=None, max_steps=100000, burst=1):
        """Drive the engine until every request completes; ``burst`` > 1
        decodes that many tokens per host sync."""
        for req in requests or ():
            if req not in self.queue and not req.done:
                self.queue.append(req)
        steps = 0
        while self._pending() and steps < max_steps:
            if burst > 1:
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
