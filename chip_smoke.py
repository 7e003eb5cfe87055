#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``rten_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: requires CUDA, prints the card's name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles every CUDA kernel from ``rten_tpu_torch/csrc`` (parallel
   nvcc) and prints the build time and ptxas reports.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving paths' shapes (GPT-2-small, batch 256, capacity 512, tail
   window 16, live lengths 65-176), with CUDA-event timings (cold L2, warm
   median) of the kernel, the plain version and, where one PyTorch call
   computes the same function, that call; plus each kernel's lower bound
   from its bytes and operations; K1 and K1' also in their exact-q mode
   (``q_bf16=False``, the reference's ``RTEN_FLAT_QBF16=0``), held to
   K6's tolerance. K2 (``head_argmax_int8``) also at M 1,
   16 and 64 (printed, with TFLOP/s and the share of the bound); K4
   (``matmul_int8_wo``, K2's tiles with a store epilogue) at M 64 and
   also at M 1, 16 and 32 (extra keys, with TFLOP/s and the share of the
   bound), with the CUDA kernels a call launches (profiler: the convert
   and the tile, two; more fails). The int4
   GEMMs (Q1 ``matmul_int4_words``, Q1' ``matmul_int4_words_int8``, Q2
   ``matmul_int4``) at every TinyLlama weight shape at decode M = 16 and at
   one prefill M = 1024, Q1 and Q2 also at Mistral-7B's w_gate at M 8192,
   each entry summed over the calls of one decode step of path (F) that
   reach it (111 for Q1 and Q1', 67 for Q2: under the byte layout wqkv and
   wo run as a bf16 dot on their dequantized copy), with the prefill
   shapes' times, bounds and library times as extra keys, each wrapper's
   launch count per call (must be 1) and the CUDA kernels a call launches
   (profiler: Q1' two; Q1 and Q2 one at decode, which is checked, and two
   at prefill); V1 (``verify_attn_grouped``
   at batch 8 and ``verify_attn_fused`` at batch 3, capacity 2048, S 4,
   lives 64-320, each in its float mode on a bf16 cache, with
   ``scaled_dot_product_attention`` as the library call, and its int8
   mode), V1 again at K6's shapes (batch 256, capacity 512, printed), each
   beside one decode query per sequence through K6 or K1' on the same
   cache; K1, K1' and K3 again at TinyLlama's shapes (batch 16, 32 heads
   over 4 KV heads, capacity 2048); K1 at capacity 16384 and K1' at 12288
   (batch 4, lives past 12,100 tokens). At path (H)'s shapes (32 query
   heads over 8 KV heads of 128): F1 (``flash_attention``, B 16, S 512,
   causal, f32, split-TF32 tensor-core products: its bound at the TF32
   peak, the f32 SIMT bound printed beside it; the library call f32
   ``scaled_dot_product_attention(is_causal=True)``), G1
   (``decode_attn_grouped_int8``) with exact q at capacity 4096 and
   with int8 scores at 1024 (its int32 dots held bit for bit), G2
   (``decode_attn_fused_int8``) at batch 3, and A1
   (``decode_attn_grouped_append``) on a bf16 and an f32 cache (the write
   held bit for bit against K5), lives 512-576. The kernels of the last
   four TPU functions: K8 (``decode_attn_flat_float``) at path (I)'s
   shapes on an f32 and a bf16 cache (the library calls f32 and bf16
   ``scaled_dot_product_attention``) and at TinyLlama's (printed); the
   partials mode (``decode_attn_int8_partials``, on the KV-group kernel,
   q_bf16 on and off) at path (B)'s shapes and at TinyLlama's (q_bf16,
   splits merged in their cluster; a sequence of length 0 emits m = -1e30
   and l 0); K9 (``decode_attn_split_kv``, separate f32 and bf16 K
   and V planes of S 4096) at path (H)'s head shape (f32 and bf16 SDPA
   with ``enable_gqa``);
   ``decode_attn_native_dots`` at path (C)'s bf16 shapes (bf16 SDPA); G1's
   ``pv_int8`` mode at path (H)'s shapes in both score modes; M1
   (``matmul_int8_tiled``, ``wgmma`` s8 over a TMA-fed ring) bit for bit
   at GPT-2-small's four linears at M 256 and 4096 and at a ragged shape
   (the masked loader) (``torch._int_mm`` and the epilogue). No path reaches
   the last five: their entries carry ``"path": null``. K6
   (``decode_attn_float``) at path (A)'s f32 and (C)'s bf16 cache (f32 and
   bf16 SDPA), at batch 3 (the reference's fused fallback) and at
   TinyLlama's GQA (B 16, 32 heads over 4 KV heads, capacity 2048); P2
   (``kv_append_paged_int8``) with and without its all-zero head. K5
   (``kv_append``, on (A)'s f32 and (C)'s bf16 cache), P1
   (``kv_append_paged``), K7, P2 and K3 (``tail_flush_int8``, at the
   burst's t 16 and at an admission's t 5 of its 16-row window) run one
   kernel body (``csrc/kv_append.cuh``) and must launch one CUDA kernel a
   call (profiler). P3, its grid mode, P3i, G1 (both score modes), G2, K6
   (f32 and bf16), K8 (f32 and bf16), K9 (f32 and bf16 planes) and V1
   (both entries, both modes) run the KV-group kernel
   (``csrc/decode_attn_kv_group.cuh``): the plan (splits a sequence,
   blocks, warps a block, query rows a warp, the ring) is printed and
   their entries add the CUDA kernels a call launches (profiler), which
   must be one. The kernels whose
   job is a rounding are held to criteria that the kernel without it
   misses, and the script checks that it does: K8 (and the partials
   mode's acc) to one bf16 step of each element and 99.9% of the elements
   within 2e-5 of max |out| (K6 at K8's inputs must miss it), native_dots
   and pv_int8 to 99% within 1e-5 (K6, and G1 without pv_int8, must
   miss it).
4. Serving paths, each ``ServingEngine`` at batch 256, capacity 512,
   64-token prompts, greedy, bursts of 21, after a warm-up serve; launch
   counts are set to 0 before each measured run and every kernel of the
   path must have launched:
   - int8 + tail: int8 weights (``init_params(0)``), an int8 KV cache with
     the 16-token bf16 tail; 320 requests of 48 new tokens, so slots are
     recycled and the 64 leftover requests are admitted as one group.
   - (A) f32: the same weights unquantized, an f32 cache (the baseline of
     ``bench.py``); 320 requests of 48 new tokens.
   - (B) int8 without a tail: int8 weights, ``tail_window=0``; 320
     requests of 48 new tokens.
   - (C) bf16 cache: int8 weights, ``cache_dtype="bfloat16"``; 288
     requests of 24 new tokens.
   - (D) paged int8: int8 weights, ``paged=True, page_size=64`` with an
     int8 page pool; 320 requests of 48 new tokens.
   - (E) paged f32: f32 weights, ``paged=True, page_size=64`` with an f32
     page pool; 320 requests of 48 new tokens.
   - int8 + tail and (B) with ``RTEN_FLAT_QBF16=0``: 256 requests of 16
     new tokens each; K1's (K1''s) exact-q mode must launch and its
     rounded mode never.
   - (I) flat f32: f32 weights and cache with ``decode_attn="flat"``: K8
     once per layer and decode step, K6 never; 320 requests of 48 new
     tokens. (I-bf16): int8 weights on a bf16 cache, 256 requests of 16.
   For int8 + tail, (A), (D), (E) and (I): decode at a full batch, one
   burst timed on the host clock and one traced by torch.profiler (time by
   kernel, the card's busy share; the device time a step of K3 on int8 +
   tail, P3i on (D), P3 on (E) and K8 on (I)); for
   (B) and (C) the timed burst only;
   for (D) and (E) also the host time of the allocator's pass before a
   burst. Then one line with the int8 + tail and f32 decode tokens/s of
   this run and their ratio, and each paged path's steady burst against
   its contiguous counterpart in three rounds of turns ((A), (E), (E),
   (A) and (B), (D), (D), (B)).
   Then path (G), speculative serving at ``tools/profile_spec.py``'s
   defaults: GPT-2-small with int8 weights, ``ServingEngine(max_batch=8,
   capacity=2048, prefill_buckets=(64,), cache_dtype="bfloat16",
   spec_draft=3, spec_ngram=3, spec_adaptive=False)``, bursts of 16, 16
   requests x 256 new tokens on repetitive (one 8-token period tiled) and
   on random 64-token prompts, in turns with the plain engine at the same
   settings (plain, spec, spec, plain; ``verify_attn_grouped`` in its float
   mode and ``matmul_int8_wo`` must launch), and one burst traced (the
   kernels that take the most device time, and K4's and V1's time per
   step);
   (G-int8), the same
   speculative serve on an int8 cache (``verify_attn_grouped`` in its int8
   mode must launch); and (G) card against CPU at ``max_batch=3`` (no
   group: ``verify_attn_fused`` must launch in each mode), 3 requests of 8
   tokens x 16 new tokens: f32 weights on an f32 cache give the CPU's
   tokens and the card's plain engine's; int8 weights on an int8 cache give
   logits within a stated tolerance and tokens apart only after a
   near-tie.
   Then path (F), TinyLlama-1.1B at full width (``init_params(0)``, int4
   words weights) through ``ServingEngine(max_batch=16, capacity=2048,
   quantized_cache=True)`` (tail window 16): 24 requests of 64-token
   prompts x 64 new tokens (slots recycle), a timed and a traced steady
   burst at batch 16, and two short serves of 16 requests x 16 tokens, one
   with the byte-packed weights (``matmul_int4`` must launch) and one with
   ``RTEN_INT4_DOT=int8`` (``matmul_int4_words_int8`` must launch).
   Then path (H), Mistral-7B's shape (``TransformerConfig.mixtral(
   n_experts=0)``: 32 layers, d_model 4096, 32 query heads over 8 KV
   heads of 128) with random int4 words weights drawn and quantized on the
   card layer by layer (``TransformerLM.init_int4_params``), through
   ``ServingEngine(max_batch=16, capacity=4096, quantized_cache=True,
   prefill_buckets=(512,))``: 24 requests of 512-token prompts x 64 new
   tokens (two admission groups), F1 once per layer and prefill, G1 with
   exact q and K7 once per layer and decode step, K1, K1' and K3 never;
   a timed and a traced steady burst (G1's device time a step). Its
   variants at 4 layers: (H-fused)
   ``max_batch=3`` (G2), (H-scores) ``decode_attn="grouped"`` at capacity
   1024 (G1 with int8 scores) and (H-append) a bf16 cache with
   ``fused_append=True`` (A1; K5 and K6 never).
5. Card against CPU, for int8 + tail, (A) and (D): the same weights, 8
   requests of 8 tokens x 16 new tokens, on the card and with
   ``device="cpu"`` (plain versions), with the fused argmax head and with
   recorded logits; logits must agree within a stated tolerance and greedy
   tokens must match except after a near-tie step; the same for (I) (K8
   must launch, K6 not). For (E) the same at
   ``max_batch=3`` with 3 requests, a batch with no group, where the paged
   decode takes the grid kernel, which must launch there. For (F) at
   TinyLlama's width with 2 layers: 4 requests of 8 tokens x 16 new tokens,
   logits + argmax (the int4 head has no fused argmax). For (H) with 1
   layer at full width: 4 requests of 128-token prompts (F1 on the card) x
   9 new tokens (G1 each decode step), logits + argmax; (H-fused) the same
   with 3 requests (G2 each decode step).

6. Path (J), the `.rten` graph runtime: ResNet-50 (224 x 224, 1000
   classes, the reference's random weights) built as ``tools/
   bench_vision.py`` builds it (``build_rten``, ``quantize_graph_weights``)
   and run through ``rten_tpu_torch.runtime.Model`` in f32 and INT8 (every
   Conv optimized to DynamicQuantizeLinear → ConvInteger → Cast → Mul) at
   batch 32: images/s over 5 runs and the ops' share of a timed run
   (``RunTiming``, CUDA events); each against the CPU at batch 2 (f32
   within 1e-3 of max |logit|, TF32 off; INT8 within 1e-2 and the same
   top-1 except after a near-tie); the first three ConvInteger
   accumulators card against CPU bit for bit; and a FusedSDPA graph at
   S 512, D 128 that must launch F1 once (its launches counted from 0 in
   that run) and meet the CPU within K6's tolerance.

7. Path (K), the HTTP server (``rten_tpu_torch.serve``) in-process over
   ``build_engine(--demo --quantize int8 --max-batch 64 --capacity 1024)``
   with bursts of 8: GPT-2-small, ``cache="auto"`` (int8 + the 16-token
   tail), the per-request sampler (no fused head). After a warm-up
   completion and with the launch counts set to 0: a 48-token prefix
   registered (``POST /v1/prefixes``) and 96 concurrent completions of
   64-token prompts x 48 new tokens (32 greedy, 32 streamed at temperature
   0.8, top-k 40, top-p 0.95, 32 under the prefix); every completion's ids
   (streamed deltas concatenated) in the vocabulary and equal to its
   engine request's tokens; ``/stats`` counts 32 prefix hits; K1 once per
   layer and decode step, K4 at least once a step (the LM head), K3 on
   every flush, V1's fused int8 entry 12 layers x 8 slices a prefix hit,
   K2 never. The wall time, requests/s, decode tokens/s and ``/stats``'s
   p50 TTFT are printed. Then one greedy completion alone against
   ``engine.generate`` of the same configuration, a chat completion
   (plain and streamed) through a char-level stub tokenizer, a
   ``--logprobs`` server (4 requests served alone, each logprob <= 0 and
   within 1e-4 of a teacher-forced replay of the request through the same
   engine steps on the card); then the server's engine card against CPU
   (the prefix registered, a hit and a cold prefill admitted together, 4
   greedy decode steps at batch 64: logits within PATH_LOGIT_TOL, K1, K3,
   K4 and V1 launched on the card), one admission of the same 64-token
   prompt cold and as a prefix hit timed in turns, the sampler's top-64
   against a stable sort with ties and its device time; and the CLI
   (``python -m rten_tpu_torch.serve --demo --quantize int8``) as a
   subprocess: /health, one completion, SIGINT. K1 and K3 at B 64,
   capacity 1024 and V1's fused entry at B 1, S 8, capacity 1024 are held
   against their plain versions with the kernel phases (printed).

8. The last configurations of the model (bf16 compute, ``scan_layers``,
   MoE). After the GPT-2 card-against-CPU phases: (L-scan), GPT-2-small
   with ``scan_layers=True`` over its int8 layers stacked by
   ``stack_layer_params`` and a stacked bf16 cache (``cache="bf16"``) at
   batch 64, 64 requests x 16 new tokens, K5 and K6 once per layer and
   decode step on each layer's view, its tokens equal to the same
   engine's without ``scan_layers``; (L-bf16), GPT-2-small int8 + tail
   with ``dtype="bfloat16"`` card against CPU at batch 64 (64 requests of
   8 tokens x 20 new tokens, capacity 128: K1, K3, K2 and K4 on bf16
   activations). After path (H): path (L), Mixtral-8x7B
   (``TransformerConfig.mixtral(dtype="bfloat16")``: 32 layers, d_model
   4096, d_ff 14336, 8 experts, top 2, 32 query heads over 8 KV heads of
   128, vocabulary 32000) with random int8 weights and expert stacks
   drawn on the card expert by expert
   (``init_int8_params``, ~47 GB), through ``ServingEngine(max_batch=16,
   capacity=1024, cache="auto")`` (an int8 cache without a tail): 16
   requests of 64-token prompts x 32 new tokens, decode tokens/s, p50
   TTFT, G1 with exact q and K7 once per layer and decode step, K4 and K2,
   F1 never (64 keys: the reference's XLA attention), the expert MLP on
   its dense path; a timed and a traced steady burst (ms a step) and the
   card's peak memory beside the weights' bytes. (L-ragged): its first 2
   layers with float (dequantized) expert stacks: an admission prefill of
   16 x 64 tokens takes the ragged path in both layers and a decode step
   the dense one (``moe.impl_counts``), its logits within
   MIXTRAL_PATH_LOGIT_TOL of the same prefill forced dense, then 16
   requests x 8 tokens served. (L) card against CPU at 1 layer: 2 requests
   of 128 tokens x 6 new tokens, logits + argmax; its prefill runs F1 once
   under bf16 compute. With the kernel phases: K4 at (L)'s wqkv (4096 x
   6144), wo (4096 x 4096) and LM head (4096 x 32000) and K2 at its head,
   M 16, and G1 with exact q at B 16, capacity 1024, lives 64-96, each on
   bf16-valued inputs against its plain version (extra keys
   ``m16_l_<weight>_*`` of K4's and K2's entries, ``l_*`` of G1's).

9. The other model families, after path (K), random weights drawn in the
   reference's numpy order. Path (M): Whisper-small
   (``EncoderDecoderConfig.whisper_small()``, ``tools/bench_whisper.py``'s
   configuration: 12 + 12 layers, 12 heads of 64, vocabulary 51865) over
   8 x 3000 frames, ``generate(start_token=1, max_tokens=64, burst=16)``
   on an f32 cache and on an int8 cache (``quantized_cache=True``):
   encode ms, the generate's tokens/s, a timed decode burst (ms a step,
   tokens/s) and peak memory; each decode step launches K5 and K6 (f32)
   or K7 and G2 (int8, capacity 448) 12 times and no other kernel of the
   repository (no F1 at head_dim 64, no G1). (M-512): 17 decode steps on
   an int8 cache of capacity 512: K7 and G1 with int8 scores, 12 a step.
   (M) card against CPU at 2 + 2 layers of full width, batch 2, 400
   frames, 8 steps (K6 and G2 in their fused forms). Path (N): BERT-base
   (``BertConfig()``) at 32 x 128 tokens with right padding, ``pooled``,
   ``qa_spans`` and ``mean_embedding`` in f32 and dynamic int8
   (``quantize_weights``), sequences/s, and card against CPU at 2 layers.
   Path (O): ViT-S/16 ``classify`` and ``DepthEstimator`` at 32 x 224²,
   SAM at batch 4 with 3 points, the ASPP segmenter on ResNet-50 at batch
   8, TTS at batch 8 x 64 phonemes: a timed forward each, and card against
   CPU at reduced depth. With the kernel phases: K5, K6, K7, G1 (int8
   scores) and G2 at (M)'s decode shape (B 8, 12 heads of 64, lives 1-64,
   capacity 448; 512 for G1), the ``w_*`` keys of their entries.

Prints a ``{"kernels": [...]}`` JSON line (V1 with one entry per entry
point and mode, G1 per mode; K1, K3, K4 and V1's fused int8 entry carry
their path (K) launches as ``k_launches``, every entry its path (L)
launches as ``l_launches``, K5, K6, K7, G1 (int8 scores) and G2 their
(M) / (M-512) launches as ``m_launches``), then as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from rten_tpu_torch import kernels
from rten_tpu_torch.fmt import container as fmt_container
from rten_tpu_torch.fmt.model_builder import ModelBuilder
from rten_tpu_torch.fmt.serialize import graph_to_bytes
from rten_tpu_torch.generate import ArgMaxSampler, ServingEngine
from rten_tpu_torch.generate.sampler import PerRequestSampler
from rten_tpu_torch.ir.graph import graph_from_model_file
from rten_tpu_torch.ir.quantize_graph import quantize_graph_weights
from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm
from rten_tpu_torch.kernels import quant as qt
from rten_tpu_torch.kernels.quant import abs_max_quantize_int8
from rten_tpu_torch.models import (SAM, Bert, BertConfig, DepthConfig,
                                   DepthEstimator, EncoderDecoderConfig,
                                   EncoderDecoderLM, QuantWeight, ResNet,
                                   ResNetConfig, SAMConfig,
                                   SegmentationConfig, Segmenter, TTSConfig,
                                   TextToSpeech, TransformerConfig,
                                   TransformerLM, ViT, ViTConfig,
                                   quantize_weights, stack_layer_params)
from rten_tpu_torch.models import moe
from rten_tpu_torch.models.transformer import int4_takes_kernel
from rten_tpu_torch.runtime import Model, RunOptions
from rten_tpu_torch.utils.topk import ordered_top_k

# Published H100 SXM peaks (NVIDIA data sheet, dense): the lower bounds.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12            # outside the tensor cores
PEAK_TF32_FLOP_S = 495e12
PEAK_INT8_OP_S = 1979e12
REPS = 20
SLEEP_CYCLES = 2_000_000           # about 1 ms at the H100's clocks
TURN_ROUNDS = 3                    # rounds of paged-against-contiguous turns

# Tolerances (kernel against its plain version on the same inputs; V1 in
# both modes sums in f32 with nothing rounded to bf16, so K6's, below):
# K1 rounds its output to bf16 like the plain version, and the two sum in
# different orders in f32, so they may land one bf16 step apart; allow two
# steps of the largest output (2^-6 relative to max |out|).
K1_REL_TOL = 2.0 ** -6
# K2: identical indices, except rows whose plain top-2 margin is below
# 1e-3 (a different f32 summation order can swap near-ties).
K2_MARGIN_TOL = 1e-3
# K4: the same bf16-rounded operands and f32 accumulation; only the
# summation order differs, far below one bf16 step (2^-8) of max |out|.
K4_REL_TOL = 2.0 ** -8
# Card against CPU through the whole model, on 8-token prompts so every
# linear stays in the row-wise bf16 / weight-only regime (M <= 64): f32
# sums in another order flip bf16 roundings of activations, which random
# GPT-2 weights carry through 12 layers to the logits at the 1e-2 scale,
# so the two devices' logits must agree to 5e-2, and a token may differ
# only after a step whose CPU top-2 margin is below twice that. (At M > 64
# a per-tensor int8 activation scale spreads such a flip over the whole
# batch; that regime is held to exact int32 agreement by
# check_int8_matmul.)
PATH_LOGIT_TOL = 5e-2
# K5 and K7: bit for bit. K6: both sum in f32 (an online softmax per warp
# over ring tiles, merged across warps and splits, against an exact
# two-pass softmax), so they differ by a few f32 roundings
# of outputs of order 1: 1e-5 of max |out|. K1' (the no-tail mode of K1):
# K1's tolerance.
K6_REL_TOL = 1e-5
# Path (A) card against CPU: f32 weights, f32 cache, TF32 off, so the two
# devices differ only in f32 summation order (about 1e-6 relative per
# layer); logits must agree to 1e-3, and a token may differ only after a
# step whose CPU top-2 margin is below twice that.
F32_PATH_LOGIT_TOL = 1e-3
# Q1, Q1' and Q2 (the int4 GEMMs) against their plain versions: the same
# formula on the same bf16 / int8 operands, f32 sums in other orders (split
# K, MMA tiles): |Δ| <= 2^-16 x the sum of the magnitudes of every term
# (int8 mode in integer units times the row scale), per element; that is
# 2^8 roundings of 2^-24 each, for K <= 5632 terms.
INT4_REL_TOL = 2.0 ** -16
# Path (F) card against CPU (int4 words weights, 2 layers at TinyLlama's
# width, every linear through Q1 on the card and its plain version on the
# CPU, which agree on identical inputs): the word formula does not cancel
# a bf16 rounding of an activation that flips between the devices' f32
# sums; the flip moves every output of its row the same way, by
# 2^-8 |x| bf16(u s) with u = q + 8 >= 0, the RMSNorms magnify it, and
# each later linear's input holds more flips (tests/test_torch_llama.py
# localizes this chain against the JAX package: 0.03 at width 256, 6-11x
# the byte layout's gap). The split order of Q1 is fixed, so the gap is
# the same in every run on one card: 0.0864 on an H100 with the one-launch
# tile (0.0863 before it). Tolerance 0.1.
LLAMA_PATH_LOGIT_TOL = 0.1
# P1 and P2 (the paged appends): bit for bit. P3, its grid mode and P3i
# (paged attention) sum in f32 throughout like K6 (an int8 pool's bytes and
# bf16 scales are exact in f32, and no bf16 rounding follows), so K6's
# tolerance: 1e-5 of max |out|.

# Path (H) card against CPU (int4 words weights at Mistral-7B's width with
# one layer, 128-token prompts): (F)'s chain of flipped bf16 activation
# roundings at width 4096. One f32 rounding of every quantized linear's
# input moves the CPU's logits by up to 0.121 at this width against 0.061
# at TinyLlama's (python -m rten_tpu_torch.tools.int4_flip_sensitivity),
# so (F)'s 0.1 doubled: 0.2 (an H100 measured 0.1375; 0.1398 before the
# one-launch Q1 tile).
MISTRAL_PATH_LOGIT_TOL = 2 * LLAMA_PATH_LOGIT_TOL
# K8 and the partials mode with q_bf16 do the sums of K6 and of K1' and then
# round the output to bf16. The two versions' f32 sums differ by K6's
# tolerance, so an element whose sums straddle a rounding boundary lands
# one bf16 step apart: every element within one step of its own value,
# 2^-7 |ref|, plus K6's 1e-5 of max |out| for the sums. Elsewhere both
# round to the same value, so at least 99.9% of the elements agree within
# 2e-5 of max |out| (the CPU tests' criterion against the JAX package); the
# unrounded kernel misses that share (K6 at K8's inputs is checked to).
BF16_STEP = 2.0 ** -7
ROUND_ELEM_TOL = 2e-5
ROUND_SHARE = 0.999
# native_dots and pv_int8 round every probability (to bf16, or to an int8
# step of its block's largest scale-folded value; see NATIVE_STEP below),
# so a rounding flips between the versions in a few heads only: at least
# 99% of the elements agree within K6's 1e-5 of max |out|. The kernel
# without the mode (K6, or G1 without pv_int8) misses that share, and is
# checked to.
FLIP_SHARE = 0.99
# Path (I) card against CPU: K8 rounds q, K and its output to bf16, so a
# rounding that flips between the devices' f32 sums travels through 12
# layers; an H100 measured 1.595e-3 against max |logit| 2.989. Tolerance
# 1e-2, 6x that reading and 5x tighter than the int8 paths'.
FLAT_PATH_LOGIT_TOL = 1e-2
# Path (L) card against CPU (Mixtral-8x7B's width at one layer, int8
# weights and experts, bf16 compute): every activation is bf16, so an f32
# sum in another order flips a bf16 rounding (one step, 2^-8 relative) now
# and then, the bf16 attention scores and softmax of the 128-token prompts
# carry it on, and the LM head's output is itself rounded to bf16 (a step
# of 2^-7 at |logit| 2-4); tolerance (H)'s 0.2, the same width.
MIXTRAL_PATH_LOGIT_TOL = MISTRAL_PATH_LOGIT_TOL
# Path (L-bf16) card against CPU (GPT-2-small int8 + tail under bf16
# compute, batch 64 x 8-token prompts, capacity 128): the prefill's M 512
# linears quantize their activations per tensor, so an f32 sum in another
# order that carries one activation across an int8 rounding moves it by a
# whole step. On an H100 (tools/bf16_gap_witness.py) the gap is 7.10e-2
# with the kernels and the same with their plain versions in their place,
# 7.60e-2 under f32 compute, and 0.48-0.86 with a planted K1, K3 or K4
# fault (max |logit| 3.04); the CPU port against the JAX package gives
# 8.98e-2. Tolerance 0.15: about twice the gap without a fault, under a
# third of the smallest planted one.
BF16_PATH_LOGIT_TOL = 0.15

PAGE = 64                          # tokens per page on the paged paths
# The kernel body of the four decode appends (K5, P1, K7 and P2).
APPEND_SOURCE = "rten_tpu_torch/csrc/kv_append.cuh"


T0 = time.perf_counter()


def stamp(what):
    """The wall seconds since the script started, after a phase."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def check(ok, what):
    """Fail the run (an exception, so no later phase and no result line)."""
    if not ok:
        raise RuntimeError(what)


def share_within(out, ref, rel):
    """The share of elements of ``out`` within ``rel`` x max |ref| of
    ``ref``."""
    return (out - ref).abs().le(rel * ref.abs().max()).float().mean().item()


def check_rounded(out, ref, label):
    """Hold a kernel that rounds its output to bf16 against its plain
    version (BF16_STEP, K6_REL_TOL, ROUND_ELEM_TOL and ROUND_SHARE above);
    returns (max abs error, share within ROUND_ELEM_TOL)."""
    err = (out - ref).abs()
    share = share_within(out, ref, ROUND_ELEM_TOL)
    over = (err - BF16_STEP * ref.abs()).max().item()
    print(f"{label}: max_abs_err {err.max().item():.3e}; max of |err| - "
          f"2^-7 |ref| {over:.3e} (tol "
          f"{K6_REL_TOL * ref.abs().max().item():.3e}); share within "
          f"{ROUND_ELEM_TOL:.0e} of max |out| {share:.6f} (min "
          f"{ROUND_SHARE})")
    check(bool(torch.isfinite(out).all())
          and over <= K6_REL_TOL * ref.abs().max().item()
          and share >= ROUND_SHARE, f"{label} disagrees")
    return err.max().item(), share


def entry_of(results, name, mode=None):
    """The kernel entry of ``name`` (and ``mode``) in ``results``."""
    return next(r for r in results
                if r["name"] == name and r.get("mode") == mode)


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def bound_ms(n_bytes, flops=0.0, peak_flop_s=PEAK_BF16_FLOP_S):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flop_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """Median device time of single calls with CUDA events, after warm-up,
    with the 50 MB L2 evicted before each call (the serving path reaches
    each kernel with the rest of a decode step in between). The card
    sleeps about a millisecond before the start event, so the host has
    enqueued the whole call by the time the card reaches it: the events
    bracket device time, not the wrapper's Python."""

    def __init__(self):
        self.scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def __call__(self, fn, reps=REPS):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def _k1_held(out, ref, q_bf16, label):
    """K1 / K1' against the plain version: two bf16 steps of max |out|
    (K1_REL_TOL) with q_bf16, K6's 1e-5 in the exact-q mode (nothing is
    rounded to bf16 there). Returns the max abs error."""
    err = (out - ref).abs().max().item()
    tol = (K1_REL_TOL if q_bf16 else K6_REL_TOL) * ref.abs().max().item()
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"{label} disagrees")
    return err


def _exact_q(entry, q_bf16):
    """The entry in its exact-q mode (RTEN_FLAT_QBF16=0) keyed "exact"."""
    if not q_bf16:
        entry["mode"] = "exact"
    return entry


def check_decode_attn(timer, b=256, h=12, kvh=12, cap=512, live=(64, 160),
                      q_bf16=True):
    """K1 with the window at 9 of 16 rows and packed lives ``live``; GQA
    when ``kvh`` < ``h``; ``q_bf16=False`` its exact-q mode."""
    d, rows, tc = 64, 16, 9
    f = kvh * d
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    tail = torch.randn((b, rows, 2, f), device="cuda",
                       generator=g).to(torch.bfloat16)
    # Lengths as the model passes them (cache lengths + 1, window fill
    # + 1) at the path's live lengths (GPT-2's: prompt 64 up to 64 + 96).
    lengths = torch.randint(live[0] + tc, live[1] + tc, (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    args = (q, kv, scales, lengths, tail, tc)
    kw = dict(q_bf16=q_bf16)
    out = at.decode_attn_int8_tail(*args, **kw)
    ref = at.decode_attn_int8_tail_plain(*args, **kw)
    torch.cuda.synchronize()
    err = _k1_held(out, ref, q_bf16, f"decode_attn_int8_tail (B {b}, H {h} "
                   f"over {kvh}, cap {cap}{'' if q_bf16 else ', exact q'})")
    n_packed = (lengths - tc).clamp(0, cap).to(torch.float64).sum().item()
    n_bytes = (n_packed * (2 * f + 2 * kvh * 2) + b * tc * 2 * f * 2
               + 2 * q.numel() * 4 + b * 4)
    flops = 4.0 * (n_packed + b * tc) * h * d
    bms, by = bound_ms(n_bytes, flops)
    return _exact_q(dict(
        name="decode_attn_int8_tail",
        source="rten_tpu_torch/csrc/decode_attn_int8_tail.cu",
        replaces="rten_tpu/kernels/attention.py:1715", max_abs_err=err,
        ms=timer(lambda: at.decode_attn_int8_tail(*args, **kw)),
        plain_ms=timer(lambda: at.decode_attn_int8_tail_plain(*args, **kw)),
        bound_ms=bms, bound_by=by, library_ms=None), q_bf16)


def check_int8_matmul():
    """The int8 x int8 product of the M > 64 linears (torch._int_mm, not a
    kernel of this repository) on the card against the CPU at the main
    path's prefill QKV shape: int32 accumulation is exact, so the f32
    results must be identical."""
    g = torch.Generator().manual_seed(6)
    x = torch.randint(-127, 128, (256 * 64, 768), dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (768, 2304), dtype=torch.int8, generator=g)
    xs = torch.tensor(0.031)
    ws = 0.001 * torch.rand(2304, generator=g)
    cpu = gemm.matmul_int8(x, w, xs, ws)
    card = gemm.matmul_int8(x.cuda(), w.cuda(), xs.cuda(), ws.cuda()).cpu()
    print(f"matmul_int8 (torch._int_mm): card == cpu "
          f"{torch.equal(card, cpu)}")
    check(torch.equal(card, cpu), "int8 x int8 product differs")


def _head_weights(k, n):
    g = torch.Generator(device="cuda").manual_seed(2)
    w = 0.02 * torch.randn((k, n), device="cuda", generator=g)
    q, s = abs_max_quantize_int8(w, axis=0)
    q, s = gemm.pad_cols(q, s)
    w_dq = (q[:, :n].to(torch.float32) * s[None, :n]).to(torch.bfloat16)
    return q, s, w_dq


def _rows(g, m, k, bf16_x):
    """Random f32 rows [m, k]; bf16-valued with ``bf16_x`` (what the model
    passes a kernel under bf16 compute)."""
    x = torch.randn((m, k), device="cuda", generator=g)
    return x.to(torch.bfloat16).to(torch.float32) if bf16_x else x


def check_head_argmax(timer, w, s, w_dq, n, ms=(256, 1, 16, 64),
                      bf16_x=False):
    """K2 at the main path's M 256 (the entry: the first of ``ms``) and at
    M 1, 16 and 64 (printed: bytes-bound), each against its plain version,
    with its TFLOP/s and share of the bound beside the library call's
    time."""
    k = w.shape[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    entry = None
    for m in ms:
        x = _rows(g, m, k, bf16_x)
        idx = gemm.head_argmax_int8(x, w, s, n_valid=n)
        logits = gemm.matmul_int8_wo_plain(x, w, s)[:, :n]
        ref = gemm.head_argmax_int8_plain(x, w, s, n_valid=n)
        torch.cuda.synchronize()
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        rows = torch.arange(m, device="cuda")
        regret = (logits[rows, ref.long()] - logits[rows, idx.long()]).abs()
        bad = (idx != ref) & (margin >= K2_MARGIN_TOL)
        near = int(((idx != ref) & ~bad).sum().item())
        print(f"head_argmax_int8 (M {m}, K {k}, N {n}): "
              f"{int((idx != ref).sum())} of {m} "
              f"indices differ, {near} of them at a margin below "
              f"{K2_MARGIN_TOL}")
        check(not bad.any(), "K2 disagrees above the margin tolerance")
        flops = 2.0 * m * k * n
        bms, by = bound_ms(k * n + 4 * n + 4 * m * k + 4 * m, flops)
        xb = x.to(torch.bfloat16)
        ms = timer(lambda: gemm.head_argmax_int8(x, w, s, n_valid=n))
        lib = timer(lambda: torch.matmul(xb, w_dq).argmax(-1))
        plan = gemm.head_argmax_plan(m, k, w.shape[1])
        print(f"head_argmax_int8 (M {m}, tile {plan['rows']} x "
              f"{plan['slab']}): kernel_ms {ms:.4f} ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bms / ms:.3f} of the {by} bound {bms:.4f}) "
              f"library_ms {lib:.4f}")
        if entry is None:
            entry = dict(name="head_argmax_int8",
                         source="rten_tpu_torch/csrc/head_argmax_int8.cu",
                         replaces="rten_tpu/kernels/gemm.py:268",
                         max_abs_err=regret.max().item(), ms=ms,
                         plain_ms=timer(lambda: gemm.head_argmax_int8_plain(
                             x, w, s, n_valid=n)),
                         bound_ms=bms, bound_by=by, library_ms=lib)
    return entry


def check_matmul_wo(timer, w, s, w_dq, n, ms=(64, 1, 16, 32), bf16_x=False):
    """K4 (K2's tiles with a store epilogue) against its plain version at
    the main path's M 64 (the entry, the first of ``ms``: the largest
    admission group) and at M 1, 16 and 32 ((G)'s verify head), each with
    its TFLOP/s and share of the bound beside the library call (the bf16
    ``matmul`` on the dequantized weight); and the CUDA kernels one call
    launches."""
    k = w.shape[0]
    g = torch.Generator(device="cuda").manual_seed(4)
    entry = None
    for m in ms:
        x = _rows(g, m, k, bf16_x)
        out = gemm.matmul_int8_wo(x, w, s)[:, :n]
        ref = gemm.matmul_int8_wo_plain(x, w, s)[:, :n]
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = K4_REL_TOL * ref.abs().max().item()
        print(f"matmul_int8_wo (M {m}, K {k}, N {n}): max_abs_err "
              f"{err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"K4 disagrees at M {m}")
        flops = 2.0 * m * k * w.shape[1]
        n_bytes = k * w.shape[1] + 4 * w.shape[1] + 4 * m * k \
            + 4 * m * w.shape[1]
        bms, by = bound_ms(n_bytes, flops)
        xb = x.to(torch.bfloat16)
        ms = timer(lambda: gemm.matmul_int8_wo(x, w, s))
        lib = timer(lambda: torch.matmul(xb, w_dq))
        plan = gemm.matmul_int8_wo_plan(m, k, w.shape[1])
        print(f"matmul_int8_wo (M {m}, tile {plan['rows']} x "
              f"{plan['slab']}): kernel_ms {ms:.4f} ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bms / ms:.3f} of the {by} bound {bms:.4f}) "
              f"library_ms {lib:.4f}")
        if entry is None:
            before = gemm.matmul_int8_wo.launches
            gemm.matmul_int8_wo(x, w, s)
            counted = gemm.matmul_int8_wo.launches - before
            launched = device_launches(lambda: gemm.matmul_int8_wo(x, w, s))
            print(f"matmul_int8_wo (M {m}): launch count +{counted} a call, "
                  f"{launched} CUDA kernels a call (profiler)")
            # The convert and the tile; the profiler can lose a kernel,
            # never add one.
            check(counted == 1 and (launched == "not measured"
                                    or launched <= 2),
                  f"K4 counted {counted} launches and ran {launched} CUDA "
                  f"kernels a call")
            entry = dict(name="matmul_int8_wo",
                         source="rten_tpu_torch/csrc/head_argmax_int8.cu",
                         replaces="rten_tpu/kernels/gemm.py:173",
                         max_abs_err=err, ms=ms,
                         plain_ms=timer(lambda: gemm.matmul_int8_wo_plain(
                             x, w, s)),
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         device_launches=launched)
        else:
            entry.update({f"m{m}_ms": ms, f"m{m}_bound_ms": bms,
                          f"m{m}_library_ms": lib})
    return entry


# Path (L)'s int8 weight-only products, K 4096: each layer's wqkv and wo
# (K4, 64 a decode step at M 16) and the LM head (K2 every step, K4 at an
# admission of 16 prompts).
L_GEMMS = (("wqkv", 6144), ("wo", 4096), ("head", 32000))
ENTRY_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def prefixed(entry, prefix):
    """An entry's measured keys under ``prefix``: the extra keys of the
    kernel's entry for another shape."""
    return {prefix + k: entry[k] for k in ENTRY_KEYS}


def check_mixtral_gemms(timer):
    """K4 at path (L)'s wqkv, wo and LM head and K2 at its head, at a
    decode step's M 16 with bf16-valued rows, each against its plain
    version with its bound and library call. Returns the extra keys of
    K4's and K2's entries (``m16_l_<weight>_*``)."""
    k4, k2 = {}, {}
    for label, n in L_GEMMS:
        w, s, w_dq = _head_weights(4096, n)
        k4.update(prefixed(check_matmul_wo(timer, w, s, w_dq, n, ms=(16,),
                                           bf16_x=True),
                           f"m16_l_{label}_"))
        if label == "head":
            k2.update(prefixed(check_head_argmax(timer, w, s, w_dq, n,
                                                 ms=(16,), bf16_x=True),
                               "m16_l_head_"))
        del w, s, w_dq
    return k4, k2


def tail_flush_inputs(b=256, kvh=12, cap=512, live=(16, 160)):
    """K3's inputs: a bf16 window of 16 rows with an all-zero head, a random
    int8 cache of capacity ``cap`` with its bf16 scales, and lengths drawn
    from ``live`` with one finished slot past capacity. Returns (tail, kv,
    scales, lengths)."""
    f = kvh * 64
    g = torch.Generator(device="cuda").manual_seed(5)
    tail = torch.randn((b, 16, 2, f), device="cuda",
                       generator=g).to(torch.bfloat16)
    tail[0, 0, 0, :64] = 0         # an all-zero head takes scale 1.0
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = torch.rand((b, cap, 2, kvh), device="cuda",
                        generator=g).to(torch.bfloat16)
    lengths = torch.randint(live[0], live[1], (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    lengths[1] = cap + 7           # a finished slot past capacity: clamps
    return tail, kv, scales, lengths


def check_tail_flush(timer, b=256, kvh=12, cap=512, live=(16, 160)):
    """K3 (``tail_flush_int8``, the decode appends' kernel body over the
    window's rows) at the burst's flush (t 16 of an R 16 window) and at an
    admission's partial flush (t 5): each bit for bit against the plain
    version and one CUDA kernel a call (profiler), an all-zero head and a
    finished slot past capacity among the inputs. The entry's numbers are
    t 16's; t 5's are printed. Bound: the t window rows read, the int8
    bytes and the scales written and the lengths read, once."""
    tail, kv, scales, lengths = tail_flush_inputs(b, kvh, cap, live)
    rows, d = tail.shape[1], 64
    f = kvh * d
    wide = kc.tail_flush_wide(d, tail, kv)
    res = {}
    for t in (rows, 5):
        kv1, s1 = kv.clone(), scales.clone()
        kv2, s2 = kv.clone(), scales.clone()
        call = lambda: kc.tail_flush_int8(tail, kv1, s1, lengths, t)
        call()
        kc.tail_flush_int8_plain(tail, kv2, s2, lengths, t)
        torch.cuda.synchronize()
        err = max((kv1.int() - kv2.int()).abs().max().item(),
                  (s1.float() - s2.float()).abs().max().item())
        label = (f"tail_flush_int8 (B {b}, KVH {kvh}, cap {cap}, t {t} of "
                 f"R {rows})")
        print(f"{label}: max_abs_err {err} (bit-exact required); "
              f"{'wide' if wide else 'narrow'} instance")
        check(torch.equal(kv1, kv2) and torch.equal(s1, s2),
              f"K3 not bit-exact at t {t}")
        bms, by = bound_ms(b * t * 2 * f * 2 + b * t * 2 * f
                           + b * t * 2 * kvh * 2 + b * 4)
        ms = timer(call)
        plain_ms = timer(lambda: kc.tail_flush_int8_plain(tail, kv2, s2,
                                                          lengths, t))
        # The profiler after the timings, as kv_group_launch does.
        n = device_launches(call)
        print(f"{label}: {n} CUDA kernel(s) a call; kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bms:.4f} ({by})")
        check(n == 1 or n == "not measured",
              f"K3 launched {n} CUDA kernels a call at t {t}, not one")
        res[t] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, device_launches=n)
    return dict(name="tail_flush_int8", source=APPEND_SOURCE,
                replaces="rten_tpu/kernels/cache.py:370,511",
                shape=f"B {b}, {kvh} heads of {d}, capacity {cap}, t {rows}",
                **res[rows], library_ms=None)


def _decode_rows(g, b, kvh, d):
    """New K/V [B, KVH, 1, D] as the model hands them over: strided views
    into a fused [B, 1, 3F] projection output."""
    f = kvh * d
    qkv = torch.randn((b, 1, 3 * f), device="cuda", generator=g)
    return tuple(qkv[..., i * f:(i + 1) * f].reshape(b, 1, kvh, d)
                 .transpose(1, 2) for i in (1, 2))


def _live_lengths(g, b):
    """Attention lengths of the serving paths (cache lengths + 1): prompt
    64 up to 64 + 112 decoded tokens."""
    return torch.randint(65, 177, (b,), device="cuda", generator=g,
                         dtype=torch.int32)


def kv_append_inputs():
    """K5's inputs at path (A)'s shapes (B 256, 12 heads of 64, capacity
    512): new rows as views of one projection output, lengths 64-175 with
    one slot past capacity, and a random f32 and bf16 cache, each drawn
    when the iterator reaches it (so the two are not held at once: later
    phases' timings depend on what the allocator holds). Returns (k, v,
    lengths, iterator of (dtype, cache))."""
    b, cap, kvh, d = 256, 512, 12, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    k, v = _decode_rows(g, b, kvh, d)
    lengths = _live_lengths(g, b) - 1
    lengths[1] = cap + 7           # a finished slot past capacity: clamps
    return k, v, lengths, (
        (dtype, torch.randn((b, cap, 2, kvh * d), device="cuda",
                            generator=g).to(dtype))
        for dtype in (torch.float32, torch.bfloat16))


def _kv_append_case(timer, label, k, v, lengths, kv):
    """K5 on one float cache ``kv``: bit-exact against the plain version,
    timed beside ``index_put_``, and one CUDA kernel a call (profiler).
    Bound: the f32 rows read, the cache rows and the lengths once."""
    b, kvh, _, d = k.shape
    f, cap = kvh * d, kv.shape[1]
    kv1, kv2 = kv.clone(), kv.clone()
    call = lambda: kc.kv_append(kv1, k, v, lengths)
    call()
    kc.kv_append_plain(kv2, k, v, lengths)
    torch.cuda.synchronize()
    err = (kv1.float() - kv2.float()).abs().max().item()
    wide = kc.kv_append_wide(d, kv1, k.reshape(b, f), v.reshape(b, f))
    print(f"kv_append ({label}): max_abs_err {err} (bit-exact required); "
          f"{'wide' if wide else 'narrow'} instance")
    check(torch.equal(kv1, kv2), f"K5 not bit-exact at {label}")
    bms, by = bound_ms(2 * b * f * 4 + b * 2 * f * kv.element_size() + b * 4)
    rows = torch.stack([k.reshape(b, f), v.reshape(b, f)],
                       dim=1).to(kv.dtype)
    idx = (torch.arange(b, device="cuda"), lengths.clamp(0, cap - 1).long())
    r = dict(max_abs_err=err, ms=timer(call),
             plain_ms=timer(lambda: kc.kv_append_plain(kv2, k, v, lengths)),
             bound_ms=bms, bound_by=by,
             library_ms=timer(lambda: kv1.index_put_(idx, rows)))
    # The profiler after the timings, as kv_group_launch does.
    r["device_launches"] = n = device_launches(call)
    print(f"kv_append ({label}): {n} CUDA kernel(s) a call; kernel_ms "
          f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {bms:.4f} "
          f"library_ms {r['library_ms']:.4f} (index_put_)")
    check(n == 1 or n == "not measured",
          f"K5 launched {n} CUDA kernels a call at {label}, not one")
    return r


def check_kv_append(timer):
    """K5 at path (A)'s shapes on an f32 cache (the entry) and path (C)'s
    bf16 cache (the entry's ``bf16_*`` keys; :func:`kv_append_inputs`):
    each bit-exact against the plain version, timed beside ``index_put_``,
    and one CUDA kernel a call (profiler)."""
    k, v, lengths, caches = kv_append_inputs()
    entry = dict(name="kv_append", source=APPEND_SOURCE,
                 replaces="rten_tpu/kernels/cache.py:32")
    for (dtype, kv), key in zip(caches, ("", "bf16_")):
        r = _kv_append_case(timer, str(dtype), k, v, lengths, kv)
        entry.update({key + name: x for name, x in r.items()})
    return entry


def kv_append_int8_inputs(b, kvh, d, cap, lives, masked, seed):
    """K7's inputs at one shape: new rows as views of one projection output
    (one head all zero, so scale 1.0), positions drawn from ``lives`` less
    one with one slot past the capacity and, with ``masked``, every fourth
    one negative (nothing written), and a random int8 cache with its bf16
    scales. Returns (k, v, positions, kv, scales)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v = _decode_rows(g, b, kvh, d)
    k[0, 0] = 0
    lengths = _decode_lengths(g, b, lives) - 1
    lengths[1 % b] = cap + 7
    if masked:
        lengths[::4] = -1 - lengths[::4]
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = torch.rand((b, cap, 2, kvh), device="cuda",
                        generator=g).to(torch.bfloat16)
    return k, v, lengths, kv, scales


def _kv_append_int8_case(timer, label, b, kvh, d, cap, lives, masked,
                         seed):
    """K7 at one shape (:func:`kv_append_int8_inputs`) against its plain
    version: bytes and scales bit for bit, one CUDA kernel a call
    (profiler), the kernel's and the plain version's times and the bound
    (the f32 rows read, the int8 bytes, the scales and the positions
    once)."""
    f = kvh * d
    k, v, lengths, kv, scales = kv_append_int8_inputs(b, kvh, d, cap, lives,
                                                      masked, seed)
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    call = lambda: kc.kv_append_int8(kv1, s1, k, v, lengths, masked)
    call()
    kc.kv_append_int8_plain(kv2, s2, k, v, lengths, masked)
    torch.cuda.synchronize()
    err = max((kv1.int() - kv2.int()).abs().max().item(),
              (s1.float() - s2.float()).abs().max().item())
    wide = kc.kv_append_wide(d, kv1, k.reshape(b, f), v.reshape(b, f))
    print(f"kv_append_int8 ({label}): max_abs_err {err} (bit-exact "
          f"required); {'wide' if wide else 'narrow'} instance")
    check(torch.equal(kv1, kv2) and torch.equal(s1, s2),
          f"K7 not bit-exact at {label}")
    rows = int((lengths >= 0).sum().item()) if masked else b
    bms, by = bound_ms(2 * b * f * 4 + 2 * rows * f + 2 * rows * kvh * 2
                       + b * 4)
    ms = timer(call)
    plain_ms = timer(lambda: kc.kv_append_int8_plain(kv2, s2, k, v, lengths,
                                                     masked))
    # The profiler after the timings, as kv_group_launch does.
    n = device_launches(call)
    print(f"kv_append_int8 ({label}): {n} CUDA kernel(s) a call")
    check(n == 1 or n == "not measured",
          f"K7 launched {n} CUDA kernels a call at {label}, not one")
    print(f"kv_append_int8 ({label}): kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, device_launches=n)


def check_kv_append_int8(timer):
    """K7 at path (B)'s shapes (the entry) and at path (H)'s (B 16, 8 KV
    heads of 128, capacity 4096; the entry's ``h_*`` keys), each bit-exact
    against the plain version, one CUDA kernel a call and timed, and both
    with ``masked`` and negative positions (bit-exact, printed)."""
    res = _kv_append_int8_case(timer, "(B): B 256, 12 heads of 64, "
                               "capacity 512", *K7_B_SHAPE, False, 8)
    h = _kv_append_int8_case(timer, "(H): B 16, 8 heads of 128, capacity "
                             "4096", *K7_H_SHAPE, False, 9)
    for label, shape in (("(B), masked", K7_B_SHAPE),
                         ("(H), masked", K7_H_SHAPE)):
        _kv_append_int8_case(timer, label, *shape, True, 10)
    return dict(name="kv_append_int8", source=APPEND_SOURCE,
                replaces="rten_tpu/kernels/cache.py:148",
                shape="B 256, 12 heads of 64, capacity 512", **res,
                library_ms=None,
                **{f"h_{key}": h[key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "device_launches")})


# K6's shapes beside paths (A) and (C): the reference's fused fallback
# (batch 3, no group divides it) and TinyLlama's float-cache GQA (B 16, 32
# query heads over 4 KV heads of 64, capacity 2048); (label, key prefix,
# B, H, KVH, capacity, lives).
K6_SHAPES = (("batch 3", "b3", 3, 12, 12, 512, (65, 177)),
             ("TinyLlama GQA", "gqa", 16, 32, 4, 2048, (65, 2001)))


def _k6_case(timer, label, q, kv, lengths):
    """K6 (``decode_attn_float``) against its plain version on one input:
    held within K6_REL_TOL of max |out|, timed beside the plain version and
    ``scaled_dot_product_attention`` in the cache dtype (q cast to it; the
    mask over the capacity; ``enable_gqa`` under GQA), the plan and one
    CUDA kernel a call (``kv_group_launch``). Bound: the live rows read
    once in the cache dtype, 4 f32 operations per (head, dim, row)."""
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    out = at.decode_attn_float(q, kv, lengths)
    ref = at.decode_attn_float_plain(q, kv, lengths)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K6_REL_TOL * ref.abs().max().item()
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"{label}: K6 disagrees")
    bms, by = _decode_bound(q, lengths, cap, 2 * kvh * d * kv.element_size())
    k4 = kv[:, :, 0].view(b, cap, kvh, d).transpose(1, 2)
    v4 = kv[:, :, 1].view(b, cap, kvh, d).transpose(1, 2)
    qs, mask = q[:, :, None].to(kv.dtype), _sdpa_mask(lengths, cap)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qs, k4, v4, attn_mask=mask, enable_gqa=h > kvh))
    ms = timer(lambda: at.decode_attn_float(q, kv, lengths))
    plain_ms = timer(lambda: at.decode_attn_float_plain(q, kv, lengths))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}) library_ms {lib:.4f} "
          f"({str(kv.dtype)[6:]} scaled_dot_product_attention)")
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib)
    res.update(kv_group_launch(label, at.rows_plan(b, h, kvh, cap, d),
                               lambda: at.decode_attn_float(q, kv, lengths),
                               res))
    return res


def check_decode_attn_float(timer):
    """K6 (the KV-group kernel in its exact mode) at path (A)'s shapes on
    an f32 cache (the entry, with f32 scaled_dot_product_attention as the
    library yardstick) and path (C)'s bf16 cache (the entry's ``bf16_*``
    keys, with bf16 SDPA), then at K6_SHAPES on f32 caches (the ``b3_*``
    and ``gqa_*`` keys): each held to K6_REL_TOL against the plain
    version, with its plan and one CUDA kernel a call."""
    b, h, d, cap = 256, 12, 64, 512
    f = h * d
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = _live_lengths(g, b)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        kv = torch.randn((b, cap, 2, f), device="cuda",
                         generator=g).to(dtype)
        res[dtype] = _k6_case(timer, f"decode_attn_float ({str(dtype)[6:]} "
                              f"cache, B {b}, {h} heads of {d}, capacity "
                              f"{cap}, lives 65-176)", q, kv, lengths)
        del kv
    extra = {}
    for label, key, b, h, kvh, cap, lives in K6_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(9)
        q = torch.randn((b, h, d), device="cuda", generator=g)
        lengths = _decode_lengths(g, b, lives)
        kv = torch.randn((b, cap, 2, kvh * d), device="cuda", generator=g)
        r = _k6_case(timer, f"decode_attn_float ({label}: f32 cache, B {b}, "
                     f"{h} heads over {kvh} of {d}, capacity {cap}, lives "
                     f"{lives[0]}-{lives[1] - 1})", q, kv, lengths)
        extra.update({f"{key}_{k}": r[k] for k in
                      ("max_abs_err", "ms", "plain_ms", "bound_ms",
                       "library_ms", "device_launches")})
        del kv
    bf = res[torch.bfloat16]
    return dict(name="decode_attn_float",
                replaces="rten_tpu/kernels/attention.py:1039,318,542",
                shape="B 256, 12 heads of 64, f32 cache of capacity 512, "
                      "lives 65-176",
                **res[torch.float32],
                **{f"bf16_{key}": bf[key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms", "device_launches")},
                **extra)


def check_decode_attn_int8(timer, b=256, h=12, kvh=12, cap=512,
                           live=(65, 177), q_bf16=True):
    """K1' (the no-tail mode of K1) at path (B)'s shapes, attention
    lengths ``live``; GQA when ``kvh`` < ``h``; ``q_bf16=False`` its
    exact-q mode."""
    d = 64
    f = kvh * d
    g = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    lengths = torch.randint(live[0], live[1], (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    args = (q, kv, scales, lengths)
    kw = dict(q_bf16=q_bf16)
    out = at.decode_attn_int8(*args, **kw)
    ref = at.decode_attn_int8_plain(*args, **kw)
    torch.cuda.synchronize()
    err = _k1_held(out, ref, q_bf16, f"decode_attn_int8 (B {b}, H {h} over "
                   f"{kvh}, cap {cap}{'' if q_bf16 else ', exact q'})")
    live = lengths.clamp(max=cap).to(torch.float64).sum().item()
    n_bytes = live * (2 * f + 2 * kvh * 2) + 2 * q.numel() * 4 + b * 4
    bms, by = bound_ms(n_bytes, 4.0 * live * h * d)
    return _exact_q(dict(
        name="decode_attn_int8",
        source="rten_tpu_torch/csrc/decode_attn_int8_tail.cu",
        replaces="rten_tpu/kernels/attention.py:1715", max_abs_err=err,
        ms=timer(lambda: at.decode_attn_int8(*args, **kw)),
        plain_ms=timer(lambda: at.decode_attn_int8_plain(*args, **kw)),
        bound_ms=bms, bound_by=by, library_ms=None), q_bf16)


def _paged_pool(g, b, lengths, dtype):
    """A pool at the paged paths' shapes (page 64, capacity 512, 12 heads
    of 64), one page per slot and page of the table plus the garbage page
    0, random contents; the table maps ceil(lengths / 64) scrambled pages
    per row and -1 past them."""
    max_pages, f, kvh = 512 // PAGE, 768, 12
    n_pages = b * max_pages + 1
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, (n_pages, PAGE, 2, f), device="cuda",
                             dtype=torch.int8, generator=g)
        scales = (0.002 + 0.01 * torch.rand((n_pages, PAGE, 2, kvh),
                                            device="cuda", generator=g)
                  ).to(torch.bfloat16)
    else:
        pool = torch.randn((n_pages, PAGE, 2, f), device="cuda",
                           generator=g)
        scales = None
    ids = 1 + torch.randperm(n_pages - 1, device="cuda", generator=g)
    table = ids[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    n_mapped = (lengths.clamp(min=1).to(torch.int64) + PAGE - 1) // PAGE
    unmapped = (torch.arange(max_pages, device="cuda")[None, :]
                >= n_mapped[:, None])
    table[unmapped] = -1
    return pool, scales, table.contiguous()


def kv_append_paged_inputs(quantized, zero_head=True):
    """P1's (f32 pool, path E) or P2's (int8 pool, path D) inputs at B 256:
    new rows as views of one projection output (with ``zero_head``, one
    head all zero: scale 1.0), lengths 64-175 with one slot past capacity
    (its last page), and a pool of scrambled pages with one released slot
    (table row -1: the garbage page). Returns (k, v, lengths, pool, scales
    or None, table)."""
    b, kvh, d = 256, 12, 64
    g = torch.Generator(device="cuda").manual_seed(11 + quantized)
    k, v = _decode_rows(g, b, kvh, d)
    if zero_head:
        k[0, 0] = 0
    lengths = _live_lengths(g, b) - 1
    lengths[1] = 512 + 7           # a finished slot past capacity
    pool, scales, table = _paged_pool(
        g, b, (lengths + 2).clamp(max=512),
        torch.int8 if quantized else torch.float32)
    table[2] = -1                  # a released slot
    return k, v, lengths, pool, scales, table


def check_kv_append_paged(timer, quantized):
    """P1 (f32 pool, path E) or P2 (int8 pool, path D) at B 256
    (:func:`kv_append_paged_inputs`): bit-exact against the plain version
    and one CUDA kernel a call (profiler). P2 also without its all-zero
    head (the entry's ``nz_*`` keys: bit-exact and timed)."""
    b, kvh, d = 256, 12, 64
    f = kvh * d
    k, v, lengths, pool, scales, table = kv_append_paged_inputs(quantized)
    if quantized:
        n_bytes = 2 * b * f * 4 + 2 * b * f + 2 * b * kvh * 2 + 2 * b * 4
        entry = dict(name="kv_append_paged_int8",
                     replaces="rten_tpu/kernels/cache.py:280",
                     library_ms=None)
        for key, zero in (("", True), ("nz_", False)):
            if not zero:
                k, v = kv_append_paged_inputs(quantized, zero)[:2]
            p1, p2 = pool.clone(), pool.clone()
            s1, s2 = scales.clone(), scales.clone()
            call = lambda: kc.kv_append_paged_int8(p1, s1, k, v, table,
                                                   lengths)
            call()
            kc.kv_append_paged_int8_plain(p2, s2, k, v, table, lengths)
            torch.cuda.synchronize()
            err = max((p1.int() - p2.int()).abs().max().item(),
                      (s1.float() - s2.float()).abs().max().item())
            label = ("kv_append_paged_int8" if zero else
                     "kv_append_paged_int8 (no all-zero head)")
            print(f"{label}: max_abs_err {err} (bit-exact required)")
            check(torch.equal(p1, p2) and torch.equal(s1, s2),
                  f"{label} not bit-exact")
            ms = timer(call)
            plain_ms = timer(lambda: kc.kv_append_paged_int8_plain(
                p2, s2, k, v, table, lengths))
            n = device_launches(call)
            print(f"{label}: {n} CUDA kernel(s) a call; kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f}")
            check(n == 1 or n == "not measured",
                  f"{label} launched {n} CUDA kernels a call, not one")
            entry.update({f"{key}max_abs_err": err, f"{key}ms": ms,
                          f"{key}plain_ms": plain_ms,
                          f"{key}device_launches": n})
    else:
        p1, p2 = pool.clone(), pool.clone()
        kc.kv_append_paged(p1, k, v, table, lengths)
        kc.kv_append_paged_plain(p2, k, v, table, lengths)
        torch.cuda.synchronize()
        err = (p1 - p2).abs().max().item()
        print(f"kv_append_paged: max_abs_err {err} (bit-exact required)")
        check(torch.equal(p1, p2), "kv_append_paged not bit-exact")
        n_bytes = 2 * b * f * 4 + b * 2 * f * 4 + 2 * b * 4
        ids, offs = kc.paged_slots(table, lengths, PAGE)
        rows = torch.stack([k.reshape(b, f), v.reshape(b, f)], dim=1)
        call = lambda: kc.kv_append_paged(p1, k, v, table, lengths)
        entry = dict(
            name="kv_append_paged", replaces="rten_tpu/kernels/cache.py:94",
            max_abs_err=err, ms=timer(call),
            plain_ms=timer(lambda: kc.kv_append_paged_plain(
                p2, k, v, table, lengths)),
            library_ms=timer(lambda: p1.index_put_((ids, offs), rows)))
        n = entry["device_launches"] = device_launches(call)
        print(f"kv_append_paged: {n} CUDA kernel(s) a call; kernel_ms "
              f"{entry['ms']:.4f} plain_ms {entry['plain_ms']:.4f} "
              f"library_ms {entry['library_ms']:.4f} (index_put_)")
        check(n == 1 or n == "not measured",
              f"kv_append_paged launched {n} CUDA kernels a call, not one")
    bms, by = bound_ms(n_bytes)
    if quantized:
        print(f"kv_append_paged_int8: bound_ms {bms:.4f} ({by}); kernel_ms "
              f"{entry['ms']:.4f} with the all-zero head, "
              f"{entry['nz_ms']:.4f} without")
        entry["nz_bound_ms"] = bms
    return dict(entry, source=APPEND_SOURCE, bound_ms=bms, bound_by=by)


def check_decode_attn_paged(timer, mode):
    """P3 (``decode_attn_paged``, path E), P3i (``decode_attn_paged_int8``,
    path D) at B 256 and the grid mode (``decode_attn_paged_grid``) at the
    batch of 3 where path E takes it; live lengths 65-176 over scrambled
    pages."""
    b = 3 if mode == "grid" else 256
    h, d = 12, 64
    f = h * d
    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = _live_lengths(g, b)
    pool, scales, table = _paged_pool(
        g, b, lengths, torch.int8 if mode == "int8" else torch.float32)
    wrapper = {"grouped": at.decode_attn_paged,
               "grid": at.decode_attn_paged_grid,
               "int8": at.decode_attn_paged_int8}[mode]
    plain = getattr(at, wrapper.__name__ + "_plain")
    args = (q, pool, table, lengths) if scales is None else (
        q, pool, scales, table, lengths)
    out = wrapper(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K6_REL_TOL * ref.abs().max().item()
    print(f"{wrapper.__name__}: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"{wrapper.__name__} disagrees")
    live = lengths.to(torch.float64).sum().item()
    row = 2 * f * 4 if scales is None else 2 * f + 2 * h * 2
    n_bytes = (live * row + 2 * q.numel() * 4 + b * 4
               + table.numel() * 4)
    bms, by = bound_ms(n_bytes, 4.0 * live * h * d, PEAK_F32_FLOP_S)
    entry = dict(name=wrapper.__name__,
                 source="rten_tpu_torch/csrc/decode_attn_paged.cu",
                 replaces=("rten_tpu/kernels/attention.py:2573"
                           if mode == "grid" else
                           "rten_tpu/kernels/attention.py:2272"),
                 max_abs_err=err, ms=timer(lambda: wrapper(*args)),
                 plain_ms=timer(lambda: plain(*args)),
                 bound_ms=bms, bound_by=by, library_ms=None)
    entry.update(kv_group_launch(
        wrapper.__name__,
        at.paged_plan(b, h, pool.shape[3] // d, PAGE, table.shape[1], d),
        lambda: wrapper(*args), entry))
    return entry


def kv_group_launch(label, plan, fn, entry):
    """The launch of a kernel on the KV-group kernel (P3, its grid mode,
    P3i, G1 with pv_int8 or without, G2, K6, K8, native_dots, V1, A1, K9,
    the partials mode):
    the plan's splits, blocks, warps and query rows a warp
    (printed: the wrapper's plan at these shapes, not read from the
    launch), and the CUDA kernels one call launches (profiler, kept in the
    entry), which must be one: the splits merge in their cluster."""
    n = device_launches(fn)
    share = entry["bound_ms"] / entry["ms"]
    print(f"{label}: {plan['splits']} split(s) a sequence, {plan['blocks']} "
          f"blocks of {plan['warps']} warps, {plan['heads_per_warp']} query "
          f"row(s) a warp in {plan['head_groups']} row group(s); {n} CUDA "
          f"kernel(s) a call; kernel_ms {entry['ms']:.4f} bound_ms "
          f"{entry['bound_ms']:.4f} (share {share:.2f})")
    check(n == 1 or n == "not measured",
          f"{label} launched {n} CUDA kernels a call, not one")
    return dict(source="rten_tpu_torch/csrc/decode_attn_kv_group.cuh",
                device_launches=n)


def _verify_inputs(g, b, s, h, d, cap, live, mode):
    """Verify-attention inputs: q [B, S, H, D], a bf16 or int8 cache of
    capacity ``cap`` (12 heads, no GQA, as GPT-2's) and pre-chunk lengths
    drawn from ``live``."""
    f = h * d
    q = torch.randn((b, s, h, d), device="cuda", generator=g)
    lengths = torch.randint(live[0], live[1], (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    if mode == "int8":
        kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                           dtype=torch.int8, generator=g)
        scales = (0.002 + 0.01 * torch.rand((b, cap, 2, h), device="cuda",
                                            generator=g)).to(torch.bfloat16)
    else:
        kv = torch.randn((b, cap, 2, f), device="cuda",
                         generator=g).to(torch.bfloat16)
        scales = None
    return q, kv, lengths, scales


def check_verify_attn(timer, entry, b, cap, live, s=4, h=12, d=64):
    """V1 through ``verify_attn_<entry>`` in its float mode (on a bf16
    cache, path (G)'s) and its int8 mode against the plain version, with
    the bound from the rows the chunk's queries read (each row once), the
    library's ``scaled_dot_product_attention`` (bf16, a boolean mask over
    the capacity; float mode only) and, at the same shapes, one decode
    query per sequence through K6 (float) or K1' (int8): a verify step
    should cost about one decode step. V1 runs the KV-group kernel
    (:func:`kv_group_launch`: the plan, one CUDA kernel a call). Returns
    one entry per mode."""
    wrapper = getattr(at, f"verify_attn_{entry}")
    plain = getattr(at, f"verify_attn_{entry}_plain")
    g = torch.Generator(device="cuda").manual_seed(15)
    entries = []
    for mode in ("float", "int8"):
        q, kv, lengths, scales = _verify_inputs(g, b, s, h, d, cap, live,
                                                mode)
        args = (q, kv, lengths, scales)
        out = wrapper(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = K6_REL_TOL * ref.abs().max().item()
        label = (f"{wrapper.__name__} ({mode}, B {b}, S {s}, cap {cap}, "
                 f"lives {live[0]}-{live[1] - 1})")
        print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"{label} disagrees")
        ahead = torch.arange(s, device="cuda")[None, :]
        reads = (lengths[:, None] + ahead + 1).clamp(max=cap)    # [B, S]
        rows = reads[:, -1].to(torch.float64).sum().item()
        row_bytes = 2 * h * d * kv.element_size() + (
            0 if scales is None else 2 * h * 2)
        n_bytes = rows * row_bytes + 2 * q.numel() * 4 + b * 4
        flops = 4.0 * h * d * reads.to(torch.float64).sum().item()
        bms, by = bound_ms(n_bytes, flops, PEAK_F32_FLOP_S)
        ms = timer(lambda: wrapper(*args))
        plain_ms = timer(lambda: plain(*args))
        q1 = q[:, 0].contiguous()
        library = None
        if scales is None:
            mask = (torch.arange(cap, device="cuda")[None, None, :]
                    < reads[:, :, None])[:, None]               # [B,1,S,cap]
            qb = q.transpose(1, 2).to(torch.bfloat16)
            k4 = kv[:, :, 0].view(b, cap, h, d).transpose(1, 2)
            v4 = kv[:, :, 1].view(b, cap, h, d).transpose(1, 2)
            library = timer(lambda: F.scaled_dot_product_attention(
                qb, k4, v4, attn_mask=mask))
            decode = timer(lambda: at.decode_attn_float(q1, kv, lengths + 1))
            decode_name = "decode_attn_float (K6)"
        else:
            decode = timer(lambda: at.decode_attn_int8(q1, kv, scales,
                                                       lengths + 1))
            decode_name = "decode_attn_int8 (K1')"
        print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bms:.4f} ({by}) library_ms {library}; one decode "
              f"query per sequence through {decode_name} {decode:.4f} ms, "
              f"verify / decode {ms / decode:.2f}")
        result = dict(
            name=wrapper.__name__, mode=mode,
            replaces=("rten_tpu/kernels/attention.py:1957" if entry ==
                      "grouped" else "rten_tpu/kernels/attention.py:2394"),
            shape=(f"B {b}, S {s}, {h} heads of {d}, capacity {cap}, "
                   f"lives {live[0]}-{live[1] - 1}, "
                   f"{'bf16' if scales is None else 'int8'} cache"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=library, decode_ms=decode)
        result.update(kv_group_launch(
            label, at.verify_plan(b, s, h, kv.shape[3] // d, cap, d),
            lambda: wrapper(*args), result))
        entries.append(result)
    return entries


# TinyLlama's int4 weights [K, N] (name, K, N, calls per decode step of
# path (F): 22 layers, w_gate and w_up share a shape, one head).
INT4_SHAPES = (("wqkv", 2048, 2560, 22), ("wo", 2048, 2048, 22),
               ("w_gate/w_up", 2048, 5632, 44), ("w_down", 5632, 2048, 22),
               ("head", 2048, 32000, 1))
INT4_KERNELS = (("matmul_int4_words", "words", "bf16"),
                ("matmul_int4_words_int8", "words", "int8"),
                ("matmul_int4", "bytes", None))
INT4_SOURCES = {"matmul_int4_words": "rten_tpu_torch/csrc/matmul_int4.cu",
                "matmul_int4_words_int8":
                    "rten_tpu_torch/csrc/matmul_int4_int8dot.cu",
                "matmul_int4": "rten_tpu_torch/csrc/matmul_int4.cu"}


def device_launches(fn, calls=3, sessions=10):
    """The CUDA kernels one call of ``fn`` launches, by the profiler's
    device events over ``calls`` calls; "not measured" where the profiler
    recorded none. The profiler can lose kernels in a session (on the H100
    one session saw two kernels in three one-kernel calls, another none;
    once four sessions in a row lost one) but never adds one, so each
    session records after a warm-up step, and sessions repeat, up to
    ``sessions``, until one counts a whole number of kernels a call; the
    count is the most that a session saw."""
    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        most = max(most, n)
        if n and n % calls == 0:
            break
    return most / calls if most else "not measured"


def _int4_bound(x, packed, scales, dot):
    """INT4_REL_TOL x the magnitude of every f32 term of the formula."""
    group = x.shape[1] // scales.shape[0]
    s_rows = scales.repeat_interleave(group, dim=0)
    if dot is None:
        q = qt.unpack_int4(packed).float()
        return INT4_REL_TOL * (x.abs() @ (q.abs() * s_rows))
    u = qt.unpack_int4_words(packed).float() + 8
    if dot == "int8":
        absmax = x.abs().amax(dim=1, keepdim=True)
        xscale = torch.where(absmax == 0, torch.ones_like(absmax),
                             absmax / torch.full_like(absmax, 127.0))
        xq = torch.clamp(torch.round(x / xscale), -127, 127)
    else:
        xq, xscale = x, 1.0
    gsum = xq.reshape(x.shape[0], -1, group).sum(-1).abs()
    return INT4_REL_TOL * (xq.abs() @ (u * s_rows) + 8 * gsum @ scales) \
        * xscale


def check_int4(timer):
    """Q1, Q1' and Q2 against their plain versions at every TinyLlama
    weight shape at decode M = 16, at the prefill M = 1024 of w_gate (an
    admission group of 16 x 64 tokens) and, for Q1 and Q2, at Mistral-7B's
    w_gate at M 8192 (path (H)'s admission group of 16 x 512 tokens; Q1''s
    plain version would hold a [K / group, M, N] f32 product there). Prints
    each shape's times and the CUDA kernels a call launches (profiler: Q1
    and Q2 one at decode, the prep and the GEMM at prefill); returns one
    entry per kernel summed over the calls of one decode step of path (F)
    that reach it (under the byte layout wqkv and wo run as a bf16 dot on
    their dequantized copy instead, as in the model's linear), with the
    prefill shapes' times, bounds and library times as extra keys. The
    library calls, timed once per shape: a bf16 matmul on the
    bf16-dequantized weight, and torch._weight_int4pack_mm (bf16 x,
    PyTorch's own int4 layout, zero points 0) where this PyTorch has it."""
    g = torch.Generator(device="cuda").manual_seed(14)
    step = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       int4pack_ms=0.0, bytes=0.0, flops=0.0, err=0.0,
                       calls=0, shapes=[])
            for name, _, _ in INT4_KERNELS}
    int4pack = hasattr(torch, "_weight_int4pack_mm")
    every = [name for name, _, _ in INT4_KERNELS]
    shapes = [(name, 16, k, n, calls, every)
              for name, k, n, calls in INT4_SHAPES]
    shapes.append(("prefill w_gate", 1024, 2048, 5632, 0, every))
    shapes.append(("prefill Mistral w_gate", 8192, 4096, 14336, 0,
                   ["matmul_int4_words", "matmul_int4"]))
    prefill_keys = {1024: "prefill", 8192: "prefill_8192"}
    for name, m, k, n, calls, names in shapes:
        w = 0.02 * torch.randn((k, n), device="cuda", generator=g)
        x = torch.randn((m, k), device="cuda", generator=g)
        layouts = {"words": qt.quantize_int4_words(w),
                   "bytes": qt.quantize_int4_groupwise(w)}
        del w
        words, scales = layouts["words"]
        w_dq = qt.dequantize_int4_words(words, scales).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        lib = timer(lambda: torch.matmul(xb, w_dq))
        del w_dq
        lib4 = None
        if int4pack:
            u = (qt.unpack_int4_words(words).to(torch.int32) + 8).t()
            packed4 = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(),
                8)
            del u
            sz = torch.stack([scales, torch.zeros_like(scales)],
                             dim=-1).to(torch.bfloat16)
            lib4 = timer(lambda: torch._weight_int4pack_mm(xb, packed4, 128,
                                                            sz))
            del packed4
        for kname, layout, dot in INT4_KERNELS:
            if kname not in names:
                continue
            wrapper = getattr(gemm, kname)
            packed, sc = layouts[layout]
            n_calls = calls if int4_takes_kernel(
                m, QuantWeight("int4", packed, sc, n)) else 0
            if dot is None:
                plain = lambda: gemm.matmul_int4_plain(x, packed, sc)  # noqa
            else:
                plain = lambda: gemm.matmul_int4_words_plain(  # noqa: E731
                    x, packed, sc, dot_mode=dot)
            before = wrapper.launches
            out = wrapper(x, packed, sc)
            counted = wrapper.launches - before
            ref = plain()
            bound = _int4_bound(x, packed, sc, dot)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            err, worst = diff.max().item(), (diff / bound).max().item()
            on_card = device_launches(lambda: wrapper(x, packed, sc))
            print(f"{kname} ({name}, M {m}, K {k}, N {n}): max_abs_err "
                  f"{err:.3e}, worst |err| / bound {worst:.3f}; launch "
                  f"count +{counted} a call, {on_card} CUDA kernels a call "
                  f"(profiler)")
            check(counted == 1, f"{kname} counted {counted} launches a call")
            # Q1 and Q2 at decode: one kernel, the split-K sum in the
            # cluster's shared memory (no reduce launch, no partial in
            # device memory).
            check(dot == "int8" or m > 64 or on_card in (1, "not measured"),
                  f"{kname} launched {on_card} CUDA kernels a decode call")
            check(bool(torch.isfinite(out).all()) and worst <= 1.0,
                  f"{kname} disagrees at {name}")
            n_bytes = k * n // 2 + scales.numel() * 4 + 4 * m * k + 4 * m * n
            flops = 2.0 * m * k * n
            bms, by = bound_ms(n_bytes, flops, PEAK_INT8_OP_S if dot == "int8"
                               else PEAK_BF16_FLOP_S)
            ms, plain_ms = timer(lambda: wrapper(x, packed, sc)), timer(plain)
            print(f"{kname} ({name}, M {m}): kernel_ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} bound_ms {bms:.4f} ({by}) library_ms "
                  f"{lib:.4f} (bf16 matmul) int4pack_ms {lib4}; calls per "
                  f"(F) decode step {n_calls}")
            acc = step[kname]
            if m in prefill_keys:
                pre = prefill_keys[m]
                acc.update({f"{pre}_ms": ms, f"{pre}_library_ms": lib,
                            f"{pre}_bound_ms": bms})
            for key, value in (("ms", ms), ("plain_ms", plain_ms),
                               ("bound_ms", bms), ("library_ms", lib),
                               ("int4pack_ms", lib4 or 0.0),
                               ("bytes", n_bytes), ("flops", flops)):
                acc[key] += n_calls * value
            if n_calls:
                acc["err"] = max(acc["err"], err)
                acc["calls"] += n_calls
                acc["shapes"].append(f"{n_calls} x {name}")
        del layouts, words, scales, x, xb
        torch.cuda.empty_cache()
    entries = []
    for kname, _, dot in INT4_KERNELS:
        acc = step[kname]
        _, by = bound_ms(acc["bytes"], acc["flops"],
                         PEAK_INT8_OP_S if dot == "int8" else PEAK_BF16_FLOP_S)
        print(f"{kname}: one decode step of (F) ({acc['calls']} calls): "
              f"kernel_ms "
              f"{acc['ms']:.4f} plain_ms {acc['plain_ms']:.4f} bound_ms "
              f"{acc['bound_ms']:.4f} ({by}, {acc['bytes'] / 1e6:.1f} MB) "
              f"library_ms {acc['library_ms']:.4f} (bf16 matmul) "
              f"int4pack_ms {acc['int4pack_ms'] if int4pack else None}")
        entries.append(dict(
            name=kname, source=INT4_SOURCES[kname],
            replaces=("rten_tpu/kernels/gemm.py:517" if dot is None
                      else "rten_tpu/kernels/gemm.py:430"),
            shape=(f"one decode step of (F), {acc['calls']} calls at M 16 "
                   f"summed: " + ", ".join(acc["shapes"])),
            max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain_ms"],
            bound_ms=acc["bound_ms"], bound_by=by,
            library_ms=acc["library_ms"],
            int4pack_ms=acc["int4pack_ms"] if int4pack else None,
            **{key: acc[key] for key in acc if key.startswith("prefill")}))
    return entries


# Path (H), Mistral-7B's shape: batch 16, 32 query heads over 8 KV heads of
# 128, 512-token prompts, so decode reads lives 512-576.
H_HEADS, H_KVH, H_D = 32, 8, 128
H_LIVES = (512, 577)
# K7's shapes: (batch, KV heads, head_dim, capacity, lives) of path (B)
# and of path (H).
K7_B_SHAPE = (256, 12, 64, 512, (65, 177))
K7_H_SHAPE = (16, H_KVH, H_D, 4096, H_LIVES)


def check_flash_attention(timer, b=16, h=H_HEADS, s=512, d=H_D):
    """F1 against its plain version at path (H)'s prefill (an admission
    group of 16 prompts of 512 tokens, k and v repeated to 32 heads),
    causal; the library call is ``scaled_dot_product_attention(is_causal=
    True)`` on the same f32 tensors. F1 does its products in split TF32
    (three tensor-core products per f32 product), so its bound is 3 x
    2*B*H*S^2*D causal FLOPs at the dense TF32 peak against each input
    read and the output written once; the f32 SIMT bound (the FLOPs at
    the f32 peak outside the tensor cores) is printed beside it."""
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn((b, h, s, d), device="cuda", generator=g)
               for _ in range(3))
    out = at.flash_attention(q, k, v)
    ref = at.flash_attention_plain(q, k, v)
    lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K6_REL_TOL * ref.abs().max().item()
    label = f"flash_attention (B {b}, {h} heads of {d}, S {s}, causal)"
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}); "
          f"scaled_dot_product_attention against the plain version "
          f"{(lib_out - ref).abs().max().item():.3e}")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"{label} disagrees")
    del lib_out
    flops = 2.0 * b * h * s * s * d
    n_bytes = 4 * q.numel() * 4
    bms, by = bound_ms(n_bytes, 3 * flops, PEAK_TF32_FLOP_S)
    simt_bms, _ = bound_ms(n_bytes, flops, PEAK_F32_FLOP_S)
    ms = timer(lambda: at.flash_attention(q, k, v))
    plain_ms = timer(lambda: at.flash_attention_plain(q, k, v))
    lib = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}, 3 x {flops / 1e9:.1f} GFLOP of TF32; the f32 "
          f"SIMT bound {simt_bms:.4f}) library_ms {lib:.4f} (f32 "
          f"scaled_dot_product_attention); {flops / ms / 1e9:.1f} TFLOP/s "
          f"of f32 work, {3 * flops / ms / 1e9:.1f} of TF32, "
          f"{bms / ms:.3f} of the bound")
    return dict(name="flash_attention",
                source="rten_tpu_torch/csrc/prefill_attn.cu",
                replaces="rten_tpu/kernels/attention.py:118",
                shape=f"B {b}, {h} heads of {d}, S {s}, causal, f32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib, simt_bound_ms=simt_bms)


def _decode_lengths(g, b, lives):
    return torch.randint(lives[0], lives[1], (b,), device="cuda",
                         generator=g, dtype=torch.int32)


def _decode_bound(q, lengths, cap, row_bytes, extra_bytes=0):
    """Bytes of the live rows (each read once), q, the output and the
    lengths, plus ``extra_bytes``; 4 f32 operations per (head, dim, row)."""
    rows = lengths.clamp(max=cap).to(torch.float64).sum().item()
    b, h, d = q.shape
    n_bytes = rows * row_bytes + 2 * q.numel() * 4 + b * 4 + extra_bytes
    return bound_ms(n_bytes, 4.0 * h * d * rows, PEAK_F32_FLOP_S)


def check_int8_decode(timer, entry, b, cap, lives=H_LIVES, h=H_HEADS,
                      kvh=H_KVH, d=H_D, bf16_q=False):
    """G1 (``entry`` "exact" or "int8_scores") or G2 ("fused") against its
    plain version on an int8 cache at path (H)'s shapes; with int8 scores
    the kernel's int32 dots must equal the plain ones bit for bit;
    ``bf16_q`` makes q bf16-valued (what the model passes under bf16
    compute). Bound: the live rows' int8 bytes and bf16 scales, each read
    once."""
    g = torch.Generator(device="cuda").manual_seed(22)
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    if bf16_q:
        q = q.to(torch.bfloat16).to(torch.float32)
    lengths = _decode_lengths(g, b, lives)
    scores = entry == "int8_scores"
    if entry == "fused":
        wrapper, plain = at.decode_attn_fused_int8, \
            at.decode_attn_fused_int8_plain
        args, kw = (q, kv, scales, lengths), {}
    else:
        wrapper, plain = at.decode_attn_grouped_int8, \
            at.decode_attn_grouped_int8_plain
        args, kw = (q, kv, scales, lengths), dict(int8_scores=scores)
    dots = torch.zeros((b, h, cap), dtype=torch.int32, device="cuda")
    out = wrapper(*args, **kw, **(dict(dots=dots) if scores else {}))
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K6_REL_TOL * ref.abs().max().item()
    label = (f"{wrapper.__name__} ({entry}, B {b}, {h} heads over {kvh} of "
             f"{d}, capacity {cap}, lives {lives[0]}-{lives[1] - 1}"
             f"{', bf16-valued q' if bf16_q else ''})")
    exact = ""
    if scores:
        same = torch.equal(dots, at.int8_score_dots_plain(q, kv, lengths))
        exact = f"; int32 dots bit-exact {same}"
        check(same, f"{label}: int32 dots differ from the plain version's")
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}){exact}")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"{label} disagrees")
    bms, by = _decode_bound(q, lengths, cap, 2 * kvh * d + 2 * kvh * 2)
    ms = timer(lambda: wrapper(*args, **kw))
    plain_ms = timer(lambda: plain(*args, **kw))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}) library_ms None")
    entry_kw = {} if entry == "fused" else dict(mode=entry)
    result = dict(name=wrapper.__name__, **entry_kw,
                  replaces=("rten_tpu/kernels/attention.py:318"
                            if entry == "fused"
                            else "rten_tpu/kernels/attention.py:1039"),
                  shape=(f"B {b}, {h} heads over {kvh} of {d}, int8 cache "
                         f"of capacity {cap}, lives {lives[0]}-"
                         f"{lives[1] - 1}"),
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by, library_ms=None)
    result.update(kv_group_launch(
        f"{wrapper.__name__} ({entry})", at.rows_plan(b, h, kvh, cap, d),
        lambda: wrapper(*args, **kw), result))
    return result


def check_grouped_append(timer, b=16, cap=4096, lives=H_LIVES, h=H_HEADS,
                         kvh=H_KVH, d=H_D):
    """A1 (the KV-group kernel with the write fused) against its plain
    version (K5's write, then K6's contract) on a bf16 cache, path
    (H-append)'s, and on an f32 one (printed, and kept in the entry's
    ``f32_*`` keys): the written cache must equal the plain version's and
    K5's bit for bit, and one call must launch one CUDA kernel
    (``kv_group_launch``, which prints the plan). k and v are strided views
    of one qkv row, as the model passes them. Bound: the live rows read
    once, the new f32 rows read and written once in the cache dtype."""
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    qkv = torch.randn((b, 1, 3 * kvh * d), device="cuda", generator=g)
    k = qkv[..., :kvh * d].reshape(b, 1, kvh, d).transpose(1, 2)
    v = qkv[..., kvh * d:2 * kvh * d].reshape(b, 1, kvh, d).transpose(1, 2)
    lengths = _decode_lengths(g, b, lives)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                         generator=g).to(dtype)
        kv_plain, kv_k5 = kv.clone(), kv.clone()
        out = at.decode_attn_grouped_append(q, kv, k, v, lengths)
        ref = at.decode_attn_grouped_append_plain(q, kv_plain, k, v,
                                                  lengths)
        kc.kv_append(kv_k5, k, v, lengths - 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = K6_REL_TOL * ref.abs().max().item()
        same = torch.equal(kv, kv_plain) and torch.equal(kv, kv_k5)
        name = str(dtype).split(".")[-1]
        label = (f"decode_attn_grouped_append ({name} cache, B {b}, {h} "
                 f"heads over {kvh} of {d}, capacity {cap}, lives "
                 f"{lives[0]}-{lives[1] - 1})")
        print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}); cache "
              f"write bit-exact against the plain version and K5 {same}")
        check(bool(torch.isfinite(out).all()) and err <= tol and same,
              f"{label} disagrees")
        elt = kv.element_size()
        bms, by = _decode_bound(q, lengths - 1, cap, 2 * kvh * d * elt,
                                b * 2 * kvh * d * (4 + elt))
        ms = timer(lambda: at.decode_attn_grouped_append(q, kv, k, v,
                                                         lengths))
        plain_ms = timer(lambda: at.decode_attn_grouped_append_plain(
            q, kv_plain, k, v, lengths))
        print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bms:.4f} ({by}) library_ms None")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by)
        res[name].update(kv_group_launch(
            label, at.rows_plan(b, h, kvh, cap, d),
            lambda: at.decode_attn_grouped_append(q, kv, k, v, lengths),
            res[name]))
        del kv, kv_plain, kv_k5
    f32 = res["float32"]
    return dict(name="decode_attn_grouped_append",
                replaces="rten_tpu/kernels/attention.py:976",
                shape=(f"B {b}, {h} heads over {kvh} of {d}, bf16 cache of "
                       f"capacity {cap}, lives {lives[0]}-{lives[1] - 1}"),
                **res["bfloat16"], library_ms=None,
                **{f"f32_{key}": f32[key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "device_launches")})


# -- K8, the partials mode, K9, native_dots, pv_int8 and M1 -------------------

def _sdpa_mask(lengths, cap):
    return (torch.arange(cap, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]


def check_flat_float(timer, b=256, h=12, kvh=12, cap=512, lives=(65, 177),
                     entry=True):
    """K8 (``decode_attn_flat_float``) against its plain version at path
    (I)'s shapes on an f32 cache (the entry, its library call f32
    ``scaled_dot_product_attention`` over the capacity with the length
    mask) and (I-bf16)'s bf16 cache (kept in the entry's ``bf16_*`` keys,
    with bf16 SDPA); or, with ``entry`` False, printed only (TinyLlama's
    B 16, 32 heads over 4 KV heads, capacity 2048). Both versions round
    the output to bf16: :func:`check_rounded`; K6 at the same inputs must
    miss its share. Bound: the live rows read once in the cache dtype, 4
    f32 operations per (head, dim, row)."""
    d = 64
    f = kvh * d
    g = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = _decode_lengths(g, b, lives)
    mask = _sdpa_mask(lengths, cap)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        kv = torch.randn((b, cap, 2, f), device="cuda",
                         generator=g).to(dtype)
        out = at.decode_attn_flat_float(q, kv, lengths)
        ref = at.decode_attn_flat_float_plain(q, kv, lengths)
        k6 = at.decode_attn_float(q, kv, lengths)
        torch.cuda.synchronize()
        label = (f"decode_attn_flat_float ({str(dtype)[6:]} cache, B {b}, "
                 f"H {h} over {kvh}, capacity {cap}, lives {lives[0]}-"
                 f"{lives[1] - 1})")
        err, share = check_rounded(out, ref, label)
        k6_share = share_within(k6, ref, ROUND_ELEM_TOL)
        print(f"{label}: K6 (decode_attn_float) at the same inputs: share "
              f"within {ROUND_ELEM_TOL:.0e} of max |out| {k6_share:.6f} "
              f"(must miss {ROUND_SHARE})")
        check(k6_share < ROUND_SHARE, f"{label}: K6 meets K8's criterion")
        bms, by = _decode_bound(q, lengths, cap, 2 * f * kv.element_size())
        rep = h // kvh
        k4 = kv[:, :, 0].view(b, cap, kvh, d).transpose(1, 2)
        v4 = kv[:, :, 1].view(b, cap, kvh, d).transpose(1, 2)
        qs = q[:, :, None].to(dtype)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qs, k4, v4, attn_mask=mask, enable_gqa=rep > 1))
        ms = timer(lambda: at.decode_attn_flat_float(q, kv, lengths))
        plain_ms = timer(lambda: at.decode_attn_flat_float_plain(q, kv,
                                                                 lengths))
        print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
              f"{bms:.4f} ({by}) library_ms {lib:.4f} ({str(dtype)[6:]} "
              f"scaled_dot_product_attention)")
        res[dtype] = dict(max_abs_err=err, share=share, k6_share=k6_share,
                          ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, library_ms=lib)
        res[dtype].update(kv_group_launch(
            label, at.rows_plan(b, h, kvh, cap, d),
            lambda: at.decode_attn_flat_float(q, kv, lengths), res[dtype]))
        del kv
    if not entry:
        return None
    bf = res[torch.bfloat16]
    return dict(name="decode_attn_flat_float",
                replaces="rten_tpu/kernels/attention.py:1715",
                shape=(f"B {b}, {h} heads of {d}, f32 cache of capacity "
                       f"{cap}, lives {lives[0]}-{lives[1] - 1}"),
                **res[torch.float32],
                **{f"bf16_{key}": bf[key] for key in
                   ("max_abs_err", "share", "k6_share", "ms", "plain_ms",
                    "bound_ms", "library_ms", "device_launches")})


# The partials mode's shapes: path (B)'s and TinyLlama's.
PARTIALS_SHAPES = dict(b=dict(b=256, h=12, kvh=12, cap=512, lives=(65, 177)),
                       gqa=dict(b=16, h=32, kvh=4, cap=2048,
                                lives=(65, 2000)))


def partials_inputs(b, h, kvh, cap, lives, d=64):
    """q, an int8 cache with its bf16 scales, and lengths from ``lives``."""
    g = torch.Generator(device="cuda").manual_seed(32)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    return q, kv, scales, _decode_lengths(g, b, lives)


def _partials_case(timer, b, h, kvh, cap, lives, q_bf16):
    """The partials mode at one shape (see check_partials); returns its
    numbers."""
    q, kv, scales, lengths = partials_inputs(b, h, kvh, cap, lives)
    d = q.shape[2]
    f = kvh * d
    args = (q, kv, scales, lengths, q_bf16)
    out = at.decode_attn_int8_partials(*args)
    ref = at.decode_attn_int8_partials_plain(*args)
    torch.cuda.synchronize()
    errs = [(out[..., sl] - ref[..., sl]).abs().max().item()
            / ref[..., sl].abs().max().item()
            for sl in (slice(0, d), d, d + 1)]
    label = (f"decode_attn_int8_partials (q_bf16 {q_bf16}, B {b}, H {h} "
             f"over {kvh}, capacity {cap}, lives {lives[0]}-{lives[1] - 1})")
    print(f"{label}: relative max errors acc {errs[0]:.3e}, m "
          f"{errs[1]:.3e}, l {errs[2]:.3e} (tol {K6_REL_TOL:.1e}"
          f"{', acc: below' if q_bf16 else ''})")
    check(bool(torch.isfinite(out).all())
          and max(errs[1:] if q_bf16 else errs) <= K6_REL_TOL,
          f"{label} disagrees")
    if q_bf16:
        check_rounded(out[..., :d], ref[..., :d], f"{label}, acc")
    # A sequence with no live row weighs nothing in the shards' merge.
    empty = lengths.clone()
    empty[0] = 0
    e = at.decode_attn_int8_partials(q, kv, scales, empty, q_bf16)[0]
    check(bool((e[:, :d] == 0).all() and (e[:, d] == -1e30).all()
               and (e[:, d + 1] == 0).all()),
          f"{label}: a sequence of length 0 does not emit (0, -1e30, 0)")
    bms, by = _decode_bound(q, lengths, cap, 2 * f + 2 * kvh * 2,
                            b * h * 2 * 4)
    ms = timer(lambda: at.decode_attn_int8_partials(*args))
    plain_ms = timer(lambda: at.decode_attn_int8_partials_plain(*args))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}) library_ms None")
    res = dict(max_abs_err=errs[0] * ref[..., :d].abs().max().item(),
               ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    res.update(kv_group_launch(label, at.rows_plan(b, h, kvh, cap, d),
                               lambda: at.decode_attn_int8_partials(*args),
                               res))
    return res


def check_partials(timer):
    """The partials mode (``decode_attn_int8_partials``: the KV-group kernel
    in its partials modes at ``rows_plan``) against its plain version, at
    path (B)'s shapes (B 256, 12 heads of 64, capacity 512, lives 65-176;
    one unsplit block a (sequence, head)) with q_bf16 on (the entry) and
    off (``exact_q_*``), and at TinyLlama's (B 16, 32 heads over 4, capacity
    2048, lives 65-1999: 4 splits of 8 heads a block, merged in their
    cluster; ``gqa_*``), q_bf16 on: acc held by :func:`check_rounded` (on:
    rounded to bf16) or within K6's tolerance (off), m and l within K6's
    relative tolerance; a sequence of length 0 emits acc 0, m = -1e30 and
    l 0; one CUDA kernel a call. Bound: the live int8 rows and their bf16
    scales read once, q and the D + 2 lanes written once."""
    res = _partials_case(timer, q_bf16=True, **PARTIALS_SHAPES["b"])
    exact = _partials_case(timer, q_bf16=False, **PARTIALS_SHAPES["b"])
    gqa = _partials_case(timer, q_bf16=True, **PARTIALS_SHAPES["gqa"])
    return dict(name="decode_attn_int8_partials",
                replaces="rten_tpu/kernels/attention.py:1715",
                shape=("B 256, 12 heads of 64, int8 cache of capacity 512, "
                       "lives 65-176, q_bf16 (gqa_: B 16, 32 heads over 4, "
                       "capacity 2048, lives 65-1999)"),
                **res, library_ms=None,
                **{f"exact_q_{key}": exact[key] for key in
                   ("max_abs_err", "ms", "plain_ms")},
                **{f"gqa_{key}": gqa[key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "device_launches")})


def split_kv_inputs(b=16, h=H_HEADS, kvh=H_KVH, d=H_D, s=4096,
                    lives=H_LIVES):
    """K9's inputs at path (H)'s head shape: q, f32 K and V planes
    [B, KVH, S, D] and lengths drawn from ``lives``."""
    g = torch.Generator(device="cuda").manual_seed(33)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    planes = [torch.randn((b, kvh, s, d), device="cuda", generator=g)
              for _ in range(2)]
    return q, planes, _decode_lengths(g, b, lives)


def check_split_kv(timer, lives=H_LIVES):
    """K9 (``decode_attn_split_kv``, the KV-group kernel over separate K and
    V planes) against its plain version at path (H)'s head shape (the
    reference's kernel shape: d 128, S a multiple of 256) on f32 planes
    (the entry) and bf16 planes (its ``bf16_*`` keys): held within
    K6_REL_TOL of max |out|, timed beside the plain version and
    ``scaled_dot_product_attention(enable_gqa=True)`` in the planes' dtype
    (q cast to it) over S with the length mask, the plan and one CUDA
    kernel a call (``kv_group_launch``). Bound: the live rows of K and V
    read once."""
    q, planes, lengths = split_kv_inputs(lives=lives)
    b, h, d = q.shape
    kvh, s = planes[0].shape[1:3]
    check(at.split_kv_takes_kernel(s, d), "K9's phase shape is not one the "
          "reference sends to its kernel")
    mask = _sdpa_mask(lengths, s)
    entry = dict(name="decode_attn_split_kv",
                 replaces="rten_tpu/kernels/attention.py:2647",
                 shape=(f"B {b}, {h} heads over {kvh} of {d}, f32 K and V "
                        f"of S {s}, lives {lives[0]}-{lives[1] - 1}"))
    for dtype, key in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
        k, v = (x.to(dtype) for x in planes)
        out = at.decode_attn_split_kv(q, k, v, lengths)
        ref = at.decode_attn_split_kv_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = K6_REL_TOL * ref.abs().max().item()
        label = (f"decode_attn_split_kv (B {b}, {h} heads over {kvh} of "
                 f"{d}, {str(dtype)[6:]} planes of S {s}, lives "
                 f"{lives[0]}-{lives[1] - 1})")
        print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"{label} disagrees")
        bms, by = _decode_bound(q, lengths, s,
                                2 * kvh * d * k.element_size())
        qd = q.to(dtype)[:, :, None]
        lib = timer(lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask, enable_gqa=True))
        call = lambda: at.decode_attn_split_kv(q, k, v, lengths)
        r = dict(max_abs_err=err, ms=timer(call),
                 plain_ms=timer(lambda: at.decode_attn_split_kv_plain(
                     q, k, v, lengths)),
                 bound_ms=bms, bound_by=by, library_ms=lib)
        print(f"{label}: kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {bms:.4f} ({by}) library_ms "
              f"{lib:.4f} ({str(dtype)[6:]} scaled_dot_product_attention, "
              f"enable_gqa)")
        r.update(kv_group_launch(label, at.rows_plan(b, h, kvh, s, d), call,
                                 r))
        entry["source"] = r.pop("source")
        entry.update({key + name: x for name, x in r.items()})
    return entry


# native_dots and pv_int8 round a probability (to bf16, or to an int8 step
# of its block's largest scale-folded value) that the kernel and the plain
# version compute in f32 in other orders, so a rounding may flip between
# them: one flip moves an output by at most one such step of one
# probability, whose weight in the output is at most 1. native_dots: a bf16
# step is at most 2^-7 of p <= 1, times max |V|; pv_int8: 1/127 of the
# block's largest p * v_scale <= max v_scale, times max |v8| = 127.
NATIVE_STEP = 2.0 ** -7
PV_INT8_STEP = 1.0 / 127


def check_flips(out, ref, tol, label, other, other_label):
    """Hold a kernel that rounds every probability against its plain
    version: no element past ``tol`` (one flipped rounding) and FLIP_SHARE
    of the elements within K6's tolerance, which ``other`` (the kernel
    without the rounding, at the same inputs) must miss. Returns (max abs
    error, share)."""
    err = (out - ref).abs().max().item()
    share = share_within(out, ref, K6_REL_TOL)
    other_share = share_within(other, ref, K6_REL_TOL)
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}); share within "
          f"K6's 1e-5 of max |out| {share:.6f} (min {FLIP_SHARE}); "
          f"{other_label} at the same inputs {other_share:.6f} (must miss)")
    check(bool(torch.isfinite(out).all()) and err <= tol
          and share >= FLIP_SHARE, f"{label} disagrees")
    check(other_share < FLIP_SHARE,
          f"{label}: {other_label} meets the criterion")
    return err, share


def native_dots_inputs(b=256, h=12, kvh=12, cap=512, lives=(65, 177)):
    """(q, kv, lengths) of :func:`check_native_dots`: path (C)'s shapes, a
    bf16 cache."""
    d = 64
    g = torch.Generator(device="cuda").manual_seed(34)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=g).to(torch.bfloat16)
    return q, kv, _decode_lengths(g, b, lives)


def check_native_dots(timer, lives=(65, 177)):
    """``decode_attn_native_dots`` against its plain version on a bf16
    cache at path (C)'s shapes (block 64, group 8): FLIP_SHARE of the
    elements within K6's tolerance, none past one bf16 step of one
    probability (NATIVE_STEP x max |V|), and K6 at the same inputs missing
    that share; the library call bf16 ``scaled_dot_product_attention``
    over the capacity with the length mask; the plan (one split of whole
    blocks) and one CUDA kernel a call. Bound: K6's on bf16 rows."""
    q, kv, lengths = native_dots_inputs(lives=lives)
    b, h, d = q.shape
    cap, f = kv.shape[1], kv.shape[3]
    kvh = f // d
    before = at.decode_attn_native_dots.launches
    out = at.decode_attn_native_dots(q, kv, lengths)
    ref = at.decode_attn_native_dots_plain(q, kv, lengths)
    k6 = at.decode_attn_float(q, kv, lengths)
    torch.cuda.synchronize()
    check(at.decode_attn_native_dots.launches == before + 1,
          "native_dots fell back")
    label = (f"decode_attn_native_dots (bf16 cache, B {b}, H {h} over {kvh}, "
             f"capacity {cap}, lives {lives[0]}-{lives[1] - 1})")
    err, share = check_flips(out, ref, NATIVE_STEP
                             * kv[:, :, 1].abs().max().item(), label, k6,
                             "K6 (decode_attn_float)")
    bms, by = _decode_bound(q, lengths, cap, 2 * f * 2)
    mask = _sdpa_mask(lengths, cap)
    k4 = kv[:, :, 0].view(b, cap, h, d).transpose(1, 2)
    v4 = kv[:, :, 1].view(b, cap, h, d).transpose(1, 2)
    qs = q[:, :, None].to(torch.bfloat16)
    lib = timer(lambda: F.scaled_dot_product_attention(qs, k4, v4,
                                                       attn_mask=mask))
    ms = timer(lambda: at.decode_attn_native_dots(q, kv, lengths))
    plain_ms = timer(lambda: at.decode_attn_native_dots_plain(q, kv,
                                                              lengths))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}) library_ms {lib:.4f} (bf16 "
          f"scaled_dot_product_attention)")
    result = dict(name="decode_attn_native_dots",
                  replaces="rten_tpu/kernels/attention.py:1039",
                  shape=(f"B {b}, {h} heads of {d}, bf16 cache of capacity "
                         f"{cap}, lives {lives[0]}-{lives[1] - 1}, block 64"),
                  max_abs_err=err, share=share, ms=ms, plain_ms=plain_ms,
                  bound_ms=bms, bound_by=by, library_ms=lib)
    result.update(kv_group_launch(
        "decode_attn_native_dots",
        at.block_plan(b, h, kvh, cap, 64, d, native=True),
        lambda: at.decode_attn_native_dots(q, kv, lengths), result))
    return result


def pv_int8_inputs(b=16, cap=4096, lives=H_LIVES, h=H_HEADS, kvh=H_KVH,
                   d=H_D):
    """(q, kv, scales, lengths) of :func:`check_pv_int8`: path (H)'s
    shapes, an int8 cache."""
    g = torch.Generator(device="cuda").manual_seed(35)
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    return q, kv, scales, _decode_lengths(g, b, lives)


def check_pv_int8(timer, int8_scores, lives=H_LIVES):
    """G1's pv_int8 mode (``decode_attn_grouped_int8(pv_int8=True)``,
    block 64, group 8) against its plain version at path (H)'s shapes,
    with exact q or int8 scores: FLIP_SHARE of the elements within K6's
    tolerance, none past one int8 step of one probability (PV_INT8_STEP x
    max v_scale x 127), and G1 without pv_int8 at the same inputs missing
    that share; the plan (chunks of whole blocks) and one CUDA kernel a
    call. Bound as G1."""
    q, kv, scales, lengths = pv_int8_inputs(lives=lives)
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    kw = dict(int8_scores=int8_scores, pv_int8=True)
    args = (q, kv, scales, lengths)
    before = at.decode_attn_grouped_int8.launches
    out = at.decode_attn_grouped_int8(*args, **kw)
    ref = at.decode_attn_grouped_int8_plain(*args, **kw)
    torch.cuda.synchronize()
    check(at.decode_attn_grouped_int8.launches == before + 1,
          "pv_int8 fell back")
    g1 = at.decode_attn_grouped_int8(*args, int8_scores=int8_scores)
    mode = "int8_scores" if int8_scores else "exact"
    label = (f"decode_attn_grouped_int8 (pv_int8, {mode}, B {b}, {h} heads "
             f"over {kvh} of {d}, capacity {cap}, lives {lives[0]}-"
             f"{lives[1] - 1})")
    err, share = check_flips(out, ref, PV_INT8_STEP * scales[:, :, 1].float()
                             .max().item() * 127, label, g1,
                             "G1 without pv_int8")
    bms, by = _decode_bound(q, lengths, cap, 2 * kvh * d + 2 * kvh * 2)
    ms = timer(lambda: at.decode_attn_grouped_int8(*args, **kw))
    plain_ms = timer(lambda: at.decode_attn_grouped_int8_plain(*args, **kw))
    print(f"{label}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bms:.4f} ({by}) library_ms None")
    result = dict(name="decode_attn_grouped_int8", mode=f"pv_int8.{mode}",
                  replaces="rten_tpu/kernels/attention.py:1039",
                  shape=(f"B {b}, {h} heads over {kvh} of {d}, int8 cache "
                         f"of capacity {cap}, lives {lives[0]}-"
                         f"{lives[1] - 1}, block 64"),
                  max_abs_err=err, share=share, ms=ms, plain_ms=plain_ms,
                  bound_ms=bms, bound_by=by, library_ms=None)
    result.update(kv_group_launch(
        f"decode_attn_grouped_int8 (pv_int8, {mode})",
        at.block_plan(b, h, kvh, cap, 64, d),
        lambda: at.decode_attn_grouped_int8(*args, **kw), result))
    return result


# GPT-2-small's linears (K, N): QKV, O, MLP up, MLP down.
GPT2_LINEARS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def check_int8_tiled(timer):
    """M1 (``matmul_int8_tiled``: ``wgmma`` s8 over a TMA-fed ring, at
    ``matmul_int8_plan``'s launch) bit for bit against its plain version
    (the int32 sums taken exactly in f64) at GPT-2-small's four linears
    at M 256 (a decode step at batch 256: the entry sums one layer's four)
    and M 4096 (an admission of 64 prompts of 64 tokens: the entry's
    ``m4096`` list), and at a ragged shape that takes the masked loader
    (M 300, K 1100, N 520, bit for bit, printed). The library call:
    ``torch._int_mm`` and the same epilogue, (f32(acc) * x_scale) *
    w_scales. Bound: 2 M N K int8 operations at the int8 peak against x, w
    and the scales read and the f32 output written once."""
    g = torch.Generator(device="cuda").manual_seed(36)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    n_bytes = flops = 0.0
    m4096 = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in ([(m, k, n) for m in (256, 4096) for k, n in GPT2_LINEARS]
                    + [(300, 1100, 520)]):
        x = torch.randint(-127, 128, (m, k), device="cuda",
                          dtype=torch.int8, generator=g)
        w = torch.randint(-127, 128, (k, n), device="cuda",
                          dtype=torch.int8, generator=g)
        ws = 0.001 + 0.01 * torch.rand(n, device="cuda", generator=g)
        xs = torch.tensor([0.0173], device="cuda")
        out = gemm.matmul_int8_tiled(x, w, xs, ws)
        ref = gemm.matmul_int8_tiled_plain(x, w, xs, ws)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        plan = gemm.matmul_int8_plan(m, k, n, sms)
        label = (f"matmul_int8_tiled (M {m}, K {k}, N {n}; {plan['bn']}-"
                 f"column tiles, {plan['splits']} K split(s), "
                 f"{plan['blocks']} blocks, {plan['loader']} loader)")
        check(same, f"{label}: not bit-exact against its plain version")
        shape_bytes = m * k + k * n + 4 * (m * n + n + 1)
        bms, by = bound_ms(shape_bytes, 2.0 * m * n * k, PEAK_INT8_OP_S)
        ms = timer(lambda: gemm.matmul_int8_tiled(x, w, xs, ws))
        plain_ms = timer(lambda: gemm.matmul_int8_tiled_plain(x, w, xs, ws))
        lib = (timer(lambda: torch._int_mm(x, w).to(torch.float32) * xs
                     * ws[None, :]) if k % 8 == 0 and n % 8 == 0 else None)
        print(f"{label}: bit-exact {same}; kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bms:.4f} ({by}) library_ms "
              f"{lib if lib is None else f'{lib:.4f}'} (torch._int_mm + "
              f"epilogue); {2.0 * m * n * k / ms / 1e9:.1f} TOP/s")
        if m == 256:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib)):
                total[key] += val
            n_bytes += shape_bytes
            flops += 2.0 * m * n * k
        elif m == 4096:
            m4096.append(dict(k=k, n=n, ms=ms, plain_ms=plain_ms,
                              bound_ms=bms, bound_by=by, library_ms=lib))
        del x, w, out, ref
    total["bound_ms"], total["bound_by"] = bound_ms(n_bytes, flops,
                                                    PEAK_INT8_OP_S)
    return dict(name="matmul_int8_tiled", source="rten_tpu_torch/csrc/"
                "matmul_int8.cu", replaces="rten_tpu/kernels/gemm.py:93",
                shape=("GPT-2-small's QKV, O, up and down linears at M 256, "
                       "summed (m4096: each at M 4096)"), max_abs_err=0.0,
                m4096=m4096, **total)


def mistral_model(path, n_layers):
    return TransformerLM(TransformerConfig.mixtral(
        n_experts=0, n_layers=n_layers, **PATHS[path].get("config", {})))


# -- path (J): the .rten graph runtime ----------------------------------------

RESNET_BATCH = 32                  # images a run on the card
RESNET_CPU_BATCH = 2               # the card against the CPU
RESNET_RUNS = 5                    # timed runs a precision
# Card against CPU at batch 2 through ResNet-50: f32 with TF32 off differs
# only in f32 summation order: 1e-3 of max |logit|. INT8 (per-tensor
# dynamic activation quantization before every conv): a rounding that
# flips between the devices' f32 sums moves one activation by a step, so
# 1e-2 of max |logit| (the CPU tests' tolerance against the JAX package),
# and the same top-1 except where the CPU's top-2 margin is below it.
RESNET_F32_TOL = 1e-3
RESNET_INT8_TOL = 1e-2


def resnet50_bytes():
    """ResNet-50 (224 x 224, 1000 classes, the reference's random weights
    from ``init_params``) as f32 and INT8 `.rten` bytes, built the way
    tools/bench_vision.py builds them: ``build_rten``, then
    ``quantize_graph_weights``."""
    net = ResNet(ResNetConfig(depth=50))
    f32 = net.build_rten(net.init_params()).to_bytes()
    graph = graph_from_model_file(fmt_container.load_bytes(f32))
    n = quantize_graph_weights(graph)
    return f32, graph_to_bytes(graph), n


def conv_integer_nodes(model, n=3):
    """The first ``n`` ConvInteger operators of the model's plan."""
    ops = (model.graph.nodes[i].data for i in model.graph.plan())
    return [op for op in ops if op.op_type == "ConvInteger"][:n]


def check_conv_integer_accumulators(card, cpu, x):
    """The int32 accumulators of the first three ConvInteger nodes, card
    against CPU: each conv's lowering on the card given the CPU's inputs to
    it (the quantized activations and their zero point) must give the
    CPU's accumulator bit for bit; the first conv's accumulator, whose
    input chain is the image alone, through the whole model too."""
    from rten_tpu_torch.ops.registry import get_op
    from rten_tpu_torch.runtime.executor import _Ctx
    nodes = conv_integer_nodes(cpu)
    in_id = cpu.input_ids()[0]
    ids = [i for op in nodes for i in (op.inputs[0], op.inputs[2],
                                        op.outputs[0])]
    values = cpu.run({in_id: x}, outputs=ids)
    fn = get_op("ConvInteger").fn
    for k, op in enumerate(nodes):
        xq, zp, acc = values[3 * k: 3 * k + 3]
        w = card.executor._device_value(card.graph, op.inputs[1],
                                        card.graph.nodes[op.inputs[1]]
                                        .data.array)
        got = fn(_Ctx(1), op.attrs, xq.cuda(), w, zp.cuda(), None)
        same = torch.equal(got.cpu(), acc)
        print(f"ConvInteger {k} ({tuple(w.shape)}): card == cpu {same}; "
              f"max |acc| {acc.abs().max().item()}")
        check(same, f"ConvInteger {k}: the card's accumulator differs")
    first = card.run({in_id: x.cuda()}, outputs=[nodes[0].outputs[0]])[0]
    same = torch.equal(first.cpu(), values[2])
    print(f"ConvInteger 0 through the whole model: card == cpu {same}")
    check(same, "ConvInteger 0 through the model differs")


def attention_graph_bytes(b, h, s, d):
    """softmax(q @ kt * d^-0.5) @ v as a `.rten` graph (the optimizer fuses
    it to FusedSDPA)."""
    mb = ModelBuilder()
    g = mb.graph
    q = g.add_value("q", shape=[b, h, s, d])
    kt = g.add_value("kt", shape=[b, h, d, s])
    v = g.add_value("v", shape=[b, h, s, d])
    c = g.add_constant("scale", np.float32(1.0 / np.sqrt(d)))
    qk = g.add_operator("MatMul", [q, kt], name="qk")
    scaled = g.add_operator("Mul", [qk, c], name="scaled")
    probs = g.add_operator("Softmax", [scaled], attrs={"axis": -1},
                           name="probs")
    out = g.add_operator("MatMul", [probs, v], name="out")
    g.inputs, g.outputs = [q, kt, v], [out]
    return mb.to_bytes()


def check_attention_graph(b=2, h=8, s=512, d=128):
    """A FusedSDPA graph at S 512, D 128 on the card: F1 must launch (the
    launch counts are set to 0 just before the run and read after), and
    the output meets the CPU's within K6's tolerance. Returns the
    counts."""
    data = attention_graph_bytes(b, h, s, d)
    card = Model.load(data, device="cuda")
    ops = [card.graph.nodes[i].data.op_type for i in card.graph.plan()]
    check(ops == ["FusedSDPA"], f"attention graph optimized to {ops}")
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn((b, h, s, d), device="cuda", generator=g)
               for _ in range(3))
    inputs = {"q": q, "kt": k.transpose(-1, -2).contiguous(), "v": v}
    kernels.reset_launch_counts()
    out = card.run(inputs)[0]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = Model.load(data, device="cpu").run(
        {n: t.cpu() for n, t in inputs.items()})[0]
    err = (out.cpu() - ref).abs().max().item()
    tol = K6_REL_TOL * ref.abs().max().item()
    print(f"FusedSDPA graph (B {b}, {h} heads of {d}, S {s}): launches "
          f"{nonzero(counts)}; card against CPU max_abs_err {err:.3e} (tol "
          f"{tol:.3e})")
    check(counts["flash_attention"] == 1,
          "the FusedSDPA graph did not launch F1 once")
    check(bool(torch.isfinite(out).all()) and err <= tol,
          "FusedSDPA graph: card against CPU disagrees")
    return counts


def graph_runtime_path(launches):
    """Path (J): ResNet-50 at full width through the `.rten` runtime
    (``rten_tpu_torch.runtime.Model``) in f32 and INT8 at batch 32 on the
    card, images/s and the ops' share of a timed run (RunTiming, CUDA
    events), card against CPU at batch 2, the first three ConvInteger
    accumulators bit for bit, and a FusedSDPA graph that must launch F1."""
    t0 = time.perf_counter()
    f32, int8, n_quant = resnet50_bytes()
    print(f"ResNet-50 .rten: f32 {len(f32) / 2**20:.1f} MiB, INT8 "
          f"{len(int8) / 2**20:.1f} MiB ({n_quant} weights quantized), "
          f"built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(30)
    x = torch.rand((RESNET_BATCH, 3, 224, 224), device="cuda", generator=g)
    rates = {}
    for kind, data in (("f32", f32), ("int8", int8)):
        t0 = time.perf_counter()
        card = Model.load(data, device="cuda")
        load_s = time.perf_counter() - t0
        in_id = card.input_ids()[0]
        out = card.run({in_id: x})[0]            # warm-up
        torch.cuda.synchronize()
        check(tuple(out.shape) == (RESNET_BATCH, 1000)
              and bool(torch.isfinite(out).all()),
              f"ResNet-50 {kind}: output {tuple(out.shape)} not finite")
        t0 = time.perf_counter()
        for _ in range(RESNET_RUNS):
            out = card.run({in_id: x})[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[kind] = RESNET_BATCH * RESNET_RUNS / wall
        card.run({in_id: x}, options=RunOptions(timing=True))
        timing = card.executor.last_timing
        share = timing.op_seconds() / timing.total
        print(f"path (J) ResNet-50 {kind}, batch {RESNET_BATCH} on the "
              f"card: load {load_s:.2f} s; {1e3 * wall / RESNET_RUNS:.2f} ms "
              f"a run, {rates[kind]:.1f} images/s; under timing the ops' "
              f"device time {1e3 * timing.op_seconds():.2f} ms of "
              f"{1e3 * timing.total:.2f} ms wall ({100 * share:.1f}%), "
              f"{len(timing.records)} ops")
        cpu = Model.load(data, device="cpu")
        xs = x[:RESNET_CPU_BATCH]
        ref = cpu.run({in_id: xs.cpu()})[0]
        got = card.run({in_id: xs})[0].cpu()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = (RESNET_F32_TOL if kind == "f32" else RESNET_INT8_TOL) * scale
        top2 = ref.topk(2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        same = bool((got.argmax(1) == ref.argmax(1)).all())
        print(f"path (J) ResNet-50 {kind} card against CPU (batch "
              f"{RESNET_CPU_BATCH}): max_abs_err {err:.4e} of max |logit| "
              f"{scale:.4e} (tol {tol:.4e}); top-1 same {same} (CPU top-2 "
              f"margin {margin:.4e})")
        check(err <= tol and (same or margin < tol),
              f"ResNet-50 {kind}: card against CPU disagrees")
        if kind == "int8":
            check_conv_integer_accumulators(card, cpu, xs.cpu())
        del card, cpu
        torch.cuda.empty_cache()
    print(f"path (J) ResNet-50 images/s at batch {RESNET_BATCH}: f32 "
          f"{rates['f32']:.1f}, INT8 {rates['int8']:.1f}")
    launches["graph_sdpa"] = check_attention_graph()
    return rates



# Path (K): the HTTP server on GPT-2-small int8 (serve.py's --demo
# --quantize int8 --max-batch 64 --capacity 1024 --burst 8).
HTTP_ARGS = dict(weights=None, demo=True, quantize="int8", tokenizer=None,
                 fixed_greedy=False, spec_draft=0, kv_cache=None, mesh=None,
                 max_batch=64, capacity=1024, paged=False, page_size=64,
                 logprobs=False, overlap=False, device="cuda")
HTTP_BURST = 8
HTTP_PREFIX = 48                   # tokens of the registered system prefix
HTTP_PROMPT = 64                   # tokens of every completion's prompt
HTTP_NEW = 48                      # new tokens a completion
HTTP_KIND = 32                     # requests of each of the three kinds
HTTP_HOT = dict(temperature=0.8, top_k=40, top_p=0.95)
HTTP_LOGPROB_TOL = 1e-4
HTTP_LOGPROB_REQUESTS = 4
HTTP_LOGPROB_NEW = 16
HTTP_CPU_NEW, HTTP_CPU_BURST = 5, 2    # the card-against-CPU run of (K)
HTTP_ADMIT_REPS = 10


def _http(base, path, payload=None, timeout=600):
    """POST ``payload`` (GET when None); returns the parsed JSON body, or
    for a streamed request the list of SSE chunk choices (an "error" chunk
    fails the run)."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not (payload or {}).get("stream"):
            return json.load(resp)
        chunks = []
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                return chunks
            evt = json.loads(body)
            check("error" not in evt, f"path (K): streamed error {evt}")
            chunks.append(evt["choices"][0])
    check(False, "path (K): a stream ended without [DONE]")


class _CharTok:
    """Char-level stub tokenizer (no tokenizer.json is read on the card:
    the BPE and Whitespace pre-tokenizers import ``regex``)."""

    def encode(self, text, add_special=False):
        return [ord(c) % 50257 for c in text]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


def _start_server(engine, **kw):
    import threading
    from rten_tpu_torch.serve import serve
    srv, driver = serve(engine, port=0, burst=HTTP_BURST, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def stop():
        srv.shutdown()
        driver.stop()
        srv.server_close()

    return f"http://127.0.0.1:{srv.server_address[1]}", stop


class _ForcedTokens:
    """A sampler that emits the given tokens for slot 0 and records slot
    0's log-softmax at each: a teacher-forced replay of one request on the
    card through the engine's own steps."""

    def __init__(self, tokens):
        self.tokens, self.logprobs = list(tokens), []

    def sample(self, logits, generator=None):
        i = len(self.logprobs)
        tok = self.tokens[i] if i < len(self.tokens) else 0
        self.logprobs.append(
            torch.log_softmax(logits[0].float(), dim=-1)[tok].item())
        out = torch.zeros(logits.shape[0], dtype=torch.int32,
                          device=logits.device)
        out[0] = tok
        return out


class _RecordingSampler(PerRequestSampler):
    """The per-request sampler, keeping every call's logits rows."""

    def __init__(self):
        super().__init__()
        self.logits = []

    def sample(self, logits, temps, top_ks, top_ps, generator=None):
        self.logits.append(logits.float().cpu().numpy())
        return super().sample(logits, temps, top_ks, top_ps, generator)


def _http_prompts(vocab, seed):
    """The 48-token system prefix, a 64-token prompt under it and a 64-token
    prompt without it."""
    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(0, vocab, HTTP_PREFIX)]
    hit = system + [int(t) for t in rng.randint(0, vocab,
                                                 HTTP_PROMPT - HTTP_PREFIX)]
    return system, hit, [int(t) for t in rng.randint(0, vocab, HTTP_PROMPT)]


def _http_engine(model, params, sampler, device="cuda"):
    """Path (K)'s engine as ``build_engine`` makes it (max_batch 64,
    capacity 1024, cache="auto") with ``sampler``."""
    eng = ServingEngine(model, params, max_batch=HTTP_ARGS["max_batch"],
                        capacity=HTTP_ARGS["capacity"], sampler=sampler,
                        cache="auto", device=device)
    check(eng._tail_flush == 16 and eng.quantized_cache,
          f"path (K) on {device}: cache='auto' gave quantized="
          f"{eng.quantized_cache}, tail window {eng._tail_flush}")
    return eng


def http_card_against_cpu(model, params_gpu):
    """Path (K)'s engine on the card and on the CPU with the same weights:
    the 48-token prefix registered, one 64-token prompt under it (a hit: 12
    layers x 8 V1 slices over its 64-token suffix bucket) and one without
    (a cold prefill) admitted together, then ``HTTP_CPU_NEW - 1`` greedy
    decode steps at batch 64 in bursts of ``HTTP_CPU_BURST`` (a window
    flush, K3, between them). Every sampler call's live rows are held at
    PATH_LOGIT_TOL while the two devices' tokens agree; a differing token
    must follow a CPU top-2 margin below twice that. The card run must
    launch K1, K3, K4 and V1's fused int8 entry."""
    system, hit, miss = _http_prompts(model.config.vocab_size, 3)

    def run(params, dev):
        rec = _RecordingSampler()
        eng = _http_engine(model, params, rec, dev)
        eng.register_prefix(system)
        toks = eng.generate([hit, miss], max_new_tokens=HTTP_CPU_NEW,
                            burst=HTTP_CPU_BURST)
        check(eng.stats()["prefix_hits"] == 1
              and all(len(t) == HTTP_CPU_NEW for t in toks),
              f"path (K) on {dev}: {eng.stats()['prefix_hits']} prefix "
              f"hits, {[len(t) for t in toks]} tokens")
        # The hit's admission, the miss's, then one call a decode step.
        check(len(rec.logits) == 1 + HTTP_CPU_NEW,
              f"path (K) on {dev}: {len(rec.logits)} sampler calls")
        return toks, rec.logits

    kernels.reset_launch_counts()
    card, rec_card = run(params_gpu, "cuda")
    counts = kernels.launch_counts()
    cpu, rec_cpu = run(to_device(params_gpu, "cpu"), "cpu")

    def row(rec, i, c):
        """The logits row that produced request i's token c."""
        return rec[i][0] if c == 0 else rec[1 + c][i]

    worst, diverged = 0.0, 0
    for i, what in enumerate(("prefix hit", "cold prefill")):
        first = next((c for c in range(HTTP_CPU_NEW)
                      if card[i][c] != cpu[i][c]), HTTP_CPU_NEW)
        for c in range(min(first + 1, HTTP_CPU_NEW)):
            worst = max(worst, float(np.abs(row(rec_card, i, c)
                                            - row(rec_cpu, i, c)).max()))
        if first < HTTP_CPU_NEW:
            diverged += 1
            top = np.sort(row(rec_cpu, i, first))[-2:]
            margin = float(top[1] - top[0])
            print(f"path (K) card vs cpu: the {what} first differs at token "
                  f"{first}, top-2 margin {margin:.3e} (tol "
                  f"{2 * PATH_LOGIT_TOL:.1e})")
            check(margin < 2 * PATH_LOGIT_TOL,
                  f"path (K) card vs cpu: the {what} differs above the "
                  f"tolerance")
    steps = HTTP_CPU_NEW - 1
    n_layers = model.config.n_layers
    print(f"path (K) card vs cpu (max_batch 64, capacity 1024, a prefix hit "
          f"and a cold prefill, {steps} decode steps in bursts of "
          f"{HTTP_CPU_BURST}): {2 * HTTP_CPU_NEW} tokens, {diverged} "
          f"near-tie divergences, max logit difference {worst:.3e} (tol "
          f"{PATH_LOGIT_TOL:.1e}); card launches {nonzero(counts)}")
    check(worst < PATH_LOGIT_TOL, "path (K): card and cpu logits disagree")
    check(counts["decode_attn_int8_tail"] == n_layers * steps
          and counts["verify_attn_fused.int8"]
          == n_layers * -(-64 // at.VERIFY_MAX_S)     # suffix bucket 64
          and counts["tail_flush_int8"] >= n_layers
          and counts["matmul_int8_wo"] >= steps,
          "path (K) card vs cpu: the card run missed K1, K3, K4 or V1")


def prefix_admission_ms(model, params, reps=HTTP_ADMIT_REPS):
    """Host ms of one admission on path (K)'s engine (the prompt's KV into
    its slot, its first token sampled and read back) of the same 64-token
    prompt: cold (the 64-token bucket prefilled) on an engine without
    prefixes, and as a prefix hit (the registered 48 tokens reused, the
    16-token suffix prefilled in its 64-token bucket: 12 layers x 8 V1
    slices) on one with the prefix. A synchronized ``_admit`` on the host
    clock, cold and hit in turns; medians of ``reps`` after two warm-ups
    each. Returns {"cold": ms, "hit": ms}."""
    system, prompt, _ = _http_prompts(model.config.vocab_size, 5)
    engines = {"cold": _http_engine(model, params, PerRequestSampler()),
               "hit": _http_engine(model, params, PerRequestSampler())}
    engines["hit"].register_prefix(system)
    times = {kind: [] for kind in engines}
    for _ in range(reps + 2):
        for kind, eng in engines.items():
            req = eng.submit(prompt, max_new_tokens=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._admit()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            check(req.done and len(req.tokens) == 1,
                  f"path (K): the {kind} admission gave no first token")
    check(engines["hit"].stats()["prefix_hits"] == reps + 2
          and engines["cold"].stats()["prefix_hits"] == 0,
          "path (K): the timed admissions hit the prefix wrongly")
    return {kind: sorted(t[2:])[reps // 2] for kind, t in times.items()}


def check_sampler(timer, vocab):
    """The per-request sampler at path (K)'s decode shape (64 rows of the
    vocabulary, greedy and hot rows mixed): ``ordered_top_k``'s candidates
    equal the first 64 of a stable descending sort on logits with planted
    ties, and the device ms of a whole ``sample`` and of ``ordered_top_k``
    beside the stable sort's. Returns the three times."""
    g = torch.Generator(device="cuda").manual_seed(9)
    logits = torch.randn((64, vocab), device="cuda", generator=g)
    # Many equal values at the 64th place; + 0.0 leaves no -0.0, which
    # lax.top_k ranks below +0.0 and a stable sort ties with it.
    tied = (logits * 4).round() / 4 + 0.0
    values, indices = ordered_top_k(tied, 64)
    ref = torch.sort(tied, dim=-1, descending=True, stable=True)
    check(torch.equal(indices, ref.indices[:, :64])
          and torch.equal(values, ref.values[:, :64]),
          "path (K): the sampler's top-64 differs from a stable sort's")
    hot = torch.arange(64, device="cuda") % 2 == 1
    temps = torch.where(hot, HTTP_HOT["temperature"], 0.0)
    top_ks = torch.where(hot, float(HTTP_HOT["top_k"]), 0.0)
    top_ps = torch.where(hot, HTTP_HOT["top_p"], 1.0)
    sampler = PerRequestSampler()
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"sample": timer(lambda: sampler.sample(logits, temps, top_ks,
                                                   top_ps, generator=gen)),
            "top_k": timer(lambda: ordered_top_k(logits, 64)),
            "stable_sort": timer(lambda: torch.sort(
                logits, dim=-1, descending=True, stable=True))}


def http_serve_path(launches, smi, timer):
    """Path (K): the port's HTTP server in-process over GPT-2-small int8
    (``build_engine``: cache="auto" → int8 + the 16-token tail, the
    per-request sampler), 96 concurrent completions (greedy, streamed hot,
    and under a registered 48-token prefix), a chat completion through a
    char-level stub tokenizer, a --logprobs server held against a
    teacher-forced replay, and the CLI as a subprocess."""
    import argparse
    import socket
    import threading

    from rten_tpu_torch.serve import build_engine

    t_path = time.perf_counter()
    engine, _ = build_engine(argparse.Namespace(**HTTP_ARGS))
    vocab = engine.model.config.vocab_size
    check(engine._tail_flush == 16 and engine.quantized_cache,
          f"path (K): cache='auto' gave quantized={engine.quantized_cache}, "
          f"tail window {engine._tail_flush}")
    check(isinstance(engine.sampler, PerRequestSampler)
          and not engine._fused_head,
          "path (K): the server's default is the per-request sampler "
          "without the fused head")
    submitted = {}
    plain_submit = engine.submit

    def recording_submit(prompt_ids, *args, **kw):
        req = plain_submit(prompt_ids, *args, **kw)
        submitted[tuple(req.prompt_ids)] = req
        return req

    engine.submit = recording_submit
    rng = np.random.RandomState(7)

    def prompt(n=HTTP_PROMPT):
        return [int(t) for t in rng.randint(0, vocab, n)]

    base, stop = _start_server(engine)
    try:
        warm = _http(base, "/v1/completions", {"prompt": prompt(),
                                               "max_tokens": 8})
        check(len(warm["choices"][0]["token_ids"]) == 8,
              "path (K): the warm-up completion failed")
        system = prompt(HTTP_PREFIX)
        before = _http(base, "/stats")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        reg = _http(base, "/v1/prefixes", {"prompt": system})
        check(reg.get("registered") == HTTP_PREFIX,
              f"path (K): prefix registration answered {reg}")
        bodies = ([{"prompt": prompt(), "max_tokens": HTTP_NEW}
                   for _ in range(HTTP_KIND)]
                  + [{"prompt": prompt(), "max_tokens": HTTP_NEW,
                      "stream": True, **HTTP_HOT} for _ in range(HTTP_KIND)]
                  + [{"prompt": system + prompt(HTTP_PROMPT - HTTP_PREFIX),
                      "max_tokens": HTTP_NEW} for _ in range(HTTP_KIND)])
        results = [None] * len(bodies)
        errors = []

        def fetch(i):
            try:
                results[i] = _http(base, "/v1/completions", bodies[i])
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {exc!r}")

        threads = [threading.Thread(target=fetch, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        after = _http(base, "/stats")
        counts = kernels.launch_counts()
        check(not errors, f"path (K): failed requests: {errors[:4]}")
        for body, res in zip(bodies, results):
            if body.get("stream"):
                ids = [t for c in res for t in c["token_ids"]]
                finish = [c["finish_reason"] for c in res
                          if c.get("finish_reason")]
            else:
                ids = res["choices"][0]["token_ids"]
                finish = [res["choices"][0]["finish_reason"]]
            req = submitted[tuple(body["prompt"])]
            check(len(ids) == HTTP_NEW and finish == ["length"]
                  and all(0 <= t < vocab for t in ids),
                  f"path (K): a completion gave {len(ids)} ids, finish "
                  f"{finish}")
            check(ids == req.tokens, "path (K): the ids sent (streamed "
                  "deltas concatenated) differ from the request's tokens")
        hits = after["prefix_hits"] - before["prefix_hits"]
        steps = after["decode_steps"] - before["decode_steps"]
        tokens = after["tokens"] - before["tokens"]
        check(hits == HTTP_KIND, f"path (K): /stats counts {hits} prefix "
              f"hits, not {HTTP_KIND}")
        n_layers = engine.model.config.n_layers
        v1 = counts["verify_attn_fused.int8"]
        slices = -(-64 // at.VERIFY_MAX_S)     # suffix bucket 64
        print(f"path (K): {len(bodies)} HTTP completions ({HTTP_KIND} "
              f"greedy, {HTTP_KIND} streamed at {HTTP_HOT}, {HTTP_KIND} "
              f"under the {HTTP_PREFIX}-token prefix) of {HTTP_PROMPT}-token "
              f"prompts x {HTTP_NEW} new tokens at max_batch 64, burst "
              f"{HTTP_BURST}: wall {wall:.3f} s, {len(bodies) / wall:.2f} "
              f"requests/s, {tokens / wall:.1f} decode tokens/s ({tokens} "
              f"tokens, {steps} decode steps); /stats: tokens_per_s "
              f"{after['tokens_per_s']} (since the engine started), p50 "
              f"TTFT {after.get('ttft_p50_ms')} ms, p99 TTFT "
              f"{after.get('ttft_p99_ms')} ms (with the warm-up request), "
              f"prefix_hits {hits}; {smi}")
        print(f"path (K) launches: {nonzero(counts)}")
        check(counts["decode_attn_int8_tail"] == n_layers * steps,
              f"path (K): K1 launched {counts['decode_attn_int8_tail']} "
              f"times, not once per layer and decode step ({n_layers} x "
              f"{steps})")
        check(counts["matmul_int8_wo"] >= steps,
              f"path (K): K4 launched {counts['matmul_int8_wo']} times over "
              f"{steps} decode steps (the lm_head takes it every step)")
        check(counts["tail_flush_int8"] >= n_layers * (steps // 16)
              and counts["tail_flush_int8"] % n_layers == 0,
              f"path (K): K3 launched {counts['tail_flush_int8']} times "
              f"over {steps} decode steps")
        check(v1 == n_layers * slices * hits,
              f"path (K): V1's fused int8 entry launched {v1} times, not "
              f"{n_layers} layers x {slices} slices x {hits} prefix hits")
        check(counts["head_argmax_int8"] == 0,
              "path (K): K2 launched under the per-request sampler")
        launches["http_serve"] = counts

        # One greedy request alone against engine.generate of the same
        # configuration on the same weights.
        alone = prompt()
        got = _http(base, "/v1/completions", {
            "prompt": alone, "max_tokens": HTTP_NEW})["choices"][0]
        stop()
        stop = None
        offline = ServingEngine(engine.model, engine.params,
                                max_batch=HTTP_ARGS["max_batch"],
                                capacity=HTTP_ARGS["capacity"],
                                sampler=PerRequestSampler(), cache="auto")
        want = offline.generate([alone], max_new_tokens=HTTP_NEW,
                                burst=HTTP_BURST)[0]
        check(got["token_ids"] == want, "path (K): a greedy HTTP completion "
              "alone differs from engine.generate")
        del offline
        print("path (K): one greedy HTTP completion alone equals "
              "engine.generate of the same configuration (48 tokens)")

        # Chat completions through the char-level stub tokenizer.
        base, stop = _start_server(engine, tokenizer=_CharTok())
        chat = {"messages": [{"role": "system", "content": "Be brief."},
                             {"role": "user", "content": "Hello, card."}],
                "max_tokens": 12}
        full = _http(base, "/v1/chat/completions", chat)
        chunks = _http(base, "/v1/chat/completions", {**chat,
                                                       "stream": True})
        text = "".join(c.get("delta", {}).get("content", "")
                       for c in chunks)
        content = full["choices"][0]["message"]["content"]
        check(full["usage"]["completion_tokens"] == 12 and text == content,
              "path (K): the streamed chat completion differs from the "
              "plain one")
        print(f"path (K): chat completion, plain and streamed: "
              f"{len(content)} characters, the same")
    finally:
        if stop is not None:
            stop()
    params = engine.params
    del engine
    torch.cuda.empty_cache()

    # A --logprobs server: each logprob of a request served alone against
    # the log-softmax of a teacher-forced replay of it on the card.
    lp_engine, _ = build_engine(argparse.Namespace(**{**HTTP_ARGS,
                                                      "logprobs": True}))
    base, stop = _start_server(lp_engine)
    try:
        served = []
        for i in range(HTTP_LOGPROB_REQUESTS):
            body = {"prompt": prompt(), "max_tokens": HTTP_LOGPROB_NEW,
                    "logprobs": True, **(HTTP_HOT if i % 2 else {})}
            served.append((body, _http(base, "/v1/completions",
                                       body)["choices"][0]))
    finally:
        stop()
    worst = 0.0
    for body, choice in served:
        lps = choice["logprobs"]["token_logprobs"]
        check(len(lps) == HTTP_LOGPROB_NEW and all(v <= 0.0 for v in lps),
              f"path (K): logprobs {lps[:4]}... not all <= 0")
        forced = _ForcedTokens(choice["token_ids"])
        replay = ServingEngine(lp_engine.model, params,
                               max_batch=HTTP_ARGS["max_batch"],
                               capacity=HTTP_ARGS["capacity"],
                               sampler=forced, cache="auto",
                               fused_head=False)
        replay.generate([body["prompt"]], max_new_tokens=HTTP_LOGPROB_NEW,
                        burst=HTTP_BURST)
        ref = forced.logprobs[:HTTP_LOGPROB_NEW]
        err = max(abs(a - b) for a, b in zip(lps, ref))
        worst = max(worst, err)
        check(err <= HTTP_LOGPROB_TOL, f"path (K): a logprob is {err:.3e} "
              f"from the teacher-forced replay's (tol {HTTP_LOGPROB_TOL})")
        del replay
    print(f"path (K) --logprobs: {len(served)} requests x "
          f"{HTTP_LOGPROB_NEW} tokens, every logprob <= 0, max |logprob - "
          f"replay| {worst:.3e} (tol {HTTP_LOGPROB_TOL})")
    model = lp_engine.model
    del lp_engine
    torch.cuda.empty_cache()

    http_card_against_cpu(model, params)
    admit = prefix_admission_ms(model, params)
    print(f"path (K) admission of one 64-token prompt (host ms, median of "
          f"{HTTP_ADMIT_REPS}, in turns): cold {admit['cold']:.3f}, prefix "
          f"hit {admit['hit']:.3f} (hit / cold "
          f"{admit['hit'] / admit['cold']:.3f}); {smi}")
    samp = check_sampler(timer, vocab)
    print(f"path (K) sampler at 64 x {vocab} (device ms): sample "
          f"{samp['sample']:.4f}, its top-64 {samp['top_k']:.4f}, a stable "
          f"full sort {samp['stable_sort']:.4f}; {smi}")
    del params
    torch.cuda.empty_cache()

    # The CLI as a subprocess: wait for /health, one completion, stop it.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rten_tpu_torch.serve", "--demo",
         "--quantize", "int8", "--port", str(port)], cwd=root, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    cli_base = f"http://127.0.0.1:{port}"
    try:
        while True:
            if proc.poll() is not None:
                log.seek(0)
                check(False, f"path (K): the CLI exited with "
                      f"{proc.returncode}: {log.read()[-2000:]}")
            check(time.perf_counter() - t0 < 240,
                  "path (K): the CLI did not answer /health in 240 s")
            try:
                if _http(cli_base, "/health", timeout=5)["status"] == "ok":
                    break
            except OSError:
                time.sleep(0.5)
        up = time.perf_counter() - t0
        out = _http(cli_base, "/v1/completions", {"prompt": prompt(),
                                                  "max_tokens": 8})
        ids = out["choices"][0]["token_ids"]
        check(len(ids) == 8 and all(0 <= t < vocab for t in ids),
              f"path (K): the CLI's completion gave {ids}")
    finally:
        proc.send_signal(2)                      # SIGINT: a clean shutdown
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    print(f"path (K) CLI: python -m rten_tpu_torch.serve --demo --quantize "
          f"int8 answered /health {up:.1f} s after start and served 8 "
          f"tokens; exit code {proc.returncode}")
    print(f"path (K) took {time.perf_counter() - t_path:.1f} s")


def mistral_paths(launches, rates, steady):
    """Path (H) at full width and depth, its three variants at 4 layers,
    and (H), (H-fused) and (H-append) card against CPU at 1 layer; fills
    ``launches``, ``rates`` and ``steady``."""
    path = "mistral_int8"
    model = mistral_model(path, 32)
    t0 = time.perf_counter()
    params = model.init_int4_params(0, device="cuda")
    torch.cuda.synchronize()
    print(f"Mistral-7B int4 weights drawn and quantized on the card, layer "
          f"by layer: {time.perf_counter() - t0:.1f} s; card memory "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rates[path], launches[path] = serve_path(model, params, path)
    steady[path] = steady_decode(model, params, path, trace=True)
    params4 = {**params, "layers": params["layers"][:4]}
    for path in ("mistral_fused", "mistral_scores", "mistral_append"):
        model4 = mistral_model(path, 4)
        n_requests, new_tokens = PATHS[path]["requests"]
        kernels.reset_launch_counts()
        engine, reqs, wall = main_path(model4, params4, path, n_requests,
                                       new_tokens)
        launches[path] = kernels.launch_counts()
        st = engine.stats()
        check(all(len(r.tokens) == new_tokens and r.done for r in reqs),
              f"{path}: a request did not complete")
        print(f"path {path} (4 layers): {len(reqs)} requests x "
              f"{new_tokens} tokens at batch {batch_of(path)}, capacity "
              f"{capacity_of(path)}, {st['decode_steps']} decode steps in "
              f"{wall:.3f} s; launches {nonzero(launches[path])}")
        check_launches(path, launches[path], 4, st["decode_steps"],
                       engine.model.prefills)
        del engine
    params1 = {**params, "layers": params["layers"][:1]}
    del params, params4
    torch.cuda.empty_cache()
    counts = card_against_cpu(
        mistral_model("mistral_int8", 1), params1, "mistral_int8",
        MISTRAL_PATH_LOGIT_TOL, max_batch=4, fused=False, prompt=128,
        new_tokens=9)
    print(f"mistral_int8 (1 layer) card against CPU, card runs: launches "
          f"{nonzero(counts)}")
    check(counts["flash_attention"] > 0
          and counts["decode_attn_grouped_int8.exact"] > 0,
          "mistral_int8 card against CPU: F1 or G1 never launched")
    # (H-fused): batch 3 has no group, so decode runs G2.
    counts = card_against_cpu(
        mistral_model("mistral_fused", 1), params1, "mistral_fused",
        MISTRAL_PATH_LOGIT_TOL, max_batch=3, fused=False, prompt=128,
        new_tokens=9)
    print(f"mistral_fused (1 layer) card against CPU, card runs: launches "
          f"{nonzero(counts)}")
    check(counts["decode_attn_fused_int8"] > 0,
          "mistral_fused card against CPU: G2 never launched")
    # (H-append): a bf16 cache with the append fused, so decode runs A1.
    counts = card_against_cpu(
        mistral_model("mistral_append", 1), params1, "mistral_append",
        MISTRAL_PATH_LOGIT_TOL, max_batch=4, fused=False, prompt=128,
        new_tokens=9)
    print(f"mistral_append (1 layer) card against CPU, card runs: launches "
          f"{nonzero(counts)}")
    check(counts["decode_attn_grouped_append"] > 0
          and counts["kv_append"] == 0,
          "mistral_append card against CPU: decode did not run through A1")
    del params1
    torch.cuda.empty_cache()


def mixtral_model(path, n_layers=32):
    return TransformerLM(TransformerConfig.mixtral(
        n_layers=n_layers, **PATHS[path].get("config", {})))


def param_bytes(tree):
    """Bytes of every tensor of a parameter tree (a QuantWeight's data
    and scales)."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    if isinstance(tree, QuantWeight):
        return param_bytes(tree.data) + param_bytes(tree.scales)
    return tree.numel() * tree.element_size()


def float_experts(layer):
    """The layer with its int8 expert stacks dequantized to f32 stacks
    (data x scales, exact in f32): (L-ragged)'s float experts."""
    out = dict(layer)
    for key in ("w_gate", "w_up", "w_down"):
        w = layer[key]
        out[key] = w.data[..., :w.n].float() * w.scales[:, None, :w.n]
    return out


def mixtral_paths(launches, rates, steady):
    """Path (L) at full width and depth (weights drawn on the card, served,
    a steady burst timed and traced, peak memory beside the weights'
    bytes), (L-ragged) at 2 layers with float expert stacks (the ragged
    and the dense path each where the reference takes it, ragged logits
    against dense ones) and (L) card against CPU at 1 layer; fills
    ``launches``, ``rates`` and ``steady``."""
    path = "mixtral_int8"
    model = mixtral_model(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_int8_params(0, device="cuda")
    torch.cuda.synchronize()
    weights_gb = param_bytes(params) / 1e9
    print(f"Mixtral-8x7B int8 weights drawn and quantized on the card, "
          f"expert by expert: {time.perf_counter() - t0:.1f} s; "
          f"{weights_gb:.2f} GB of weights; card memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    check(45 < weights_gb < 50, "path (L): the int8 weights are not ~47.9 "
          "GB")
    moe.impl_counts.clear()
    rates[path], launches[path] = serve_path(model, params, path)
    check(set(moe.impl_counts) == {"dense"},
          f"path (L): int8 experts took {dict(moe.impl_counts)}")
    steady[path] = steady_decode(model, params, path, steps=8, trace=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"path (L): card peak memory {peak:.2f} GB "
          f"(torch.cuda.max_memory_allocated) beside {weights_gb:.2f} GB of "
          f"weights")
    stamp("path (L)")
    head = {k: params[k] for k in ("embed", "ln_f_scale", "lm_head")}
    params1 = {**head, "layers": params["layers"][:1]}
    params2 = {**head, "layers": [float_experts(layer)
                                  for layer in params["layers"][:2]]}
    del params
    torch.cuda.empty_cache()
    mixtral_ragged(params2, launches)
    del params2
    torch.cuda.empty_cache()
    stamp("path (L-ragged)")
    mixtral_card_against_cpu(params1)
    del params1
    torch.cuda.empty_cache()


def mixtral_card_against_cpu(params1):
    """(L) card against CPU at 1 layer (``params1``): 2 requests of 128
    tokens, so that the prefill reaches F1 under bf16 compute."""
    path = "mixtral_int8"
    counts = card_against_cpu(mixtral_model(path, 1), params1, path,
                              MIXTRAL_PATH_LOGIT_TOL, max_batch=2,
                              fused=False, prompt=128, new_tokens=6)
    print(f"{path} (1 layer) card against CPU, card runs: launches "
          f"{nonzero(counts)}")
    check(counts["kv_append_int8"] > 0 and counts["matmul_int8_wo"] > 0
          and counts["flash_attention"] == 1,
          f"{path} card against CPU: K7 or K4 never launched, or F1 not "
          f"once (the 2 x 128-token prefill of its layer)")


def mixtral_ragged(params, launches):
    """(L-ragged): one admission prefill of 16 x 64 tokens takes the
    ragged path in both layers and one decode step the dense one; the
    ragged prefill's logits against the same prefill forced dense; then
    the path's serve with its launches."""
    path = "mixtral_ragged"
    model = mixtral_model(path, 2)
    dense = TransformerLM(TransformerConfig.mixtral(
        n_layers=2, moe_impl="dense", **PATHS[path]["config"]))
    rng = np.random.RandomState(4)
    tokens = torch.from_numpy(rng.randint(0, 32000, (16, 64))).cuda()
    last = torch.full((16,), 63, dtype=torch.int64, device="cuda")
    out = {}
    for name, mdl in (("ragged", model), ("dense", dense)):
        moe.impl_counts.clear()
        cache = mdl.new_cache(16, 1024, quantized=True, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name], cache = mdl.prefill_last(params, tokens, cache, last)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        prefill_impl = dict(moe.impl_counts)
        moe.impl_counts.clear()
        mdl.decode_step_argmax(params, out[name].argmax(-1), cache)
        print(f"path (L-ragged), moe_impl {mdl.config.moe_impl!r}: prefill "
              f"of 16 x 64 tokens {ms:.1f} ms took {prefill_impl}, a decode "
              f"step took {dict(moe.impl_counts)}")
        want = "ragged" if name == "ragged" else "dense"
        check(prefill_impl == {want: 2},
              f"path (L-ragged): the prefill took {prefill_impl}")
        check(dict(moe.impl_counts) == {"dense": 2},
              "path (L-ragged): decode did not take the dense path")
        del cache
    err = float((out["ragged"] - out["dense"]).abs().max())
    print(f"path (L-ragged): ragged against dense prefill logits: max "
          f"difference {err:.3e} (tol {MIXTRAL_PATH_LOGIT_TOL}; max |logit| "
          f"{float(out['dense'].abs().max()):.3f})")
    check(err < MIXTRAL_PATH_LOGIT_TOL,
          "path (L-ragged): ragged and dense logits disagree")
    n_requests, new_tokens = PATHS[path]["requests"]
    moe.impl_counts.clear()
    kernels.reset_launch_counts()
    engine, reqs, wall = main_path(model, params, path, n_requests,
                                   new_tokens)
    launches[path] = kernels.launch_counts()
    st = engine.stats()
    check(all(len(r.tokens) == new_tokens and r.done for r in reqs),
          f"{path}: a request did not complete")
    print(f"path {path} (2 layers): {len(reqs)} requests x {new_tokens} "
          f"tokens, {st['decode_steps']} decode steps in {wall:.3f} s; MoE "
          f"paths {dict(moe.impl_counts)}; launches "
          f"{nonzero(launches[path])}")
    check_launches(path, launches[path], 2, st["decode_steps"],
                   engine.model.prefills)
    check(moe.impl_counts["ragged"] == 2 * engine.model.prefills,
          f"{path}: the admission prefills did not take the ragged path")
    del engine


def scan_path(params, launches):
    """(L-scan): GPT-2-small with scan_layers over its stacked int8 layers
    and a stacked bf16 cache, then the same engine without scan_layers on
    the layer list: the same tokens, token for token."""
    path = "scan_bf16"
    n_requests, new_tokens = PATHS[path]["requests"]
    stacked = {**params, "layers": stack_layer_params(params["layers"])}
    kernels.reset_launch_counts()
    engine, reqs, wall = main_path(gpt2_model(path), stacked, path,
                                   n_requests, new_tokens)
    launches[path] = kernels.launch_counts()
    st = engine.stats()
    check(engine.cache.stacked and engine.cache.kv.dtype == torch.bfloat16,
          f"{path}: the engine's cache is not a stacked bf16 cache")
    check_launches(path, launches[path], 12, st["decode_steps"],
                   engine.model.prefills)
    scan_tokens = [r.tokens for r in reqs]
    del engine
    engine, reqs, wall_loop = main_path(TransformerLM(
        TransformerConfig.gpt2()), params, path, n_requests, new_tokens)
    same = scan_tokens == [r.tokens for r in reqs]
    print(f"path (L-scan): {n_requests} requests x {new_tokens} tokens at "
          f"batch {batch_of(path)}, scan {wall:.3f} s, loop "
          f"{wall_loop:.3f} s; tokens equal {same}; launches "
          f"{nonzero(launches[path])}")
    check(all(len(t) == new_tokens for t in scan_tokens) and same,
          "path (L-scan): scan_layers tokens differ from the loop's")
    del engine


def to_device(params, device):
    """The parameter tree (tensors and int8 QuantWeights) on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    if isinstance(params, QuantWeight):
        return QuantWeight(params.kind, params.data.to(device),
                           params.scales.to(device), params.n, params.group)
    return params.to(device)


# The serving paths: the weights each takes, its ServingEngine options, the
# tail window its engine must pick, the requests of its measured run
# (count, new tokens), whether a steady burst is timed after it
# (``steady``, default True) and the kernels it must launch (``name.mode``
# for a
# mode of a wrapper) and must not (``absent``). GPT-2-small paths serve at
# batch 256 / capacity 512, with ``config`` overrides of
# ``TransformerConfig.gpt2()``; the TinyLlama paths (``llama``) at batch 16 /
# capacity 2048, with ``env`` set while they serve; the Mistral-7B paths
# (``mistral``) at their own ``batch``, ``capacity`` and ``prompt`` length,
# with ``config`` overrides of ``TransformerConfig.mixtral(n_experts=0)``;
# on (H) and (I) the kernels of ``per_step`` launch once per layer and decode
# step, those of ``per_prefill`` once per layer and admission group; a
# traced path with ``trace_kernel`` (label, CUDA symbol) prints that
# kernel's device time a step.
PATHS = {
    "int8_tail": dict(weights="int8", engine=dict(quantized_cache=True),
                      tail=16, requests=(320, 48),
                      kernels=("decode_attn_int8_tail", "head_argmax_int8",
                               "tail_flush_int8", "matmul_int8_wo"),
                      trace_kernel=("K3 (tail_flush_int8)",
                                    "kvappend::kernel")),
    "f32": dict(weights="f32", engine=dict(), tail=0, requests=(320, 48),
                kernels=("kv_append", "decode_attn_float")),
    "int8_no_tail": dict(weights="int8",
                         engine=dict(quantized_cache=True, tail_window=0),
                         tail=0, requests=(320, 48),
                         kernels=("kv_append_int8", "decode_attn_int8",
                                  "head_argmax_int8", "matmul_int8_wo")),
    # RTEN_FLAT_QBF16=0: the reference's flat kernel with exact q, K1's and
    # K1''s exact-q mode, and never the rounded one.
    "int8_tail_exact_q": dict(weights="int8",
                              engine=dict(quantized_cache=True), tail=16,
                              requests=(256, 16), steady=False,
                              env={"RTEN_FLAT_QBF16": "0"},
                              kernels=("decode_attn_int8_tail.exact",),
                              absent=("decode_attn_int8_tail.bf16",)),
    "int8_no_tail_exact_q": dict(weights="int8",
                                 engine=dict(quantized_cache=True,
                                             tail_window=0),
                                 tail=0, requests=(256, 16), steady=False,
                                 env={"RTEN_FLAT_QBF16": "0"},
                                 kernels=("decode_attn_int8.exact",),
                                 absent=("decode_attn_int8.bf16",)),
    "bf16": dict(weights="int8", engine=dict(cache_dtype="bfloat16"),
                 tail=0, requests=(288, 24),
                 kernels=("kv_append", "decode_attn_float",
                          "head_argmax_int8", "matmul_int8_wo")),
    "paged_int8": dict(weights="int8",
                       engine=dict(paged=True, page_size=PAGE,
                                   quantized_cache=True),
                       tail=0, requests=(320, 48),
                       kernels=("kv_append_paged_int8",
                                "decode_attn_paged_int8", "head_argmax_int8",
                                "matmul_int8_wo"),
                       trace_kernel=("P3i (decode_attn_paged_int8)",
                                     "kv_group::kernel")),
    "paged_f32": dict(weights="f32", engine=dict(paged=True, page_size=PAGE),
                      tail=0, requests=(320, 48),
                      kernels=("kv_append_paged", "decode_attn_paged"),
                      trace_kernel=("P3 (decode_attn_paged)",
                                    "kv_group::kernel")),
    # (I): decode_attn="flat" on float caches takes K8, 12 launches a step.
    "flat_f32": dict(weights="f32", engine=dict(),
                     config=dict(decode_attn="flat"), tail=0,
                     requests=(320, 48),
                     kernels=("kv_append", "decode_attn_flat_float"),
                     per_step=("decode_attn_flat_float",),
                     absent=("decode_attn_float",),
                     trace_kernel=("K8 (decode_attn_flat_float)",
                                   "kv_group::kernel")),
    "flat_bf16": dict(weights="int8", engine=dict(cache_dtype="bfloat16"),
                      config=dict(decode_attn="flat"), tail=0,
                      requests=(256, 16),
                      kernels=("kv_append", "decode_attn_flat_float",
                               "head_argmax_int8"),
                      per_step=("decode_attn_flat_float",),
                      absent=("decode_attn_float",), steady=False),
    "tinyllama_int4": dict(weights="int4", engine=dict(quantized_cache=True),
                           tail=16, requests=(24, 64), llama=True,
                           kernels=("matmul_int4_words",
                                    "decode_attn_int8_tail",
                                    "tail_flush_int8")),
    "tinyllama_int4_bytes": dict(weights="int4_bytes",
                                 engine=dict(quantized_cache=True), tail=16,
                                 requests=(16, 16), llama=True,
                                 kernels=("matmul_int4",)),
    "tinyllama_int4_dot_int8": dict(weights="int4",
                                    engine=dict(quantized_cache=True),
                                    tail=16, requests=(16, 16), llama=True,
                                    env={"RTEN_INT4_DOT": "int8"},
                                    kernels=("matmul_int4_words_int8",)),
    "mistral_int8": dict(weights="mistral", engine=dict(quantized_cache=True),
                         tail=0, requests=(24, 64), mistral=True, batch=16,
                         capacity=4096, prompt=512,
                         kernels=("flash_attention",
                                  "decode_attn_grouped_int8.exact",
                                  "kv_append_int8", "matmul_int4_words"),
                         per_step=("decode_attn_grouped_int8.exact",
                                   "kv_append_int8"),
                         per_prefill=("flash_attention",),
                         trace_kernel=("G1 (decode_attn_grouped_int8, exact "
                                       "q)", "kv_group::kernel"),
                         absent=("decode_attn_int8", "decode_attn_int8_tail",
                                 "tail_flush_int8", "decode_attn_fused_int8",
                                 "decode_attn_grouped_int8.int8_scores")),
    "mistral_fused": dict(weights="mistral4",
                          engine=dict(quantized_cache=True), tail=0,
                          requests=(6, 16), mistral=True, batch=3,
                          capacity=4096, prompt=512,
                          kernels=("flash_attention",
                                   "decode_attn_fused_int8"),
                          absent=("decode_attn_grouped_int8",
                                  "decode_attn_int8")),
    "mistral_scores": dict(weights="mistral4",
                           engine=dict(quantized_cache=True),
                           config=dict(decode_attn="grouped"), tail=0,
                           requests=(16, 16), mistral=True, batch=16,
                           capacity=1024, prompt=512,
                           kernels=("flash_attention",
                                    "decode_attn_grouped_int8.int8_scores"),
                           absent=("decode_attn_grouped_int8.exact",
                                   "decode_attn_int8")),
    "mistral_append": dict(weights="mistral4",
                           engine=dict(cache_dtype="bfloat16"),
                           config=dict(fused_append=True), tail=0,
                           requests=(16, 16), mistral=True, batch=16,
                           capacity=4096, prompt=512,
                           kernels=("flash_attention",
                                    "decode_attn_grouped_append"),
                           absent=("kv_append", "decode_attn_float")),
    # (L): Mixtral-8x7B at full width and depth, int8 weights and expert
    # stacks drawn on the card, bf16 compute, cache="auto" (int8; the tail
    # gate refuses the E matrix of 32 heads over 8 KV heads of 128). The
    # 64-token prompts stay below flash_attention's 128-key block, so the
    # reference's prefill is its XLA attention and F1 does not run here.
    "mixtral_int8": dict(weights="mixtral", engine=dict(cache="auto"),
                         config=dict(dtype="bfloat16"), tail=0,
                         requests=(16, 32), own_phase=True, batch=16,
                         capacity=1024, prompt=64,
                         kernels=("decode_attn_grouped_int8.exact",
                                  "kv_append_int8", "matmul_int8_wo",
                                  "head_argmax_int8"),
                         per_step=("decode_attn_grouped_int8.exact",
                                   "kv_append_int8"),
                         trace_kernel=("G1 (decode_attn_grouped_int8, exact "
                                       "q)", "kv_group::kernel"),
                         absent=("flash_attention", "decode_attn_int8",
                                 "decode_attn_int8_tail", "tail_flush_int8",
                                 "decode_attn_fused_int8",
                                 "decode_attn_grouped_int8.int8_scores")),
    # (L-ragged): (L) at 2 layers with float (dequantized) expert stacks:
    # the prefill's 1024 tokens take the ragged path, decode the dense one.
    "mixtral_ragged": dict(weights="mixtral_float",
                           engine=dict(cache="auto"),
                           config=dict(dtype="bfloat16"), tail=0,
                           requests=(16, 8), own_phase=True, batch=16,
                           capacity=1024, prompt=64,
                           kernels=("decode_attn_grouped_int8.exact",
                                    "kv_append_int8", "head_argmax_int8")),
    # (L-scan): GPT-2-small with scan_layers (stacked int8 weights, a
    # stacked bf16 cache: K5 and K6 on each layer's view) against the same
    # engine without it, token for token.
    "scan_bf16": dict(weights="int8", engine=dict(cache="bf16"),
                      config=dict(scan_layers=True), tail=0,
                      requests=(64, 16), own_phase=True, batch=64,
                      kernels=("kv_append", "decode_attn_float",
                               "head_argmax_int8", "matmul_int8_wo"),
                      per_step=("kv_append", "decode_attn_float")),
    # (L-bf16): GPT-2-small int8 + tail under bf16 compute, card against
    # CPU at batch 64 (capacity 128, so that the CPU's plain K1 reads a
    # quarter of 512's rows): K1, K3, K2 and K4 on bf16 activations.
    "int8_tail_bf16": dict(weights="int8", engine=dict(quantized_cache=True),
                           config=dict(dtype="bfloat16"), tail=16,
                           requests=(64, 20), own_phase=True, batch=64,
                           kernels=("decode_attn_int8_tail",
                                    "tail_flush_int8", "head_argmax_int8",
                                    "matmul_int8_wo")),
}
GPT2_PATHS = [p for p in PATHS
              if not (PATHS[p].get("llama") or PATHS[p].get("mistral")
                      or PATHS[p].get("own_phase"))]
# Kernels that no serving path reaches (``name`` or ``name.mode``).
KERNEL_LEVEL = ("decode_attn_int8_partials", "decode_attn_split_kv",
                "decode_attn_native_dots", "matmul_int8_tiled",
                "decode_attn_grouped_int8.pv_int8.exact",
                "decode_attn_grouped_int8.pv_int8.int8_scores")
# The paged grid kernel serves batches with no group: its launches are
# counted in path (E)'s card-against-CPU phase at max_batch 3.
GRID_PHASE = "paged_f32_batch3"


def gpt2_model(path):
    return TransformerLM(TransformerConfig.gpt2(
        **PATHS[path].get("config", {})))


def batch_of(path):
    return PATHS[path].get("batch", 16 if PATHS[path].get("llama") else 256)


def capacity_of(path):
    return PATHS[path].get("capacity",
                           2048 if PATHS[path].get("llama") else 512)


def prompt_of(path):
    return PATHS[path].get("prompt", 64)


class path_env:
    """The path's environment variables, set while it serves."""

    def __init__(self, path):
        self.env = PATHS[path].get("env", {})

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class PrefillCounter:
    """The model, counting the engine's prefills of admission groups
    (``prefills``); it holds no reference to the engine, so a deleted
    engine frees its cache at once."""

    def __init__(self, model):
        self.model = model
        self.prefills = 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill_last(self, *args):
        self.prefills += 1
        return self.model.prefill_last(*args)


def new_engine(model, params, path, device="cuda", **kw):
    """The path's engine; ``engine.model.prefills`` counts its
    prefills."""
    engine = ServingEngine(PrefillCounter(model), params,
                           max_batch=batch_of(path),
                           capacity=capacity_of(path),
                           prefill_buckets=(prompt_of(path),), device=device,
                           **PATHS[path]["engine"], **kw)
    check(engine._tail_flush == PATHS[path]["tail"],
          f"{path}: the engine picked tail window {engine._tail_flush}")
    return engine


def main_path(model, params, path, n_requests, new_tokens, burst=21):
    """Serve ``n_requests`` random prompts of the path's length at its
    batch and capacity and return (engine, requests, wall seconds)."""
    engine = new_engine(model, params, path)
    rng = np.random.RandomState(0)
    reqs = [engine.submit(rng.randint(0, model.config.vocab_size,
                                      prompt_of(path)),
                          max_new_tokens=new_tokens)
            for _ in range(n_requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with path_env(path):
        engine.run(burst=burst)
    torch.cuda.synchronize()
    return engine, reqs, time.perf_counter() - t0


def serve_path(model, params, path):
    """A warm-up serve, then the measured run with every launch count set
    to 0 just before it and read just after. Checks that every request
    completed with in-vocabulary tokens and that every kernel of the path
    launched. Returns (decode tokens/s with admissions, launch counts)."""
    n_requests, new_tokens = PATHS[path]["requests"]
    main_path(model, params, path, batch_of(path), 4)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    engine, reqs, wall = main_path(model, params, path, n_requests,
                                   new_tokens)
    launches = kernels.launch_counts()
    st = engine.stats()
    check(all(len(r.tokens) == new_tokens and r.done for r in reqs),
          f"{path}: a request did not complete with {new_tokens} tokens")
    check(all(0 <= t < model.config.vocab_size for r in reqs
              for t in r.tokens), f"{path}: a token outside the vocabulary")
    rate = st["tokens"] / wall
    print(f"path {path}: {len(reqs)} requests, {st['decode_steps']} decode "
          f"steps, {st['tokens']} decode tokens in {wall:.3f} s = "
          f"{rate:.1f} decode tokens/s; p50 TTFT {st.get('ttft_p50_ms')} ms; "
          f"launches {launches}")
    check_launches(path, launches, model.config.n_layers,
                   st["decode_steps"], engine.model.prefills)
    del engine
    torch.cuda.empty_cache()
    return rate, launches


def check_launches(path, launches, n_layers, steps, prefills):
    """Every kernel of the path launched, none of its ``absent`` ones did,
    and those of ``per_step`` / ``per_prefill`` launched once per layer and
    decode step / admission group."""
    spec = PATHS[path]
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    check(not missing, f"{path}: kernels of the path never launched: "
          f"{missing}")
    stray = [k for k in spec.get("absent", ()) if launches[k]]
    check(not stray, f"{path}: kernels off the path launched: {stray}")
    for keys, n, what in ((spec.get("per_step", ()), steps, "decode step"),
                          (spec.get("per_prefill", ()), prefills,
                           "prefill")):
        for k in keys:
            check(launches[k] == n_layers * n,
                  f"{path}: {k} launched {launches[k]} times, not once per "
                  f"layer and {what} ({n_layers} x {n})")
    if spec.get("per_step"):
        names = spec["per_step"] + spec.get("per_prefill", ())
        print(f"path {path}: {', '.join(names)}"
              f" launched once per layer and decode step / prefill "
              f"({steps} steps, {prefills} prefills, {n_layers} layers)")


def steady_decode(model, params, path, steps=16, trace=False):
    """Decode at a full batch (after an admission and a warm-up burst): one
    burst of ``steps`` steps timed on the host clock, with the launches per
    step of each kernel, and, with ``trace``, one more traced by
    torch.profiler for the card's busy share (the sum of its kernels' time
    over the traced wall time) and the kernels that take the most device
    time. Returns the untraced decode tokens/s."""
    engine = new_engine(model, params, path)
    batch = batch_of(path)
    rng = np.random.RandomState(2)
    for _ in range(batch):
        engine.submit(rng.randint(0, model.config.vocab_size,
                                  prompt_of(path)),
                      max_new_tokens=5 + 2 * steps)
    engine.step_burst(5)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine.step_burst(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = batch * steps / wall
    per_step = {k.__name__: k.launches / steps for k in kernels.KERNELS
                if k.launches}
    print(f"path {path}, decode at batch {batch}: {1e3 * wall / steps:.3f} "
          f"ms per step, {rate:.1f} tokens/s; launches per step {per_step}")
    if engine.paged:
        # The host work a paged burst adds: map every active slot's pages
        # for the burst on the host table, upload the table if it changed.
        active = engine._active()
        t0 = time.perf_counter()
        for _ in range(10):
            engine._map_decode(active, engine._host_lengths, steps + 1)
        torch.cuda.synchronize()
        print(f"path {path}: allocator pass over {len(active)} slots before "
              f"a burst {1e2 * (time.perf_counter() - t0):.3f} ms")
    if trace:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step_burst(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        on_card = sorted((e for e in events
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        busy_s = sum(e.self_device_time_total for e in on_card) / 1e6
        print(f"path {path}, decode at batch {batch} under the profiler: "
              f"{1e3 * wall / steps:.3f} ms per step; card busy "
              f"{busy_s:.4f} s of {wall:.4f} s ({100 * busy_s / wall:.1f}%)")
        for e in on_card[:15]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"{e.count:5d}x  {e.key[:90]}")
        if "trace_kernel" in PATHS[path]:
            # K3 on int8 + tail (the appends' kernel body: no other
            # kernel of the path runs it), P3i on (D), P3 on (E), K8 on
            # (I), G1 on (H): the kernel's device time a step beside the
            # step time.
            label, symbol = PATHS[path]["trace_kernel"]
            mine = [e for e in on_card if symbol in e.key]
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            count = sum(e.count for e in mine)
            print(f"path {path}: {label} device time {ms / steps:.4f} ms a "
                  f"step ({count / steps:.2f} launches a step in the trace) "
                  f"of {1e3 * wall / steps:.3f} ms a traced step")
    del engine
    torch.cuda.empty_cache()
    return rate


def card_against_cpu(model, params_gpu, path, logit_tol, device="cuda",
                     max_batch=8, fused=True, prompt=8, new_tokens=16,
                     capacity=512, reading=None):
    """Greedy tokens of ``max_batch`` requests of ``prompt`` tokens x
    ``new_tokens`` of ``path`` on the card and on the CPU, each with the
    fused argmax head (unless ``fused`` is False: an int4 head has none)
    and with logits + argmax (recording the logits), compared step by step:
    logits within ``logit_tol``, tokens identical except after a CPU top-2
    margin below twice that. Returns the launch counts of the card's
    runs; a ``reading`` dict receives the largest logit difference
    (``dev``), that of the prefill's logits (``prefill_dev``), the
    divergences and max |logit|."""

    class Recorder(ArgMaxSampler):
        """Greedy, keeping every call's logits rows."""

        def __init__(self):
            self.logits = []

        def sample(self, logits, generator=None):
            self.logits.append(logits.cpu().numpy())
            return super().sample(logits)

    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, model.config.vocab_size, prompt))
               for _ in range(max_batch)]
    params_cpu = to_device(params_gpu, "cpu")

    def serve(params, dev, recorder=None):
        kw = dict(sampler=recorder, fused_head=False) if recorder else {}
        eng = ServingEngine(model, params, max_batch=max_batch,
                            capacity=capacity, prefill_buckets=(prompt,),
                            device=dev, **PATHS[path]["engine"], **kw)
        check(eng._tail_flush == PATHS[path]["tail"],
              f"{path} at max_batch {max_batch}: the engine picked tail "
              f"window {eng._tail_flush}")
        with path_env(path):
            return eng.generate(prompts, max_new_tokens=new_tokens, burst=6)

    kernels.reset_launch_counts()
    card_fused = cpu_fused = []
    if fused:
        card_fused, cpu_fused = serve(params_gpu, device), serve(params_cpu,
                                                                 "cpu")
    rec_card, rec_cpu = Recorder(), Recorder()
    card, cpu = serve(params_gpu, device, rec_card), serve(params_cpu, "cpu",
                                                           rec_cpu)
    check(all(len(t) == new_tokens
              for t in card_fused + cpu_fused + card + cpu),
          "a request got the wrong number of tokens")

    def compare(a_runs, b_runs, rec, tol, what):
        """Index of the first differing token per request; a difference
        must follow a step whose recorded top-2 margin is below ``tol``.
        One admission group in request order and one decode slot per
        request, so rec.logits[c][i] is the step that produced request i's
        token c."""
        first = []
        for i, (a, b) in enumerate(zip(a_runs, b_runs)):
            c = next((c for c in range(len(a)) if a[c] != b[c]), len(a))
            first.append(c)
            if c < len(a):
                top = np.sort(rec.logits[c][i])[-2:]
                margin = float(top[1] - top[0])
                print(f"{what}: request {i} first differs at token {c}, "
                      f"top-2 margin {margin:.3e} (tol {tol:.1e})")
                check(margin < tol, f"{what}: differ above the tolerance")
        return first

    if fused:
        compare(card_fused, card, rec_card, K2_MARGIN_TOL,
                f"{path}: card fused head vs logits head")
        compare(cpu_fused, cpu, rec_cpu, K2_MARGIN_TOL,
                f"{path}: cpu fused head vs logits head")
    first = compare(card, cpu, rec_cpu, 2 * logit_tol,
                    f"{path}: card vs cpu")
    # Logits rows computed from identical histories on both devices.
    dev = max(float(np.abs(rec_card.logits[c][i] - rec_cpu.logits[c][i])
                    .max())
              for i in range(len(card))
              for c in range(min(first[i] + 1, new_tokens)))
    prefill_dev = float(np.abs(rec_card.logits[0]
                               - rec_cpu.logits[0]).max())
    scale = max(float(np.abs(x).max()) for x in rec_cpu.logits)
    n_diverged = sum(f < new_tokens for f in first)
    print(f"{path}: card vs cpu: {sum(len(t) for t in card)} tokens, "
          f"{n_diverged} near-tie divergences, max logit difference "
          f"{dev:.3e} (prefill {prefill_dev:.3e}; tol {logit_tol:.1e}; max "
          f"|logit| {scale:.3f})")
    if reading is not None:
        reading.update(dev=dev, prefill_dev=prefill_dev,
                       divergences=n_diverged, scale=scale)
    check(dev < logit_tol, f"{path}: card and cpu logits disagree")
    return kernels.launch_counts()


# Path (G): speculative serving at tools/profile_spec.py's defaults
# (GPT-2-small, int8 weights, bf16 cache, draft 3, 3-grams, bursts of 16);
# 16 requests of 256 new tokens through 8 slots, so slots recycle.
SPEC_ENGINE = dict(max_batch=8, capacity=2048, prefill_buckets=(64,),
                   cache_dtype="bfloat16")
SPEC_OPTS = dict(spec_draft=3, spec_ngram=3, spec_adaptive=False)
SPEC_BURST = 16
SPEC_REQUESTS = (16, 256)


def spec_prompts(kind, n, vocab):
    """64-token prompts: random, or one 8-token period tiled
    (tools/profile_spec.py:130-137)."""
    rng = np.random.RandomState(0)
    if kind == "random":
        return [list(rng.randint(0, vocab, 64)) for _ in range(n)]
    period = rng.randint(0, vocab, 8)
    return [list(np.tile(period, 8)) for _ in range(n)]


def serve_spec(model, params, prompts, new_tokens, spec, **kw):
    """One serve of ``prompts`` at path (G)'s settings, speculative or
    plain; returns (decode tokens/s, decode steps, engine stats)."""
    engine = ServingEngine(model, params, device="cuda", **SPEC_ENGINE,
                           **kw, **(SPEC_OPTS if spec else {}))
    check(engine._tail_flush == 0, "a speculative path picked a tail")
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(burst=SPEC_BURST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "a speculative-path request did not complete")
    check(all(0 <= t < model.config.vocab_size for r in reqs
              for t in r.tokens), "a token outside the vocabulary")
    st = engine.stats()
    del engine
    return st["tokens"] / wall, st["decode_steps"], st


def spec_paths(model, weights):
    """Path (G) on repetitive and random prompts, plain and speculative in
    turns (plain, spec, spec, plain), launch counts read over the first
    speculative serve of each kind; then (G-int8), the same speculative
    serve on an int8 cache. Returns the launch counts by path."""
    params = weights["int8"]
    vocab = model.config.vocab_size
    n_requests, new_tokens = SPEC_REQUESTS
    warm = spec_prompts("random", 8, vocab)
    serve_spec(model, params, warm, 8, False)
    serve_spec(model, params, warm, 8, True)
    launches = {}
    for kind in ("repetitive", "random"):
        prompts = spec_prompts(kind, n_requests, vocab)
        turns = []
        for spec in (False, True, True, False):
            if spec and len(turns) == 1:
                kernels.reset_launch_counts()
            rate, steps, st = serve_spec(model, params, prompts, new_tokens,
                                         spec)
            if spec and len(turns) == 1:
                launches[f"spec_{kind}"] = kernels.launch_counts()
            turns.append((rate, steps, st))
        (p1, plain_steps, _), (s1, spec_steps, st), (s2, _, _), (p2, _, _) \
            = turns
        print(f"path (G) {kind}: {n_requests} requests x {new_tokens} "
              f"tokens; decode steps plain {plain_steps}, speculative "
              f"{spec_steps}: {plain_steps / spec_steps:.2f} tokens per "
              f"step per sequence (last burst's EMA "
              f"{st.get('spec_tokens_per_step')}, draft length "
              f"{st['spec_k']}); decode tokens/s in turns plain / spec / "
              f"spec / plain: {p1:.1f} / {s1:.1f} / {s2:.1f} / {p2:.1f}; "
              f"spec / plain {(s1 + s2) / (p1 + p2):.3f}")
        print(f"path (G) {kind}: launches "
              f"{nonzero(launches[f'spec_{kind}'])}")
    trace_spec_burst(model, params, spec_prompts("repetitive", 8, vocab))
    for kind in ("repetitive", "random"):
        counts = launches[f"spec_{kind}"]
        missing = [k for k in ("verify_attn_grouped.float", "matmul_int8_wo")
                   if counts[k] == 0]
        check(not missing, f"path (G) {kind}: never launched {missing}")
    kernels.reset_launch_counts()
    rate, steps, st = serve_spec(model, params,
                                 spec_prompts("repetitive", n_requests,
                                              vocab), new_tokens, True,
                                 quantized_cache=True)
    launches["spec_int8"] = kernels.launch_counts()
    print(f"path (G-int8) repetitive, int8 cache: {steps} decode steps, "
          f"{rate:.1f} decode tokens/s; launches "
          f"{nonzero(launches['spec_int8'])}")
    check(launches["spec_int8"]["verify_attn_grouped.int8"] > 0,
          "path (G-int8) never launched verify_attn_grouped in int8 mode")
    return launches


def trace_spec_burst(model, params, prompts, steps=8):
    """One speculative burst of path (G) at a full batch of 8 under
    torch.profiler, after an admission and a warm-up burst: ms per step,
    the card's busy share and the kernels that take the most device
    time."""
    engine = ServingEngine(model, params, device="cuda", **SPEC_ENGINE,
                           **SPEC_OPTS)
    for p in prompts:
        engine.submit(p, max_new_tokens=10 ** 6)
    engine.step_spec_burst(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step_spec_burst(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in on_card) / 1e6
    print(f"path (G), a speculative burst at batch 8 under the profiler: "
          f"{1e3 * wall / steps:.3f} ms per step (draft length "
          f"{engine._spec_k}); card busy {busy_s:.4f} s of {wall:.4f} s "
          f"({100 * busy_s / wall:.1f}%)")
    for e in on_card[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:5d}x  {e.key[:90]}")
    # K4 (the verify head): its convert and tile launches.
    k4 = [e for e in on_card
          if "x_to_bf16" in e.key or "int8_head_tile" in e.key
          or "int8_head_wgmma" in e.key]
    print(f"path (G), K4 (matmul_int8_wo) in the traced burst: "
          f"{sum(e.self_device_time_total for e in k4) / 1e3 / steps:.4f} "
          f"ms per step over {sum(e.count for e in k4)} CUDA kernels")
    # V1 (verify_attn_grouped): the KV-group kernel over ChunkRows.
    v1 = [e for e in on_card if "ChunkRows" in e.key]
    print(f"path (G), V1 (verify_attn_grouped) in the traced burst: "
          f"{sum(e.self_device_time_total for e in v1) / 1e3 / steps:.4f} "
          f"ms per step over {sum(e.count for e in v1) / steps:.2f} CUDA "
          f"kernels a step")
    del engine


class LogitsRecorder:
    """The model with the logits of every admission prefill and verify
    step recorded in order (host copies)."""

    def __init__(self, model):
        self.model = model
        self.logits = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill_last(self, params, tokens, cache, last_idx):
        logits, cache = self.model.prefill_last(params, tokens, cache,
                                                last_idx)
        self.logits.append(logits.cpu().numpy())
        return logits, cache

    def verify_step(self, params, tokens, cache):
        logits, cache = self.model.verify_step(params, tokens, cache)
        self.logits.append(logits.cpu().numpy())
        return logits, cache


def spec_card_against_cpu(model, weights):
    """Path (G) at ``max_batch=3`` (no group: the fused entry) on the card
    and on the CPU, 3 requests of 8 tokens x 16 new tokens. f32 weights on
    an f32 cache: the card's speculative tokens equal the CPU's and the
    card's plain engine's. int8 weights on an int8 cache: every verify
    step's logits agree within PATH_LOGIT_TOL while both devices have
    emitted the same tokens, and their greedy rows part only where the CPU's
    top-2 margin is below twice that. Returns the card runs' launch
    counts by mode."""
    vocab = model.config.vocab_size
    rng = np.random.RandomState(3)
    prompts = [list(np.tile(rng.randint(0, vocab, 4), 2)),
               list(rng.randint(0, vocab, 8)), list(rng.randint(0, vocab, 8))]
    kw = dict(max_batch=3, capacity=512, prefill_buckets=(8,))

    def serve(mdl, params, dev, spec=True, **extra):
        eng = ServingEngine(mdl, params, device=dev, **kw, **extra,
                            **(SPEC_OPTS if spec else {}))
        return eng.generate(prompts, max_new_tokens=16, burst=6)

    launches = {}
    kernels.reset_launch_counts()
    card = serve(model, weights["f32"], "cuda")
    launches["float"] = kernels.launch_counts()
    cpu = serve(model, to_device(weights["f32"], "cpu"), "cpu")
    plain = serve(model, weights["f32"], "cuda", spec=False)
    print(f"path (G) at max_batch 3, f32: card == cpu {card == cpu}, card "
          f"== card plain {card == plain}; launches "
          f"{nonzero(launches['float'])}")
    check(card == cpu == plain, "path (G) f32: tokens differ")
    check(launches["float"]["verify_attn_fused.float"] > 0,
          "path (G) at max_batch 3 never launched verify_attn_fused")

    rec = {"cuda": LogitsRecorder(model), "cpu": LogitsRecorder(model)}
    kernels.reset_launch_counts()
    serve(rec["cuda"], weights["int8"], "cuda", quantized_cache=True)
    launches["int8"] = kernels.launch_counts()
    serve(rec["cpu"], to_device(weights["int8"], "cpu"), "cpu",
          quantized_cache=True)
    # Event 0 is the admission prefill, then one per verify step; while
    # every earlier argmax agrees, both devices saw the same inputs.
    worst, parted = 0.0, None
    for event, (a, b) in enumerate(zip(rec["cuda"].logits,
                                       rec["cpu"].logits)):
        worst = max(worst, float(np.abs(a - b).max()))
        apart = np.argwhere(a.argmax(-1) != b.argmax(-1))
        if len(apart):
            top = np.sort(b, axis=-1)[..., -2:]
            margins = [float(top[tuple(ix)][1] - top[tuple(ix)][0])
                       for ix in apart]
            print(f"path (G) at max_batch 3, int8: argmax parts at event "
                  f"{event} (0 = prefill), CPU top-2 margins {margins}")
            check(max(margins) < 2 * PATH_LOGIT_TOL,
                  "path (G) int8: tokens apart above the tolerance")
            parted = event
            break
    print(f"path (G) at max_batch 3, int8: {len(rec['cuda'].logits) - 1} "
          f"verify steps on the card, max logit difference {worst:.3e} (tol "
          f"{PATH_LOGIT_TOL:.1e}) before the devices part (at event "
          f"{parted}); launches {nonzero(launches['int8'])}")
    check(worst < PATH_LOGIT_TOL, "path (G) int8: logits disagree")
    check(launches["int8"]["verify_attn_fused.int8"] > 0,
          "path (G) int8 at max_batch 3 never launched verify_attn_fused")
    return launches


# -- the other model families: (M) Whisper-small, (N) BERT-base, (O) -----------

# Path (M), tools/bench_whisper.py's configuration: Whisper-small at batch 8
# over 30 s of log-mel frames (3000, 1500 positions after the conv), 64
# greedy tokens in bursts of 16. generate's first step and four whole
# bursts: 65 decode steps (the last burst's overshoot is dropped).
WHISPER_BATCH = 8
WHISPER_FRAMES = 3000
WHISPER_TOKENS = 64
WHISPER_BURST = 16
WHISPER_STEPS = 1 + -(-(WHISPER_TOKENS - 1) // WHISPER_BURST) * WHISPER_BURST
WHISPER_TIMED_STEPS = 16           # the timed decode burst
# (M) card against CPU: full width at 2 encoder and 2 decoder layers,
# batch 2 (no group: K6 and G2 in their fused forms), 400 frames, 8 tokens.
# The f32 cache: f32 throughout with TF32 off, so (A)'s F32_PATH_LOGIT_TOL.
# The int8 cache: an f32 sum in another order that carries a K or V value
# across an int8 rounding moves it by a step of its head's scale, as the
# int8 GPT-2 paths' caches: their PATH_LOGIT_TOL. A token may differ only
# after a step whose CPU top-2 margin is below twice the tolerance.
WHISPER_CPU = dict(layers=2, batch=2, frames=400, tokens=8)
# (N) BERT-base: batch 32 x 128 tokens with right padding; card against CPU
# at 2 layers, batch 4. f32: (A)'s tolerance. Dynamic int8 at M 512 rows:
# a flipped int8 rounding of an activation under the per-tensor scale, as
# on the int8 paths: PATH_LOGIT_TOL.
BERT_BATCH, BERT_SEQ = 32, 128
# (O): f32 throughout with TF32 off, card against CPU at reduced depth:
# within F32_PATH_LOGIT_TOL of max |out| (each output's own scale).
VISION_REL_TOL = F32_PATH_LOGIT_TOL
# K5, K6, K7, G1 (int8 scores) and G2 at Whisper's decode shape: B 8, 12
# heads of 64, lives 1-64 (64 tokens decoded), capacity 448 (512 for G1).
W_LIVES = (1, 65)
W_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
          "library_ms", "device_launches")


def whisper_features(b, frames, seed=0):
    """Random log-mel-like features [B, frames, 80] on the CPU (both
    devices' runs take the same values)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, frames, 80), generator=g)


def whisper_greedy(model, params, feats, cross, quantized, steps,
                   capacity=None, forced=None):
    """``steps`` one-token decode steps from the start token (1) over a new
    cache: greedy, or teacher-forced by ``forced`` [steps, B]. Returns
    (the last-position logits of each step on the CPU [B, steps, V], the
    tokens fed after each step)."""
    dev = feats.device
    cache = model.new_cache(feats.shape[0], capacity, quantized=quantized,
                            device=dev)
    cur = torch.ones((feats.shape[0],), dtype=torch.int64, device=dev)
    rows, fed = [], []
    for i in range(steps):
        logits, cache = model.decode(params, cur[:, None], cross, cache)
        rows.append(logits[:, -1].cpu())
        cur = (forced[i].to(dev) if forced is not None
               else torch.argmax(logits[:, -1], dim=-1))
        fed.append(cur.cpu())
    return torch.stack(rows, 1), torch.stack(fed)


def whisper_decode_ms(model, params, cross, quantized, capacity=None,
                      steps=WHISPER_TIMED_STEPS):
    """Device time a greedy decode step (CUDA events around ``steps``
    steps after the first, the host's enqueue included: eager PyTorch)."""
    b, dev = cross[0][0].shape[0], cross[0][0].device
    cache = model.new_cache(b, capacity, quantized=quantized, device=dev)
    cur = torch.ones((b, 1), dtype=torch.int64, device=dev)
    logits, cache = model.decode(params, cur, cross, cache)
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        logits, cache = model.decode(params, cur, cross, cache)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def event_ms(fn):
    """Device time of one call of ``fn`` (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def whisper_paths(launches, timer):
    """Path (M): Whisper-small (``EncoderDecoderConfig.whisper_small()``,
    random ``init_params(0)``: no checkpoint is in the repository) through
    ``generate(start_token=1, max_tokens=64, burst=16)`` at batch 8 over
    3000 frames, on an f32 cache and on an int8 cache: encode ms, the
    generate's wall time and tokens/s, a timed decode burst (ms a step,
    tokens/s) and the card's peak memory; each decode step must launch K5
    and K6 (f32) or K7 and G2 (int8, capacity 448) once a layer and no
    other kernel of the repository (no F1 at head_dim 64, no G1). Then
    (M-512): decode steps on ``new_cache(8, capacity=512,
    quantized=True)``: K7 and G1 with int8 scores once a layer."""
    model = EncoderDecoderLM(EncoderDecoderConfig.whisper_small())
    cfg = model.config
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    print(f"Whisper-small weights ({param_bytes(params) / 2**20:.1f} MiB "
          f"f32): {time.perf_counter() - t0:.1f} s")
    feats = whisper_features(WHISPER_BATCH, WHISPER_FRAMES).cuda()
    model.generate(params, feats, 1, max_tokens=2)   # warm-up, encode too
    enc_ms, cross = event_ms(lambda: model.cross_kv(
        params, model.encode(params, feats)))
    print(f"path (M) encode + cross K/V, B {WHISPER_BATCH} x "
          f"{WHISPER_FRAMES} frames ({cross[0][0].shape[2]} positions): "
          f"{enc_ms:.3f} ms")
    n = cfg.n_dec_layers
    kinds = {"whisper_f32": (False, None, {"kv_append": n,
                                           "decode_attn_float": n}),
             "whisper_int8": (True, None, {"kv_append_int8": n,
                                           "decode_attn_fused_int8": n}),
             "whisper_int8_512": (True, 512, {
                 "kv_append_int8": n, "decode_attn_grouped_int8": n,
                 "decode_attn_grouped_int8.int8_scores": n})}
    for path, (quantized, capacity, per_step) in kinds.items():
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        if capacity is None:
            t0 = time.perf_counter()
            tokens = model.generate(params, feats, 1,
                                    max_tokens=WHISPER_TOKENS,
                                    quantized_cache=quantized,
                                    burst=WHISPER_BURST)
            wall = time.perf_counter() - t0
            steps = WHISPER_STEPS
            check(tokens.shape == (WHISPER_BATCH, WHISPER_TOKENS)
                  and tokens.min() >= 0 and tokens.max() < cfg.vocab_size,
                  f"path {path}: generate gave tokens of shape "
                  f"{tokens.shape} outside the vocabulary")
            print(f"path {path}: generate of {WHISPER_TOKENS} tokens x "
                  f"{WHISPER_BATCH} in {wall:.3f} s (encode included): "
                  f"{WHISPER_BATCH * WHISPER_TOKENS / wall:.1f} tokens/s; "
                  f"first tokens {tokens[0, :8].tolist()}")
        else:
            logits, _ = whisper_greedy(model, params, feats, cross, True,
                                       WHISPER_TIMED_STEPS + 1, capacity)
            steps = WHISPER_TIMED_STEPS + 1
            check(bool(torch.isfinite(logits).all()),
                  f"path {path}: logits not finite")
        counts = launches[path] = kernels.launch_counts()
        want = {k: c * steps for k, c in per_step.items()}
        print(f"path {path}: launches over {steps} decode steps "
              f"{nonzero(counts)}")
        check(nonzero(counts) == want, f"path {path}: launches "
              f"{nonzero(counts)}, expected {want}")
        ms = whisper_decode_ms(model, params, cross, quantized, capacity)
        peak = torch.cuda.max_memory_allocated()
        print(f"path {path}: decode {ms:.3f} ms a step at batch "
              f"{WHISPER_BATCH} ({WHISPER_BATCH * 1e3 / ms:.1f} tokens/s); "
              f"peak memory {peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f}"
              f" above the {held / 2**30:.2f} held before it (the weights, "
              f"the timed cross K/V, earlier phases' tensors)")
    del params, cross
    torch.cuda.empty_cache()
    whisper_card_against_cpu()


def whisper_card_against_cpu():
    """(M) card against CPU: Whisper-small's width at 2 + 2 layers, batch 2,
    400 frames, 8 decode steps on an f32 and an int8 cache, the card
    greedy and the CPU (plain kernels) teacher-forced by the card's
    tokens; logits within WHISPER_CPU's tolerances, tokens equal except
    after a near-tie, and the card's launches K5 + K6 (f32) or K7 + G2
    (int8) once a layer and step."""
    c = WHISPER_CPU
    model = EncoderDecoderLM(EncoderDecoderConfig.whisper_small(
        n_enc_layers=c["layers"], n_dec_layers=c["layers"]))
    feats = whisper_features(c["batch"], c["frames"], seed=1)
    params = {dev: model.init_params(0, device=dev)
              for dev in ("cuda", "cpu")}
    for quantized, tol in ((False, F32_PATH_LOGIT_TOL),
                           (True, PATH_LOGIT_TOL)):
        out, forced = {}, None
        for dev in ("cuda", "cpu"):
            p, f = params[dev], feats.to(dev)
            kernels.reset_launch_counts()
            cross = model.cross_kv(p, model.encode(p, f))
            out[dev] = whisper_greedy(model, p, f, cross, quantized,
                                      c["tokens"], forced=forced)
            if forced is None:                 # the card's run, first
                forced, counts = out[dev][1], nonzero(kernels.launch_counts())
        label = "int8" if quantized else "f32"
        steps = c["layers"] * c["tokens"]
        want = ({"kv_append_int8": steps, "decode_attn_fused_int8": steps}
                if quantized else {"kv_append": steps,
                                   "decode_attn_float": steps})
        check(counts == want, f"(M) {label} card against CPU: card "
              f"launches {counts}, expected {want}")
        card, cpu = out["cuda"][0], out["cpu"][0]
        err = (card - cpu).abs().max().item()
        top2 = cpu.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
        same = (cpu.argmax(-1) == forced.T) | ~clear
        print(f"(M) {label} cache card against CPU ({c['layers']} + "
              f"{c['layers']} layers, B {c['batch']}, {c['frames']} frames, "
              f"{c['tokens']} steps): max |logit diff| {err:.3e} (tol "
              f"{tol:.0e}, max |logit| {cpu.abs().max().item():.3f}); "
              f"tokens {forced.T.tolist()}; card launches {counts}")
        check(bool(torch.isfinite(card).all()) and err <= tol,
              f"(M) {label} card against CPU: logits differ by {err:.3e}")
        check(bool(same.all()), f"(M) {label} card against CPU: a token "
              f"differs where the CPU's top-2 margin exceeds {2 * tol}")
    del params
    torch.cuda.empty_cache()


def bert_inputs(b, s, vocab, seed=0):
    """Token ids with right padding (lengths s/4..s, row 0 whole; id 0 past
    each length), the mask and segment ids (question 0, context 1 from
    s/4), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(s // 4, s + 1, (b,), generator=g)
    lengths[0] = s
    mask = (torch.arange(s)[None] < lengths[:, None]).to(torch.int32)
    ids = torch.randint(1, vocab, (b, s), generator=g) * mask
    types = (torch.arange(s)[None] >= s // 4).to(torch.int32).expand(b, s)
    return ids, mask, types


def bert_heads(model, params, ids, mask, types):
    return (model.pooled(params, ids, mask),
            *model.qa_spans(params, ids, mask, token_type_ids=types),
            model.mean_embedding(params, ids, mask))


def bert_path(launches, timer):
    """Path (N): BERT-base (``BertConfig()``, bert-base-uncased's shape,
    random ``init_params(0)``) at batch 32 x 128 tokens with right
    padding, in f32 and dynamic int8 (``quantize_weights(params,
    "int8")``): ``pooled``, ``qa_spans`` and ``mean_embedding`` finite and
    of their shapes, sequences/s of ``pooled`` (median of 5 timed
    forwards), then card against CPU at 2 layers, batch 4."""
    model = Bert(BertConfig())
    t0 = time.perf_counter()
    weights = {"f32": model.init_params(0, device="cuda")}
    weights["int8"] = quantize_weights(weights["f32"], "int8")
    print(f"BERT-base f32 and int8 weights: {time.perf_counter() - t0:.1f} "
          f"s")
    ids, mask, types = (t.cuda() for t in bert_inputs(
        BERT_BATCH, BERT_SEQ, model.config.vocab_size))
    for kind, params in weights.items():
        kernels.reset_launch_counts()
        outs = bert_heads(model, params, ids, mask, types)
        launches[f"bert_{kind}"] = kernels.launch_counts()
        shapes = [tuple(o.shape) for o in outs]
        check(shapes == [(BERT_BATCH, 768), (BERT_BATCH, BERT_SEQ),
                         (BERT_BATCH, BERT_SEQ), (BERT_BATCH, 768)]
              and all(bool(torch.isfinite(o).all()) for o in outs),
              f"path (N) {kind}: heads of shapes {shapes} or not finite")
        ms = timer(lambda: model.pooled(params, ids, mask), reps=5)
        print(f"path (N) BERT-base {kind}, B {BERT_BATCH} x {BERT_SEQ}: "
              f"pooled {ms:.3f} ms, {BERT_BATCH * 1e3 / ms:.1f} "
              f"sequences/s; launches of the repository's kernels "
              f"{nonzero(launches[f'bert_{kind}'])}")
    del weights
    torch.cuda.empty_cache()
    small = Bert(BertConfig(n_layers=2))
    f32 = {dev: small.init_params(0, device=dev) for dev in ("cuda", "cpu")}
    inputs = bert_inputs(4, BERT_SEQ, small.config.vocab_size, seed=1)
    for kind, tol in (("f32", F32_PATH_LOGIT_TOL), ("int8", PATH_LOGIT_TOL)):
        outs = {}
        for dev in ("cuda", "cpu"):
            p = (f32[dev] if kind == "f32"
                 else quantize_weights(f32[dev], "int8"))
            outs[dev] = [o.cpu() for o in bert_heads(
                small, p, *(t.to(dev) for t in inputs))]
        errs = [(a - b).abs().max().item()
                for a, b in zip(outs["cuda"], outs["cpu"])]
        print(f"(N) {kind} card against CPU (2 layers, B 4 x {BERT_SEQ}): "
              f"max |diff| pooled {errs[0]:.3e}, start {errs[1]:.3e}, end "
              f"{errs[2]:.3e}, mean embedding {errs[3]:.3e} (tol {tol:.0e})")
        check(max(errs) <= tol, f"(N) {kind} card against CPU: {errs}")


def held(label, card, cpu):
    """Card output against the CPU's within VISION_REL_TOL of max |out|."""
    card, cpu = card.cpu(), cpu.cpu()
    err = (card - cpu).abs().max().item()
    tol = VISION_REL_TOL * max(cpu.abs().max().item(), 1e-30)
    print(f"(O) {label} card against CPU: max |diff| {err:.3e} (tol "
          f"{tol:.3e})")
    check(card.shape == cpu.shape and bool(torch.isfinite(card).all())
          and err <= tol, f"(O) {label} card against CPU differs")


def family_forward(label, timer, fn, shape):
    """One forward of a family on the card: its shape, finite, timed
    (median of 5)."""
    out = fn()
    first = out[0] if isinstance(out, tuple) else out
    check(tuple(first.shape) == shape and bool(torch.isfinite(first).all()),
          f"(O) {label}: output of shape {tuple(first.shape)}, expected "
          f"{shape}, or not finite")
    ms = timer(fn, reps=5)
    print(f"path (O) {label}: {ms:.3f} ms a forward")
    return ms


def vision_tts_paths(launches, timer):
    """Path (O): one forward each at the reference's default configs with
    random weights: ViT-S/16 ``classify`` and ``DepthEstimator.predict``
    at batch 32, 224 x 224; SAM (ViT-S/16 encoder) at batch 4 with 3 of 8
    points; the ASPP segmenter on ResNet-50 at batch 8, 224 x 224;
    ``TextToSpeech.synthesize`` at batch 8 x 64 phonemes. Each also card
    against CPU at reduced depth (ViTs of 2 layers, ResNet-50 at batch 1,
    TTS of 2 layers: TTS stage by stage at the card's durations)."""
    g = torch.Generator().manual_seed(2)
    images = torch.randn((32, 3, 224, 224), generator=g)
    kernels.reset_launch_counts()
    vit = ViT(ViTConfig())
    p = vit.init_params(0, device="cuda")
    x = images.cuda()
    family_forward("ViT-S/16 classify, B 32", timer,
                   lambda: vit.classify(p, x), (32, 1000))
    depth = DepthEstimator(DepthConfig())
    p = depth.init_params(0, device="cuda")
    family_forward("DepthEstimator, B 32", timer,
                   lambda: depth.predict(p, x), (32, 224, 224))
    sam = SAM(SAMConfig())
    p = sam.init_params(0, device="cuda")
    pts = torch.rand((4, 8, 2), generator=g)
    labels = torch.randint(0, 2, (4, 8), generator=g)
    n_pts = torch.full((4,), 3)
    prompt = [t.cuda() for t in (images[:4], pts, labels, n_pts)]
    family_forward("SAM, B 4, 3 points", timer,
                   lambda: sam.predict(p, *prompt), (4, 224, 224))
    seg = Segmenter(SegmentationConfig())
    p = seg.init_params(0, device="cuda")
    family_forward("segmenter (ResNet-50 + ASPP), B 8", timer,
                   lambda: seg.forward(p, x[:8]), (8, 21, 224, 224))
    tts = TextToSpeech(TTSConfig())
    p = tts.init_params(0, device="cuda")
    phonemes = torch.randint(0, 256, (8, 64), generator=g)
    lengths = torch.randint(16, 65, (8,), generator=g)
    ph, ln = phonemes.cuda(), lengths.cuda()
    family_forward("TTS synthesize, B 8 x 64 phonemes", timer,
                   lambda: tts.synthesize(p, ph, ln), (8, 512 * 64))
    launches["families"] = kernels.launch_counts()
    print(f"path (O): launches of the repository's kernels "
          f"{nonzero(launches['families'])}")
    del p, x
    torch.cuda.empty_cache()

    def both(model):
        return {dev: model.init_params(0, device=dev)
                for dev in ("cuda", "cpu")}

    small = ViTConfig(n_layers=2)
    vit = ViT(small)
    ps = both(vit)
    held("ViT-S/16 at 2 layers, B 2",
         *(vit.classify(ps[d], images[:2].to(d)) for d in ("cuda", "cpu")))
    depth = DepthEstimator(DepthConfig(vit=ViTConfig(n_layers=2,
                                                     use_cls_token=False)))
    ps = both(depth)
    held("DepthEstimator at 2 layers, B 2",
         *(depth.predict(ps[d], images[:2].to(d)) for d in ("cuda", "cpu")))
    sam = SAM(SAMConfig(vit=ViTConfig(n_layers=2, use_cls_token=False)))
    ps = both(sam)
    outs = [sam.predict(ps[d], *(t[:1].to(d) for t in (images, pts, labels,
                                                         n_pts)))
            for d in ("cuda", "cpu")]
    held("SAM masks at 2 encoder layers, B 1", outs[0][0], outs[1][0])
    held("SAM IoU at 2 encoder layers, B 1", outs[0][1], outs[1][1])
    ps = both(seg)
    held("segmenter logits (ResNet-50), B 1",
         *(seg.forward(ps[d], images[:1].to(d)) for d in ("cuda", "cpu")))
    tts = TextToSpeech(TTSConfig(n_layers=2))
    ps = both(tts)
    hidden = {d: tts.encode(ps[d], phonemes[:2].to(d), lengths[:2].to(d))
              for d in ("cuda", "cpu")}
    held("TTS encoder at 2 layers, B 2", hidden["cuda"], hidden["cpu"])
    dur = {d: tts.durations(ps[d], hidden[d]).cpu() for d in hidden}
    print(f"(O) TTS durations equal on both devices: "
          f"{torch.equal(dur['cuda'], dur['cpu'])}")
    mel = {}
    for d in hidden:
        frames, fmask, _ = tts.length_regulate(hidden[d], dur["cuda"].to(d),
                                               lengths[:2].to(d))
        mel[d] = tts.mel(ps[d], frames, fmask)
    held("TTS mel at the card's durations", mel["cuda"], mel["cpu"])
    held("TTS waveform at the card's durations",
         *(tts.vocode(ps[d], mel[d]) for d in ("cuda", "cpu")))


def whisper_kernel_rows(timer):
    """K5, K6, K7, G1 (int8 scores) and G2 at Whisper's decode shape (B 8,
    12 heads of 64, lives 1-64; capacity 448, and 512 for G1), each against
    its plain version and timed as at its home shape: the ``w_*`` keys of
    its entry, by (name, mode)."""
    b, h, d = WHISPER_BATCH, 12, 64
    g = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = _decode_lengths(g, b, W_LIVES)
    kv = torch.randn((b, 448, 2, h * d), device="cuda", generator=g)
    shape = "(M): B 8, 12 heads of 64, capacity 448, lives 1-64"
    rows = {("decode_attn_float", None): _k6_case(
        timer, f"decode_attn_float {shape}, f32 cache", q, kv, lengths)}
    k, v = _decode_rows(g, b, h, d)
    rows[("kv_append", None)] = _kv_append_case(timer, shape, k, v,
                                                lengths - 1, kv)
    del kv
    rows[("kv_append_int8", None)] = _kv_append_int8_case(
        timer, shape, b, h, d, 448, W_LIVES, False, 32)
    rows[("decode_attn_fused_int8", None)] = check_int8_decode(
        timer, "fused", b=b, cap=448, lives=W_LIVES, h=h, kvh=h, d=d)
    rows[("decode_attn_grouped_int8", "int8_scores")] = check_int8_decode(
        timer, "int8_scores", b=b, cap=512, lives=W_LIVES, h=h, kvh=h, d=d)
    return {key: {f"w_{k}": r[k] for k in W_KEYS if k in r}
            for key, r in rows.items()}


# Each (name, mode) row's launches on path (M): the path that runs it.
M_HOME = {("kv_append", None): "whisper_f32",
          ("decode_attn_float", None): "whisper_f32",
          ("kv_append_int8", None): "whisper_int8",
          ("decode_attn_fused_int8", None): "whisper_int8",
          ("decode_attn_grouped_int8", "int8_scores"): "whisper_int8_512"}




def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    build_s = _build.build_all(verbose=True)
    print(f"build: {build_s:.1f} s")
    stamp("build")

    check_int8_matmul()
    timer = Timer()
    k_head, n_vocab = 768, 50257
    w, s, w_dq = _head_weights(k_head, n_vocab)
    results = [check_decode_attn(timer),
               check_head_argmax(timer, w, s, w_dq, n_vocab),
               check_tail_flush(timer),
               check_matmul_wo(timer, w, s, w_dq, n_vocab),
               check_kv_append(timer),
               check_decode_attn_float(timer),
               check_kv_append_int8(timer),
               check_decode_attn_int8(timer),
               check_decode_attn(timer, q_bf16=False),
               check_decode_attn_int8(timer, q_bf16=False),
               check_kv_append_paged(timer, quantized=False),
               check_kv_append_paged(timer, quantized=True),
               check_decode_attn_paged(timer, "grouped"),
               check_decode_attn_paged(timer, "int8"),
               check_decode_attn_paged(timer, "grid")]
    del w, s, w_dq
    results += check_int4(timer)
    # V1 at path (G)'s shapes (batch 8: the grouped entry; batch 3: the
    # fused one), then at K6's serving shapes (printed only).
    results += check_verify_attn(timer, "grouped", b=8, cap=2048,
                                 live=(64, 321))
    results += check_verify_attn(timer, "fused", b=3, cap=2048,
                                 live=(64, 321))
    check_verify_attn(timer, "grouped", b=256, cap=512, live=(65, 177))
    # F1, G1 in both score modes, G2 and A1 at path (H)'s shapes.
    results += [check_flash_attention(timer),
                check_int8_decode(timer, "exact", b=16, cap=4096),
                check_int8_decode(timer, "int8_scores", b=16, cap=1024),
                check_int8_decode(timer, "fused", b=3, cap=4096),
                check_grouped_append(timer)]
    # K8 at path (I)'s shapes and TinyLlama's (printed), the partials mode
    # at path (B)'s and TinyLlama's (splits merged in a cluster), K9 at (H)'s
    # head shape, native_dots at (C)'s, pv_int8 at (H)'s in both score
    # modes, M1 at GPT-2's linears: the kernel-level entries.
    results += [check_flat_float(timer), check_partials(timer),
                check_split_kv(timer), check_native_dots(timer),
                check_pv_int8(timer, False), check_pv_int8(timer, True),
                check_int8_tiled(timer)]
    check_flat_float(timer, b=16, h=32, kvh=4, cap=2048, lives=(65, 2000),
                     entry=False)
    # K1 and K3 at path (F)'s shapes (GQA: 32 query heads over 4 KV heads),
    # K1' there too, and K1 and K1' past the 12,080 tokens that one
    # shared-memory score row allowed, printed beside their entries.
    printed = [check_decode_attn(timer, b=16, h=32, kvh=4, cap=2048,
                                 live=(56, 1991)),
               check_tail_flush(timer, b=16, kvh=4, cap=2048,
                                live=(16, 2000)),
               check_decode_attn_int8(timer, b=16, h=32, kvh=4, cap=2048,
                                      live=(65, 2000)),
               check_decode_attn(timer, b=4, cap=16384,
                                 live=(12100, 16369)),
               check_decode_attn_int8(timer, b=4, cap=12288,
                                      live=(12100, 12289)),
               check_decode_attn(timer, b=64, cap=1024, live=(64, 112)),
               check_tail_flush(timer, b=64, cap=1024, live=(64, 112))]
    # V1's fused int8 entry at path (K)'s prefix hit: one sequence, slices
    # of 8 queries at depths 48-104 (its float mode is printed too).
    printed += check_verify_attn(timer, "fused", b=1, s=8, cap=1024,
                                 live=(48, 105))
    # K4, K2 and G1 (exact q) at path (L)'s shapes on bf16-valued inputs:
    # extra keys of their entries.
    l_k4, l_k2 = check_mixtral_gemms(timer)
    entry_of(results, "matmul_int8_wo").update(l_k4)
    entry_of(results, "head_argmax_int8").update(l_k2)
    entry_of(results, "decode_attn_grouped_int8", "exact").update(prefixed(
        check_int8_decode(timer, "exact", b=16, cap=1024, lives=(64, 97),
                          bf16_q=True), "l_"))
    # K5, K6, K7, G1 (int8 scores) and G2 at path (M)'s decode shape: the
    # ``w_*`` keys of their entries.
    for (name, mode), row in whisper_kernel_rows(timer).items():
        entry_of(results, name, mode).update(row)
    for r in results + printed:
        print(f"{r['name']}{' (' + r['mode'] + ')' if 'mode' in r else ''}: "
              f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) library_ms "
              f"{r['library_ms']}")
    print("(the last nine lines: K1, K3 and K1' at TinyLlama shapes, B 16, "
          "32 heads over 4 KV heads, capacity 2048; K1 at B 4, capacity "
          "16384, lives 12100-16368; K1' at B 4, capacity 12288, lives "
          "12100-12288; K1 and K3 at path (K)'s B 64, capacity 1024; V1 "
          "fused, float and int8, at path (K)'s prefix hit, B 1, S 8, "
          "capacity 1024)")
    stamp("kernel phases")

    model = gpt2_model("f32")
    t0 = time.perf_counter()
    weights = {"f32": model.init_params(0, device="cuda")}
    weights["int8"] = quantize_weights(weights["f32"])
    print(f"GPT-2-small f32 and int8 weights: {time.perf_counter() - t0:.1f}"
          f" s")
    rates, steady, launches = {}, {}, {}
    for path in GPT2_PATHS:
        params = weights[PATHS[path]["weights"]]
        rates[path], launches[path] = serve_path(gpt2_model(path), params,
                                                 path)
        if PATHS[path].get("steady", True):
            steady[path] = steady_decode(
                gpt2_model(path), params, path,
                trace=path in ("int8_tail", "f32", "paged_int8",
                               "paged_f32", "flat_f32"))
    print(f"same-run decode tokens/s at batch 256, int8 + tail against the "
          f"f32 baseline: with admissions {rates['int8_tail']:.1f} / "
          f"{rates['f32']:.1f} = {rates['int8_tail'] / rates['f32']:.3f}; "
          f"steady burst {steady['int8_tail']:.1f} / {steady['f32']:.1f} = "
          f"{steady['int8_tail'] / steady['f32']:.3f}")
    print(f"same-run decode tokens/s with admissions: "
          + ", ".join(f"{p} {r:.1f}" for p, r in rates.items())
          + "; steady burst: "
          + ", ".join(f"{p} {r:.1f}" for p, r in steady.items()))
    # Each paged path against its contiguous counterpart in turns
    # (contiguous, paged, paged, contiguous), TURN_ROUNDS rounds:
    # host-bound steps drift within a run, so only turns give the same-run
    # spread.
    for base, paged in (("f32", "paged_f32"), ("int8_no_tail", "paged_int8")):
        params = weights[PATHS[base]["weights"]]
        ratios = []
        for _ in range(TURN_ROUNDS):
            turns = [steady_decode(model, params, p)
                     for p in (base, paged, paged, base)]
            ratios.append((turns[1] + turns[2]) / (turns[0] + turns[3]))
            print(f"in turns, decode tokens/s at batch 256, {base} / "
                  f"{paged} / {paged} / {base}: "
                  + " / ".join(f"{r:.1f}" for r in turns))
        print(f"in turns, {paged} / {base} decode tokens/s by round: "
              + ", ".join(f"{r:.3f}" for r in ratios)
              + f"; median {sorted(ratios)[len(ratios) // 2]:.3f}")

    stamp("GPT-2 paths")
    launches.update(spec_paths(model, weights))
    spec_cpu = spec_card_against_cpu(model, weights)
    card_against_cpu(model, weights["int8"], "int8_tail", PATH_LOGIT_TOL)
    card_against_cpu(model, weights["f32"], "f32", F32_PATH_LOGIT_TOL)
    card_against_cpu(model, weights["int8"], "paged_int8", PATH_LOGIT_TOL)
    launches[GRID_PHASE] = card_against_cpu(
        model, weights["f32"], "paged_f32", F32_PATH_LOGIT_TOL, max_batch=3)
    print(f"paged_f32 at max_batch 3, card runs: launches "
          f"{launches[GRID_PHASE]}")
    check(launches[GRID_PHASE]["decode_attn_paged_grid"] > 0,
          "paged_f32 at max_batch 3 never launched decode_attn_paged_grid")
    counts = card_against_cpu(gpt2_model("flat_f32"), weights["f32"],
                              "flat_f32", FLAT_PATH_LOGIT_TOL)
    print(f"flat_f32 card against CPU, card runs: launches "
          f"{nonzero(counts)}")
    check(counts["decode_attn_flat_float"] > 0
          and counts["decode_attn_float"] == 0,
          "flat_f32 card against CPU: decode did not run through K8")
    stamp("speculative paths and card against CPU")
    scan_path(weights["int8"], launches)
    path = "int8_tail_bf16"
    launches[path] = card_against_cpu(
        gpt2_model(path), weights["int8"], path, BF16_PATH_LOGIT_TOL,
        max_batch=batch_of(path), new_tokens=PATHS[path]["requests"][1],
        capacity=128)
    print(f"path (L-bf16) card against CPU at batch {batch_of(path)}, card "
          f"runs: launches {nonzero(launches[path])}")
    missing = [k for k in PATHS[path]["kernels"] if launches[path][k] == 0]
    check(not missing, f"path (L-bf16): never launched {missing}")
    del weights
    torch.cuda.empty_cache()
    stamp("(L-scan) and (L-bf16)")

    # Path (F): TinyLlama-1.1B at full width with int4 weights, drawn on
    # the host in the reference's order; the f32 weights are freed once
    # both packings are quantized.
    llama = TransformerLM(TransformerConfig.tiny_llama())
    t0 = time.perf_counter()
    f32 = llama.init_params(0, device="cuda")
    weights = {"int4": quantize_weights(f32, "int4"),
               "int4_bytes": quantize_weights(f32, "int4",
                                              int4_packing="bytes")}
    del f32
    torch.cuda.empty_cache()
    print(f"TinyLlama-1.1B int4 weights (words and bytes): "
          f"{time.perf_counter() - t0:.1f} s; card memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    path = "tinyllama_int4"
    rates[path], launches[path] = serve_path(llama, weights["int4"], path)
    steady[path] = steady_decode(llama, weights["int4"], path, trace=True)
    for path in ("tinyllama_int4_bytes", "tinyllama_int4_dot_int8"):
        n_requests, new_tokens = PATHS[path]["requests"]
        kernels.reset_launch_counts()
        engine, reqs, wall = main_path(llama, weights[PATHS[path]["weights"]],
                                       path, n_requests, new_tokens)
        launches[path] = kernels.launch_counts()
        check(all(len(r.tokens) == new_tokens and r.done for r in reqs),
              f"{path}: a request did not complete")
        print(f"path {path}: {len(reqs)} requests x {new_tokens} tokens in "
              f"{wall:.3f} s; launches {launches[path]}")
        missing = [k for k in PATHS[path]["kernels"]
                   if launches[path][k] == 0]
        check(not missing, f"{path}: kernels never launched: {missing}")
        del engine
    del weights
    torch.cuda.empty_cache()
    # (F) card against CPU at TinyLlama's width with 2 layers.
    llama2 = TransformerLM(TransformerConfig.tiny_llama(n_layers=2))
    counts = card_against_cpu(llama2, quantize_weights(llama2.init_params(
        0, device="cuda"), "int4"), "tinyllama_int4", LLAMA_PATH_LOGIT_TOL,
        max_batch=4, fused=False)
    print(f"tinyllama_int4 (2 layers) card against CPU, card runs: launches "
          f"{counts}")
    missing = [k for k in PATHS["tinyllama_int4"]["kernels"]
               if counts[k] == 0]
    check(not missing, f"tinyllama_int4 card against CPU: kernels never "
          f"launched: {missing}")
    del llama2
    torch.cuda.empty_cache()

    stamp("TinyLlama paths")
    mistral_paths(launches, rates, steady)
    stamp("Mistral paths")
    mixtral_paths(launches, rates, steady)
    stamp("Mixtral paths (L)")
    graph_runtime_path(launches)
    stamp("graph runtime (J)")
    http_serve_path(launches, smi, timer)
    stamp("HTTP server (K)")
    whisper_paths(launches, timer)
    stamp("Whisper-small (M), (M-512), (M) card against CPU")
    bert_path(launches, timer)
    stamp("BERT-base (N)")
    vision_tts_paths(launches, timer)
    stamp("ViT, depth, SAM, segmenter and TTS (O)")

    # Each kernel reports its launches on the path it was ported for; V1's
    # entries per mode: path (G) for the grouped entry (float on the bf16
    # cache, int8 on G-int8's), its batch-3 card-against-CPU phase for the
    # fused one.
    launches["spec_batch3_float"] = spec_cpu["float"]
    launches["spec_batch3_int8"] = spec_cpu["int8"]
    home = {k: p for p in reversed(PATHS) for k in PATHS[p]["kernels"]}
    home["decode_attn_paged_grid"] = GRID_PHASE
    spec_home = {("verify_attn_grouped", "float"): "spec_repetitive",
                 ("verify_attn_grouped", "int8"): "spec_int8",
                 ("verify_attn_fused", "float"): "spec_batch3_float",
                 ("verify_attn_fused", "int8"): "spec_batch3_int8",
                 ("decode_attn_grouped_int8", "exact"): "mistral_int8",
                 ("decode_attn_int8_tail", "exact"): "int8_tail_exact_q",
                 ("decode_attn_int8", "exact"): "int8_no_tail_exact_q",
                 ("decode_attn_grouped_int8", "int8_scores"):
                     "mistral_scores"}
    for r in results:
        r["route"] = "cuda"
        key = f"{r['name']}.{r['mode']}" if "mode" in r else r["name"]
        if key in KERNEL_LEVEL:
            # No path runs it: its launches summed over every path's run.
            r["path"] = None
            r["launches"] = sum(c.get(key, 0) for c in launches.values())
        elif "mode" in r:
            r["path"] = spec_home[(r["name"], r["mode"])]
            r["launches"] = launches[r["path"]][key]
        else:
            r["path"] = home[r["name"]]
            r["launches"] = launches[r["path"]][key]
        if r["name"] == "flash_attention":
            # F1 also serves path (J)'s FusedSDPA graph: its launches there.
            r["graph_launches"] = launches["graph_sdpa"]["flash_attention"]
        if r["name"] == "kv_append_int8":
            # K7 runs on path (H) too: its launches there beside (B)'s.
            r["h_launches"] = launches["mistral_int8"][key]
        if key in ("decode_attn_int8_tail", "tail_flush_int8",
                   "matmul_int8_wo", "verify_attn_fused.int8"):
            # K1, K3, K4 and V1's fused int8 entry serve path (K) too.
            r["k_launches"] = launches["http_serve"][key]
        # Every kernel's launches on path (L), Mixtral-8x7B (0 where the
        # reference's dispatch does not take it there).
        r["l_launches"] = launches["mixtral_int8"].get(key, 0)
        if (r["name"], r.get("mode")) in M_HOME:
            # K5, K6, K7, G1 (int8 scores) and G2 on path (M) / (M-512).
            r["m_launches"] = launches[M_HOME[r["name"], r.get("mode")]][key]
    keys = ("name", "route", "source", "replaces", "launches", "path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("mode", "shape", "device_launches", "m1_ms", "m1_bound_ms",
             "m1_library_ms", "m16_ms", "m16_bound_ms", "m16_library_ms",
             "m32_ms", "m32_bound_ms", "m32_library_ms", "simt_bound_ms",
             "int4pack_ms", "prefill_ms",
             "prefill_library_ms", "prefill_bound_ms", "prefill_8192_ms",
             "prefill_8192_library_ms", "prefill_8192_bound_ms",
             "decode_ms", "f32_max_abs_err",
             "f32_ms", "f32_plain_ms", "f32_bound_ms",
             "f32_device_launches", "h_max_abs_err", "h_ms", "h_plain_ms",
             "h_bound_ms", "h_device_launches", "h_launches",
             "bf16_max_abs_err",
             "bf16_ms", "bf16_plain_ms", "bf16_bound_ms", "bf16_library_ms",
             "bf16_device_launches", "b3_max_abs_err", "b3_ms",
             "b3_plain_ms", "b3_bound_ms", "b3_library_ms",
             "b3_device_launches", "gqa_max_abs_err", "gqa_ms",
             "gqa_plain_ms", "gqa_bound_ms", "gqa_library_ms",
             "gqa_device_launches", "nz_max_abs_err", "nz_ms",
             "nz_plain_ms", "nz_bound_ms", "nz_device_launches",
             "exact_q_max_abs_err", "exact_q_ms", "exact_q_plain_ms",
             "m4096", "graph_launches", "k_launches", "l_launches",
             "m_launches") + tuple(f"w_{k}" for k in W_KEYS) \
        + tuple(f"m16_l_{w}_{k}" for w, _ in L_GEMMS for k in ENTRY_KEYS) \
        + tuple(f"l_{k}" for k in ENTRY_KEYS)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in results]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
