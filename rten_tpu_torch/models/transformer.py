"""Decoder-only transformer LM (port of ``rten_tpu/models/transformer.py``):
the GPT-2 family (learned positions, LayerNorm, exact-erf GELU) and the
Llama family (RoPE, RMSNorm, SwiGLU, grouped-query attention, untied head),
with a fused QKV projection in both.

The model is a plain class whose methods take the parameter dict, as in
the reference, so the same weights (converted with
:func:`rten_tpu_torch.models.convert.params_from_numpy` or drawn by
:meth:`TransformerLM.init_params`) run through both packages. Weights may
be float, int8 per channel or group-wise int4 (word- or byte-packed); see
:func:`linear`.

Prefill attention takes ``flash_attention`` where the reference's does
(head_dim 128 and prompts of 128 tokens or more, transformer.py:792-800;
:func:`~rten_tpu_torch.kernels.attention.flash_attention_takes`) and
``attn_reference`` elsewhere. Decode attention follows the reference's
automatic choice (``_pallas_decode_attn``, transformer.py:366-492): an int8
cache with the tail window reads through ``decode_attn_int8_tail``; a float
(f32 or bf16) cache through ``decode_attn_float``, or
``decode_attn_flat_float`` where ``decode_attn="flat"`` takes the float
mode of ``flash_decode_flat`` (see
:func:`~rten_tpu_torch.kernels.attention.float_decode_kernel`), or, with
``fused_append`` where the reference fuses it (transformer.py:650-663),
through ``decode_attn_grouped_append``, which also writes the new row; an
int8 cache without a tail through ``decode_attn_int8``,
``decode_attn_grouped_int8`` or ``decode_attn_fused_int8``, as
:func:`~rten_tpu_torch.kernels.attention.int8_decode_kernel` chooses. A
block-paged cache (:meth:`TransformerLM.new_paged_cache`) follows
``_pallas_paged_decode_attn`` (transformer.py:495-524): see
:func:`_paged_decode_attn`. Chunked verify (:meth:`TransformerLM.
verify_step`, speculative decoding) follows transformer.py:741-772: see
:func:`_verify_attn`.

Not ported yet, and raising ``NotImplementedError`` naming its ROADMAP.md
item: bf16 compute, ``scan_layers`` and MoE.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..generate.kv_cache import KVCache
from ..generate.paged_cache import PagedKVCache
from ..kernels.attention import (attn_reference, decode_attn_flat_float,
                                 decode_attn_float, decode_attn_fused_int8,
                                 decode_attn_grouped_append,
                                 decode_attn_grouped_int8, decode_attn_int8,
                                 decode_attn_int8_tail, decode_attn_paged,
                                 decode_attn_paged_grid,
                                 decode_attn_paged_int8, flash_attention,
                                 flash_attention_takes, flat_q_bf16,
                                 float_decode_kernel,
                                 group_for, int8_decode_kernel,
                                 verify_attn_fused,
                                 verify_attn_grouped)
from ..kernels.gemm import (head_argmax_int8, matmul_int4, matmul_int4_words,
                            matmul_int4_words_int8, matmul_int8,
                            matmul_int8_wo, pad_cols)
from ..kernels.quant import (INT4_GROUP, abs_max_quantize_int8,
                             dequantize_int4_groupwise, dequantize_int4_words,
                             quantize_int4_groupwise, quantize_int4_words)


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's config fields that the port reads, so a config
    builds identically in both packages; the features that are not ported
    raise when a model is built."""
    vocab_size: int = 50257
    n_layers: int = 12
    n_heads: int = 12
    kv_heads: int | None = None
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 1024
    pos: str = "learned"
    norm: str = "layernorm"
    act: str = "gelu"
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "float32"
    use_pallas: bool = True        # the tail gate, fused_append
    scan_layers: bool = False
    n_experts: int = 0
    decode_attn: str = "auto"      # the tail gate and decode dispatch
    fused_append: bool = False
    quant_int8_scores: bool = True

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def n_kv_heads(self):
        return self.kv_heads or self.n_heads

    @staticmethod
    def gpt2(**kw):
        return TransformerConfig(**{**dict(
            vocab_size=50257, n_layers=12, n_heads=12, d_model=768,
            d_ff=3072, max_seq_len=1024, pos="learned", norm="layernorm",
            act="gelu"), **kw})

    @staticmethod
    def tiny_llama(**kw):
        return TransformerConfig(**{**dict(
            vocab_size=32000, n_layers=22, n_heads=32, kv_heads=4,
            d_model=2048, d_ff=5632, max_seq_len=2048, pos="rope",
            norm="rmsnorm", act="swiglu", tie_embeddings=False,
            rope_theta=10000.0), **kw})

    @staticmethod
    def mixtral(**kw):
        """Mixtral-8x7B's shape; with ``n_experts=0`` it is
        Mistral-7B-v0.2's (head_dim 128, 32 query heads over 8 KV
        heads). MoE raises: it is not ported."""
        return TransformerConfig(**{**dict(
            vocab_size=32000, n_layers=32, n_heads=32, kv_heads=8,
            d_model=4096, d_ff=14336, max_seq_len=4096, pos="rope",
            norm="rmsnorm", act="swiglu", tie_embeddings=False,
            rope_theta=1e6, n_experts=8), **kw})

    @staticmethod
    def tiny_test(**kw):
        """Small config for tests."""
        return TransformerConfig(**{**dict(
            vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
            max_seq_len=128, pos="learned", norm="layernorm", act="gelu"),
            **kw})


def _check_supported(cfg: TransformerConfig):
    unported = [
        (cfg.n_experts > 0, "MoE", "Queue 1, serving breadth: MoE"),
        (cfg.scan_layers, "scan_layers",
         "Queue 1, serving breadth: bf16 compute and scan_layers"),
        (cfg.dtype != "float32", "bf16 compute",
         "Queue 1, serving breadth: bf16 compute and scan_layers"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


@dataclass
class QuantWeight:
    """A linear weight in quantized storage. ``kind`` "int8": ``data`` int8
    [K, N_pad] per output channel (columns padded to a multiple of 8, see
    :func:`rten_tpu_torch.kernels.gemm.pad_cols`), ``scales`` f32 [N_pad].
    ``kind`` "int4": group-wise, ``data`` int32 words [K/4, N_pad/2] or
    uint8 tile-planar bytes [K, N_pad/2] (N padded to 256), ``scales`` f32
    [K / group, N_pad]. ``n`` is the logical N."""
    kind: str
    data: torch.Tensor
    scales: torch.Tensor
    n: int = 0
    group: int = INT4_GROUP


# Below this many weight elements, decode-size (M <= 64) int8 linears run
# as a bf16 dot; at or above it they take the weight-only kernel — the
# reference's dispatch (transformer.py:162-182), kept so both packages take
# the same numerics at the same shapes. Word-packed int4 weights take their
# kernel from a quarter of it (transformer.py:202-206).
WO_KERNEL_MIN_ELEMENTS = 8 * 1024 * 1024


def _bf16_dot(x2, w):
    """x2 [M, K] f32 rounded to bf16 times a weight holding bf16 values,
    accumulated in f32 (products of bf16 values are exact in f32)."""
    return x2.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def _linear_int8(x2, w):
    m = x2.shape[0]
    if m <= 64 and w.data.shape[0] * w.n < WO_KERNEL_MIN_ELEMENTS:
        return _bf16_dot(x2, w.data) * w.scales[None, :]
    if m <= 64:
        return matmul_int8_wo(x2.contiguous(), w.data, w.scales)
    # Per-tensor dynamic activation quantization over the whole (padded)
    # group, then the int8 x int8 product.
    absmax = x2.abs().amax()
    x_scale = torch.where(absmax == 0, torch.ones_like(absmax),
                          absmax / torch.full_like(absmax, 127.0))
    xq = torch.clamp(torch.round(x2 / x_scale), -127, 127).to(torch.int8)
    return matmul_int8(xq, w.data, x_scale, w.scales)


def int4_takes_kernel(m, w):
    """Whether an int4 linear of ``m`` rows runs its layout's kernel: at
    M <= 64 a weight under the size threshold runs as a bf16 dot on its
    dequantized copy instead (transformer.py:202-206)."""
    words = w.data.dtype == torch.int32
    min_elems = (WO_KERNEL_MIN_ELEMENTS // 4 if words
                 else WO_KERNEL_MIN_ELEMENTS)
    return m > 64 or w.data.numel() * (8 if words else 2) >= min_elems


def _linear_int4(x2, w):
    """The reference's int4 branch (transformer.py:191-221): x zero-padded
    to the packed K, then a bf16 dot on the dequantized weight or the
    kernel of its layout (:func:`int4_takes_kernel`; the word kernel's dot
    mode from ``RTEN_INT4_DOT``, read at call time)."""
    words = w.data.dtype == torch.int32
    k_packed = w.data.shape[0] * (4 if words else 1)
    if x2.shape[1] < k_packed:
        x2 = torch.nn.functional.pad(x2, (0, k_packed - x2.shape[1]))
    if not int4_takes_kernel(x2.shape[0], w):
        deq = dequantize_int4_words if words else dequantize_int4_groupwise
        return _bf16_dot(x2, deq(w.data, w.scales, w.group).to(
            torch.bfloat16))
    x2 = x2.contiguous()
    if not words:
        return matmul_int4(x2, w.data, w.scales, w.group)
    mode = os.environ.get("RTEN_INT4_DOT", "bf16")
    kernel = {"bf16": matmul_int4_words, "int8": matmul_int4_words_int8}
    if mode not in kernel:
        raise ValueError(f"RTEN_INT4_DOT={mode!r}: expected 'bf16' or 'int8'")
    return kernel[mode](x2, w.data, w.scales, w.group)


def linear(x, w, bias=None):
    """x @ w (+ bias), dispatching on weight storage like
    ``rten_tpu.models.transformer.linear`` (:165-230)."""
    if isinstance(w, QuantWeight):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if w.kind == "int8":
            out = _linear_int8(x2, w)
        elif w.kind == "int4":
            out = _linear_int4(x2, w)
        else:
            raise ValueError(w.kind)
        out = out[:, :w.n].reshape(*lead, -1).to(x.dtype)
    else:
        out = torch.matmul(x, w).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def _quant_int8(w):
    q, scales = abs_max_quantize_int8(w, axis=0)
    n = q.shape[1]
    q, scales = pad_cols(q, scales)
    return QuantWeight("int8", q, scales, n)


def quantize_weights(params, kind="int8", group=INT4_GROUP,
                     int4_packing="words"):
    """Convert every 2-D projection weight to quantized storage
    (transformer.py:233-296): int8 per channel, or group-wise int4 in the
    word (default) or byte layout. Embeddings and norms stay float. A tied
    model gets a separate int8 ``lm_head`` built from ``embed.T``, whatever
    ``kind`` (transformer.py:290-296)."""
    if kind not in ("int8", "int4"):
        raise ValueError(f"kind must be 'int8' or 'int4', got {kind!r}")
    if int4_packing not in ("words", "bytes"):
        raise ValueError(f"int4_packing must be 'words' or 'bytes', got "
                         f"{int4_packing!r}")

    def convert(w):
        if kind == "int8":
            return _quant_int8(w)
        quant = (quantize_int4_words if int4_packing == "words"
                 else quantize_int4_groupwise)
        packed, scales = quant(w, group)
        return QuantWeight("int4", packed, scales, w.shape[1], group)

    def walk(obj, name):
        if isinstance(obj, dict):
            return {k: walk(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v, str(i)) for i, v in enumerate(obj)]
        if (isinstance(obj, torch.Tensor) and obj.dim() == 2
                and "embed" not in name and "pos" not in name
                and name != "router"):
            return convert(obj)
        return obj

    out = walk(params, "")
    if "embed" in out and "lm_head" not in out:
        out["lm_head"] = _quant_int8(out["embed"].T)
    return out


def _norm(cfg, x, scale, bias):
    # Statistics in f32 (the reference's rule under any compute dtype).
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + cfg.layer_norm_eps) * scale).to(
            x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + cfg.layer_norm_eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def _rope_freqs(d, theta, device):
    """freqs = theta^(-i / (D/2)) in f32 (transformer.py:325-336). The
    exponent divides by a tensor: CUDA PyTorch turns a division by a
    Python number into a multiply by its reciprocal, which rounds
    otherwise than the reference's division unless D/2 is a power of
    two."""
    half = d // 2
    i = torch.arange(0, half, dtype=torch.float32, device=device)
    return theta ** (-i / torch.full_like(i, half))


def _rope_tables(positions, d, theta):
    """cos and sin [B, 1, S, D/2] of the rotary angles for positions
    [B, S]."""
    freqs = _rope_freqs(d, theta, positions.device)
    angles = positions.to(torch.float32)[:, None, :, None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """Half-split rotary embedding of x [B, H, S, D] (not interleaved)."""
    d = x.shape[-1]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class TransformerLM:
    def __init__(self, config: TransformerConfig):
        _check_supported(config)
        self.config = config

    # -- parameters --------------------------------------------------------

    def init_params(self, seed=0, device="cuda") -> dict:
        """Random demo weights, drawn in the reference's numpy
        ``default_rng(seed)`` order (transformer.py:547-610), so seed s
        gives the JAX package's ``init_params(PRNGKey(s))`` exactly."""
        dev = resolve_device(device)
        cfg = self.config
        rng = np.random.default_rng(seed)

        def dense(shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32) * 0.02).to(dev)

        def const(value, n):
            return torch.full((n,), value, dtype=torch.float32, device=dev)

        d, dff = cfg.d_model, cfg.d_ff
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        layernorm = cfg.norm == "layernorm"
        params = {"embed": dense((cfg.vocab_size, d)),
                  "ln_f_scale": const(1.0, d), "layers": []}
        if layernorm:
            params["ln_f_bias"] = const(0.0, d)
        if cfg.pos == "learned":
            params["pos_embed"] = dense((cfg.max_seq_len, d))
        if not cfg.tie_embeddings:
            params["lm_head"] = dense((d, cfg.vocab_size))
        for _ in range(cfg.n_layers):
            layer = {"ln1_scale": const(1.0, d),
                     "wqkv": dense((d, (h + 2 * kvh) * hd)),
                     "wo": dense((h * hd, d)),
                     "ln2_scale": const(1.0, d)}
            if layernorm:
                layer.update(ln1_bias=const(0.0, d), ln2_bias=const(0.0, d),
                             bqkv=const(0.0, (h + 2 * kvh) * hd),
                             bo=const(0.0, d))
            if cfg.act == "swiglu":
                layer.update(w_gate=dense((d, dff)), w_up=dense((d, dff)),
                             w_down=dense((dff, d)))
            else:
                layer.update(w_up=dense((d, dff)), b_up=const(0.0, dff),
                             w_down=dense((dff, d)), b_down=const(0.0, d))
            params["layers"].append(layer)
        return params

    def init_int4_params(self, seed=0, device="cuda") -> dict:
        """Random weights of a Llama-family model with every projection in
        int4 words, drawn on ``device`` with a seeded torch.Generator:
        N(0, 0.02^2) as :meth:`init_params` draws them and norms at 1, each
        projection quantized as soon as it is drawn, so no more than one
        f32 matrix exists at a time (a 7B model draws in seconds on the
        card). Not the reference's numpy order: seed s does not give
        :meth:`init_params`'s weights."""
        cfg = self.config
        if not (cfg.norm == "rmsnorm" and cfg.act == "swiglu"
                and cfg.pos == "rope" and not cfg.tie_embeddings):
            raise ValueError("init_int4_params draws Llama-family weights "
                             "(rmsnorm, swiglu, rope, untied lm_head)")
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        d, hd = cfg.d_model, cfg.head_dim

        def dense(k, n):
            return 0.02 * torch.randn((k, n), device=dev, generator=g)

        def int4(k, n):
            packed, scales = quantize_int4_words(dense(k, n))
            return QuantWeight("int4", packed, scales, n, INT4_GROUP)

        def ones():
            return torch.ones(d, device=dev)

        params = {"embed": dense(cfg.vocab_size, d), "ln_f_scale": ones(),
                  "layers": []}
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "ln1_scale": ones(),
                "wqkv": int4(d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
                "wo": int4(cfg.n_heads * hd, d), "ln2_scale": ones(),
                "w_gate": int4(d, cfg.d_ff), "w_up": int4(d, cfg.d_ff),
                "w_down": int4(cfg.d_ff, d)})
        params["lm_head"] = int4(d, cfg.vocab_size)
        return params

    # -- forward -----------------------------------------------------------

    def _decode_attn(self, q3, cache, layer_idx):
        """Single-query attention over the cache; q3 [B, H, D] → [B, H, D].
        A tail cache is read by the tail kernel only."""
        if getattr(cache, "paged", False):
            return _paged_decode_attn(self.config, q3, cache, layer_idx)
        if cache.tail is not None:
            return decode_attn_int8_tail(
                q3, cache.kv[layer_idx], cache.scales[layer_idx],
                cache.lengths + 1, cache.tail[layer_idx],
                cache.tail_count + 1, q_bf16=flat_q_bf16())
        return _cache_decode_attn(self.config, q3, cache, layer_idx)

    def _attention(self, layer_params, x, cache, layer_idx, rope=None,
                   chunk=False):
        """``rope``: the (cos, sin) tables of :func:`_rope_tables`, applied
        to q and k after the QKV split (transformer.py:626-628). ``chunk``:
        the S tokens are a verify chunk appended at each sequence's depth
        and attending to the whole cache (transformer.py:664-671,741-772);
        a one-token chunk is a decode step, as in the reference."""
        cfg = self.config
        b, s, _ = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = linear(x, layer_params["wqkv"], layer_params.get("bqkv"))
        q = qkv[..., :h * hd].reshape(b, s, h, hd).transpose(1, 2)
        k = qkv[..., h * hd:(h + kvh) * hd].reshape(b, s, kvh,
                                                    hd).transpose(1, 2)
        v = qkv[..., (h + kvh) * hd:].reshape(b, s, kvh, hd).transpose(1, 2)
        if rope is not None:
            q, k = _rope(q, *rope), _rope(k, *rope)
        fuse_app = _fused_append_takes(cfg, cache, b, s, chunk)
        if cache is not None and not fuse_app:
            cache = cache.append(layer_idx, k, v,
                                 position=None if chunk or s == 1 else 0)
        if fuse_app:
            # The kernel writes the new row itself (transformer.py:714-725).
            out = decode_attn_grouped_append(
                q[:, :, 0].contiguous(), cache.kv[layer_idx], k, v,
                cache.lengths + 1)[:, :, None]
        elif s == 1 and cache is not None:
            out = self._decode_attn(q[:, :, 0].contiguous(), cache,
                                    layer_idx)[:, :, None]
        elif chunk and cache is not None:
            out = _verify_attn(cfg, q, cache, layer_idx)
        else:
            if kvh != h:
                k = k.repeat_interleave(h // kvh, dim=1)
                v = v.repeat_interleave(h // kvh, dim=1)
            # transformer.py:792-800: flash_attention, whose own fallback
            # sends the shapes it does not take to the plain reference.
            if flash_attention_takes(s, k.shape[2], hd):
                out = flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), True,
                                      1.0 / math.sqrt(hd))
            else:
                out = attn_reference(q, k, v, True, 1.0 / math.sqrt(hd))
        out = out.transpose(1, 2).reshape(b, s, h * hd)
        return linear(out, layer_params["wo"], layer_params.get("bo")), cache

    def _mlp(self, layer_params, x):
        if self.config.act == "swiglu":
            gate = linear(x, layer_params["w_gate"])
            up = linear(x, layer_params["w_up"])
            return linear(torch.nn.functional.silu(gate) * up,
                          layer_params["w_down"])
        hidden = linear(x, layer_params["w_up"], layer_params.get("b_up"))
        hidden = torch.nn.functional.gelu(hidden, approximate="none")
        return linear(hidden, layer_params["w_down"],
                      layer_params.get("b_down"))

    def _hidden_states(self, params, tokens, cache=None, chunk=False):
        """The stack through the final norm. Returns (hidden [B, S, D],
        the cache advanced by S, or with its lengths unchanged for a
        ``chunk`` of S > 1)."""
        cfg = self.config
        tokens = tokens.to(torch.int64)
        b, s = tokens.shape
        if cache is not None and (s == 1 or chunk):
            positions = (cache.lengths[:, None].to(torch.int64)
                         + torch.arange(s, device=tokens.device)[None, :])
        else:
            positions = torch.arange(s, device=tokens.device)[None, :]
        x = params["embed"][tokens]
        rope = None
        if cfg.pos == "learned":
            # Finished slots keep decoding past the table; clamp the gather.
            x = x + params["pos_embed"][positions.clamp(
                max=cfg.max_seq_len - 1)]
        else:
            # RoPE takes the positions unclamped, as the reference does.
            rope = _rope_tables(positions.expand(b, s), cfg.head_dim,
                                cfg.rope_theta)
        x = x.to(torch.float32)
        for i, layer in enumerate(params["layers"]):
            attn_in = _norm(cfg, x, layer["ln1_scale"], layer.get("ln1_bias"))
            attn_out, cache = self._attention(layer, attn_in, cache, i, rope,
                                              chunk)
            x = x + attn_out
            mlp_in = _norm(cfg, x, layer["ln2_scale"], layer.get("ln2_bias"))
            x = x + self._mlp(layer, mlp_in)
        x = _norm(cfg, x, params["ln_f_scale"], params.get("ln_f_bias"))
        if cache is not None and (s == 1 or not chunk):
            cache = cache.advance(s)
        return x, cache

    def _head(self, params, x):
        if self.config.tie_embeddings and "lm_head" not in params:
            logits = x @ params["embed"].T.to(x.dtype)
        else:
            logits = linear(x, params["lm_head"])
        return logits.to(torch.float32)

    def forward(self, params, tokens, cache=None, chunk=False):
        """tokens [B, S] int64/int32. Returns (logits [B, S, V], cache);
        ``chunk``: see :meth:`verify_step`."""
        x, cache = self._hidden_states(params, tokens, cache, chunk)
        return self._head(params, x), cache

    def verify_step(self, params, tokens, cache):
        """Speculative-decoding verification (transformer.py:1293-1302):
        ``tokens`` [B, S], each row the last committed token and S - 1
        drafts, appended at each sequence's depth; the S queries attend to
        the whole cache. Returns (logits [B, S, V], the cache with its
        lengths unchanged): the caller advances each sequence by its
        accepted count, and rows past it are overwritten by later appends
        and masked until then."""
        return self.forward(params, tokens, cache, chunk=True)

    # -- serving entry points ---------------------------------------------

    def prefill(self, params, tokens, cache):
        """Full-prompt forward writing the cache from position 0."""
        return self.forward(params, tokens, cache)

    def prefill_last(self, params, tokens, cache, last_idx):
        """Prefill returning only each row's logits at ``last_idx`` [B]
        ([B, V]); the LM head runs on the B gathered rows only."""
        x, cache = self._hidden_states(params, tokens, cache)
        xl = x[torch.arange(x.shape[0], device=x.device), last_idx]
        return self._head(params, xl), cache

    def decode_step(self, params, tokens, cache):
        """tokens [B] — one token per sequence. Returns (logits [B, V],
        cache)."""
        logits, cache = self.forward(params, tokens[:, None], cache)
        return logits[:, 0], cache

    def decode_step_argmax(self, params, tokens, cache):
        """Greedy decode step through the fused int8 head + argmax kernel
        (no [B, V] logits); a float or int4 head takes its logits + argmax,
        as the reference does (transformer.py:1312-1315). Returns (tokens
        int32 [B], cache)."""
        head = params.get("lm_head")
        if not (isinstance(head, QuantWeight) and head.kind == "int8"):
            logits, cache = self.decode_step(params, tokens, cache)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        x, cache = self._hidden_states(params, tokens[:, None], cache)
        nxt = head_argmax_int8(x[:, 0].to(torch.float32).contiguous(),
                               head.data, head.scales, n_valid=head.n)
        return nxt, cache

    def new_cache(self, batch, capacity=None, quantized=False,
                  cache_dtype=None, tail_window=0, device="cuda"):
        """A cache for ``batch`` sequences; ``tail_window`` > 0 adds the
        bf16 decode window (int8 caches only)."""
        cfg = self.config
        dtype = getattr(torch, cache_dtype) if cache_dtype else torch.float32
        return KVCache.create(batch, cfg.n_layers, cfg.n_kv_heads,
                              capacity or cfg.max_seq_len, cfg.head_dim,
                              dtype=dtype, quantized=quantized,
                              tail_window=tail_window,
                              device=resolve_device(device))

    def new_paged_cache(self, batch, capacity, page_size, n_pages,
                        identity_table=False, quantized=False,
                        device="cuda"):
        """A block-paged cache (``generate/paged_cache.py``) of ``n_pages``
        pages for ``batch`` sequences of up to ``capacity`` tokens. The
        float pool's dtype follows ``config.dtype`` (f32; the reference
        never reads ``cache_dtype`` for a paged cache). With
        ``identity_table`` the table maps pages ``0..B*P-1`` in order — the
        prefill group caches, where every sequence owns its pages."""
        cfg = self.config
        dev = resolve_device(device)
        max_pages = -(-capacity // page_size)
        cache = PagedKVCache.create(cfg.n_layers, n_pages, page_size,
                                    cfg.n_kv_heads, cfg.head_dim, batch,
                                    max_pages, dtype=torch.float32,
                                    quantized=quantized, device=dev)
        if identity_table:
            if n_pages < batch * max_pages:
                raise ValueError(f"an identity table needs {batch} x "
                                 f"{max_pages} pages, the pool has "
                                 f"{n_pages}")
            cache.page_table.copy_(torch.arange(
                batch * max_pages, dtype=torch.int32,
                device=dev).reshape(batch, max_pages))
        return cache


def _paged_decode_attn(cfg, q3, cache, layer_idx):
    """Decode attention on a block-paged cache, chosen as the reference's
    ``_pallas_paged_decode_attn`` chooses (transformer.py:495-524): a batch
    with a group in (8, 4, 2) and ``decode_attn`` "auto" or "grouped" →
    the grouped kernel (``decode_attn_paged`` or ``decode_attn_paged_int8``);
    otherwise an int8 pool → the pages gathered and dequantized, then
    :func:`attn_reference` (the reference's own XLA path, no Pallas kernel
    there either); a float pool → the grid kernel
    (``decode_attn_paged_grid``)."""
    lengths = cache.lengths + 1
    pool, table = cache.fused_layer(layer_idx), cache.page_table
    if (group_for(q3.shape[0])
            and cfg.decode_attn in ("auto", "grouped")):
        if cache.quantized:
            return decode_attn_paged_int8(q3, pool, cache.scales[layer_idx],
                                          table, lengths)
        return decode_attn_paged(q3, pool, table, lengths)
    if cache.quantized:
        h, kvh = q3.shape[1], cache.kv_heads
        kc, vc = cache.layer_kv(layer_idx)
        if kvh != h:
            kc = kc.repeat_interleave(h // kvh, dim=1)
            vc = vc.repeat_interleave(h // kvh, dim=1)
        return attn_reference(q3[:, :, None, :], kc, vc, False,
                              1.0 / math.sqrt(cache.head_dim),
                              lengths)[:, :, 0]
    return decode_attn_paged_grid(q3, pool, table, lengths)


def _fused_append_takes(cfg, cache, b, s, chunk):
    """The reference's fused-append eligibility, to the letter
    (transformer.py:650-663): a single-token decode step on a contiguous
    float cache with ``fused_append`` and Pallas on, ``decode_attn`` "auto"
    or "grouped", a batch with a group in (8, 4, 2), rows of a multiple of
    128 values and a capacity that divides by the grouped block."""
    if not (cfg.fused_append and s == 1 and cache is not None and not chunk
            and cfg.use_pallas):
        return False
    if getattr(cache, "paged", False) or cache.quantized:
        return False
    cap = cache.capacity
    return bool(cfg.decode_attn in ("auto", "grouped") and group_for(b)
                and (cfg.n_kv_heads * cfg.head_dim) % 128 == 0
                and cap % min(128 if cap >= 2048 else 64, cap) == 0)


def _cache_decode_attn(cfg, q3, cache, layer_idx):
    """Decode attention on a cache without a tail window, chosen as the
    reference's automatic dispatch chooses (transformer.py:366-492): a
    float cache → the kernel that :func:`float_decode_kernel` names:
    ``decode_attn_flat_float`` (``flash_decode_flat``'s float mode, q
    rounded to bf16) or ``decode_attn_float`` (the reference's grouped,
    fused and stream float kernels); an int8 cache → the kernel that
    :func:`int8_decode_kernel` names: ``decode_attn_int8``
    (``flash_decode_flat``, ``q_bf16``), ``decode_attn_grouped_int8`` (exact
    q or ``int8_scores``) or ``decode_attn_fused_int8``. A tail cache must
    never get here: its newest tokens live in the window, which only the
    tail kernel reads (the reference raises the same way,
    transformer.py:426-431)."""
    if cache.tail is not None:
        raise ValueError("KV cache has a tail write-buffer but decode "
                         "attention picked a reader without the window — "
                         "only the tail kernel reads it")
    lengths = cache.lengths + 1
    b = q3.shape[0]
    if not cache.quantized:
        # "stream" (flash_decode_stream) has K6's numerics and is held
        # against it by tests/test_torch_decode_paths.py.
        kind, _ = float_decode_kernel(b, q3.shape[1], cache.head_dim,
                                      cache.kv_heads, cache.capacity,
                                      cfg.decode_attn)
        # "flat_exact" (RTEN_FLAT_QBF16=0) is K6's arithmetic.
        attend = decode_attn_flat_float if kind == "flat" else \
            decode_attn_float
        return attend(q3, cache.kv[layer_idx], lengths)
    kind, _ = int8_decode_kernel(b, q3.shape[1], cache.head_dim,
                                 cache.kv_heads, cache.capacity,
                                 cfg.decode_attn, cfg.quant_int8_scores)
    kv, scales = cache.kv[layer_idx], cache.scales[layer_idx]
    if kind in ("flat", "flat_exact"):
        return decode_attn_int8(q3, kv, scales, lengths,
                                q_bf16=kind == "flat")
    if kind == "fused":
        return decode_attn_fused_int8(q3, kv, scales, lengths)
    return decode_attn_grouped_int8(q3, kv, scales, lengths,
                                    int8_scores=kind == "grouped_scores")


def _verify_attn(cfg, q, cache, layer_idx):
    """Chunked-verify attention, chosen as the reference chooses
    (transformer.py:741-772): a batch with a group in (8, 4, 2) and
    ``decode_attn`` "auto" or "grouped" → ``verify_attn_grouped``, every
    other batch → ``verify_attn_fused``; an int8 cache reads through the
    int8 mode. q [B, H, S, D] → [B, H, S, D]. A paged cache raises from
    its append before this runs; a tail cache raises here (its newest
    tokens live in the window, which no verify kernel reads; the
    reference's engine never builds one for speculation)."""
    if cache.tail is not None:
        raise ValueError("chunked verify on a cache with a tail window: "
                         "the verify kernels do not read the window")
    grouped = (group_for(q.shape[0])
               and cfg.decode_attn in ("auto", "grouped"))
    attend = verify_attn_grouped if grouped else verify_attn_fused
    scales = cache.scales[layer_idx] if cache.quantized else None
    out = attend(q.transpose(1, 2).contiguous(), cache.kv[layer_idx],
                 cache.lengths, scales)
    return out.transpose(1, 2)
