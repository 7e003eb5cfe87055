"""Decoder-only transformer LM, GPT-2 family (port of
``rten_tpu/models/transformer.py``: learned positions, LayerNorm,
exact-erf GELU, fused QKV).

The model is a plain class whose methods take the parameter dict, as in
the reference, so the same weights (converted with
:func:`rten_tpu_torch.models.convert.params_from_numpy` or drawn by
:meth:`TransformerLM.init_params`) run through both packages.

Not ported yet, and raising ``NotImplementedError``: RoPE, RMSNorm,
SwiGLU, bf16 compute, ``scan_layers``, int4 weights, paged caches and
chunked verify (ROADMAP.md Queue 1 item 11), MoE (item 13), meshes (item
14), and decode on a cache without a tail window on CUDA (the f32/bf16-cache
and no-tail int8 paths, items 5 and 6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..generate.kv_cache import KVCache
from ..kernels.attention import attn_reference, decode_attn_int8_tail
from ..kernels.gemm import (head_argmax_int8, matmul_int8, matmul_int8_wo,
                            pad_cols)
from ..kernels.quant import abs_max_quantize_int8


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's config fields that this slice reads, so a config
    builds identically in both packages; values outside the GPT-2 family
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
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "float32"
    use_pallas: bool = True        # read only by the engine's tail gate
    scan_layers: bool = False
    n_experts: int = 0
    decode_attn: str = "auto"      # read only by the engine's tail gate
    fused_append: bool = False

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
    def tiny_test(**kw):
        """Small config for tests."""
        return TransformerConfig(**{**dict(
            vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
            max_seq_len=128, pos="learned", norm="layernorm", act="gelu"),
            **kw})


def _check_supported(cfg: TransformerConfig):
    unported = [
        (cfg.pos != "learned", "RoPE", "Queue 1 item 11, Llama family"),
        (cfg.norm != "layernorm", "RMSNorm",
         "Queue 1 item 11, Llama family"),
        (cfg.act != "gelu", "SwiGLU", "Queue 1 item 11, Llama family"),
        (cfg.n_experts > 0, "MoE", "Queue 1 item 13, moe.py"),
        (cfg.scan_layers, "scan_layers", "Queue 1 item 11"),
        (cfg.dtype != "float32", "bf16 compute", "Queue 1 item 11"),
        (cfg.fused_append, "fused_append", "Queue 1 item 11"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


@dataclass
class QuantWeight:
    """A linear weight in int8 per-output-channel storage: ``data`` int8
    [K, N_pad] (columns padded to a multiple of 8, see
    :func:`rten_tpu_torch.kernels.gemm.pad_cols`), ``scales`` f32 [N_pad],
    ``n`` the logical N."""
    kind: str
    data: torch.Tensor
    scales: torch.Tensor
    n: int = 0


# Below this many weight elements, decode-size (M <= 64) int8 linears run
# as a bf16 dot; at or above it they take the weight-only kernel — the
# reference's dispatch (transformer.py:162-182), kept so both packages take
# the same numerics at the same shapes.
WO_KERNEL_MIN_ELEMENTS = 8 * 1024 * 1024


def linear(x, w, bias=None):
    """x @ w (+ bias), dispatching on weight storage like
    ``rten_tpu.models.transformer.linear`` (:165-230)."""
    if isinstance(w, QuantWeight):
        if w.kind != "int8":
            raise NotImplementedError(
                f"{w.kind} weights are not ported yet (ROADMAP.md Queue 1 "
                f"item 11, int4-words weights)")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        m = x2.shape[0]
        if m <= 64 and w.data.shape[0] * w.n < WO_KERNEL_MIN_ELEMENTS:
            # bf16 dot: products of bf16 values are exact in f32.
            acc = x2.to(torch.bfloat16).to(torch.float32) @ \
                w.data.to(torch.float32)
            out = acc * w.scales[None, :]
        elif m <= 64:
            out = matmul_int8_wo(x2.contiguous(), w.data, w.scales)
        else:
            # Per-tensor dynamic activation quantization over the whole
            # (padded) group, then the int8 x int8 product.
            absmax = x2.abs().amax()
            x_scale = torch.where(absmax == 0, torch.ones_like(absmax),
                                  absmax / 127.0)
            xq = torch.clamp(torch.round(x2 / x_scale), -127,
                             127).to(torch.int8)
            out = matmul_int8(xq, w.data, x_scale, w.scales)
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


def quantize_weights(params, kind="int8"):
    """Convert every 2-D projection weight to int8 per-channel storage;
    embeddings and norms stay float. A tied model gets a separate int8
    ``lm_head`` built from ``embed.T`` (transformer.py:290-296)."""
    if kind != "int8":
        raise NotImplementedError(
            f"{kind} weights are not ported yet (ROADMAP.md Queue 1 item 11)")

    def walk(obj, name):
        if isinstance(obj, dict):
            return {k: walk(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v, str(i)) for i, v in enumerate(obj)]
        if (isinstance(obj, torch.Tensor) and obj.dim() == 2
                and "embed" not in name and "pos" not in name
                and name != "router"):
            return _quant_int8(obj)
        return obj

    out = walk(params, "")
    if "embed" in out and "lm_head" not in out:
        out["lm_head"] = _quant_int8(out["embed"].T)
    return out


def _norm(cfg, x, scale, bias):
    # Statistics in f32 (the reference's rule under any compute dtype).
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + cfg.layer_norm_eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


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
        params = {"embed": dense((cfg.vocab_size, d)),
                  "ln_f_scale": const(1.0, d), "layers": [],
                  "ln_f_bias": const(0.0, d),
                  "pos_embed": dense((cfg.max_seq_len, d))}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense((d, cfg.vocab_size))
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "ln1_scale": const(1.0, d),
                "wqkv": dense((d, (h + 2 * kvh) * hd)),
                "wo": dense((h * hd, d)),
                "ln2_scale": const(1.0, d),
                "ln1_bias": const(0.0, d),
                "ln2_bias": const(0.0, d),
                "bqkv": const(0.0, (h + 2 * kvh) * hd),
                "bo": const(0.0, d),
                "w_up": dense((d, dff)),
                "b_up": const(0.0, dff),
                "w_down": dense((dff, d)),
                "b_down": const(0.0, d),
            })
        return params

    # -- forward -----------------------------------------------------------

    def _decode_attn(self, q3, cache, layer_idx):
        """Single-query attention over the cache. A tail cache is read by
        the tail kernel only; q3 [B, H, D] → [B, H, D]."""
        if cache.tail is not None:
            return decode_attn_int8_tail(
                q3, cache.kv[layer_idx], cache.scales[layer_idx],
                cache.lengths + 1, cache.tail[layer_idx],
                cache.tail_count + 1)
        if q3.device.type != "cpu":
            raise NotImplementedError(
                "decode on a cache without a tail window is not ported to "
                "CUDA yet (ROADMAP.md Queue 1 items 5 and 6: the "
                "f32/bf16-cache path and the no-tail int8 path)")
        return _plain_decode_attn(q3, cache, layer_idx)

    def _attention(self, layer_params, x, cache, layer_idx):
        cfg = self.config
        b, s, _ = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = linear(x, layer_params["wqkv"], layer_params.get("bqkv"))
        q = qkv[..., :h * hd].reshape(b, s, h, hd).transpose(1, 2)
        k = qkv[..., h * hd:(h + kvh) * hd].reshape(b, s, kvh,
                                                    hd).transpose(1, 2)
        v = qkv[..., (h + kvh) * hd:].reshape(b, s, kvh, hd).transpose(1, 2)
        if cache is not None:
            cache = cache.append(layer_idx, k, v,
                                 position=None if s == 1 else 0)
        if s == 1 and cache is not None:
            out = self._decode_attn(q[:, :, 0].contiguous(), cache,
                                    layer_idx)[:, :, None]
        else:
            if kvh != h:
                k = k.repeat_interleave(h // kvh, dim=1)
                v = v.repeat_interleave(h // kvh, dim=1)
            out = attn_reference(q, k, v, True, 1.0 / math.sqrt(hd))
        out = out.transpose(1, 2).reshape(b, s, h * hd)
        return linear(out, layer_params["wo"], layer_params.get("bo")), cache

    def _mlp(self, layer_params, x):
        hidden = linear(x, layer_params["w_up"], layer_params.get("b_up"))
        hidden = torch.nn.functional.gelu(hidden, approximate="none")
        return linear(hidden, layer_params["w_down"],
                      layer_params.get("b_down"))

    def _hidden_states(self, params, tokens, cache=None):
        """The stack through the final norm. Returns (hidden [B, S, D],
        advanced cache)."""
        cfg = self.config
        tokens = tokens.to(torch.int64)
        b, s = tokens.shape
        if cache is not None and s == 1:
            positions = cache.lengths[:, None].to(torch.int64)
        else:
            positions = torch.arange(s, device=tokens.device)[None, :]
        # Finished slots keep decoding past the table; clamp the gather.
        positions = positions.clamp(max=cfg.max_seq_len - 1)
        x = params["embed"][tokens] + params["pos_embed"][positions]
        x = x.to(torch.float32)
        for i, layer in enumerate(params["layers"]):
            attn_in = _norm(cfg, x, layer["ln1_scale"], layer.get("ln1_bias"))
            attn_out, cache = self._attention(layer, attn_in, cache, i)
            x = x + attn_out
            mlp_in = _norm(cfg, x, layer["ln2_scale"], layer.get("ln2_bias"))
            x = x + self._mlp(layer, mlp_in)
        x = _norm(cfg, x, params["ln_f_scale"], params.get("ln_f_bias"))
        if cache is not None:
            cache = cache.advance(1 if s == 1 else s)
        return x, cache

    def _head(self, params, x):
        if self.config.tie_embeddings and "lm_head" not in params:
            logits = x @ params["embed"].T.to(x.dtype)
        else:
            logits = linear(x, params["lm_head"])
        return logits.to(torch.float32)

    def forward(self, params, tokens, cache=None, chunk=False):
        """tokens [B, S] int64/int32. Returns (logits [B, S, V], cache)."""
        if chunk:
            raise NotImplementedError(
                "chunked verify is not ported yet (ROADMAP.md Queue 1 "
                "item 11, speculative decoding)")
        x, cache = self._hidden_states(params, tokens, cache)
        return self._head(params, x), cache

    def verify_step(self, params, tokens, cache):
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
        (no [B, V] logits); a float head takes exact logits + argmax.
        Returns (tokens int32 [B], cache)."""
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


def _plain_decode_attn(q3, cache, layer_idx):
    """Decode attention on dequantized cache views (CPU only). A tail
    cache must never get here: its newest tokens live in the window, which
    only the tail kernel reads (the reference raises the same way,
    transformer.py:426-431)."""
    if cache.tail is not None:
        raise ValueError("KV cache has a tail write-buffer but decode "
                         "attention picked the plain reader — only the "
                         "tail kernel reads the window")
    kc, vc = cache.layer_kv(layer_idx)
    h, kvh = q3.shape[1], cache.kv_heads
    if kvh != h:
        kc = kc.repeat_interleave(h // kvh, dim=1)
        vc = vc.repeat_interleave(h // kvh, dim=1)
    out = attn_reference(q3[:, :, None, :], kc.to(q3.dtype),
                         vc.to(q3.dtype), False,
                         1.0 / math.sqrt(cache.head_dim), cache.lengths + 1)
    return out[:, :, 0]
