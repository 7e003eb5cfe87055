"""Encoder-decoder transformer, Whisper-class (port of
``rten_tpu/models/encoder_decoder.py``).

A bidirectional encoder over input features (log-mel frames through
Whisper's two-conv frontend, or a linear projection) and an autoregressive
decoder with KV-cached self-attention and cross-attention over the encoder
memory. The cross K/V are computed once per request (:meth:`cross_kv`) and
passed to every decode step.

Attention follows the reference's choices:

* the encoder's and a multi-token decode's self-attention take
  ``flash_attention`` where the reference's kernel runs
  (:func:`~rten_tpu_torch.kernels.attention.flash_attention_takes`) and
  ``attn_reference`` elsewhere (head_dim 64, Whisper's, is always the
  latter); a multi-token decode attends within its chunk only;
* cross-attention is always ``attn_reference`` over the stored K/V;
* a one-token decode step with a cache runs the model's own dispatch
  (encoder_decoder.py:210-240, :func:`decode_attn_choice`): K6
  (``decode_attn_float``) on a float cache, G1
  (``decode_attn_grouped_int8``, exact q or int8 scores) or G2
  (``decode_attn_fused_int8``) on an int8 cache; the new row is appended
  first by K5 (``kv_append``) or K7 (``kv_append_int8``).

``log_mel_spectrogram`` is the reference's host-side numpy, copied.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..generate.kv_cache import KVCache
from ..kernels.attention import (_grouped_or_fused, attn_reference,
                                 decode_attn_float, decode_attn_fused_int8,
                                 decode_attn_grouped_int8, flash_attention,
                                 flash_attention_takes)
from ..ops.common import full_f32
from .convert import params_from_numpy
from .transformer import _norm, linear


@dataclass(frozen=True)
class EncoderDecoderConfig:
    """The reference's config fields, so a config builds identically in
    both packages. With ``conv_frontend``, ``max_source_len`` is the
    length after the stride-2 conv (Whisper's n_audio_ctx)."""
    vocab_size: int = 1000
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    n_heads: int = 8
    d_model: int = 256
    d_ff: int = 1024
    n_mels: int = 80
    max_source_len: int = 1500
    max_target_len: int = 448
    norm: str = "layernorm"
    layer_norm_eps: float = 1e-5
    use_pallas: bool = True        # False: attn_reference everywhere
    conv_frontend: bool = False

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @staticmethod
    def whisper_small(**kw):
        """Whisper-small's shape (``tools/bench_whisper.py``'s)."""
        return EncoderDecoderConfig(**{**dict(
            vocab_size=51865, n_enc_layers=12, n_dec_layers=12, n_heads=12,
            d_model=768, d_ff=3072, n_mels=80, max_source_len=1500,
            max_target_len=448, conv_frontend=True), **kw})

    @staticmethod
    def tiny_test(**kw):
        return EncoderDecoderConfig(**{**dict(
            vocab_size=64, n_enc_layers=2, n_dec_layers=2, n_heads=4,
            d_model=64, d_ff=128, n_mels=16, max_source_len=32,
            max_target_len=32), **kw})


def decode_attn_choice(batch, cap, quantized):
    """The kernel of a one-token decode step, as the reference's decoder
    picks it (encoder_decoder.py:210-240, then ``flash_decode_grouped``'s
    own fallback, attention.py:1062-1065): a group from (16, 8, 4, 2) on an
    int8 cache and (8, 4, 2) on a float one, the first with ``b % g == 0``
    and ``b >= 2g``; ``block_k`` 128 on an int8 cache (its scales are
    always packed there) and 64 on a float one; int8 scores only below
    group 16. Returns (kind, group): "grouped" (K6 on a float cache, G1
    with exact q on an int8 one), "grouped_scores" (G1 with int8 scores)
    or "fused" (K6, or G2 on an int8 cache; group 0)."""
    groups = (16, 8, 4, 2) if quantized else (8, 4, 2)
    group = next((g for g in groups if batch % g == 0 and batch >= 2 * g), 0)
    if not group:
        return "fused", 0
    return _grouped_or_fused(batch, group, cap, 128 if quantized else 64,
                             quantized and group < 16, quant=quantized)


def _gelu(x):
    return F.gelu(x, approximate="none")


class EncoderDecoderLM:
    def __init__(self, config: EncoderDecoderConfig):
        self.config = config

    # -- params ------------------------------------------------------------

    def init_params(self, seed=0, device="cuda") -> dict:
        """Random demo weights drawn in the reference's numpy
        ``RandomState`` order (encoder_decoder.py:63-112): seed 0 gives the
        JAX package's ``init_params`` exactly."""
        cfg = self.config
        rng = np.random.RandomState(seed)
        d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size

        def dense(*shape):
            fan_in = shape[0]
            return (rng.randn(*shape) / math.sqrt(fan_in)).astype(np.float32)

        def attn_block():
            return {
                "ln_scale": np.ones(d, np.float32),
                "ln_bias": np.zeros(d, np.float32),
                "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
                "wo": dense(d, d),
            }

        def mlp_block():
            return {
                "ln_scale": np.ones(d, np.float32),
                "ln_bias": np.zeros(d, np.float32),
                "w_up": dense(d, dff), "b_up": np.zeros(dff, np.float32),
                "w_down": dense(dff, d), "b_down": np.zeros(d, np.float32),
            }

        params = {
            "src_proj": dense(cfg.n_mels, d),
            "src_pos": (rng.randn(cfg.max_source_len, d) * 0.02
                        ).astype(np.float32),
            **({"conv1_w": (rng.randn(3, cfg.n_mels, d)
                            / math.sqrt(3 * cfg.n_mels)
                            ).astype(np.float32),
                "conv1_b": np.zeros(d, np.float32),
                "conv2_w": (rng.randn(3, d, d) / math.sqrt(3 * d)
                            ).astype(np.float32),
                "conv2_b": np.zeros(d, np.float32)}
               if cfg.conv_frontend else {}),
            "tgt_embed": (rng.randn(v, d) * 0.02).astype(np.float32),
            "tgt_pos": (rng.randn(cfg.max_target_len, d) * 0.02
                        ).astype(np.float32),
            "enc_ln_scale": np.ones(d, np.float32),
            "enc_ln_bias": np.zeros(d, np.float32),
            "dec_ln_scale": np.ones(d, np.float32),
            "dec_ln_bias": np.zeros(d, np.float32),
            "encoder": [{"attn": attn_block(), "mlp": mlp_block()}
                        for _ in range(cfg.n_enc_layers)],
            "decoder": [{"self_attn": attn_block(),
                         "cross_attn": attn_block(), "mlp": mlp_block()}
                        for _ in range(cfg.n_dec_layers)],
        }
        return params_from_numpy(params, device)

    # -- attention helpers ---------------------------------------------------

    def _heads(self, x, b, s):
        cfg = self.config
        return x.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    def _merge(self, x, b, s):
        return x.transpose(1, 2).reshape(b, s, self.config.d_model)

    def _attend(self, q, k, v, causal):
        """Self-attention of S queries over the same S keys:
        ``flash_attention`` at the shapes where the reference's kernel
        runs, else the reference's plain path."""
        cfg = self.config
        s, hd = q.shape[2], cfg.head_dim
        if cfg.use_pallas and flash_attention_takes(s, s, hd):
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal)
        return attn_reference(q, k, v, causal, 1.0 / math.sqrt(hd))

    def _qkv(self, p, x):
        b, s, _ = x.shape
        return tuple(self._heads(linear(x, p[w], p.get(bias)), b, s)
                     for w, bias in (("wq", "bq"), ("wk", "bk"),
                                     ("wv", "bv")))

    def _out(self, p, out, b, s):
        return linear(self._merge(out, b, s), p["wo"], p.get("bo"))

    def _mlp(self, p, x):
        h = _gelu(linear(x, p["w_up"], p["b_up"]))
        return linear(h, p["w_down"], p["b_down"])

    def _decode_attn(self, q3, cache, i):
        """One query per sequence over layer ``i`` of the cache, through
        the kernel that :func:`decode_attn_choice` names."""
        lengths = cache.lengths + 1
        kind, _ = decode_attn_choice(q3.shape[0], cache.capacity,
                                     cache.quantized)
        if not cache.quantized:
            return decode_attn_float(q3, cache.kv[i], lengths)
        kv, scales = cache.kv[i], cache.scales[i]
        if kind == "fused":
            return decode_attn_fused_int8(q3, kv, scales, lengths)
        return decode_attn_grouped_int8(q3, kv, scales, lengths,
                                        int8_scores=kind == "grouped_scores")

    # -- encoder -------------------------------------------------------------

    def _frontend(self, params, features):
        """Whisper's conv frontend (encoder_decoder.py:149-162): conv1
        (k 3, pad 1) + exact GELU, conv2 (k 3, stride 2, pad 1) + exact
        GELU; weights stored [k, in, out] ("NHC"/"HIO"), torch's
        [out, in, k] permuted. features [B, S, n_mels] → [B, S', d]."""
        x = features.transpose(1, 2)                      # [B, C, S]
        for i, stride in ((1, 1), (2, 2)):
            x = F.conv1d(x, params[f"conv{i}_w"].permute(2, 1, 0), None,
                         stride, 1)
            x = _gelu(x + params[f"conv{i}_b"][:, None])
        return x.transpose(1, 2)

    def encode(self, params, features):
        """features [B, S_src, n_mels] → memory [B, S_src', d]."""
        cfg = self.config
        with full_f32():
            if cfg.conv_frontend:
                x = self._frontend(params, features)
            else:
                x = linear(features, params["src_proj"])
            b, s, _ = x.shape
            x = x + params["src_pos"][None, :s]
            for layer in params["encoder"]:
                a = layer["attn"]
                q, k, v = self._qkv(a, _norm(cfg, x, a["ln_scale"],
                                             a["ln_bias"]))
                x = x + self._out(a, self._attend(q, k, v, False), b, s)
                m = layer["mlp"]
                x = x + self._mlp(m, _norm(cfg, x, m["ln_scale"],
                                           m["ln_bias"]))
            return _norm(cfg, x, params["enc_ln_scale"],
                         params["enc_ln_bias"])

    def cross_kv(self, params, memory):
        """Per-decoder-layer cross-attention (K, V) [B, H, S_src, D] from
        the encoder memory, computed once per request."""
        b, s, _ = memory.shape
        out = []
        with full_f32():
            for layer in params["decoder"]:
                c = layer["cross_attn"]
                out.append((self._heads(linear(memory, c["wk"], c.get("bk")),
                                        b, s),
                            self._heads(linear(memory, c["wv"], c.get("bv")),
                                        b, s)))
        return out

    # -- decoder -------------------------------------------------------------

    def decode(self, params, tokens, cross, cache, positions=None):
        """tokens [B, S]; ``cross``: the per-layer (K, V) of
        :meth:`cross_kv`; ``cache``: the self-attention KVCache or None.
        A one-token step with a cache appends at each sequence's depth and
        attends over the cache; S > 1 writes the cache from position 0 and
        attends within the chunk. Returns (logits f32 [B, S, V], the cache
        advanced by S)."""
        cfg = self.config
        tokens = tokens.to(torch.int64)
        b, s = tokens.shape
        dev = tokens.device
        if positions is None:
            if cache is not None and s == 1:
                positions = cache.lengths[:, None].to(torch.int64)
            else:
                positions = torch.arange(s, device=dev)[None].expand(b, s)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        with full_f32():
            # Past the position table the reference's gather gives NaN
            # (jnp.take's fill mode); the port clamps, so a CUDA gather
            # never reads out of range.
            x = params["tgt_embed"][tokens] + params["tgt_pos"][
                positions.clamp(max=cfg.max_target_len - 1)]
            for i, layer in enumerate(params["decoder"]):
                sa = layer["self_attn"]
                q, k, v = self._qkv(sa, _norm(cfg, x, sa["ln_scale"],
                                              sa["ln_bias"]))
                if cache is not None:
                    cache = cache.append(i, k, v,
                                         position=0 if s > 1 else None)
                if s == 1 and cache is not None:
                    if cfg.use_pallas:
                        out = self._decode_attn(q[:, :, 0].contiguous(),
                                                cache, i)[:, :, None]
                    else:
                        kc, vc = cache.layer_kv(i)
                        out = attn_reference(q, kc, vc, False, scale,
                                             cache.lengths + 1)
                else:
                    out = self._attend(q, k, v, True)
                x = x + self._out(sa, out, b, s)

                ca = layer["cross_attn"]
                cross_in = _norm(cfg, x, ca["ln_scale"], ca["ln_bias"])
                qc = self._heads(linear(cross_in, ca["wq"], ca.get("bq")),
                                 b, s)
                ck, cv = cross[i]
                out = attn_reference(qc, ck, cv, False, scale)
                x = x + self._out(ca, out, b, s)

                m = layer["mlp"]
                x = x + self._mlp(m, _norm(cfg, x, m["ln_scale"],
                                           m["ln_bias"]))
            x = _norm(cfg, x, params["dec_ln_scale"], params["dec_ln_bias"])
            logits = x @ params["tgt_embed"].T
        if cache is not None:
            cache = cache.advance(s)
        return logits, cache

    def new_cache(self, batch, capacity=None, quantized=False,
                  cache_dtype=None, device="cuda"):
        """The self-attention cache: f32 (or ``cache_dtype``), or int8 with
        per-(token, head) scales; ``capacity`` defaults to
        ``max_target_len``."""
        cfg = self.config
        dtype = getattr(torch, cache_dtype) if cache_dtype else torch.float32
        return KVCache.create(batch, cfg.n_dec_layers, cfg.n_heads,
                              capacity or cfg.max_target_len, cfg.head_dim,
                              dtype=dtype, quantized=quantized,
                              device=resolve_device(device))

    # -- generation ----------------------------------------------------------

    def _step(self, params, cur, cross, cache):
        logits, cache = self.decode(params, cur[:, None], cross, cache)
        return torch.argmax(logits[:, -1], dim=-1), cache

    def generate(self, params, features, start_token, max_tokens=32,
                 eos_token=None, quantized_cache=False, burst=1):
        """Greedy transcription (encoder_decoder.py:282-360): encode once,
        then cached decode steps. ``quantized_cache``: an int8
        self-attention cache. ``burst`` > 1 runs that many steps between
        host syncs (the reference scans them on the device); tokens past
        ``max_tokens`` or an all-``eos_token`` row are dropped on the host,
        so the tokens equal the stepwise loop's. Returns int32
        [B, max_tokens] (fewer columns after an early stop)."""
        cross = self.cross_kv(params, self.encode(params, features))
        b = features.shape[0]
        cache = self.new_cache(b, quantized=quantized_cache,
                               device=features.device)
        cur = torch.full((b,), start_token, dtype=torch.int64,
                         device=features.device)
        cur, cache = self._step(params, cur, cross, cache)
        out = [cur.cpu().numpy().astype(np.int32)]
        stopped = eos_token is not None and (out[-1] == eos_token).all()
        while len(out) < max_tokens and not stopped:
            steps = []
            for _ in range(max(burst, 1)):
                cur, cache = self._step(params, cur, cross, cache)
                steps.append(cur)
            for row in torch.stack(steps).cpu().numpy().astype(np.int32):
                out.append(row)
                if eos_token is not None and (row == eos_token).all():
                    stopped = True
                    break
                if len(out) >= max_tokens:
                    break
        return np.stack(out[:max_tokens], axis=1)


def log_mel_spectrogram(audio, sample_rate=16000, n_mels=80, n_fft=400,
                        hop=160):
    """Whisper-style log-mel features from mono PCM (host-side numpy, the
    reference's, copied)."""
    audio = np.asarray(audio, np.float32)
    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + max(0, (len(audio) - n_fft)) // hop
    frames = np.stack([audio[i * hop:i * hop + n_fft] * window
                       for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2

    # Triangular mel filter bank.
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0), hz_to_mel(sample_rate / 2),
                                    n_mels + 2))
    bins = np.floor((n_fft + 1) * mel_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, spec.shape[-1]), np.float32)
    for m in range(1, n_mels + 1):
        lo, center, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, center):
            if center > lo:
                fb[m - 1, k] = (k - lo) / (center - lo)
        for k in range(center, hi):
            if hi > center:
                fb[m - 1, k] = (hi - k) / (hi - center)
    mel = spec @ fb.T
    log_mel = np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 8.0)
    return ((log_mel + 4.0) / 4.0).astype(np.float32)
