"""ViT-family vision encoders (port of ``rten_tpu/models/vit.py``): a plain
ViT (classification, feature extraction) and a DPT-style dense head for
depth estimation.

The patch embedding is one matmul over unfolded patches; the encoder
blocks are pre-norm with exact GELU; attention over the patch tokens takes
``flash_attention`` where the reference's kernel runs
(:func:`~rten_tpu_torch.kernels.attention.flash_attention_takes`) and
``attn_reference`` elsewhere (ViT-S/16's head_dim 64 and 197 tokens are
the latter). Every product is f32 with TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import (attn_reference, flash_attention,
                                 flash_attention_takes)
from ..ops.common import full_f32
from .convert import params_from_numpy
from .transformer import _norm


@dataclass(frozen=True)
class ViTConfig:
    """ViT-S/16 by default (the reference's fields)."""
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 1536
    n_classes: int = 1000
    layer_norm_eps: float = 1e-6
    use_cls_token: bool = True
    use_pallas: bool = True        # False: attn_reference everywhere
    norm: str = "layernorm"        # consumed by _norm

    @property
    def n_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @staticmethod
    def tiny_test(**kw):
        return ViTConfig(**{**dict(image_size=32, patch_size=8,
                                   d_model=64, n_layers=2, n_heads=4,
                                   d_ff=128, n_classes=10), **kw})


def resize_bilinear(x, size):
    """``jax.image.resize(x, (..., *size), "bilinear")`` when upsampling the
    last two axes: half-pixel centres, the edge rows and columns taking
    their nearest source row (the reference renormalises the weights the
    image covers; torch clamps the source index: the same values)."""
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, *x.shape[-2:])
    out = F.interpolate(x4, size=tuple(size), mode="bilinear",
                        align_corners=False)
    return out.reshape(*lead, *size)


class ViT:
    def __init__(self, config: ViTConfig):
        self.config = config

    def init_params(self, seed=0, device="cuda") -> dict:
        """Random demo weights in the reference's numpy ``default_rng``
        order (vit.py:67-102): seed 0 gives the JAX package's
        ``init_params`` exactly."""
        return params_from_numpy(self._numpy_params(seed), device)

    def _numpy_params(self, seed):
        cfg = self.config
        rng = np.random.default_rng(seed)
        d = cfg.d_model

        def dense(*shape):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape, dtype=np.float32)
                    / math.sqrt(fan_in))

        def zeros(*shape):
            return np.zeros(shape, np.float32)

        n_tokens = cfg.n_patches + (1 if cfg.use_cls_token else 0)
        params = {
            "patch_w": dense(cfg.patch_size * cfg.patch_size
                             * cfg.in_channels, d),
            "patch_b": zeros(d),
            "pos_embed": (rng.standard_normal((n_tokens, d),
                                              dtype=np.float32) * 0.02),
            "ln_f_scale": np.ones(d, np.float32),
            "ln_f_bias": zeros(d),
            "head": dense(d, cfg.n_classes),
            "head_b": zeros(cfg.n_classes),
            "layers": [],
        }
        if cfg.use_cls_token:
            params["cls"] = zeros(1, 1, d)
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "ln1_scale": np.ones(d, np.float32), "ln1_bias": zeros(d),
                "wqkv": dense(d, 3 * d), "bqkv": zeros(3 * d),
                "wo": dense(d, d), "bo": zeros(d),
                "ln2_scale": np.ones(d, np.float32), "ln2_bias": zeros(d),
                "w_up": dense(d, cfg.d_ff), "b_up": zeros(cfg.d_ff),
                "w_down": dense(cfg.d_ff, d), "b_down": zeros(d),
            })
        return params

    # -- pieces --------------------------------------------------------------

    def patchify(self, images):
        """[B, C, H, W] → [B, n_patches, P*P*C] (patch rows in (y, x, c)
        order, as the reference unfolds them)."""
        p = self.config.patch_size
        b, c, h, w = images.shape
        x = images.reshape(b, c, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1)            # [B, Hp, Wp, p, p, C]
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def _attention(self, lp, x):
        cfg = self.config
        b, s, d = x.shape
        h, hd = cfg.n_heads, cfg.head_dim
        qkv = x @ lp["wqkv"] + lp["bqkv"]
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        if cfg.use_pallas and flash_attention_takes(s, s, hd):
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), False)
        else:
            out = attn_reference(q, k, v, False, 1.0 / math.sqrt(hd))
        out = out.transpose(1, 2).reshape(b, s, d)
        return out @ lp["wo"] + lp["bo"]

    def encode(self, params, images):
        """[B, C, H, W] → token features [B, n_tokens, d]."""
        cfg = self.config
        with full_f32():
            x = self.patchify(images) @ params["patch_w"] + params["patch_b"]
            if cfg.use_cls_token:
                cls = params["cls"].expand(x.shape[0], 1, cfg.d_model)
                x = torch.cat([cls, x], dim=1)
            x = x + params["pos_embed"][None]
            for lp in params["layers"]:
                x = x + self._attention(
                    lp, _norm(cfg, x, lp["ln1_scale"], lp["ln1_bias"]))
                hidden = (_norm(cfg, x, lp["ln2_scale"], lp["ln2_bias"])
                          @ lp["w_up"] + lp["b_up"])
                x = x + (F.gelu(hidden, approximate="none") @ lp["w_down"]
                         + lp["b_down"])
            return _norm(cfg, x, params["ln_f_scale"], params["ln_f_bias"])

    def classify(self, params, images):
        """Logits [B, n_classes] from the CLS token (or the mean of the
        tokens without one)."""
        feats = self.encode(params, images)
        pooled = (feats[:, 0] if self.config.use_cls_token
                  else feats.mean(dim=1))
        with full_f32():
            return pooled @ params["head"] + params["head_b"]


# ---------------------------------------------------------------------------
# DPT-style dense head (depth-anything-class)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DepthConfig:
    vit: ViTConfig = ViTConfig(use_cls_token=False)
    head_dim: int = 64

    @staticmethod
    def tiny_test():
        return DepthConfig(vit=ViTConfig.tiny_test(use_cls_token=False))


class DepthEstimator:
    """ViT encoder + a light DPT head: patch tokens → per-patch depth →
    bilinear upsample to the pixels ([B, 3, H, W] → [B, H, W])."""

    def __init__(self, config: DepthConfig):
        self.config = config
        self.vit = ViT(config.vit)

    def init_params(self, seed=0, device="cuda") -> dict:
        """The ViT's weights from ``seed`` and the head's from ``seed + 1``
        (``default_rng``), the reference's order (vit.py:172-182)."""
        rng = np.random.default_rng(seed + 1)
        d, hd = self.config.vit.d_model, self.config.head_dim
        params = {"vit": self.vit._numpy_params(seed)}
        params["proj"] = (rng.standard_normal((d, hd), dtype=np.float32)
                          / math.sqrt(d))
        params["proj_b"] = np.zeros(hd, np.float32)
        params["out"] = (rng.standard_normal((hd, 1), dtype=np.float32)
                         / math.sqrt(hd))
        params["out_b"] = np.zeros(1, np.float32)
        return params_from_numpy(params, device)

    def predict(self, params, images):
        """Relative depth [B, H, W] of images [B, 3, H, W]."""
        cfg = self.config.vit
        b = images.shape[0]
        hp = images.shape[2] // cfg.patch_size
        wp = images.shape[3] // cfg.patch_size
        feats = self.vit.encode(params["vit"], images)   # [B, Hp*Wp, d]
        with full_f32():
            x = torch.relu(feats @ params["proj"] + params["proj_b"])
            depth = (x @ params["out"] + params["out_b"]).reshape(b, hp, wp)
        return resize_bilinear(depth, images.shape[2:])
