"""Promptable segmentation, Segment-Anything-class (port of
``rten_tpu/models/sam.py``): the port's ViT image encoder, a point-prompt
encoder and a two-way-attention mask decoder.

Learned output tokens and Fourier-embedded point prompts cross-attend
with the image embedding (dense [tokens x patches] attention), then the
mask logits are the mask token's projection dotted with a per-patch
embedding upscaled by two stride-2 transposed convs. The reference's
"transposed" conv is ``conv_general_dilated`` with ``lhs_dilation``: a
correlation over the zero-stuffed input with the kernel not flipped,
which :func:`conv_lhs_dilated` computes (``conv_transpose2d`` would flip
it). GELU is the tanh approximation here (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import full_f32
from .convert import params_from_numpy
from .transformer import _norm
from .vit import ViT, ViTConfig, resize_bilinear


@dataclass(frozen=True)
class SAMConfig:
    vit: ViTConfig = field(default_factory=lambda: ViTConfig(
        image_size=224, patch_size=16, d_model=384, n_layers=12,
        n_heads=6, d_ff=1536, use_cls_token=False))
    decoder_layers: int = 2
    n_heads: int = 8
    max_points: int = 8
    upscale: int = 4
    norm: str = "layernorm"      # consumed by _norm
    layer_norm_eps: float = 1e-6

    @property
    def d(self):
        return self.vit.d_model

    @staticmethod
    def tiny_test(**kw):
        return SAMConfig(**{**dict(
            vit=ViTConfig.tiny_test(use_cls_token=False),
            decoder_layers=1, n_heads=4, max_points=4), **kw})


def conv_lhs_dilated(x, w, stride, pads):
    """``jax.lax.conv_general_dilated(x, w, 1, pads, lhs_dilation=stride)``
    with an "in, out, spatial..." kernel ("IOH" / "IOHW") over NC...
    inputs: zeros stuffed between the input's samples, the given
    (lo, hi) padding of each spatial axis, then a correlation with the
    kernel as it is (not flipped). x [N, C, *S], w [C, O, *K]."""
    n_sp = x.dim() - 2
    size = [(s - 1) * stride + 1 for s in x.shape[2:]]
    stuffed = x.new_zeros((*x.shape[:2], *size))
    stuffed[(slice(None), slice(None))
            + (slice(None, None, stride),) * n_sp] = x
    pad = []
    for lo, hi in reversed(pads):
        pad += [lo, hi]
    stuffed = F.pad(stuffed, pad)
    conv = F.conv1d if n_sp == 1 else F.conv2d
    return conv(stuffed, w.transpose(0, 1))


def fourier_point_embedding(points, d, n_freqs=None):
    """[..., 2] normalized coords in [0, 1] → [..., d] Fourier features
    over the fixed log-spaced bank 2^i * pi (the reference's)."""
    n_freqs = n_freqs or d // 4
    freqs = (2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                 device=points.device)) * math.pi
    ang = points[..., None, :] * freqs[:, None]          # [..., F, 2]
    feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    feats = feats.reshape(*points.shape[:-1], 4 * n_freqs)
    if feats.shape[-1] < d:
        feats = F.pad(feats, (0, d - feats.shape[-1]))
    return feats[..., :d]


def _div(x, c):
    """x / c with c as a tensor on x's device: CUDA PyTorch turns a
    division by a Python number into a multiply by its reciprocal."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


class SAM:
    def __init__(self, config: SAMConfig = SAMConfig()):
        self.config = config
        self.encoder = ViT(config.vit)

    def init_params(self, seed=0, device="cuda") -> dict:
        """The encoder's weights (``default_rng(seed)``) and the decoder's
        in the reference's numpy ``RandomState(seed)`` order
        (sam.py:70-103): seed 0 gives the JAX package's ``init_params``."""
        cfg = self.config
        rng = np.random.RandomState(seed)
        d = cfg.d

        def dense(*shape):
            return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

        def conv(c_in, c_out):
            return (rng.randn(c_in, c_out, 2, 2)
                    / np.sqrt(c_in)).astype(np.float32)

        params = {
            "encoder": self.encoder._numpy_params(seed),
            "out_tokens": dense(2, d),
            "label_embed": dense(2, d),
            "point_proj": dense(d, d),
            "iou_w": dense(d, 1), "iou_b": np.zeros(1, np.float32),
            "up1.w": conv(d, d // 2),
            "up1.b": np.zeros(d // 2, np.float32),
            "up2.w": conv(d // 2, d // 4),
            "up2.b": np.zeros(d // 4, np.float32),
            "mask_mlp": dense(d, d // 4),
            "layers": [],
        }
        for _ in range(cfg.decoder_layers):
            params["layers"].append({
                "t2i_q": dense(d, d), "t2i_k": dense(d, d),
                "t2i_v": dense(d, d), "t2i_o": dense(d, d),
                "i2t_q": dense(d, d), "i2t_k": dense(d, d),
                "i2t_v": dense(d, d), "i2t_o": dense(d, d),
                "ln1_scale": np.ones(d, np.float32),
                "ln1_bias": np.zeros(d, np.float32),
                "ln2_scale": np.ones(d, np.float32),
                "ln2_bias": np.zeros(d, np.float32),
                "w_up": dense(d, 2 * d), "w_down": dense(2 * d, d),
            })
        return params_from_numpy(params, device)

    def _xattn(self, q_in, kv_in, wq, wk, wv, wo, q_mask=None, kv_mask=None):
        h = self.config.n_heads
        hd = self.config.d // h
        b, nq, _ = q_in.shape
        nk = kv_in.shape[1]
        q = (q_in @ wq).reshape(b, nq, h, hd).transpose(1, 2)
        k = (kv_in @ wk).reshape(b, nk, h, hd).transpose(1, 2)
        v = (kv_in @ wv).reshape(b, nk, h, hd).transpose(1, 2)
        s = _div(torch.einsum("bhqd,bhkd->bhqk", q, k), math.sqrt(hd))
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask[:, None, None, :], -1e30)
        a = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", a, v)
        out = out.transpose(1, 2).reshape(b, nq, -1) @ wo
        if q_mask is not None:
            out = out * q_mask[..., None]
        return out

    def predict(self, params, images, points, point_labels, n_points):
        """images [B, 3, H, W]; points [B, P, 2] in [0, 1]; point_labels
        [B, P] (1 foreground, 0 background); n_points [B] valid points.
        Returns (mask_logits [B, H, W], iou_pred [B])."""
        cfg = self.config
        b, d = images.shape[0], cfg.d
        g = cfg.vit.image_size // cfg.vit.patch_size
        img = self.encoder.encode(params["encoder"], images)  # [B, g*g, d]
        dev = images.device
        with full_f32():
            pmask = (torch.arange(cfg.max_points, device=dev)[None]
                     < n_points.to(dev)[:, None])
            pts = fourier_point_embedding(points, d) @ params["point_proj"]
            pts = pts + params["label_embed"][point_labels.to(torch.int64)]
            pts = pts * pmask[..., None]
            tokens = torch.cat([params["out_tokens"][None].expand(b, 2, d),
                                pts], dim=1)
            tok_mask = torch.cat([torch.ones((b, 2), dtype=torch.bool,
                                             device=dev), pmask], dim=1)
            for layer in params["layers"]:
                # tokens → image, then image → tokens (SAM's two-way
                # block), each followed by a norm; a residual MLP.
                tokens = tokens + self._xattn(
                    tokens, img, layer["t2i_q"], layer["t2i_k"],
                    layer["t2i_v"], layer["t2i_o"], q_mask=tok_mask)
                tokens = _norm(cfg, tokens, layer["ln1_scale"],
                               layer["ln1_bias"])
                img = img + self._xattn(
                    img, tokens, layer["i2t_q"], layer["i2t_k"],
                    layer["i2t_v"], layer["i2t_o"], kv_mask=tok_mask)
                tokens = tokens + F.gelu(tokens @ layer["w_up"],
                                         approximate="tanh") @ layer["w_down"]
                tokens = _norm(cfg, tokens, layer["ln2_scale"],
                               layer["ln2_bias"])

            mask_tok, iou_tok = tokens[:, 0], tokens[:, 1]
            iou = torch.sigmoid((iou_tok @ params["iou_w"]
                                 + params["iou_b"])[:, 0])
            fmap = img.transpose(1, 2).reshape(b, d, g, g)
            up = F.gelu(self._tconv(fmap, params["up1.w"], params["up1.b"]),
                        approximate="tanh")
            up = self._tconv(up, params["up2.w"], params["up2.b"])
            probe = mask_tok @ params["mask_mlp"]              # [B, d/4]
            mask = torch.einsum("bc,bchw->bhw", probe, up)
        size = cfg.vit.image_size
        return resize_bilinear(mask, (size, size)), iou

    @staticmethod
    def _tconv(x, w, bias):
        """sam.py:173-179: stride-2 lhs dilation, padding (0, 1)."""
        out = conv_lhs_dilated(x, w, 2, [(0, 1), (0, 1)])
        return out + bias.reshape(1, -1, 1, 1)
