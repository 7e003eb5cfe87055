"""Semantic segmentation, DeepLab-class (port of
``rten_tpu/models/segmentation.py``): the port's ResNet backbone
(:meth:`~rten_tpu_torch.models.resnet.ResNet.features`, 1/32 of the input)
and an ASPP head of dilated convs plus an image-level pooling branch, then
a bilinear upsample of the class logits to the input's size. f32 with
TF32 off throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.common import full_f32
from .convert import resnet_params_from_numpy
from .resnet import ResNet, ResNetConfig
from .vit import resize_bilinear


@dataclass(frozen=True)
class SegmentationConfig:
    backbone: ResNetConfig = field(default_factory=lambda: ResNetConfig(50))
    n_classes: int = 21              # PASCAL VOC
    aspp_channels: int = 256
    aspp_rates: tuple = (1, 6, 12, 18)

    @staticmethod
    def tiny_test(**kw):
        return SegmentationConfig(**{**dict(
            backbone=ResNetConfig(18, n_classes=10), n_classes=4,
            aspp_channels=32, aspp_rates=(1, 2)), **kw})


class Segmenter:
    def __init__(self, config: SegmentationConfig = SegmentationConfig()):
        self.config = config
        self.backbone = ResNet(config.backbone)

    def _backbone_channels(self):
        cfg = self.config.backbone
        expansion = 4 if cfg.bottleneck else 1
        return 64 * 2 ** (len(cfg.stages) - 1) * expansion

    def init_params(self, seed=0, device="cuda") -> dict:
        """The backbone's weights (the reference's ResNet draw) and the
        head's in the reference's numpy ``RandomState(seed + 1)`` order
        (segmentation.py:49-71): seed 0 gives the JAX package's
        ``init_params`` exactly."""
        cfg = self.config
        rng = np.random.RandomState(seed + 1)
        c_in = self._backbone_channels()
        ch = cfg.aspp_channels

        def conv(c_out, c_inp, k):
            fan_in = c_inp * k * k
            return (rng.randn(c_out, c_inp, k, k)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)

        head = {}
        for i, rate in enumerate(cfg.aspp_rates):
            k = 1 if rate == 1 else 3
            head[f"aspp{i}.w"] = conv(ch, c_in, k)
            head[f"aspp{i}.b"] = np.zeros(ch, np.float32)
        head["pool.w"] = conv(ch, c_in, 1)
        head["pool.b"] = np.zeros(ch, np.float32)
        head["fuse.w"] = conv(ch, ch * (len(cfg.aspp_rates) + 1), 1)
        head["fuse.b"] = np.zeros(ch, np.float32)
        head["cls.w"] = conv(cfg.n_classes, ch, 1)
        head["cls.b"] = np.zeros(cfg.n_classes, np.float32)
        dev = resolve_device(device)
        return {"backbone": resnet_params_from_numpy(
                    self.backbone.init_params(), dev),
                **resnet_params_from_numpy(head, dev)}

    @staticmethod
    def _conv(x, w, b, dilation=1):
        k = w.shape[-1]
        pad = dilation * (k - 1) // 2
        return F.conv2d(x, w, None, 1, pad, dilation) + b.reshape(1, -1, 1,
                                                                  1)

    def forward(self, params, x):
        """x [B, 3, H, W] → per-pixel class logits [B, n_classes, H, W]."""
        cfg = self.config
        h, w = x.shape[2:]
        with full_f32():
            feat = self.backbone.features(params["backbone"], x)
            branches = [torch.relu(self._conv(
                feat, params[f"aspp{i}.w"], params[f"aspp{i}.b"], rate))
                for i, rate in enumerate(cfg.aspp_rates)]
            # Image-level context: global average pool → 1x1 conv →
            # broadcast over the map.
            pooled = torch.relu(self._conv(
                feat.mean(dim=(2, 3), keepdim=True), params["pool.w"],
                params["pool.b"]))
            branches.append(pooled.expand(-1, -1, *branches[0].shape[2:]))
            fused = torch.relu(self._conv(torch.cat(branches, dim=1),
                                          params["fuse.w"],
                                          params["fuse.b"]))
            logits = self._conv(fused, params["cls.w"], params["cls.b"])
        return resize_bilinear(logits, (h, w))

    def predict(self, params, x):
        """Per-pixel class ids int32 [B, H, W]."""
        return torch.argmax(self.forward(params, x), dim=1).to(torch.int32)
