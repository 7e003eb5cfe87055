"""ResNet family (ResNet-50 flagship for the vision configs).

The torch counterpart of ``rten_tpu/models/resnet.py``:

* ``build_rten`` emits the full ResNet graph as a `.rten` model
  (Conv/BatchNormalization/Relu/MaxPool/Gemm nodes), a copy of the
  reference's, so the same numpy weights give the same bytes;
* ``ResNet.forward`` is the native torch forward on the same weights dict
  (as tensors, :func:`~rten_tpu_torch.models.convert.
  resnet_params_from_numpy`).

Weights are a flat dict name → array; ``init_params`` gives the
reference's random weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import full_f32

# (blocks per stage, bottleneck?) per variant
_VARIANTS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    n_classes: int = 1000

    @property
    def stages(self):
        return _VARIANTS[self.depth][0]

    @property
    def bottleneck(self):
        return _VARIANTS[self.depth][1]


class ResNet:
    def __init__(self, config: ResNetConfig = ResNetConfig()):
        self.config = config

    # -- weight construction -----------------------------------------------

    def _shapes(self):
        cfg = self.config
        shapes = {"conv1.w": (64, 3, 7, 7), "bn1": 64}
        in_ch = 64
        expansion = 4 if cfg.bottleneck else 1
        for stage, n_blocks in enumerate(cfg.stages):
            width = 64 * 2 ** stage
            out_ch = width * expansion
            for block in range(n_blocks):
                prefix = f"layer{stage + 1}.{block}"
                stride = 2 if block == 0 and stage > 0 else 1
                if cfg.bottleneck:
                    shapes[f"{prefix}.conv1.w"] = (width, in_ch, 1, 1)
                    shapes[f"{prefix}.bn1"] = width
                    shapes[f"{prefix}.conv2.w"] = (width, width, 3, 3)
                    shapes[f"{prefix}.bn2"] = width
                    shapes[f"{prefix}.conv3.w"] = (out_ch, width, 1, 1)
                    shapes[f"{prefix}.bn3"] = out_ch
                else:
                    shapes[f"{prefix}.conv1.w"] = (width, in_ch, 3, 3)
                    shapes[f"{prefix}.bn1"] = width
                    shapes[f"{prefix}.conv2.w"] = (width, width, 3, 3)
                    shapes[f"{prefix}.bn2"] = width
                if block == 0 and in_ch != out_ch:
                    shapes[f"{prefix}.down.w"] = (out_ch, in_ch, 1, 1)
                    shapes[f"{prefix}.down_bn"] = out_ch
                in_ch = out_ch
        shapes["fc.w"] = (in_ch, cfg.n_classes)
        shapes["fc.b"] = (cfg.n_classes,)  # tuple: plain tensor, not a BN group
        return shapes

    def init_params(self, key=None) -> dict:
        """Random weights as numpy, the reference's exactly (``key`` is
        unused there too: the draw is ``RandomState(0)``)."""
        rng = np.random.RandomState(0)
        params = {}
        for name, shape in self._shapes().items():
            if isinstance(shape, int):   # batchnorm params
                params[f"{name}.scale"] = np.ones(shape, np.float32)
                params[f"{name}.bias"] = np.zeros(shape, np.float32)
                params[f"{name}.mean"] = (
                    rng.randn(shape).astype(np.float32) * 0.01)
                params[f"{name}.var"] = np.ones(shape, np.float32)
            else:
                fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
                params[name] = (rng.randn(*np.atleast_1d(shape))
                                * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return params

    # -- native forward ----------------------------------------------------

    @staticmethod
    def _conv(x, w, stride=1, pad=0):
        return F.conv2d(x, w, None, stride, pad)

    @staticmethod
    def _bn(x, p, name, eps=1e-5):
        shape = (1, -1, 1, 1)
        return ((x - p[f"{name}.mean"].reshape(shape))
                * torch.rsqrt(p[f"{name}.var"].reshape(shape) + eps)
                * p[f"{name}.scale"].reshape(shape)
                + p[f"{name}.bias"].reshape(shape))

    def forward(self, params, x):
        """Logits [B, n_classes] of images ``x`` [B, 3, H, W] (f32 tensors;
        ``params`` from :func:`~rten_tpu_torch.models.convert.
        resnet_params_from_numpy`), f32 throughout with TF32 off."""
        with full_f32():
            out = self.features(params, x)
            out = torch.mean(out, dim=(2, 3))
            return out @ params["fc.w"] + params["fc.b"]

    def features(self, params, x):
        """Backbone feature map [B, C, H/32, W/32] (pre-pool)."""
        cfg = self.config
        p = params
        out = self._conv(x, p["conv1.w"], stride=2, pad=3)
        out = torch.clamp(self._bn(out, p, "bn1"), min=0)
        out = F.max_pool2d(F.pad(out, (1, 1, 1, 1), value=-float("inf")),
                           3, 2)
        for stage, n_blocks in enumerate(cfg.stages):
            for block in range(n_blocks):
                prefix = f"layer{stage + 1}.{block}"
                stride = 2 if block == 0 and stage > 0 else 1
                identity = out
                if cfg.bottleneck:
                    h = torch.clamp(self._bn(self._conv(
                        out, p[f"{prefix}.conv1.w"]), p, f"{prefix}.bn1"),
                        min=0)
                    h = torch.clamp(self._bn(self._conv(
                        h, p[f"{prefix}.conv2.w"], stride=stride, pad=1),
                        p, f"{prefix}.bn2"), min=0)
                    h = self._bn(self._conv(
                        h, p[f"{prefix}.conv3.w"]), p, f"{prefix}.bn3")
                else:
                    h = torch.clamp(self._bn(self._conv(
                        out, p[f"{prefix}.conv1.w"], stride=stride, pad=1),
                        p, f"{prefix}.bn1"), min=0)
                    h = self._bn(self._conv(
                        h, p[f"{prefix}.conv2.w"], pad=1), p, f"{prefix}.bn2")
                if f"{prefix}.down.w" in p:
                    identity = self._bn(self._conv(
                        out, p[f"{prefix}.down.w"], stride=stride),
                        p, f"{prefix}.down_bn")
                out = torch.clamp(h + identity, min=0)
        return out

    # -- .rten graph emission ----------------------------------------------

    def build_rten(self, params, input_shape=("batch", 3, 224, 224)):
        """Emit the model as a `.rten` ModelBuilder (graph parity with the
        native forward)."""
        from ..fmt.model_builder import ModelBuilder

        cfg = self.config
        mb = ModelBuilder()
        g = mb.graph
        x = g.add_value("input", shape=list(input_shape))

        def conv(inp, wname, stride=1, pad=0, name=None):
            w = g.add_constant(wname, params[wname])
            return g.add_operator(
                "Conv", [inp, w, None],
                attrs={"auto_pad": 1, "pads": [pad, pad, pad, pad],
                       "strides": [stride, stride], "groups": 1,
                       "dilations": [1, 1]},
                name=name or wname.replace(".w", ""))

        def bn(inp, bname):
            args = [inp]
            for suffix in ("scale", "bias", "mean", "var"):
                args.append(g.add_constant(f"{bname}.{suffix}",
                                           params[f"{bname}.{suffix}"]))
            return g.add_operator("BatchNormalization", args,
                                  attrs={"epsilon": 1e-5}, name=bname)

        def relu(inp, name):
            return g.add_operator("Relu", [inp], name=name)

        out = relu(bn(conv(x, "conv1.w", stride=2, pad=3), "bn1"), "relu1")
        out = g.add_operator(
            "MaxPool", [out],
            attrs={"kernel_size": [3, 3], "strides": [2, 2],
                   "pads": [1, 1, 1, 1], "auto_pad": 1}, name="maxpool")
        for stage, n_blocks in enumerate(cfg.stages):
            for block in range(n_blocks):
                prefix = f"layer{stage + 1}.{block}"
                stride = 2 if block == 0 and stage > 0 else 1
                identity = out
                if cfg.bottleneck:
                    h = relu(bn(conv(out, f"{prefix}.conv1.w"),
                                f"{prefix}.bn1"), f"{prefix}.relu1")
                    h = relu(bn(conv(h, f"{prefix}.conv2.w", stride=stride,
                                     pad=1), f"{prefix}.bn2"),
                             f"{prefix}.relu2")
                    h = bn(conv(h, f"{prefix}.conv3.w"), f"{prefix}.bn3")
                else:
                    h = relu(bn(conv(out, f"{prefix}.conv1.w", stride=stride,
                                     pad=1), f"{prefix}.bn1"),
                             f"{prefix}.relu1")
                    h = bn(conv(h, f"{prefix}.conv2.w", pad=1),
                           f"{prefix}.bn2")
                if f"{prefix}.down.w" in params:
                    identity = bn(conv(out, f"{prefix}.down.w",
                                       stride=stride), f"{prefix}.down_bn")
                summed = g.add_operator("Add", [h, identity],
                                        name=f"{prefix}.add")
                out = relu(summed, f"{prefix}.out")
        pooled = g.add_operator("GlobalAveragePool", [out], name="gap")
        flat = g.add_operator("Flatten", [pooled], attrs={"axis": 1},
                              name="flatten")
        w = g.add_constant("fc.w", params["fc.w"])
        b = g.add_constant("fc.b", params["fc.b"])
        logits = g.add_operator("Gemm", [flat, w, b],
                                attrs={"alpha": 1.0, "beta": 1.0,
                                       "transpose_a": False,
                                       "transpose_b": False},
                                name="fc")
        g.inputs = [x]
        g.outputs = [logits]
        mb.metadata = {"description": f"ResNet-{cfg.depth} (rten_tpu native)"}
        return mb
