"""Every operator of the port's graph runtime (``rten_tpu_torch/ops``)
against the JAX package's lowering of the same op type
(``rten_tpu.ops.registry.get_op(name).fn``) on seeded numpy inputs, on the
CPU. Integer results are exact (ConvInteger, QLinearConv and MatMulInteger
bit for bit, over uint8 x with a nonzero zero point, pads, strides,
dilation, depthwise groups, 1-D, M <= 16 and K = 147); float results are
held to 1e-5 of max |out|. The port registers exactly the op types of the
reference's eight ported op modules, and every one has a case here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.ops import registry as jreg
from rten_tpu.runtime.executor import _Ctx as JCtx
from rten_tpu_torch.ops import registry as preg
from rten_tpu_torch.runtime.executor import _Ctx as PCtx

PORTED = ("elementwise", "layout", "reduce", "norm", "pool", "matmul",
          "conv", "quantized")
# f32 outputs: the two packages' f32 arithmetic in other orders.
F32_REL_TOL = 1e-5

jreg.ensure_registered()
preg.ensure_registered()


def rng(seed=0):
    return np.random.default_rng(seed)


def randn(*shape, seed=0):
    return rng(seed).standard_normal(shape).astype(np.float32)


def randint(lo, hi, shape, dtype, seed=0):
    return rng(seed).integers(lo, hi, shape).astype(dtype)


def u8(*shape, seed=0):
    return randint(0, 256, shape, np.uint8, seed)


def i8(*shape, seed=0):
    return randint(-128, 128, shape, np.int8, seed)


def conv_attrs(pads=(0, 0, 0, 0), strides=(1, 1), dilations=(1, 1),
               groups=1):
    return {"auto_pad": 1, "pads": list(pads), "strides": list(strides),
            "dilations": list(dilations), "groups": groups}


POS = np.abs(randn(2, 3, 4)) + np.float32(0.1)
UNIT = np.clip(randn(2, 3, 4), -0.9, 0.9)
INTS = randint(-7, 8, (3, 4), np.int32)
NONZERO = randint(1, 5, (3, 4), np.int32) * np.where(
    randint(0, 2, (3, 4), np.int32, 1), 1, -1).astype(np.int32)
BITS = randint(0, 2, (3, 4), np.int32)
BITS2 = randint(0, 2, (3, 4), np.int32, 2)

# (case id, op type, attrs, inputs, outputs)
CASES = [(n, n, {}, [randn(2, 3, 4)], 1) for n in (
    "Abs", "Atan", "Ceil", "Cos", "Erf", "Exp", "Floor", "Identity", "Neg",
    "Relu", "Round", "Sigmoid", "Sign", "Sin", "Softplus", "Tan", "Tanh",
    "Gelu", "Elu", "HardSigmoid", "HardSwish", "Silu")]
CASES += [
    ("Acos", "Acos", {}, [UNIT], 1),
    ("Asin", "Asin", {}, [UNIT], 1),
    ("Log", "Log", {}, [POS], 1),
    ("Sqrt", "Sqrt", {}, [POS], 1),
    ("Reciprocal", "Reciprocal", {}, [POS], 1),
    ("Round_halves", "Round", {},
     [np.float32([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5])], 1),
    ("LeakyRelu", "LeakyRelu", {"alpha": 0.1}, [randn(2, 3, 4)], 1),
    ("Elu_alpha", "Elu", {"alpha": 0.5}, [randn(2, 3, 4)], 1),
    ("Not", "Not", {}, [BITS], 1),
    ("Clip", "Clip", {}, [randn(2, 3, 4), np.float32(-0.5),
                          np.float32(0.7)], 1),
    ("Clip_min", "Clip", {}, [randn(2, 3, 4), np.float32(-0.5)], 1),
    ("Cast_int", "Cast", {"to": 0}, [randn(2, 3, 4) * 4], 1),
    ("Cast_float", "Cast", {"to": 1}, [INTS], 1),
    ("Add", "Add", {}, [randn(2, 3, 4), randn(3, 1, seed=1)], 1),
    ("Sub", "Sub", {}, [randn(2, 3, 4), randn(4, seed=1)], 1),
    ("Mul", "Mul", {}, [randn(2, 3, 4), randn(1, 3, 1, seed=1)], 1),
    ("Add_int", "Add", {}, [INTS, NONZERO], 1),
    ("Pow", "Pow", {}, [POS, randn(2, 3, 4, seed=1)], 1),
    ("Div", "Div", {}, [randn(2, 3, 4), POS], 1),
    ("Div_int_trunc", "Div", {}, [INTS, NONZERO], 1),
    ("Mod", "Mod", {}, [INTS, NONZERO], 1),
    ("Mod_fmod", "Mod", {"fmod": 1}, [INTS, NONZERO], 1),
    ("Mod_float", "Mod", {"fmod": 1}, [randn(2, 3, 4), POS], 1),
    ("Where", "Where", {}, [BITS, randn(3, 4), randn(3, 4, seed=1)], 1),
    ("Max", "Max", {}, [randn(3, 4), randn(4, seed=1),
                        randn(1, 4, seed=2)], 1),
    ("Min", "Min", {}, [randn(3, 4), randn(4, seed=1)], 1),
    ("Sum", "Sum", {}, [randn(3, 4), randn(4, seed=1),
                        randn(3, 1, seed=2)], 1),
    ("Mean", "Mean", {}, [randn(3, 4), randn(4, seed=1),
                          randn(3, 1, seed=2)], 1),
]
CASES += [(n, n, {}, [INTS, INTS[::-1].copy()], 1) for n in (
    "Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual")]
CASES += [(n, n, {}, [BITS, BITS2], 1) for n in ("And", "Or", "Xor")]

X4 = randn(2, 3, 4, 5)
CASES += [
    ("Reshape", "Reshape", {}, [X4, np.int32([0, -1, 5])], 1),
    ("Flatten", "Flatten", {"axis": 2}, [X4], 1),
    ("Flatten_0", "Flatten", {"axis": 0}, [X4], 1),
    ("Squeeze", "Squeeze", {}, [randn(2, 1, 3, 1), np.int32([1, -1])], 1),
    ("Squeeze_all", "Squeeze", {}, [randn(2, 1, 3, 1)], 1),
    ("Unsqueeze", "Unsqueeze", {}, [randn(2, 3), np.int32([0, -1])], 1),
    ("Transpose", "Transpose", {"perm": [2, 0, 3, 1]}, [X4], 1),
    ("Transpose_rev", "Transpose", {}, [X4], 1),
    ("Expand", "Expand", {}, [randn(3, 1), np.int32([2, 3, 4])], 1),
    ("Shape", "Shape", {}, [X4], 1),
    ("Size", "Size", {}, [X4], 1),
    ("Concat", "Concat", {"axis": 1}, [randn(2, 3), randn(2, 1, seed=1)],
     1),
    ("Split", "Split", {"axis": 1}, [randn(2, 7), np.int32([2, 5])], 2),
    ("Split_even", "Split", {"axis": 1}, [randn(2, 7)], 3),
    ("Slice", "Slice", {}, [X4, np.int32([1, -4]), np.int32([100, -1]),
                            np.int32([1, 3]), np.int32([1, 2])], 1),
    ("Slice_neg_step", "Slice", {}, [X4, np.int32([-1, 3]),
                                     np.int32([-100, 0]), np.int32([2, 1]),
                                     np.int32([-2, -1])], 1),
    ("Pad", "Pad", {}, [randn(2, 3), np.int32([1, 0, 2, 3]),
                        np.float32(1.5)], 1),
    ("Pad_zero", "Pad", {}, [randn(2, 3), np.int32([0, 1, 1, 2])], 1),
]
CASES += [(f"Pad_{m}", "Pad", {"mode": i}, [randn(3, 4),
                                             np.int32([2, 1, 1, 2])], 1)
          for i, m in ((1, "reflect"), (2, "edge"), (3, "wrap"))]
CASES += [
    ("Tile", "Tile", {}, [randn(2, 3), np.int32([2, 3])], 1),
    ("Trilu", "Trilu", {}, [randn(4, 5), np.int32([1])], 1),
    ("Trilu_upper", "Trilu", {"upper": 1}, [randn(4, 5), np.int32([-1])],
     1),
]

TIES = np.float32([[1, 3, 3, 0], [2, 2, 1, 2], [0, 0, 0, 0]])
CASES += [
    ("ArgMax", "ArgMax", {"axis": 1}, [TIES], 1),
    ("ArgMax_nokeep", "ArgMax", {"axis": 0, "keep_dims": 0}, [randn(3, 4)],
     1),
    ("ArgMin", "ArgMin", {"axis": -1}, [TIES], 1),
    ("CumSum", "CumSum", {}, [randn(3, 4), np.int32(1)], 1),
    ("CumSum_int", "CumSum", {}, [INTS, np.int32(0)], 1),
    ("NonZero", "NonZero", {}, [BITS], 1),
    ("TopK", "TopK", {"axis": 1}, [TIES, np.int32([2])], 2),
    ("TopK_smallest", "TopK", {"axis": 0, "largest": 0},
     [randn(5, 3), np.int32([3])], 2),
]
for name in ("ReduceSum", "ReduceMean", "ReduceMin", "ReduceMax",
             "ReduceProd", "ReduceL2", "ReduceSumSquare"):
    CASES += [
        (name, name, {"axes": [1, -1]}, [randn(2, 3, 4)], 1),
        (f"{name}_input_nokeep", name, {"keep_dims": 0},
         [randn(2, 3, 4), np.int32([0])], 1),
        (f"{name}_all", name, {}, [randn(2, 3, 4)], 1)]
CASES += [("ReduceSum_int", "ReduceSum", {"axes": [1]}, [INTS], 1)]

C = 3
CASES += [
    ("BatchNormalization", "BatchNormalization", {"epsilon": 1e-3},
     [randn(2, C, 4, 5), randn(C, seed=1), randn(C, seed=2),
      randn(C, seed=3), np.abs(randn(C, seed=4)) + 0.5], 1),
    ("InstanceNormalization", "InstanceNormalization", {},
     [randn(2, C, 4, 5), randn(C, seed=1), randn(C, seed=2)], 1),
    ("LayerNormalization", "LayerNormalization", {"axis": -2},
     [randn(2, 3, 4), randn(3, 4, seed=1), randn(3, 4, seed=2)], 1),
    ("LayerNormalization_nobias", "LayerNormalization", {},
     [randn(2, 3, 4), randn(4, seed=1)], 1),
    ("Softmax", "Softmax", {"axis": 1}, [randn(2, 3, 4) * 4], 1),
    ("LogSoftmax", "LogSoftmax", {}, [randn(2, 3, 4) * 4], 1),
]

POOL = {"kernel_size": [3, 2], "strides": [2, 1], "pads": [1, 0, 0, 1],
        "auto_pad": 1}
CASES += [
    ("MaxPool", "MaxPool", POOL, [randn(2, 3, 7, 6)], 1),
    ("MaxPool_resnet", "MaxPool", {"kernel_size": [3, 3], "strides": [2, 2],
                                   "pads": [1, 1, 1, 1], "auto_pad": 1},
     [randn(2, 3, 8, 8)], 1),
    ("MaxPool_same", "MaxPool", {"kernel_size": [3, 3], "strides": [2, 2],
                                 "auto_pad": 0}, [randn(1, 2, 7, 8)], 1),
    ("MaxPool_1d", "MaxPool", {"kernel_size": [3], "strides": [2],
                               "pads": [1, 1], "auto_pad": 1},
     [randn(2, 3, 9)], 1),
    ("AveragePool", "AveragePool", POOL, [randn(2, 3, 7, 6)], 1),
    ("AveragePool_include_pad", "AveragePool",
     {**POOL, "count_include_pad": 1}, [randn(2, 3, 7, 6)], 1),
    ("AveragePool_nopad", "AveragePool", {"kernel_size": [2, 2],
                                          "strides": [2, 2]},
     [randn(2, 3, 6, 6)], 1),
    ("GlobalAveragePool", "GlobalAveragePool", {}, [randn(2, 3, 7, 6)], 1),
]

CASES += [
    ("MatMul", "MatMul", {}, [randn(2, 1, 5, 6), randn(3, 6, 4, seed=1)],
     1),
    ("MatMul_vec", "MatMul", {}, [randn(6), randn(2, 6, 4, seed=1)], 1),
    ("MatMul_int", "MatMul", {}, [INTS, randint(-9, 9, (4, 5), np.int32)],
     1),
    ("Gemm", "Gemm", {"alpha": 0.5, "beta": 2.0, "transpose_a": 1,
                      "transpose_b": 1},
     [randn(6, 3), randn(4, 6, seed=1), randn(4, seed=2)], 1),
    ("Gemm_plain", "Gemm", {}, [randn(3, 6), randn(6, 4, seed=1),
                                randn(3, 4, seed=2)], 1),
    ("Einsum", "Einsum", {"equation": "bij, bjk -> bik"},
     [randn(2, 3, 4), randn(2, 4, 5, seed=1)], 1),
    ("FusedSDPA_mask", "FusedSDPA", {"scale": 0.3},
     [randn(2, 2, 5, 8), randn(2, 2, 8, 7, seed=1),
      randn(2, 2, 7, 8, seed=2), randn(1, 1, 5, 7, seed=3)], 1),
    ("FusedSDPA_causal", "FusedSDPA", {"scale": 0.25, "causal": 1},
     [randn(1, 2, 6, 8), randn(1, 2, 8, 6, seed=1),
      randn(1, 2, 6, 8, seed=2)], 1),
    # The reference's flash condition (s 256, no mask) at head_dim 64: its
    # kernel's own plain fallback, and at 128: F1's plain version against
    # the Pallas kernel in interpret mode.
    ("FusedSDPA_flash_d64", "FusedSDPA", {"scale": 0.125, "causal": 1},
     [randn(1, 1, 256, 64), randn(1, 1, 64, 256, seed=1),
      randn(1, 1, 256, 64, seed=2)], 1),
    ("FusedSDPA_flash_d128", "FusedSDPA", {"scale": 0.09, "causal": 0},
     [randn(1, 1, 256, 128), randn(1, 1, 128, 256, seed=1),
      randn(1, 1, 256, 128, seed=2)], 1),
]

CASES += [
    ("Conv", "Conv", conv_attrs((1, 0, 2, 1), (2, 1), (1, 2)),
     [randn(2, 4, 9, 8), randn(6, 4, 3, 2, seed=1), randn(6, seed=2)], 1),
    ("Conv_depthwise", "Conv", conv_attrs((1, 1, 1, 1), groups=4),
     [randn(2, 4, 6, 6), randn(4, 1, 3, 3, seed=1)], 1),
    ("Conv_same", "Conv", {"auto_pad": 0, "strides": [2, 2]},
     [randn(1, 3, 7, 8), randn(5, 3, 3, 3, seed=1)], 1),
    ("Conv_1d", "Conv", {"auto_pad": 1, "pads": [2, 1], "strides": [2],
                         "dilations": [2]},
     [randn(2, 3, 11), randn(4, 3, 3, seed=1), randn(4, seed=2)], 1),
    ("ConvTranspose", "ConvTranspose",
     {"auto_pad": 1, "pads": [1, 0, 0, 2], "strides": [2, 3],
      "output_padding": [1, 2], "dilations": [1, 2], "groups": 2},
     [randn(2, 4, 5, 4), randn(4, 3, 3, 2, seed=1), randn(6, seed=2)], 1),
    ("ConvTranspose_plain", "ConvTranspose", {"strides": [2, 2]},
     [randn(1, 3, 4, 4), randn(3, 2, 2, 2, seed=1)], 1),
    ("ConvTranspose_same", "ConvTranspose", {"auto_pad": 2,
                                             "strides": [2, 2]},
     [randn(1, 2, 4, 3), randn(2, 3, 3, 3, seed=1)], 1),
    ("ConvTranspose_1d", "ConvTranspose", {"strides": [2], "pads": [1, 0]},
     [randn(2, 3, 6), randn(3, 2, 3, seed=1)], 1),
]

CASES += [
    ("QuantizeLinear", "QuantizeLinear", {},
     [randn(2, 3, 4) * 3, np.float32(0.03), np.uint8(100)], 1),
    ("QuantizeLinear_nozp", "QuantizeLinear", {},
     [np.abs(randn(2, 3, 4)), np.float32(0.01)], 1),
    ("QuantizeLinear_axis", "QuantizeLinear", {"axis": 1},
     [randn(2, 3, 4) * 3, np.float32([0.01, 0.02, 0.05]),
      np.int8([0, -3, 4])], 1),
    ("DequantizeLinear", "DequantizeLinear", {"axis": 0},
     [i8(3, 4), np.float32([0.1, 0.2, 0.3]), np.int8([1, 0, -2])], 1),
    ("DequantizeLinear_scalar", "DequantizeLinear", {},
     [u8(3, 4), np.float32(0.05), np.uint8(128)], 1),
    ("DynamicQuantizeLinear", "DynamicQuantizeLinear", {},
     [randn(4, 6) * 2 + 0.5], 3),
    ("MatMulInteger_int8", "MatMulInteger", {}, [i8(24, 16), i8(16, 8)], 1),
    # M <= 16 and K = 147 (the stem's), uint8 x with its zero point.
    ("MatMulInteger_m1_k147", "MatMulInteger", {},
     [u8(1, 147), i8(147, 10), np.uint8(131)], 1),
    ("MatMulInteger_m16", "MatMulInteger", {},
     [u8(16, 40), i8(40, 12), np.uint8(7)], 1),
    ("MatMulInteger_batched", "MatMulInteger", {},
     [u8(2, 5, 24), i8(24, 9), np.uint8(200)], 1),
    ("MatMulInteger_bzp", "MatMulInteger", {},
     [u8(5, 24), u8(24, 9, seed=1), np.uint8(3), np.uint8(250)], 1),
    ("QLinearMatMul", "QLinearMatMul", {},
     [u8(5, 24), np.float32(0.02), np.uint8(120), i8(24, 9),
      np.float32([0.01] * 9), np.int8(0), np.float32(0.5),
      np.uint8(128)], 1),
    ("QLinearMatMul_int8", "QLinearMatMul", {},
     [i8(20, 16), np.float32(0.02), None, i8(16, 8),
      np.float32(0.03), None, np.float32(0.5), np.int8(3)], 1),
    ("QLinearConv", "QLinearConv", conv_attrs((1, 0, 2, 1), (2, 1), (1, 2)),
     [u8(2, 4, 9, 8), np.float32(0.02), np.uint8(110), i8(6, 4, 3, 2),
      np.float32(0.01), np.int8(0), np.float32(0.1), np.uint8(128),
      randint(-500, 500, (6,), np.int32)], 1),
    ("QLinearConv_wzp_depthwise", "QLinearConv",
     conv_attrs((1, 1, 1, 1), groups=4),
     [u8(2, 4, 6, 6), np.float32(0.02), np.uint8(17), u8(4, 1, 3, 3),
      np.float32(0.01), np.uint8(9), np.float32(0.3), np.uint8(100)], 1),
    ("ConvInteger", "ConvInteger", conv_attrs((1, 0, 2, 1), (2, 1), (1, 2)),
     [u8(2, 4, 9, 8), i8(6, 4, 3, 2), np.uint8(113)], 1),
    # ResNet's stem: K = 3 x 7 x 7 = 147, stride 2, pads 3.
    ("ConvInteger_stem", "ConvInteger", conv_attrs((3, 3, 3, 3), (2, 2)),
     [u8(2, 3, 16, 16), i8(8, 3, 7, 7), np.uint8(77)], 1),
    ("ConvInteger_1x1_stride", "ConvInteger", conv_attrs(strides=(2, 2)),
     [u8(2, 16, 7, 7), i8(24, 16, 1, 1), np.uint8(255)], 1),
    ("ConvInteger_int8_nozp", "ConvInteger", conv_attrs((1, 1, 1, 1)),
     [i8(2, 8, 5, 5), i8(8, 8, 3, 3)], 1),
    ("ConvInteger_depthwise", "ConvInteger",
     conv_attrs((1, 1, 1, 1), groups=4),
     [u8(2, 4, 6, 6), i8(4, 1, 3, 3), np.uint8(90)], 1),
    ("ConvInteger_wzp", "ConvInteger", conv_attrs((0, 1, 1, 0)),
     [u8(1, 3, 5, 5), u8(4, 3, 2, 2), np.uint8(4), np.uint8(130)], 1),
    ("ConvInteger_1d", "ConvInteger", {},
     [u8(2, 3, 10), i8(4, 3, 3), np.uint8(140)], 1),
    # |acc| above 2^24: 3x3x512 taps of 255 x 127 (x at 255, zp 0).
    ("ConvInteger_large_acc", "ConvInteger", conv_attrs((1, 1, 1, 1)),
     [np.full((1, 512, 3, 3), 255, np.uint8), np.full((2, 512, 3, 3), 127,
                                                      np.int8),
      np.uint8(0)], 1),
]


def _call(reg, ctx, name, attrs, inputs, convert):
    spec = reg.get_op(name)
    args = [None if a is None else (np.asarray(a) if spec.data_dependent
                                    or i in spec.static else convert(a))
            for i, a in enumerate(inputs)]
    out = spec.fn(ctx, dict(attrs), *args)
    return out if isinstance(out, tuple) else (out,)


def run_both(name, attrs, inputs, n_out=1):
    """(reference outputs, port outputs) as numpy, each lowering given its
    executor's operand kinds (device arrays, static numpy)."""
    ref = _call(jreg, JCtx(True, n_out, {}, None, None), name, attrs,
                inputs, jnp.asarray)
    got = _call(preg, PCtx(n_out), name, attrs, inputs,
                lambda a: torch.from_numpy(np.array(a)))
    return ([np.asarray(r) for r in ref],
            [g if isinstance(g, np.ndarray) else g.numpy() for g in got])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    _, name, attrs, inputs, n_out = case
    ref, got = run_both(name, attrs, inputs, n_out)
    assert len(got) >= len(ref) == n_out
    for r, g in zip(ref, got):
        assert g.shape == r.shape, (g.shape, r.shape)
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if np.issubdtype(r.dtype, np.floating):
            tol = F32_REL_TOL * max(float(np.abs(r).max()), 1.0)
            np.testing.assert_allclose(g, r, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g, r)


def _reference_ported_ops():
    return {n for n, s in jreg.OPS.items()
            if s.fn.__module__.split(".")[-1] in PORTED}


def test_port_registers_the_ported_modules_op_types():
    assert set(preg.OPS) == _reference_ported_ops()
    for name, spec in preg.OPS.items():
        ref = jreg.OPS[name]
        assert (tuple(spec.static), spec.data_dependent, spec.random) == \
            (tuple(ref.static), ref.data_dependent, ref.random), name


def test_every_op_type_has_a_case():
    assert {c[1] for c in CASES} == set(preg.OPS)


def test_unported_op_raises_naming_roadmap():
    for module, names in preg.NOT_PORTED.items():
        for name in names:
            assert jreg.OPS[name].fn.__module__.endswith(module)
            with pytest.raises(preg.OpError,
                               match=f"ROADMAP.md Queue 1.*ops/{module}.py"):
                preg.get_op(name)


def test_conv_integer_takes_the_int8_route_exactly(monkeypatch):
    """The ungrouped int8 ConvInteger runs on torch._int_mm (im2col), not
    the f64 route, and agrees with the reference bit for bit."""
    from rten_tpu_torch.ops import quantized as pq
    calls = []
    real = pq.int_mm

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(pq, "int_mm", spy)
    ref, got = run_both("ConvInteger", conv_attrs((3, 3, 3, 3), (2, 2)),
                        [u8(2, 3, 16, 16), i8(8, 3, 7, 7), np.uint8(77)])
    np.testing.assert_array_equal(got[0], ref[0])
    # The conv and its taps (ones at batch 1): K = 147 each.
    assert calls == [((2 * 8 * 8, 147), (147, 8)), ((8 * 8, 147), (147, 8))]
