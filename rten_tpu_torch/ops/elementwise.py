"""Unary / binary / variadic elementwise operators.

The torch counterpart of ``rten_tpu/ops/elementwise.py`` (ONNX-equivalent
semantics matching the reference's ``src/ops/unary_elementwise.rs`` /
``binary_elementwise.rs`` / ``variadic_elementwise.rs``).

Conventions: comparisons/logical ops return int32 (the reference coerces
bool→i32 at convert time); integer division truncates toward zero (Rust
i32 semantics; torch's ``//`` floors, so Div uses ``rounding_mode="trunc"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fmt import schema
from .common import as_bool, bool_out
from .registry import register


def _unary(name, fn):
    @register(name)
    def op(ctx, attrs, x):
        return fn(x)
    op.__name__ = name.lower()
    return op


_unary("Abs", torch.abs)
_unary("Acos", torch.acos)
_unary("Asin", torch.asin)
_unary("Atan", torch.atan)
_unary("Ceil", torch.ceil)
_unary("Cos", torch.cos)
_unary("Erf", torch.erf)
_unary("Exp", torch.exp)
_unary("Floor", torch.floor)
_unary("Identity", lambda x: x)
_unary("Log", torch.log)
_unary("Neg", torch.neg)
_unary("Relu", lambda x: torch.clamp(x, min=0))
_unary("Round", torch.round)  # round-half-to-even, same as the ONNX spec
_unary("Sigmoid", torch.sigmoid)
_unary("Sign", torch.sign)
_unary("Sin", torch.sin)
# jax.nn.softplus is logaddexp(x, 0), with no threshold switch.
_unary("Softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)))
_unary("Sqrt", torch.sqrt)
_unary("Tan", torch.tan)
_unary("Tanh", torch.tanh)


@register("Reciprocal")
def reciprocal(ctx, attrs, x):
    return torch.ones_like(x) / x if x.is_floating_point() else \
        torch.div(torch.ones_like(x), x, rounding_mode="trunc")


@register("Not")
def not_(ctx, attrs, x):
    return bool_out(x == 0)


@register("Gelu")
def gelu(ctx, attrs, x):
    # Exact (erf-based) variant, matching the reference (src/ops/mod.rs Gelu).
    return F.gelu(x, approximate="none")


@register("LeakyRelu")
def leaky_relu(ctx, attrs, x):
    alpha = float(attrs.get("alpha", 0.01))
    return torch.where(x >= 0, x, alpha * x)


@register("Elu")
def elu(ctx, attrs, x):
    alpha = float(attrs.get("alpha", 1.0))
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@register("HardSigmoid")
def hard_sigmoid(ctx, attrs, x):
    alpha = float(attrs.get("alpha", 0.2))
    beta = float(attrs.get("beta", 0.5))
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("HardSwish")
def hard_swish(ctx, attrs, x):
    # x * HardSigmoid(x) with alpha=1/6, beta=0.5 (ONNX spec).
    return x * torch.clamp(x / torch.full_like(x, 6.0) + 0.5, 0.0, 1.0)


@register("Clip")
def clip(ctx, attrs, x, min=None, max=None):
    if min is not None:
        x = torch.maximum(x, min.to(x.dtype))
    if max is not None:
        x = torch.minimum(x, max.to(x.dtype))
    return x


@register("Cast")
def cast(ctx, attrs, x):
    to = int(attrs.get("to", 0))
    name = schema.ENUMS["DataType"][to]
    if name == "Int32":
        return x.to(torch.int32)
    return x.to(torch.float32)


# -- binary ----------------------------------------------------------------

def _promote(a, b):
    """Both operands in their common dtype (jnp's promotion for the
    float32 / int32 / uint8 / int8 mixes that graphs carry)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _binary(name, fn):
    @register(name)
    def op(ctx, attrs, a, b):
        return fn(*_promote(a, b))
    op.__name__ = name.lower()
    return op


_binary("Add", torch.add)
_binary("Sub", torch.sub)
_binary("Mul", torch.mul)


@register("Pow")
def pow_(ctx, attrs, a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        # Integer powers: exact in f64 for the int32 range (CUDA has no
        # integer pow of tensors), then back to the integer type.
        return torch.pow(a.to(torch.float64), b.to(torch.float64)) \
            .round().to(torch.int64).to(a.dtype)
    return torch.pow(a, b)


@register("Div")
def div(ctx, attrs, a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        # Truncating division, matching Rust i32 `/` in the reference.
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


@register("Mod")
def mod(ctx, attrs, a, b):
    a, b = _promote(a, b)
    fmod = bool(attrs.get("fmod", False))
    if fmod:
        # C fmod: result has the sign of the dividend.
        return torch.fmod(a, b)
    # Python-style modulo: result has the sign of the divisor.
    return torch.remainder(a, b)


def _compare(name, fn):
    @register(name)
    def op(ctx, attrs, a, b):
        return bool_out(fn(*_promote(a, b)))
    op.__name__ = name.lower()
    return op


_compare("Equal", torch.eq)
_compare("Greater", torch.gt)
_compare("GreaterOrEqual", torch.ge)
_compare("Less", torch.lt)
_compare("LessOrEqual", torch.le)


def _logical(name, fn):
    @register(name)
    def op(ctx, attrs, a, b):
        return bool_out(fn(as_bool(a), as_bool(b)))
    op.__name__ = name.lower()
    return op


_logical("And", torch.logical_and)
_logical("Or", torch.logical_or)
_logical("Xor", torch.logical_xor)


@register("Where")
def where(ctx, attrs, cond, x, y):
    return torch.where(as_bool(cond), *_promote(x, y))


# -- variadic --------------------------------------------------------------

@register("Max")
def max_(ctx, attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(*_promote(out, x))
    return out


@register("Min")
def min_(ctx, attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(*_promote(out, x))
    return out


@register("Sum")
def sum_(ctx, attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*_promote(out, x))
    return out


@register("Mean")
def mean(ctx, attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*_promote(out, x))
    return out / len(xs)
