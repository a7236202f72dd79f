"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
broadcasting binary ops with their legacy same-shape names, the
comparisons, the scalar and reversed-scalar forms, the unary math and
rounding family, ``add_n``, ``clip``, ``BlockGrad`` and ``make_loss``.
Every op is differentiable through PyTorch's autograd; where PyTorch's own
derivative differs from the reference's at a tie, the op is written so
that it gives the reference's: ``maximum``/``minimum`` split the gradient
at a tie (as ``torch.maximum`` does), ``clip`` and ``hard_sigmoid`` are
that same pair of ops, so a value on a bound gets half the gradient, and
``abs`` passes the gradient at 0 as +1.  ``mod`` is floor-mod
(``torch.remainder``, ``jnp.mod``), ``round`` and ``rint`` round half to
even, ``fix`` truncates.  A comparison or logical op returns 0/1 in its
left operand's dtype, as the reference's do."""
from __future__ import annotations

import math

import torch

from .registry import param, register

__all__ = []


def _full(x, s):
    return torch.full_like(x, s)


def _clip(x, lo, hi):
    """``min(max(x, lo), hi)`` as ``jnp.clip``: a value on a bound gets
    half the gradient."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


def _as(pred, like):
    return pred.to(like.dtype)


# --------------------------------------------------------------------------
# binary broadcasting ops and their legacy same-shape names
# --------------------------------------------------------------------------
_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}

_LEGACY_BINARY_ALIAS = {
    "add": ("elemwise_add", "_plus", "_add"),
    "sub": ("elemwise_sub", "_minus", "_sub"),
    "mul": ("elemwise_mul", "_mul"),
    "div": ("elemwise_div", "_div", "_scatter_elemwise_div"),
    "mod": ("_mod",),
    "power": ("_power", "_pow"),
    "maximum": ("_maximum",),
    "minimum": ("_minimum",),
    "hypot": ("_hypot",),
}

for _name, _f in _BINARY.items():
    register("broadcast_" + _name, arg_names=("lhs", "rhs"),
             aliases=_LEGACY_BINARY_ALIAS[_name])(
        (lambda f: lambda attrs, lhs, rhs: f(lhs, rhs))(_f))

_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}

for _name, _f in _CMP.items():
    register("broadcast_" + _name, arg_names=("lhs", "rhs"),
             aliases=("_" + _name,))(
        (lambda f: lambda attrs, lhs, rhs: _as(f(lhs, rhs), lhs))(_f))


# --------------------------------------------------------------------------
# scalar ops (attr ``scalar``); the ``_r*`` forms put the scalar on the left
# --------------------------------------------------------------------------
_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_full(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _full(x, s)),
    "_equal_scalar": lambda x, s: _as(x == s, x),
    "_not_equal_scalar": lambda x, s: _as(x != s, x),
    "_greater_scalar": lambda x, s: _as(x > s, x),
    "_greater_equal_scalar": lambda x, s: _as(x >= s, x),
    "_lesser_scalar": lambda x, s: _as(x < s, x),
    "_lesser_equal_scalar": lambda x, s: _as(x <= s, x),
    "_logical_and_scalar": lambda x, s: _as((x != 0) & bool(s), x),
    "_logical_or_scalar": lambda x, s: _as((x != 0) | bool(s), x),
    "_logical_xor_scalar": lambda x, s: _as((x != 0) ^ bool(s), x),
}

_SCALAR_ALIAS = {"_plus_scalar": ("_scatter_plus_scalar",),
                 "_minus_scalar": ("_scatter_minus_scalar",)}

for _name, _f in _SCALAR_OPS.items():
    register(_name, params={"scalar": param(float, 0.0)},
             aliases=_SCALAR_ALIAS.get(_name, ()))(
        (lambda f: lambda attrs, x: f(x, attrs["scalar"]))(_f))


# --------------------------------------------------------------------------
# unary ops
# --------------------------------------------------------------------------
def _abs(x):
    """``|x|`` whose gradient at 0 is +1, as ``jnp.abs``'s."""
    return torch.where(x >= 0, x, -x)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _softsign(x):
    return x / (1.0 + torch.abs(x))


_UNARY = {
    "negative": torch.neg,
    "abs": _abs,
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": _softsign,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "reciprocal": torch.reciprocal,
    "logical_not": lambda x: _as(x == 0, x),
}

for _name, _f in _UNARY.items():
    register(_name)((lambda f: lambda attrs, x: f(x))(_f))


@register("_copy", aliases=("identity",))
def _copy(attrs, x):
    """A copy of ``x`` (a new tensor: no later in-place write to either
    reaches the other)."""
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(attrs, x):
    """``x``, with no gradient flowing back through it."""
    return x.detach()


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(attrs, x):
    """Identity (``elemwise.py:172``); the head it makes is a loss whose
    backward seeds ones, which ``Executor.backward`` gives every head when
    no head gradient is passed."""
    return x


@register("hard_sigmoid", params={"alpha": param(float, 0.2),
                                  "beta": param(float, 0.5)})
def _hard_sigmoid(attrs, x):
    return _clip(attrs["alpha"] * x + attrs["beta"], 0.0, 1.0)


@register("clip", params={"a_min": param(float, 0.0, required=True),
                          "a_max": param(float, 0.0, required=True)})
def _clip_op(attrs, x):
    return _clip(x, attrs["a_min"], attrs["a_max"])


@register("smooth_l1", params={"scalar": param(float, 1.0)})
def _smooth_l1(attrs, x):
    """``0.5 s² x²`` where ``|x| < 1/s²``, else ``|x| - 0.5/s²``."""
    s2 = attrs["scalar"] ** 2
    ax = _abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


@register("add_n", aliases=("ElementWiseSum", "_sum"),
          params={"num_args": param(int, 0)})
def _add_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
