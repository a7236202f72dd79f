"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): what
``Symbol.__add__`` emits for the residual add and ``Symbol.__mul__`` for a
loss's weight.  The same-shape names are aliases of ``broadcast_add``, as
in the reference package, so JSON written by either package names the op
the same way."""
from __future__ import annotations

from .registry import param, register

__all__ = []


@register("broadcast_add", arg_names=("lhs", "rhs"),
          aliases=("elemwise_add", "_plus", "_add"))
def _broadcast_add(attrs, lhs, rhs):
    return lhs + rhs


@register("_plus_scalar", params={"scalar": param(float, 0.0)})
def _plus_scalar(attrs, x):
    return x + attrs["scalar"]


@register("_mul_scalar", params={"scalar": param(float, 1.0)})
def _mul_scalar(attrs, x):
    return x * attrs["scalar"]
