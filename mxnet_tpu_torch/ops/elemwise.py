"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): what
``Symbol.__add__`` emits for the residual add and ``Symbol.__mul__`` for a
loss's weight, and ``make_loss``.  The same-shape names are aliases of ``broadcast_add``, as
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


@register("make_loss")
def _make_loss(attrs, x):
    """Identity (``elemwise.py:172``); the head it makes is a loss whose
    backward seeds ones, which ``Executor.backward`` gives every head when
    no head gradient is passed."""
    return x
