"""Reductions and broadcasts (counterpart of ``mxnet_tpu/ops/reduce.py``):
what the LSTM layer's zero states, the Gluon losses and the transformer LM's
position ids use."""
from __future__ import annotations

import torch

from .registry import param, register

__all__ = []


def _axes(attrs, ndim):
    """The reduced axes: ``axis`` (all when unset), or every other axis
    with ``exclude`` (``reduce.py:23-31``)."""
    axis = attrs["axis"]
    axes = tuple(range(ndim)) if not axis else tuple(a % ndim for a in axis)
    if attrs["exclude"]:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


@register("mean", params={"axis": param("shape", None),
                          "keepdims": param(bool, False),
                          "exclude": param(bool, False)})
def _mean(attrs, x):
    axes = _axes(attrs, x.dim())
    if not axes:                # nothing to reduce, as jnp.mean(axis=())
        return x
    return torch.mean(x, dim=axes, keepdim=attrs["keepdims"])


@register("broadcast_axis", aliases=("broadcast_axes",),
          params={"axis": param("shape", ()), "size": param("shape", ())})
def _broadcast_axis(attrs, x):
    tgt = list(x.shape)
    for a, s in zip(attrs["axis"], attrs["size"]):
        tgt[a % x.dim()] = s
    return x.expand(tuple(tgt))


@register("broadcast_like")
def _broadcast_like(attrs, x, like):
    """``x`` broadcast to ``like``'s shape (``reduce.py:103``)."""
    return x.expand(tuple(like.shape))
