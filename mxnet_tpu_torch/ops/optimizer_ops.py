"""Optimizer update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``):
``sgd_update`` and ``sgd_mom_update``, the updates of ``optimizer.SGD``.

Convention, the reference's (``optimizer_ops.py:1-13``): the raw gradient
is scaled by ``rescale_grad``, then clipped to ``clip_gradient`` (when it
is >= 0), then ``wd * weight`` is added.  Each op returns new tensors; the
updater writes them into the weight's and the state's NDArrays.
"""
from __future__ import annotations

import torch

from .registry import param, register

__all__ = ["prep_grad"]

_COMMON = {
    "lr": param(float, 0.0, required=True),
    "wd": param(float, 0.0),
    "rescale_grad": param(float, 1.0),
    "clip_gradient": param(float, -1.0),
}


def prep_grad(attrs, weight, grad):
    """``clip(grad * rescale_grad) + wd * weight``."""
    g = grad * attrs["rescale_grad"]
    if attrs["clip_gradient"] >= 0:
        g = torch.clamp(g, -attrs["clip_gradient"], attrs["clip_gradient"])
    return g + attrs["wd"] * weight


@register("sgd_update", params=dict(_COMMON), arg_names=("weight", "grad"))
def _sgd_update(attrs, weight, grad):
    """``weight - lr * g`` (``optimizer_ops.py:46``)."""
    return weight - attrs["lr"] * prep_grad(attrs, weight, grad)


@register("sgd_mom_update", params={**_COMMON, "momentum": param(float, 0.0)},
          nout=2, visible=1, aux_writeback={1: 2},
          arg_names=("weight", "grad", "mom"))
def _sgd_mom_update(attrs, weight, grad, mom):
    """``mom' = momentum * mom - lr * g``, ``weight + mom'``
    (``optimizer_ops.py:52``); returns (new weight, new momentum)."""
    g = prep_grad(attrs, weight, grad)
    new_mom = attrs["momentum"] * mom - attrs["lr"] * g
    return weight + new_mom, new_mom
