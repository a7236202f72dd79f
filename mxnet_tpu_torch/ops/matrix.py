"""Shape ops of the serving path (counterpart of
``mxnet_tpu/ops/matrix.py``)."""
from __future__ import annotations

from .registry import register

__all__ = []


@register("Flatten", aliases=("flatten",))
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)
