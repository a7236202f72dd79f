"""Gluon activation block (counterpart of
``mxnet_tpu/gluon/nn/activations.py``; only ``Activation`` so far)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """Applies 'relu', 'sigmoid', 'tanh', 'softrelu' or 'softsign'."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")
