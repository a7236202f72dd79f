"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``; so far
``SoftmaxCrossEntropyLoss`` with sparse labels, the loss of the LSTM
language model).

A loss is a HybridBlock of two inputs, ``loss(pred, label)``, giving one
value per example: the mean over every axis but ``batch_axis``.  Called on
Symbols it builds its graph; called on NDArrays it runs that graph.
``FusedTrainer`` takes a loss block and averages its output to the step's
scalar.
"""
from __future__ import annotations

from .. import symbol as _symbol
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..symbol import Symbol
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None):
    """Scale by the number ``weight`` (``loss.py:22-30``; per-example
    ``sample_weight`` is not ported: a loss here takes pred and label)."""
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base class of losses: ``hybrid_forward(F, pred, label)``."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis
        self._graph = None

    def __repr__(self):
        return "{name}(batch_axis={_batch_axis}, w={_weight})".format(
            name=self.__class__.__name__, **self.__dict__)

    def graph(self):
        """(pred variable, label variable, per-example loss Symbol)."""
        if self._graph is None:
            pred, label = _symbol.var("pred"), _symbol.var("label")
            with self.name_scope():
                out = self.hybrid_forward(_symbol, pred, label)
            if out.list_arguments() != ["pred", "label"]:
                raise MXNetError("a loss's graph takes pred and label only, "
                                 "got %s" % out.list_arguments())
            self._graph = pred, label, out
        return self._graph

    def __call__(self, pred, label):
        if isinstance(pred, Symbol):
            with self.name_scope():
                return self.hybrid_forward(_symbol, pred, label)
        if not isinstance(pred, NDArray):
            raise MXNetError("a loss takes NDArrays or Symbols, got %s"
                             % type(pred).__name__)
        if self._cached_op is None:
            from ..cached_op import CachedOp
            self._cached_op = CachedOp(self.graph()[2])
        given = {"pred": pred, "label": label}
        return self._cached_op(*[given[n] for n in
                                 self._cached_op.input_names])

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy (``loss.py:100-138``).  With sparse labels
    (class ids, as floats or ints) and logits, it is the fused
    ``streaming_softmax_ce``; ``from_logits`` and dense labels are not
    ported yet and raise."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if from_logits or not sparse_label:
            raise MXNetError("SoftmaxCrossEntropyLoss: only sparse labels on "
                             "logits are ported (ROADMAP.md Queue 1 item 7)")
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label):
        loss = F.streaming_softmax_ce(pred, label, axis=self._axis,
                                      keepdims=True)
        loss = _apply_weighting(F, loss, self._weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
