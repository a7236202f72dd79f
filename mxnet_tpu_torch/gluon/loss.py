"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): L2, L1,
sigmoid binary cross-entropy, softmax cross-entropy (sparse or dense
labels, on logits or log-probabilities), KL divergence, Huber, hinge,
squared hinge, logistic, triplet and Poisson NLL.  ``CTCLoss`` waits for
the ctc op (ROADMAP.md Queue 1 item 9).

A loss is a HybridBlock, ``loss(pred, label[, sample_weight])``, giving one
value per example: the mean over every axis but ``batch_axis``, scaled by
the number ``weight`` and by ``sample_weight`` (broadcast) when given.  On
NDArrays it runs op by op (recorded under ``autograd.record``), or through
its graph once hybridized; on Symbols it builds its graph.
``FusedTrainer`` takes a loss block and averages its output to the step's
scalar.
"""
from __future__ import annotations

import numpy as np

from .. import symbol as _symbol
from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Scale by ``sample_weight`` (broadcast) and the number ``weight``
    (``loss.py:22-30``)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base class of losses: ``hybrid_forward(F, pred, label, ...)``."""

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

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """``0.5 * weight * (pred - label)²``."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy, on logits in the stable log-sum-exp form, or
    on probabilities with ``from_sigmoid``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy (``loss.py:100-138``).  Sparse labels (class
    ids) on logits take the fused ``streaming_softmax_ce``; with
    ``from_logits`` ``pred`` is already log-probabilities (``pick``), and
    dense labels are distributions (``-sum(pred * label)``)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            loss = F.streaming_softmax_ce(pred, label, axis=self._axis,
                                          keepdims=True)
            loss = _apply_weighting(F, loss, self._weight, sample_weight)
            return F.mean(loss, axis=self._batch_axis, exclude=True)
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = F.reshape_like(label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities (or
    logits without ``from_logits``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    """Quadratic within ``rho`` of 0, linear outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)²``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for labels in {-1, 1} (``signed``)
    or {0, 1} (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """``max(0, |positive - pred|² - |negative - pred|² + margin)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, None)


class PoissonNLLLoss(Loss):
    """``exp(pred) - target * pred`` on log-rates (``from_logits``), else
    ``pred - target * log(pred + epsilon)``, with Stirling's term under
    ``compute_full``; the mean over everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = F.reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target) - target + \
                0.5 * F.log(2 * target * np.pi)
            stirling = F.where(target > 1, stirling, F.zeros_like(stirling))
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)
