"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``): Accuracy,
TopKAccuracy, F1, MCC, Perplexity, MAE, MSE, RMSE, CrossEntropy,
NegativeLogLikelihood, PearsonCorrelation, Loss, Torch, Caffe,
CustomMetric, CompositeEvalMetric and ``create``.  A metric reads labels
and predictions on the host with ``asnumpy()``, one copy per array per
update, as the reference does, except ``Perplexity``, which picks the
label's probability on the prediction's device and copies only those;
``fit`` runs the update a few steps behind
the step that made the arrays (``train_loop.OverlappedLoop``)."""
from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "create", "np", "register"]

_REGISTRY = {}


def register(klass):
    """Register a metric class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError("labels/preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        # list names stay lists (multi-value metrics like the SSD MultiBox
        # CE+SmoothL1 pair; get_name_value zips them)
        self.name = list(name) if isinstance(name, (list, tuple)) \
            else str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_config(self):
        return {"metric": self.__class__.__name__, "name": self.name,
                **self._kwargs}

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, label, pred):
        for m in self.metrics:
            m.update_dict(label, pred)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int32).ravel()
            label = label.astype(np.int32).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).astype(np.int32)
            topk = np.argsort(-pred, axis=1)[:, :self.top_k]
            for i in range(label.shape[0]):
                self.sum_metric += int(label[i] in topk[i])
            self.num_inst += label.shape[0]


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).ravel()
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=1)
            pred = pred.ravel()
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (binary)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).ravel()
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=1)
            pred = pred.ravel()
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            denom = math.sqrt((self._tp + self._fp) * (self._tp + self._fn) *
                              (self._tn + self._fp) * (self._tn + self._fn))
            mcc = (self._tp * self._tn - self._fp * self._fn) / max(denom, 1e-12)
            self.sum_metric = mcc
            self.num_inst = 1


def _picked(pred, label):
    """``pred.reshape(-1, classes)[i, label[i]]`` for every row, as numpy:
    the label's probability is gathered where ``pred`` lies and only those
    values are copied to the host (an LM's prediction is rows x vocab)."""
    if isinstance(pred, NDArray):
        pred = pred._data
    if not isinstance(pred, torch.Tensor):
        pred = np.asarray(pred)
        pred = pred.reshape(-1, pred.shape[-1])
        return pred[np.arange(label.shape[0]), label]
    pred = pred.reshape(-1, pred.shape[-1])
    n = pred.shape[1]
    if pred.shape[0] != label.shape[0]:
        raise MXNetError("Perplexity: %d labels for %d predictions"
                         % (label.shape[0], pred.shape[0]))
    if label.size and (label.max() >= n or label.min() < -n):
        raise IndexError("Perplexity: a label outside [-%d, %d)" % (n, n))
    # numpy's negative indices count from the end
    idx = torch.from_numpy(np.where(label < 0, label + n, label)
                           .astype(np.int64)).to(pred.device)
    return _as_np(NDArray(pred.gather(1, idx[:, None])[:, 0]))


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log of the label's probability, positions
    labelled ``ignore_label`` left out.  The prediction is reshaped to
    (rows, its last dim) whatever ``axis`` says, as the reference's is."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).astype(np.int32).ravel()
            probs = _picked(pred, label)
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss += -np.log(np.maximum(probs, 1e-10)).sum()
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(pred.shape)
            self.sum_metric += np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(pred.shape)
            self.sum_metric += ((label - pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label).ravel(), _as_np(pred)
            probs = pred[np.arange(label.shape[0]), label.astype(np.int64)]
            self.sum_metric += (-np.log(probs + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.eps = eps


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label).ravel(), _as_np(pred).ravel()
            self.sum_metric += np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in preds:
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


@register
class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False, **kwargs):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__("custom(%s)" % name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                s, n = reval
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += reval
                self.num_inst += 1


def create(metric, *args, **kwargs):
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        c = CompositeEvalMetric()
        for m in metric:
            c.add(create(m))
        return c
    if metric in ("acc",):
        metric = "accuracy"
    if metric in ("ce",):
        metric = "crossentropy"
    if metric.lower() == "crossentropy":
        return CrossEntropy(*args, **kwargs)
    if metric.lower() == "nll_loss":
        return NegativeLogLikelihood(*args, **kwargs)
    if metric.lower().startswith("top_k_accuracy"):
        return TopKAccuracy(*args, **kwargs)
    klass = _REGISTRY.get(metric.lower())
    if klass is None:
        raise MXNetError("unknown metric %r (have %s)"
                         % (metric, sorted(_REGISTRY)))
    return klass(*args, **kwargs)
