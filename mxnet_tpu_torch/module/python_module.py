"""Modules computed in Python rather than bound from a Symbol (counterpart
of ``mxnet_tpu/module/python_module.py``): :class:`PythonModule`, a
parameter-free base that keeps the shapes, and :class:`PythonLossModule`,
a loss head for a ``SequentialModule``: its forward passes the scores
through, its backward makes their gradient with ``grad_func(scores,
labels)`` or, without one, softmax cross-entropy's, ``(softmax(scores) -
onehot(labels)) / batch``, computed on the host in numpy as the
reference computes it.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..ndarray import ndarray as nd
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A parameter-free module whose subclasses give
    ``_compute_output_shapes`` and their forward and backward."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Nothing to initialise."""
        self.params_initialized = True

    def update(self):
        """Nothing to update."""

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """A Python module leaves the metric alone, as the reference's."""

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Keep the input shapes (a ``DataDesc``'s shape, or the shape
        itself) and compute the output shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        def plain(s):
            return tuple(s.shape) if hasattr(s, "shape") else tuple(s)

        self._data_shapes = [plain(s) for s in data_shapes]
        self._label_shapes = ([plain(s) for s in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Nothing to optimise."""


class PythonLossModule(PythonModule):
    """A loss layer as a module (``python_module.py:102``): ``forward``
    keeps the scores (and, in training, the labels), ``get_outputs`` gives
    the scores back, and ``backward`` makes their gradient."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise MXNetError("PythonLossModule takes one data and one label "
                             "name")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        """The scores' gradient: the loss head starts the backward, so
        ``out_grads`` must be None."""
        if out_grads is not None:
            raise MXNetError("PythonLossModule is a loss head: it starts "
                             "the gradients and takes none")
        if not self.for_training:
            raise MXNetError("PythonLossModule.backward needs a module "
                             "bound for training")
        ctx = self._scores.context
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(np.asarray(grad), ctx)
            self._scores_grad = grad
            return
        scores = self._scores.asnumpy()
        labels = self._labels.asnumpy().astype(np.int64).ravel()
        prob = np.exp(scores - scores.max(axis=1, keepdims=True))
        prob /= prob.sum(axis=1, keepdims=True)
        prob[np.arange(len(labels)), labels] -= 1.0
        self._scores_grad = nd.array(prob / len(labels), ctx)

    def get_input_grads(self, merge_multi_context=True):
        if not merge_multi_context:
            raise MXNetError("PythonLossModule has one context")
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError
