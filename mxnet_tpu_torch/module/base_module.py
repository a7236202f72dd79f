"""BaseModule: the training-harness interface and its loops (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit`` (bind, init, the epoch loop
of forward_backward, update, metric and callbacks), ``score``, ``predict``
and ``iter_predict``.

``fit`` keeps the reference's overlapped tail: with ``overlap_depth`` > 0
(default ``MXNET_IO_OVERLAP_DEPTH``, 2) each step's metric update and batch
callback run that many steps later (``train_loop.OverlappedLoop``), in step
order, so the host's copies of outputs and labels do not stall the next
step.  The reference's fault tolerance (``MXNET_CKPT_DIR``: periodic
checkpoints, preemption and resume; the chaos harness) is not ported yet:
``fit`` raises while ``MXNET_CKPT_DIR`` is set rather than train without
it.
"""
from __future__ import annotations

import logging
import os
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..callback import BatchEndParam
from ..ndarray.ndarray import concatenate

__all__ = ["BaseModule"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _call(callbacks, param):
    for cb in _as_list(callbacks):
        cb(param)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def bind(self, *a, **kw):
        raise NotImplementedError

    def init_params(self, *a, **kw):
        raise NotImplementedError

    def init_optimizer(self, *a, **kw):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    def forward_backward(self, data_batch):
        """A forward in training mode, then the backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def _check_ready(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")

    # ---- evaluation ----------------------------------------------------
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """The metric over ``eval_data`` in inference mode
        (``base_module.py:77``), as ``[(name, value)]``."""
        self._check_ready()
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                _call(batch_end_callback,
                      BatchEndParam(epoch, nbatch, eval_metric))
        if score_end_callback is not None:
            _call(score_end_callback, BatchEndParam(epoch, nbatch,
                                                    eval_metric))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch, the padding
        rows cut off the outputs."""
        self._check_ready()
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outs = [o[0:o.shape[0] - pad] for o in self.get_outputs()]
            yield outs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` (``base_module.py:96``): each
        output joined over the batches, the padding rows cut off."""
        output_list = [[o.copy() for o in outs] for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return []
        if not merge_batches:
            return output_list
        merged = [concatenate([b[i] for b in output_list])
                  for i in range(len(output_list[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    # ---- training ------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, overlap_depth=None):
        """The reference's training loop (``base_module.py:117-254``)
        without its fault tolerance (see the module docstring)."""
        if num_epoch is None:
            raise MXNetError("num_epoch must be specified")
        if os.environ.get("MXNET_CKPT_DIR"):
            raise MXNetError("MXNET_CKPT_DIR is set: fit's fault-tolerant "
                             "checkpoints (checkpoint.py, chaos.py) are not "
                             "ported yet; unset it, or checkpoint with "
                             "epoch_end_callback=callback.do_checkpoint")
        from .. import initializer as init_mod
        from ..train_loop import OverlappedLoop, default_overlap_depth
        initializer = initializer or init_mod.Uniform(0.01)
        depth = default_overlap_depth() if overlap_depth is None \
            else max(0, int(overlap_depth))
        overlap = depth > 0 and monitor is None
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            loop = OverlappedLoop(depth) if overlap else None
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                deferred = None
                if loop is not None:
                    deferred = self.defer_metric_update(eval_metric,
                                                        data_batch.label)
                if deferred is not None:
                    def _tail(_d=deferred, _i=nbatch, _e=epoch):
                        _d()
                        if batch_end_callback is not None:
                            _call(batch_end_callback,
                                  BatchEndParam(_e, _i, eval_metric))
                    loop.push(_tail)
                else:
                    self.update_metric(eval_metric, data_batch.label)
                    if batch_end_callback is not None:
                        _call(batch_end_callback,
                              BatchEndParam(epoch, nbatch, eval_metric))
            if loop is not None:
                loop.drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def defer_metric_update(self, eval_metric, labels):
        """A closure that updates the metric later, or None where that
        would not be the same update."""
        return None
