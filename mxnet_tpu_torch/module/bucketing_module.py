"""BucketingModule: one bound Module per bucket, all training one set of
parameters (counterpart of ``mxnet_tpu/module/bucketing_module.py``).

    def sym_gen(seq_len):
        ...                                   # the net at this length
        return symbol, ("data",), ("softmax_label",)

    mod = BucketingModule(sym_gen, default_bucket_key=40)
    mod.fit(rnn.BucketSentenceIter(sentences, 32, buckets=[10, 20, 30, 40]),
            eval_metric=metric.Perplexity(ignore_label=0), optimizer="adam",
            num_epoch=1)

``sym_gen(bucket_key)`` gives each bucket's symbol and input names;
``bind`` binds the default bucket, and a batch whose ``bucket_key`` is
another bucket switches to that bucket's Module, binding it at its first
visit.  The reference copies the parameters into a bucket at every switch
after an update (``get_params`` then ``init_params``,
``bucketing_module.py:80-98``); here a bucket's executors bind the default
bucket's parameter, gradient and auxiliary NDArrays themselves
(``Module.bind(shared_module=)``, as the reference's own
``Executor.reshape`` keeps same-shape arrays), so a switch copies nothing
and every bucket reads the weights the last update wrote; a bucket whose
parameters cannot share them (another shape or dtype) raises.  The
optimizer, its updater (Adam's moments,
the update counts) and the kvstore are the current bucket's, shared with
every bucket, as the reference shares them; each bucket's parameters must
be the default bucket's, in the same order, so that a slot index names
the same parameter everywhere.

``BucketingModule`` does not override ``forward_backward``, as the
reference's does not: ``fit`` runs ``forward``, then ``backward``, then
the bucket's ``update`` with no batch staged, on the eager path.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._group2ctxs = group2ctxs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    def _gen_module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                sym, data_names, label_names, self.logger, self._context,
                self._work_load_list, self._fixed_param_names,
                group2ctxs=self._group2ctxs)
        return self._buckets[bucket_key]

    def _check_shared(self, mod, bucket_key):
        """Raise unless ``mod``'s executors hold the default bucket's very
        parameter and auxiliary NDArrays."""
        base = self._buckets[self._default_bucket_key]._exec_group
        for ex, ex0 in zip(mod._exec_group.execs, base.execs):
            if any(ex.arg_dict[n] is not ex0.arg_dict.get(n)
                   for n in mod._param_names) or \
                    any(ex.aux_dict[n] is not ex0.aux_dict.get(n)
                        for n in mod._aux_names):
                raise MXNetError(
                    "BucketingModule: bucket %r's parameters or auxiliary "
                    "states differ from the default bucket's in name, "
                    "shape or dtype" % (bucket_key,))

    def _borrow_optimizer(self, mod, src):
        """``mod`` trains with ``src``'s optimizer, updater and kvstore
        (``bucketing_module.py:88-92``)."""
        if mod._param_names != src._param_names:
            raise MXNetError(
                "BucketingModule: a bucket's parameters %s differ from %s; "
                "the shared updater's slots follow the parameter order"
                % (mod._param_names, src._param_names))
        mod._optimizer = src._optimizer
        mod._updater = src._updater
        mod._kvstore = src._kvstore
        mod.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket for these shapes (``provide_data`` of a
        ``BucketSentenceIter`` is the default bucket's)."""
        if self.binded and not force_rebind:
            return
        if force_rebind:
            # the other buckets bound the default bucket's old arrays
            self._buckets = {k: m for k, m in self._buckets.items()
                             if k == self._default_bucket_key}
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind, grad_req=grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s Module current, binding it at its first
        visit on the default bucket's arrays."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self.inputs_need_grad,
                     shared_module=self._buckets[self._default_bucket_key])
            self._check_shared(mod, bucket_key)
            mod.params_initialized = self.params_initialized
            if self._curr_module.optimizer_initialized:
                self._borrow_optimizer(mod, self._curr_module)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, **kwargs):
        """Initialise the current bucket's parameters, which every bound
        bucket shares."""
        self._curr_module.init_params(**kwargs)
        for mod in self._buckets.values():
            mod.params_initialized = mod.binded
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        """The current bucket's optimizer, shared with every bound
        bucket."""
        self._curr_module.init_optimizer(**kwargs)
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.binded:
                self._borrow_optimizer(mod, self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is not None and key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_params(self):
        return self._curr_module.get_params()

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
