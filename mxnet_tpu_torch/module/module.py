"""Module: a Symbol bound on a list of contexts and trained with an
optimizer (counterpart of ``mxnet_tpu/module/module.py``).

    mod = Module(transformer_lm(cfg), context=[gpu(0)])
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(initializer.Xavier(rnd_type="gaussian", magnitude=2.0))
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    for batch in io.SyntheticLMIter(cfg.vocab_size, T, batch_size=B):
        mod.forward_backward(batch)
        mod.update()
        loss = mod.get_outputs()[0]

or ``mod.fit(train_iter, num_epoch=..., ...)`` with ``score`` and
``predict`` (:class:`~mxnet_tpu_torch.module.base_module.BaseModule`).

On one context ``forward_backward`` stages the batch and ``update`` runs
the fused step (:class:`~mxnet_tpu_torch.fused_step.ModuleFusedStep`:
forward, gradients and one foreach update, for SGD, NAG, Adam and RMSProp),
unless ``MXNET_TPU_FUSED_STEP=0`` or the optimizer has no fused update;
then the executors' ``forward_backward`` fills ``grad_dict`` and ``update``
pushes each parameter's gradients from every context to the kvstore,
pulls their sum back (``module.py:189-240``: the local store reduces
across contexts before the updater), and updates each (parameter, context)
slot.  ``kvstore`` is ``"local"``, ``"device"``, a store, or None (no
reduction); the distributed stores and the monitor are not ported yet.
``save_checkpoint`` writes the reference's files, and ``Module.load``
reads them, optimizer states included.
"""
from __future__ import annotations

import logging

from .. import amp
from .. import fused_step as _fused
from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import InitDesc
from ..io import DataDesc
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        # state_names and compression_params are accepted and ignored, as
        # the reference's Module does
        super().__init__(logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._work_load_list = work_load_list
        self._group2ctxs = group2ctxs
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._exec_group = None
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        self._fused_step = None
        self._preload_opt_states = None

    # ---- info -----------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape for d in
                  self.data_shapes + self.label_shapes}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # ---- bind / init ----------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind one executor per context for these input shapes
        (``module.py:110``); ``grad_req`` is one request or a dict by
        name.  With ``shared_module``, a bound Module on the same
        contexts, the executors bind its parameter, gradient and
        auxiliary arrays wherever the shapes agree, so the two train one
        set of tensors (``BucketingModule``'s buckets).  Under
        ``MXNET_TPU_BF16`` (read now, as the reference reads it at bind)
        the arrays take ``amp.type_dict_for``'s dtypes: bf16 data and
        weights, fp32 labels, gammas, betas and moving statistics."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                        for l in (label_shapes or [])]
        type_dict = None
        if amp.enabled():
            type_dict = amp.type_dict_for(self._symbol, self._data_names,
                                          [l.name for l in label_shapes])
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            [d if isinstance(d, DataDesc) else DataDesc(*d)
             for d in data_shapes], label_shapes, self._param_names,
            for_training, inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            type_dict=type_dict, group2ctxs=self._group2ctxs, shared_group=(
                shared_module._exec_group if shared_module is not None
                else None))
        self.binded = True
        if self._arg_params is not None:
            self._exec_group.set_params(self._arg_params, self._aux_params,
                                        allow_extra=True)

    def init_params(self, initializer="__default__", arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` or the
        initializer (``module.py:150``).  As in the reference, the values
        are made in host copies on the CPU (drawn from the CPU generator,
        so a seed gives the same weights whatever the context) and then
        copied to every executor."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if initializer == "__default__":
            from .. import initializer as init_mod
            initializer = init_mod.Uniform(0.01)
        ex = self._exec_group.execs[0]
        attrs = self._symbol.attr_dict()
        self._arg_params = {n: ex.arg_dict[n].copyto(cpu())
                            for n in self._param_names}
        self._aux_params = {n: ex.aux_dict[n].copyto(cpu())
                            for n in self._aux_names}

        def _fill(params, source):
            for name, arr in params.items():
                if source is not None and name in source:
                    arr[:] = source[name]
                elif source is not None and not allow_missing:
                    raise MXNetError("parameter %r missing from provided "
                                     "params (allow_missing=False)" % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, {})), arr)

        _fill(self._arg_params, arg_params)
        _fill(self._aux_params, aux_params)
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the kvstore, the optimizer and its updater
        (``module.py:190-240``): an optimizer named by a string gets
        ``rescale_grad = 1/batch`` unless the parameters set it, and one
        state slot per (parameter, context); the store is initialised
        with every parameter.  States that ``Module.load`` preloaded are
        set on the updater."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before "
                             "init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._exec_group.batch_size)
            idx2name = opt.Optimizer.build_idx2name(self._param_names,
                                                    len(self._context))
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name, **params)
        self._optimizer = optimizer
        kv = kvs.create(kvstore) if isinstance(kvstore, str) and kvstore \
            else (kvstore or None)
        self._kvstore = kv
        self._updater = opt.get_updater(optimizer)
        if kv is not None:
            for name in self._param_names:
                kv.init(name, self._arg_params[name])
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            with open(self._preload_opt_states, "rb") as f:
                self._updater.set_states(f.read())
            self._preload_opt_states = None
        self._fused_step = _fused.ModuleFusedStep(self)

    # ---- step -----------------------------------------------------------
    def _fused(self):
        """The fused step, made again after a ``force_rebind``."""
        fs = self._fused_step
        if fs is not None and fs.stale():
            fs = self._fused_step = _fused.ModuleFusedStep(self)
        return fs

    def _flush(self):
        """Replay a staged batch on the eager path, so that its outputs
        and gradients become observable."""
        fs = self._fused()
        if fs is not None:
            fs.flush_eager()

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before forward")
        self._flush()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before backward")
        self._flush()
        self._exec_group.backward(out_grads)

    def forward_backward(self, data_batch):
        """Stage the batch for the fused step, or run the forward and the
        backward now on the eager path (``module.py:276``)."""
        fs = self._fused()
        if fs is not None and fs.eligible():
            fs.flush_eager()
            fs.stage(data_batch)
            return
        self._flush()
        self._exec_group.forward_backward(data_batch)

    def update(self):
        """Apply the optimizer (``module.py:291``): the fused step when a
        batch is staged and the fused path is eligible, else the kvstore
        reduction and the per-slot loop over ``grad_dict``."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        fs = self._fused()
        if fs is not None and fs.pending and fs.eligible() and fs.step():
            return
        self._flush()
        eg = self._exec_group
        ndev = len(self._context)
        live = [i for i, g in enumerate(eg.grad_arrays) if g]
        if self._kvstore is not None and live:
            names = [self._param_names[i] for i in live]
            grads = [eg.grad_arrays[i] for i in live]
            self._kvstore.push(names, grads)
            self._kvstore.pull(names, out=grads)
        for i in live:
            for k, (w, g) in enumerate(zip(eg.param_arrays[i],
                                           eg.grad_arrays[i])):
                self._updater(opt.Optimizer.slot_index(i, ndev, k), g, w)

    def get_outputs(self, merge_multi_context=True):
        self._flush()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True to get the "
                             "inputs' gradients")
        self._flush()
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._flush()
        self._exec_group.update_metric(eval_metric, labels)

    def defer_metric_update(self, eval_metric, labels):
        """This step's outputs and labels, captured now, and a closure that
        updates the metric with them later (``module.py:360``), for
        ``fit``'s overlapped tail; None on several contexts, as the
        reference's."""
        self._flush()
        eg = self._exec_group
        if len(eg.execs) != 1:
            return None
        lab = [l[eg.slices[0]] for l in labels]
        outs = list(eg.execs[0].outputs)
        return lambda: eval_metric.update(lab, outs)

    def get_params(self):
        """Copies of the parameters and auxiliary states, averaged over the
        contexts, on the first context."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before get_params")
        arg, aux = {}, {}
        self._exec_group.get_params(arg, aux)
        return arg, aux

    def install_monitor(self, mon):
        raise MXNetError("Module.install_monitor: monitor.py is not ported "
                         "yet")

    # ---- checkpoints ----------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (the updater's
        pickled states)."""
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open("%s-%04d.states" % (prefix, epoch), "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint (``module.py:413-433``): its parameters
        count as initialised, and with ``load_optimizer_states`` its
        ``.states`` file is set on the updater by ``init_optimizer``."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch, cpu())
        mod = Module(sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod
