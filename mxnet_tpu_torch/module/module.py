"""Module: a Symbol bound on one context and trained with an optimizer
(counterpart of ``mxnet_tpu/module/module.py``).

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

``forward_backward`` stages the batch and ``update`` runs the fused step
(:class:`~mxnet_tpu_torch.fused_step.ModuleFusedStep`: forward, gradients
and one foreach SGD update), unless ``MXNET_TPU_FUSED_STEP=0``, which takes
the eager path: the executor's ``forward_backward`` fills ``grad_dict`` and
the updater updates one parameter at a time.  ``kvstore`` is ``"local"`` or
``None``: on one context the updater applies the update, as in the
reference; other stores, ``fit``/``score``/``predict`` and checkpoints are
not ported yet.
"""
from __future__ import annotations

from .. import fused_step as _fused
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), context=None):
        super().__init__()
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._exec_group = None
        self._optimizer = None
        self._updater = None
        self._fused_step = None

    # ---- bind / init ----------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        """Bind the symbol on the context for these input shapes
        (``module.py:110``)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, for_training, inputs_need_grad,
            grad_req=grad_req)
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
        copied to the executor."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if initializer == "__default__":
            from .. import initializer as init_mod
            initializer = init_mod.Uniform(0.01)
        ex = self._exec_group.execs[0]
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
                    initializer(name, arr)

        _fill(self._arg_params, arg_params)
        _fill(self._aux_params, aux_params)
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Set the parameters from dicts of arrays."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer and its updater (``module.py:190-240``): an
        optimizer named by a string gets ``rescale_grad = 1/batch`` unless
        the parameters set it, and one state slot per parameter."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before "
                             "init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        if kvstore not in ("local", None, ""):
            raise MXNetError("kvstore %r: the port's Module runs on one "
                             "context with kvstore='local' or None; "
                             "distributed stores are not ported yet"
                             % (kvstore,))
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._exec_group.batch_size)
            idx2name = opt.Optimizer.build_idx2name(self._param_names,
                                                    len(self._context))
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name, **params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._fused_step = _fused.ModuleFusedStep(self)

    # ---- step -----------------------------------------------------------
    def _fused(self):
        fs = self._fused_step
        if fs is not None and fs.stale():
            fs = self._fused_step = _fused.ModuleFusedStep(self)
        return fs

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before forward")
        fs = self._fused()
        if fs is not None:
            fs.flush_eager()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before backward")
        fs = self._fused()
        if fs is not None:
            fs.flush_eager()
        self._exec_group.backward(out_grads)

    def forward_backward(self, data_batch):
        """Stage the batch for the fused step, or run the forward and the
        backward now on the eager path (``module.py:276``)."""
        fs = self._fused()
        if fs is not None and fs.eligible():
            fs.flush_eager()
            fs.stage(data_batch)
            return
        if fs is not None:
            fs.flush_eager()
        self._exec_group.forward_backward(data_batch)

    def update(self):
        """Apply the optimizer (``module.py:291``): the fused step when a
        batch is staged and the fused path is eligible, else the eager
        per-parameter loop over ``grad_dict``."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        fs = self._fused()
        if fs is not None and fs.pending and fs.eligible():
            fs.step()
            return
        if fs is not None:
            fs.flush_eager()
        eg = self._exec_group
        for i, (grads, weights) in enumerate(zip(eg.grad_arrays,
                                                 eg.param_arrays)):
            for k, (w, g) in enumerate(zip(weights, grads)):
                self._updater(opt.Optimizer.slot_index(
                    i, len(self._context), k), g, w)

    def get_outputs(self, merge_multi_context=True):
        fs = self._fused()
        if fs is not None:
            fs.flush_eager()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_params(self):
        """Copies of the current parameters and auxiliary states, on the
        context."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before get_params")
        ex = self._exec_group.execs[0]
        arg = {n: NDArray(ex.arg_dict[n]._data.detach().clone())
               for n in self._param_names}
        aux = {n: NDArray(ex.aux_dict[n]._data.detach().clone())
               for n in self._aux_names}
        return arg, aux
