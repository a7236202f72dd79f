"""Gluon ``Trainer`` (counterpart of ``mxnet_tpu/gluon/trainer.py:33-379``):
applies an optimizer to a set of Parameters from the gradients that
``autograd.backward`` wrote into them.

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sums each gradient over the contexts through the kvstore (the
local store, made when the parameters live on more than one context) and
updates every parameter whose ``grad_req`` is not ``"null"`` with
``rescale_grad = scale / batch_size``.  On one context the update is the
optimizer's fused arm (``Optimizer.fused_update``: every parameter at once
in foreach kernels, in place; SGD, NAG, Adam and RMSProp) under the
``MXNET_TPU_FUSED_STEP`` switch, as ``Module``'s fused step takes it,
bit-identical to the per-parameter updater it replaces; otherwise, or
where a slot's state is not fusable, one updater per context updates each
parameter.  The optimizer reads each Parameter's ``lr_mult``/``wd_mult``
through its ``param_dict``.  ``save_states``/``load_states`` read and write
the reference's ``.states`` pickle.  ``ignore_stale_grad`` is accepted and,
as in the reference, every live parameter is updated with whatever its
gradient array holds.  ``fit_epoch`` and the multi-precision Trainer wait
for later slices (ROADMAP.md Queue 1 items 4 and 6).
"""
from __future__ import annotations

from .. import fused_step as _fused
from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from ..fused_step import _tensors
from ..optimizer import fused_state_leaves
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies ``optimizer`` (a name with ``optimizer_params``, or an
    ``Optimizer``) to ``params`` (a list of Parameters or a dict of
    them)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(p))
        self._params = list(params)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_name = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False

    def _check_contexts(self):
        contexts = None
        for p in self._params:
            ctx = p.list_ctx()
            if contexts is not None and contexts != ctx:
                raise ValueError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (p.name, ctx, contexts))
            contexts = ctx
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and list(optimizer_params) != \
                    ["rescale_grad"]:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        """The local store when the parameters live on several contexts
        (``trainer.py:_create_kvstore``); none on one."""
        name = self._kvstore_name
        if isinstance(name, kvs.KVStore):
            kv = name
        elif name is None or name == "None" or len(self._contexts) == 1:
            kv = None
        else:
            kv = kvs.create(name)
        if self._update_on_kvstore:
            raise MXNetError("update_on_kvstore=True needs a distributed "
                             "kvstore, which is not ported yet")
        if kv is not None:
            if self._compression_params:
                raise MXNetError("gradient compression is not ported yet")
            for i, p in enumerate(self._params):
                kv.init(i, p.list_data()[0])
        self._kvstore = kv
        self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Sum the gradients over the contexts, then update every live
        parameter with ``rescale_grad = scale / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients over the contexts only (then call
        :meth:`update`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _live(self):
        return [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        live = self._live()
        if live:
            grads = [self._params[i].list_grad() for i in live]
            self._kvstore.push(live, grads)
            self._kvstore.pull(live, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update the parameters only (after :meth:`allreduce_grads`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _fused_eligible(self, live):
        o = self._optimizer
        return (_fused.enabled() and len(self._contexts) == 1 and live
                and all(o.supports_fused(self._params[i].list_data()[0])
                        for i in live))

    def _fused_update(self, live) -> bool:
        """Every live parameter through ``Optimizer.fused_update`` in one
        call; False (nothing updated) when a slot's state is not
        fusable."""
        o, upd = self._optimizer, self._updaters[0]
        weights, grads, states = [], [], []
        for i in live:
            w = self._params[i].list_data()[0]
            st = upd.state(i, w)
            if o.fused_mp(w):
                leaves = fused_state_leaves(st, mp=True)
                if leaves is None:
                    return False
                st = tuple(leaf._data for leaf in leaves)
            else:
                st = _tensors(st)
            weights.append(w._data)
            grads.append(self._params[i].list_grad()[0]._data)
            states.append(st)
        o.fused_update(live, weights, grads, states)
        return True

    def _update(self, ignore_stale_grad=False):
        live = self._live()
        if self._fused_eligible(live) and self._fused_update(live):
            return
        for i in live:
            p = self._params[i]
            for upd, arr, grad in zip(self._updaters, p.list_data(),
                                      p.list_grad()):
                upd(i, grad, arr)

    def save_states(self, fname):
        """Write the optimizer's states (and update count) in the
        reference's ``.states`` format."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a ``.states`` file (the port's or the reference's)."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
