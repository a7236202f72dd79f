"""Checkpoints and the legacy ``FeedForward`` API (counterpart of
``mxnet_tpu/model.py``): ``prefix-symbol.json`` holds the graph and
``prefix-%04d.params`` the parameters, named ``arg:<name>`` and
``aux:<name>``, in the npz container of ``ndarray.save``, so each package
reads the checkpoints the other writes.  bf16 parameters (a Module bound
under ``MXNET_TPU_BF16``) are written as the reference writes them, two-byte
``|V2`` entries, and load back as bf16; a multi-precision updater's
``.states`` hold each slot's ``(momentum, master)`` in fp32."""
from __future__ import annotations

import logging
from typing import Optional

from . import ndarray as nd
from . import symbol as sym_mod
from .callback import BatchEndParam  # noqa: F401  (re-exported, as there)
from .context import Context, current_context

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "FeedForward", "BatchEndParam"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``
    (``remove_amp_cast`` is accepted and ignored, as the reference's
    is)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)
    logging.info('Saved checkpoint to "%s-%04d.params"', prefix, epoch)


def load_params(prefix, epoch, ctx: Optional[Context] = None):
    """``(arg_params, aux_params)`` of ``prefix-%04d.params``, on ``ctx``
    (default: the current context)."""
    loaded = nd.load("%s-%04d.params" % (prefix, epoch), ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx: Optional[Context] = None):
    """``(symbol, arg_params, aux_params)`` of a checkpoint."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch, ctx)
    return symbol, arg_params, aux_params


class FeedForward:
    """The pre-Module trainer (``model.py:66``), a shell over
    :class:`~mxnet_tpu_torch.module.Module`: ``fit`` on numpy arrays or a
    ``DataIter``, ``predict``, ``save`` and ``load``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx or [current_context()]
        if not isinstance(self.ctx, list):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle, ctx=self.ctx[0])

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module
        X = self._iter(X, y, shuffle=True)
        mod = Module(self.symbol,
                     data_names=[d.name for d in X.provide_data],
                     label_names=[d.name for d in (X.provide_label or [])],
                     context=self.ctx, work_load_list=work_load_list)
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs.get(
                    "optimizer_params", (("learning_rate", 0.01),)),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        return self._module.predict(self._iter(X), num_batch=num_batch,
                                    reset=reset).asnumpy()

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
