"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``): the
``Optimizer`` base with the reference's learning-rate, weight-decay and
gradient-rescaling rules, ``SGD`` (with momentum), ``create``, and the
``Updater`` that keeps one state per (parameter, device) slot.

``SGD.update`` is the eager update of one parameter through the
``sgd_update``/``sgd_mom_update`` ops; ``SGD.fused_update`` is the same
update over all parameters of a step at once, in place, with PyTorch's
foreach kernels, which ``Module``'s fused step runs.  The other optimizers
of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .base import MXNetError
from .ndarray import ndarray as nd
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class Optimizer:
    """Base optimizer (``optimizer.py:30-300``).

    Weight decay applies only to names ending in ``_weight`` or ``_gamma``
    (``set_wd_mult``); ``__lr_mult__``/``__wd_mult__`` symbol attributes
    scale a parameter's rate; ``idx2name`` maps an updater slot to its
    parameter's name."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None,
                 multi_precision=False):
        if multi_precision:
            raise MXNetError("multi_precision comes with the port's bf16 "
                             "slice; this optimizer trains float32 weights")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ()
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _get_lr(self, index):
        return self.lr * self.lr_mult.get(self.idx2name.get(index, index),
                                          1.0)

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(self.idx2name.get(index, index),
                                          1.0)

    def _common_kwargs(self, index):
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": -1.0 if self.clip_gradient is None
                else float(self.clip_gradient)}

    @staticmethod
    def slot_index(param_idx, num_device=1, device=0):
        """The updater slot of parameter ``param_idx`` on ``device``."""
        return param_idx * num_device + device

    @staticmethod
    def build_idx2name(param_names, num_device=1):
        """``idx2name`` covering every (parameter, device) slot."""
        return {Optimizer.slot_index(i, num_device, k): name
                for i, name in enumerate(param_names)
                for k in range(num_device)}

    def supports_fused(self, weight) -> bool:
        """Whether :meth:`fused_update` takes this weight."""
        return False


@register
class SGD(Optimizer):
    """SGD with momentum (``optimizer.py:310``):
    ``mom = momentum * mom - lr * g``, ``w += mom``, with
    ``g = clip(rescale_grad * grad) + wd * w``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        """One parameter's update through the ``sgd_mom_update`` (or
        ``sgd_update``) op; the new values replace the NDArrays' tensors."""
        attrs = self._common_kwargs(index)
        with torch.no_grad():
            if state is not None:
                attrs["momentum"] = self.momentum
                w, m = _ops._sgd_mom_update(attrs, weight._data, grad._data,
                                            state._data)
                weight._data, state._data = w, m
            else:
                weight._data = _ops._sgd_update(attrs, weight._data,
                                                grad._data)

    def supports_fused(self, weight) -> bool:
        return weight._data.dtype == torch.float32

    def fused_update(self, indices: List[int], weights: List[torch.Tensor],
                     grads: List[torch.Tensor], states: List[Any]):
        """The update of every slot in ``indices`` at once, in place on the
        weight and momentum tensors, with foreach kernels grouped by each
        slot's (lr, wd); ``grads`` are consumed (scaled in place)."""
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        with torch.no_grad():
            if self.rescale_grad != 1.0:
                torch._foreach_mul_(grads, self.rescale_grad)
            if self.clip_gradient is not None and self.clip_gradient >= 0:
                torch._foreach_clamp_min_(grads, -self.clip_gradient)
                torch._foreach_clamp_max_(grads, self.clip_gradient)
            groups: Dict[tuple, List[int]] = {}
            for j, key in enumerate(zip(lrs, wds)):
                groups.setdefault(key, []).append(j)
            for (lr, wd), js in groups.items():
                w = [weights[j] for j in js]
                g = [grads[j] for j in js]
                if wd:
                    torch._foreach_add_(g, w, alpha=wd)
                if self.momentum != 0.0:
                    m = [states[j] for j in js]
                    torch._foreach_mul_(m, self.momentum)
                    torch._foreach_add_(m, g, alpha=-lr)
                    torch._foreach_add_(w, m)
                else:
                    torch._foreach_add_(w, g, alpha=-lr)


def create(name, **kwargs) -> Optimizer:
    """An optimizer from its registered name (or itself)."""
    if isinstance(name, Optimizer):
        return name
    klass = _REGISTRY.get(str(name).lower())
    if klass is None:
        raise MXNetError("unknown optimizer %r (the port has %s so far)"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)


class Updater:
    """Callable ``(index, grad, weight)`` applying the optimizer with one
    state per slot, made at the slot's first update (``optimizer.py:788``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def state(self, index, weight):
        """The slot's state, made now if it has none."""
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad, self.state(index, weight))


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
