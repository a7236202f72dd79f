"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``): the ``Optimizer``
base with the reference's learning-rate, weight-decay, gradient-rescaling
and update-count rules (``lr_scheduler``, ``begin_num_update``,
``param_dict``, the ``__lr_mult__``/``__wd_mult__`` symbol attributes), the
reference's optimizers — SGD, Signum, NAG, Adam, FTML, RMSProp (plain and
centered), Ftrl, AdaGrad, AdaDelta, Adamax, Nadam, SGLD, DCASGD, LBSGD and
Test — ``create``, and the ``Updater`` that keeps one state per (parameter,
device) slot and pickles them as the reference does.

``update`` is the eager update of one parameter, through an update op of
``ops/optimizer_ops.py`` or the reference's own arithmetic; the new values
replace the NDArrays' tensors.  SGD, NAG, Adam and RMSProp also have a
``fused_update``, the same update over every parameter of a step at once,
in place, with PyTorch's foreach kernels (one launch chain for the model),
which ``Module``'s fused step runs, as the reference's four classes with a
``fused_update``; the others train on the eager path there, as in the
reference.

``multi_precision=True`` gives a bf16 or fp16 weight a master fp32 copy
(``create_state_multi_precision``: the state is ``(inner_state, master)``,
the reference's layout, which the ``.states`` pickle carries): the update
runs in fp32 on the master with the gradient widened, and the weight is
cast again from the new master (``update_multi_precision``; SGD through
its ``mp_sgd_update``/``mp_sgd_mom_update`` ops).  SGD's fused update takes
such a weight too (``fused_mp``), with the flat state ``(master,
*inner_leaves)`` of :func:`fused_state_leaves`, and repeats the eager ops'
arithmetic operation for operation in foreach kernels, so the fused and
eager paths give bit-identical masters and weights.  NAG, Adam and RMSProp
train low-precision weights on the eager path.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List

import numpy as np
import torch

from . import amp as _amp
from .base import MXNetError
from .ndarray import ndarray as nd
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "LBSGD", "Test", "Updater", "get_updater", "create",
           "register", "fused_state_leaves"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _zeros_like(weight):
    return nd.zeros(weight.shape, weight.context, dtype=weight.dtype)


class Optimizer:
    """Base optimizer (``optimizer.py:30-300``).

    Weight decay applies only to names ending in ``_weight`` or ``_gamma``
    (``set_wd_mult``); ``__lr_mult__``/``__wd_mult__`` symbol attributes,
    or a ``param_dict`` entry's ``lr_mult``/``wd_mult``, scale a
    parameter's rate; ``idx2name`` maps an updater slot to its parameter's
    name.  Each update counts its slot (``_update_count``); ``num_update``,
    the largest count, drives the ``lr_scheduler``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ()
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The slot's state; in multi-precision mode a low-precision weight
        gets ``(create_state(master), master)``, ``master`` its fp32 copy
        (``optimizer.py:66-76``)."""
        if self.multi_precision and _amp.is_low_precision(weight.dtype):
            w32 = weight.astype(np.float32)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The generic multi-precision step (``optimizer.py:78-90``): the
        fp32 update on the master with the gradient widened to fp32, then
        the low-precision weight cast again from the new master."""
        if self._mp_state(weight, state):
            inner, w32 = state
            self.update(index, w32, grad.astype(np.float32), inner)
            w32.copyto(weight)
            return
        self.update(index, weight, grad, state)

    def _mp_state(self, weight, state):
        """Whether ``state`` is the multi-precision layout ``(inner_state,
        master_fp32)`` of this low-precision weight."""
        return (self.multi_precision and _amp.is_low_precision(weight.dtype)
                and isinstance(state, tuple) and len(state) == 2
                and isinstance(state[1], nd.NDArray)
                and state[1]._data.dtype == torch.float32)

    @property
    def learning_rate(self):
        """The current rate: the scheduler's at ``num_update``, else
        ``lr``."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

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

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            lr *= self.param_dict[name].lr_mult
        elif name in self.lr_mult:
            lr *= self.lr_mult[name]
        return lr

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            wd *= self.param_dict[name].wd_mult
        elif name in self.wd_mult:
            wd *= self.wd_mult[name]
        return wd

    def _common_kwargs(self, index):
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": -1.0 if self.clip_gradient is None
                else float(self.clip_gradient)}

    def _prep(self, index, weight, grad, with_wd=True):
        """``clip(rescale_grad * grad)`` (``+ wd * weight``) as a tensor,
        for the optimizers the reference writes in NDArray arithmetic."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        if with_wd:
            g = g + self._get_wd(index) * weight._data
        return g

    @staticmethod
    def _run(op, attrs, weight, grad, *states):
        """One update op on tensors; the new weight and states replace the
        NDArrays' tensors (a weight marked for autograd, a Gluon
        parameter's, is written in place: ``NDArray._assign``)."""
        with torch.no_grad():
            res = op(attrs, weight._data, grad._data,
                     *[s._data for s in states])
            res = res if isinstance(res, tuple) else (res,)
            for arr, t in zip((weight,) + states, res):
                arr._assign(t)

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

    # ---- the fused step ----------------------------------------------
    def supports_fused(self, weight) -> bool:
        """Whether :meth:`fused_update` takes this weight."""
        return False

    def fused_mp(self, weight) -> bool:
        """Whether this weight takes the fused update in multi-precision
        form: low-precision storage, its flat state ``(master,
        *inner_leaves)``."""
        return self.multi_precision and _amp.is_low_precision(weight.dtype)

    def _fused_dtype_ok(self, weight) -> bool:
        """fp32 weights; a low-precision one only in multi-precision mode
        (``optimizer.py:225-233``)."""
        return weight._data.dtype == torch.float32 or self.fused_mp(weight)


    def fused_slot_lr(self, lr, t):
        """The slot's learning rate with any host-side correction folded in
        (Adam's bias correction), as the eager update computes it."""
        return lr

    def fused_update(self, indices: List[int], weights: List[torch.Tensor],
                     grads: List[torch.Tensor], states: List[Any]):
        """The update of every slot in ``indices`` at once, in place on the
        weight and state tensors (``states[j]`` is the slot's state as a
        tensor, a tuple of tensors or None; for a multi-precision weight,
        :meth:`fused_mp`, the flat tuple ``(master, *inner_leaves)``);
        Each slot is counted and its learning rate
        taken in order, as the eager loop does
        (``fused_step.py:1015-1021``); slots with the same (lr, wd) go
        through one chain of foreach kernels.  A multi-precision slot's
        gradient is widened to fp32, the chain updates its master, and the
        weight is cast again from it (``fused_update_mp``,
        ``optimizer.py:209-222``).  Weight decay is added as ``g + wd * w``
        in two roundings, as the update ops add it.  ``grads`` are left
        as they were."""
        groups: Dict[tuple, List[int]] = {}
        for j, i in enumerate(indices):
            self._update_count(i)
            t = self._index_update_count[i]
            key = (self.fused_slot_lr(self._get_lr(i), t), self._get_wd(i))
            groups.setdefault(key, []).append(j)
        mp = [self.fused_mp(w) for w in weights]
        with torch.no_grad():
            grads = [g.float() if m else g for g, m in zip(grads, mp)]
            targets = [s[0] if m else w
                       for w, s, m in zip(weights, states, mp)]
            # only SGD fuses low-precision weights: its state is the
            # momentum or None
            inner = [(s[1] if len(s) > 1 else None) if m else s
                     for s, m in zip(states, mp)]
            # out of place: the callers' gradient arrays stay as they are
            grads = torch._foreach_mul(grads, self.rescale_grad)
            if self.clip_gradient is not None and self.clip_gradient >= 0:
                torch._foreach_clamp_min_(grads, -self.clip_gradient)
                torch._foreach_clamp_max_(grads, self.clip_gradient)
            for (lr, wd), js in groups.items():
                w = [targets[j] for j in js]
                g = [grads[j] for j in js]
                if wd:
                    torch._foreach_add_(g, torch._foreach_mul(w, wd))
                self._fused_group(lr, w, g, [inner[j] for j in js])
            low = [j for j, m in enumerate(mp) if m]
            if low:
                torch._foreach_copy_([weights[j] for j in low],
                                     [targets[j] for j in low])

    def _fused_group(self, lr, w, g, states):
        raise MXNetError("%s has no fused update" % type(self).__name__)


@register
class SGD(Optimizer):
    """SGD with momentum (``optimizer.py:310``):
    ``mom = momentum * mom - lr * g``, ``w += mom``, with
    ``g = clip(rescale_grad * grad) + wd * w``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        """One slot's update; a multi-precision state ``(mom, master)`` goes
        through the ``mp_sgd_mom_update``/``mp_sgd_update`` ops
        (``optimizer.py:319-339``)."""
        self._update_count(index)
        attrs = self._common_kwargs(index)
        if isinstance(state, tuple):
            mom, w32 = state
            if mom is not None:
                attrs["momentum"] = self.momentum
                self._run(_ops._mp_sgd_mom_update, attrs, weight, grad, mom,
                          w32)
            else:
                self._run(_ops._mp_sgd_update, attrs, weight, grad, w32)
        elif state is not None:
            attrs["momentum"] = self.momentum
            self._run(_ops._sgd_mom_update, attrs, weight, grad, state)
        else:
            self._run(_ops._sgd_update, attrs, weight, grad)

    update_multi_precision = update

    def supports_fused(self, weight) -> bool:
        return self._fused_dtype_ok(weight)

    def _fused_group(self, lr, w, g, states):
        """``mom = momentum * mom - lr * g``, ``w += mom`` (or ``w -= lr *
        g``), each product and sum rounded as the update ops round them."""
        lg = torch._foreach_mul(g, lr)
        if self.momentum != 0.0:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_sub_(states, lg)
            torch._foreach_add_(w, states)
        else:
            torch._foreach_sub_(w, lg)


@register
class Signum(Optimizer):
    """Signum / signSGD (``optimizer.py:360``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_kwargs(index)
        if state is not None:
            attrs.update(momentum=self.momentum, wd_lh=self.wd_lh)
            self._run(_ops._signum_update, attrs, weight, grad, state)
        else:
            self._run(_ops._signsgd_update, attrs, weight, grad)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``optimizer.py:382``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_kwargs(index)
        if state is not None:
            attrs["momentum"] = self.momentum
            self._run(_ops._nag_mom_update, attrs, weight, grad, state)
        else:
            self._run(_ops._sgd_update, attrs, weight, grad)

    def supports_fused(self, weight) -> bool:
        return weight._data.dtype == torch.float32

    def _fused_group(self, lr, w, g, states):
        """``mom = momentum * mom + g``; ``w -= lr * (g + momentum * mom)``,
        each product and sum rounded as ``nag_mom_update`` rounds it."""
        if self.momentum != 0.0:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, g)
            g = torch._foreach_add(g, torch._foreach_mul(states,
                                                         self.momentum))
        torch._foreach_sub_(w, torch._foreach_mul(g, lr))


@register
class Adam(Optimizer):
    """Adam (``optimizer.py:418``), its bias correction folded into the
    learning rate on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        attrs = self._common_kwargs(index)
        attrs["lr"] = self.fused_slot_lr(attrs["lr"], t)
        attrs.update(beta1=self.beta1, beta2=self.beta2,
                     epsilon=self.epsilon)
        self._run(_ops._adam_update, attrs, weight, grad, *state)

    def supports_fused(self, weight) -> bool:
        return weight._data.dtype == torch.float32

    def fused_slot_lr(self, lr, t):
        return lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def _fused_group(self, lr, w, g, states):
        """The moments and the step, each product and sum rounded as
        ``adam_update`` rounds it (no fused multiply-adds)."""
        mean = [s[0] for s in states]
        var = [s[1] for s in states]
        torch._foreach_mul_(mean, self.beta1)
        torch._foreach_add_(mean, torch._foreach_mul(g, 1 - self.beta1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - self.beta2)
        torch._foreach_mul_(var, self.beta2)
        torch._foreach_add_(var, sq)
        denom = torch._foreach_sqrt(var)
        torch._foreach_add_(denom, self.epsilon)
        step = torch._foreach_mul(mean, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(w, step)


@register
class FTML(Optimizer):
    """Follow the moving leader (``optimizer.py:467``)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_kwargs(index)
        attrs.update(beta1=self.beta1, beta2=self.beta2,
                     epsilon=self.epsilon,
                     t=self._index_update_count[index])
        self._run(_ops._ftml_update, attrs, weight, grad, *state)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (``optimizer.py:489``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def _attrs(self, index):
        attrs = self._common_kwargs(index)
        attrs.update(gamma1=self.gamma1, gamma2=self.gamma2,
                     epsilon=self.epsilon,
                     clip_weights=float(self.clip_weights)
                     if self.clip_weights else -1.0)
        return attrs

    def update(self, index, weight, grad, state):
        self._update_count(index)
        op = _ops._rmspropalex_update if self.centered \
            else _ops._rmsprop_update
        self._run(op, self._attrs(index), weight, grad, *state)

    def supports_fused(self, weight) -> bool:
        return weight._data.dtype == torch.float32

    def _fused_group(self, lr, w, g, states):
        """``rmsprop_update`` (or ``rmspropalex_update``, centered) over
        the group, each product and sum rounded as the op rounds it."""
        g1 = self.gamma1
        n = [s[0] for s in states]
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - g1)
        torch._foreach_mul_(n, g1)
        torch._foreach_add_(n, sq)
        step = torch._foreach_mul(g, lr)
        if self.centered:
            gs = [s[1] for s in states]
            delta = [s[2] for s in states]
            torch._foreach_mul_(gs, g1)
            torch._foreach_add_(gs, torch._foreach_mul(g, 1 - g1))
            denom = torch._foreach_sub(n, torch._foreach_mul(gs, gs))
            torch._foreach_add_(denom, self.epsilon)
            torch._foreach_sqrt_(denom)
            torch._foreach_div_(step, denom)
            torch._foreach_mul_(delta, self.gamma2)
            torch._foreach_sub_(delta, step)
            torch._foreach_add_(w, delta)
        else:
            denom = torch._foreach_add(n, self.epsilon)
            torch._foreach_sqrt_(denom)
            torch._foreach_div_(step, denom)
            torch._foreach_sub_(w, step)
        if self.clip_weights:
            torch._foreach_clamp_min_(w, -float(self.clip_weights))
            torch._foreach_clamp_max_(w, float(self.clip_weights))


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``optimizer.py:544``)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_kwargs(index)
        attrs.update(lamda1=self.lamda1, beta=self.beta)
        self._run(_ops._ftrl_update, attrs, weight, grad, *state)


@register
class AdaGrad(Optimizer):
    """AdaGrad (``optimizer.py:565``)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        with torch.no_grad():
            g = self._prep(index, weight, grad)
            state._data = state._data + g * g
            weight._data = weight._data - lr * g / (
                state._data.sqrt() + self.float_stable_eps)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``optimizer.py:587``); weight decay applies to the
    weight after the step."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            g = self._prep(index, weight, grad, with_wd=False)
            acc_g._data = rho * acc_g._data + (1 - rho) * g * g
            delta = (acc_delta._data + eps).sqrt() / \
                (acc_g._data + eps).sqrt() * g
            acc_delta._data = rho * acc_delta._data \
                + (1 - rho) * delta * delta
            weight._data = weight._data - delta - wd * weight._data


@register
class Adamax(Optimizer):
    """Adamax (``optimizer.py:612``): the infinity-norm Adam."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        m, u = state
        with torch.no_grad():
            g = grad._data * self.rescale_grad + wd * weight._data
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            m._data = self.beta1 * m._data + (1 - self.beta1) * g
            u._data = torch.maximum(self.beta2 * u._data, g.abs())
            weight._data = weight._data - lr * m._data / u._data


@register
class Nadam(Optimizer):
    """Nesterov Adam (``optimizer.py:637``) with its momentum schedule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        mt = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mtn = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= mt
        sched_next = self.m_schedule * mtn
        m, v = state
        with torch.no_grad():
            g = grad._data * self.rescale_grad + wd * weight._data
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            m._data = b1 * m._data + (1 - b1) * g
            v._data = b2 * v._data + (1 - b2) * g * g
            g_prime = g / (1 - self.m_schedule)
            m_prime = m._data / (1 - sched_next)
            v_prime = v._data / (1 - b2 ** t)
            weight._data = weight._data - lr * (
                mtn * m_prime + (1 - mt) * g_prime) / (
                v_prime.sqrt() + self.epsilon)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (``optimizer.py:673``): a
    half step of SGD plus N(0, lr) noise from the weight's device
    generator (:mod:`mxnet_tpu_torch.random`)."""

    def update(self, index, weight, grad, state):
        from . import random as _random
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._prep(index, weight, grad, with_wd=False)
            w = weight._data
            noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                                generator=_random.generator(weight.context))
            weight._data = w - lr / 2 * (g + wd * w) + noise * math.sqrt(lr)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (``optimizer.py:688``)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev = state
        with torch.no_grad():
            g = self._prep(index, weight, grad, with_wd=False)
            w = weight._data
            comp = g + wd * w + self.lamda * g * g * (w - prev._data)
            if mom is not None:
                mom._data = self.momentum * mom._data - lr * comp
                step = mom._data
            else:
                step = -lr * comp
            prev._data = w.clone()
            weight._data = w + step


@register
class LBSGD(SGD):
    """Large-batch SGD (``optimizer.py:720``): the reference keeps its
    warm-up settings and updates as SGD."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch


@register
class Test(Optimizer):
    """The reference's test optimizer (``optimizer.py:735``):
    ``w += rescale_grad * grad`` and the state keeps the weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data = weight._data + grad._data * self.rescale_grad
            state._data = weight._data.clone()


def create(name, **kwargs) -> Optimizer:
    """An optimizer from its registered name (or itself)."""
    if isinstance(name, Optimizer):
        return name
    klass = _REGISTRY.get(str(name).lower())
    if klass is None:
        raise MXNetError("unknown optimizer %r (have %s)"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)


def _state_to_numpy(s):
    if isinstance(s, nd.NDArray):
        return s.asnumpy()
    if isinstance(s, (tuple, list)):
        return type(s)(_state_to_numpy(x) for x in s)
    return s


def _state_to_nd(s, ctx):
    if isinstance(s, np.ndarray):
        return nd.array(s, ctx, dtype=s.dtype)
    if isinstance(s, (tuple, list)):
        return type(s)(_state_to_nd(x, ctx) for x in s)
    return s


def _state_context(s):
    if isinstance(s, nd.NDArray):
        return s.context
    if isinstance(s, (tuple, list)):
        for x in s:
            c = _state_context(x)
            if c is not None:
                return c
    return None


class Updater:
    """Callable ``(index, grad, weight)`` applying the optimizer with one
    state per slot, made at the slot's first update (``optimizer.py:788``).
    ``get_states``/``set_states`` pickle the states as numpy arrays (and
    ``num_update`` with ``dump_optimizer``), the reference's format
    (``optimizer.py:813-837``), so a ``.states`` file carries across in
    both directions.  Loaded states land on the CPU and move to their
    weight's context at the slot's next use."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def state(self, index, weight):
        """The slot's state on the weight's context, made now if it has
        none."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            ctx = _state_context(self.states[index])
            if ctx is not None and ctx != weight.context:
                self.states[index] = _state_to_nd(
                    _state_to_numpy(self.states[index]), weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state(index, weight))

    def set_states(self, states):
        from .context import cpu
        states = pickle.loads(states) if isinstance(states, bytes) \
            else states
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer.num_update = states
        self.states = {k: _state_to_nd(v, cpu()) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        states = {k: _state_to_numpy(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer.num_update)
                            if dump_optimizer else states)


def fused_state_leaves(state, mp=False):
    """An updater state flattened into a tuple of NDArray leaves for the
    fused step (None -> ``()``), or None when its structure is not fusable
    (``optimizer.py:744-776``).  With ``mp`` the state must be the
    multi-precision layout ``(inner_state, master)``, and the master comes
    first: ``(master, *inner_leaves)``."""
    if mp:
        if not (isinstance(state, (tuple, list)) and len(state) == 2
                and isinstance(state[1], nd.NDArray)):
            return None
        inner = fused_state_leaves(state[0])
        return None if inner is None else (state[1],) + inner
    if state is None:
        return ()
    if isinstance(state, nd.NDArray):
        return (state,)
    if isinstance(state, (tuple, list)) and all(
            isinstance(s, nd.NDArray) for s in state):
        return tuple(state)
    return None


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
