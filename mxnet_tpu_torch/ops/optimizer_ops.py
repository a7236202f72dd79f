"""Optimizer update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``):
the updates of ``optimizer.py``'s optimizers, one function each — sgd,
sgd_mom, nag_mom, mp_sgd, mp_sgd_mom, adam, rmsprop, rmspropalex, ftrl,
ftml, signsgd and signum — registered so that ``nd.<name>_update`` exists.

Convention, the reference's (``optimizer_ops.py:1-13``): the raw gradient
is scaled by ``rescale_grad``, then clipped to ``clip_gradient`` (when it
is >= 0), then ``wd * weight`` is added.  Each op returns new tensors (the
weight first, then the new states); ``aux_writeback`` maps each new state
onto the input it replaces, which ``nd.<name>_update`` writes back.
"""
from __future__ import annotations

import torch

from .registry import param, register

__all__ = ["prep_grad"]

_COMMON = {
    "lr": param(float, 0.0, required=True),
    "wd": param(float, 0.0),
    "rescale_grad": param(float, 1.0),
    "clip_gradient": param(float, -1.0),
}


def _clip(attrs, g):
    if attrs["clip_gradient"] >= 0:
        g = torch.clamp(g, -attrs["clip_gradient"], attrs["clip_gradient"])
    return g


def prep_grad(attrs, weight, grad):
    """``clip(grad * rescale_grad) + wd * weight``."""
    return _clip(attrs, grad * attrs["rescale_grad"]) + attrs["wd"] * weight


def _opt(name, arg_names, extra=None, nout=1):
    """Register an update op over ``arg_names`` (weight, grad, states...)
    whose outputs after the first replace the states, in order."""
    writeback = {i: i + 1 for i in range(1, nout)}
    return register(name, params={**_COMMON, **(extra or {})}, nout=nout,
                    visible=1, aux_writeback=writeback,
                    arg_names=arg_names)


_MOM = {"momentum": param(float, 0.0)}


@_opt("sgd_update", ("weight", "grad"))
def _sgd_update(attrs, weight, grad):
    """``weight - lr * g`` (``optimizer_ops.py:46``)."""
    return weight - attrs["lr"] * prep_grad(attrs, weight, grad)


@_opt("sgd_mom_update", ("weight", "grad", "mom"), _MOM, nout=2)
def _sgd_mom_update(attrs, weight, grad, mom):
    """``mom' = momentum * mom - lr * g``, ``weight + mom'``
    (``optimizer_ops.py:52``); returns (new weight, new momentum)."""
    g = prep_grad(attrs, weight, grad)
    new_mom = attrs["momentum"] * mom - attrs["lr"] * g
    return weight + new_mom, new_mom


@_opt("nag_mom_update", ("weight", "grad", "mom"), _MOM, nout=2)
def _nag_mom_update(attrs, weight, grad, mom):
    """Nesterov: ``mom' = momentum * mom + g``,
    ``weight - lr * (g + momentum * mom')`` (``optimizer_ops.py:60``)."""
    g = prep_grad(attrs, weight, grad)
    new_mom = attrs["momentum"] * mom + g
    return weight - attrs["lr"] * (g + attrs["momentum"] * new_mom), new_mom


def _mp_grad(attrs, grad, weight32):
    g = _clip(attrs, grad.float() * attrs["rescale_grad"])
    return g + attrs["wd"] * weight32


@_opt("mp_sgd_update", ("weight", "grad", "weight32"), nout=2)
def _mp_sgd_update(attrs, weight, grad, weight32):
    """SGD on an fp32 master copy of a low-precision weight
    (``optimizer_ops.py:68``): (weight cast from the new master, master)."""
    new_w32 = weight32 - attrs["lr"] * _mp_grad(attrs, grad, weight32)
    return new_w32.to(weight.dtype), new_w32


@_opt("mp_sgd_mom_update", ("weight", "grad", "mom", "weight32"), _MOM,
      nout=3)
def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    """SGD with momentum on an fp32 master (``optimizer_ops.py:80``)."""
    new_mom = attrs["momentum"] * mom \
        - attrs["lr"] * _mp_grad(attrs, grad, weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@_opt("adam_update", ("weight", "grad", "mean", "var"),
      {"beta1": param(float, 0.9), "beta2": param(float, 0.999),
       "epsilon": param(float, 1e-8), "lazy_update": param(bool, True)},
      nout=3)
def _adam_update(attrs, weight, grad, mean, var):
    """Adam without bias correction, which the optimizer folds into ``lr``
    (``optimizer_ops.py:92``)."""
    g = prep_grad(attrs, weight, grad)
    b1, b2 = attrs["beta1"], attrs["beta2"]
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    w = weight - attrs["lr"] * new_mean / (torch.sqrt(new_var)
                                           + attrs["epsilon"])
    return w, new_mean, new_var


def _clip_weights(attrs, w):
    if attrs["clip_weights"] > 0:
        w = torch.clamp(w, -attrs["clip_weights"], attrs["clip_weights"])
    return w


@_opt("rmsprop_update", ("weight", "grad", "n"),
      {"gamma1": param(float, 0.95), "epsilon": param(float, 1e-8),
       "clip_weights": param(float, -1.0)}, nout=2)
def _rmsprop_update(attrs, weight, grad, n):
    """RMSProp (``optimizer_ops.py:104``)."""
    g = prep_grad(attrs, weight, grad)
    new_n = (1 - attrs["gamma1"]) * torch.square(g) + attrs["gamma1"] * n
    w = weight - attrs["lr"] * g / torch.sqrt(new_n + attrs["epsilon"])
    return _clip_weights(attrs, w), new_n


@_opt("rmspropalex_update", ("weight", "grad", "n", "g", "delta"),
      {"gamma1": param(float, 0.95), "gamma2": param(float, 0.9),
       "epsilon": param(float, 1e-8), "clip_weights": param(float, -1.0)},
      nout=4)
def _rmspropalex_update(attrs, weight, grad, n, g_, delta):
    """Centered RMSProp, Graves' form (``optimizer_ops.py:117``)."""
    g = prep_grad(attrs, weight, grad)
    g1 = attrs["gamma1"]
    new_n = (1 - g1) * torch.square(g) + g1 * n
    new_g = (1 - g1) * g + g1 * g_
    new_delta = attrs["gamma2"] * delta - attrs["lr"] * g / \
        torch.sqrt(new_n - torch.square(new_g) + attrs["epsilon"])
    return _clip_weights(attrs, weight + new_delta), new_n, new_g, new_delta


@_opt("ftrl_update", ("weight", "grad", "z", "n"),
      {"lamda1": param(float, 0.01), "beta": param(float, 1.0)}, nout=3)
def _ftrl_update(attrs, weight, grad, z, n):
    """FTRL-proximal (``optimizer_ops.py:134``); ``wd`` enters the
    denominator, not the gradient."""
    g = _clip(attrs, grad * attrs["rescale_grad"])
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / attrs["lr"]
    new_z = z + g - sigma * weight
    denom = (attrs["beta"] + torch.sqrt(new_n)) / attrs["lr"] + attrs["wd"]
    w = torch.where(torch.abs(new_z) > attrs["lamda1"],
                    (torch.sign(new_z) * attrs["lamda1"] - new_z) / denom,
                    torch.zeros((), dtype=weight.dtype,
                                device=weight.device))
    return w, new_z, new_n


@_opt("ftml_update", ("weight", "grad", "d", "v", "z"),
      {"beta1": param(float, 0.6), "beta2": param(float, 0.999),
       "epsilon": param(float, 1e-8), "t": param(int, 1)}, nout=4)
def _ftml_update(attrs, weight, grad, d, v, z):
    """FTML (``optimizer_ops.py:150``) at step ``t``."""
    g = prep_grad(attrs, weight, grad)
    t = attrs["t"]
    b1, b2 = attrs["beta1"], attrs["beta2"]
    new_v = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / attrs["lr"] * \
        (torch.sqrt(new_v / (1 - b2 ** t)) + attrs["epsilon"])
    sigma = d_t - b1 * d
    new_z = b1 * z + (1 - b1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@_opt("signsgd_update", ("weight", "grad"))
def _signsgd_update(attrs, weight, grad):
    """``weight - lr * sign(g)`` (``optimizer_ops.py:164``)."""
    return weight - attrs["lr"] * torch.sign(prep_grad(attrs, weight, grad))


@_opt("signum_update", ("weight", "grad", "mom"),
      {**_MOM, "wd_lh": param(float, 0.0)}, nout=2)
def _signum_update(attrs, weight, grad, mom):
    """Signum (``optimizer_ops.py:170``): the sign of the momentum, with
    decoupled weight decay ``wd_lh``."""
    g = prep_grad(attrs, weight, grad)
    new_mom = attrs["momentum"] * mom - (1 - attrs["momentum"]) * g
    w = (1 - attrs["lr"] * attrs["wd_lh"]) * weight \
        + attrs["lr"] * torch.sign(new_mom)
    return w, new_mom
