"""The rest of the op registry (counterpart of
``mxnet_tpu/ops/misc_parity.py``): ``_grad_add``,
``_identity_with_attr_like_rhs``, ``_histogram``, ``_ravel_multi_index``
and ``_unravel_index``, ``_slice_assign``/``_slice_assign_scalar`` and
``_scatter_set_nd`` (the lowerings of ``x[...] = y``), ``_square_sum``,
``_sparse_adagrad_update``, ``IdentityAttachKLSparseReg``,
``cast_storage`` and the four ``_sample_*`` tails of per-element
parameters.

Every op works on dense tensors, as the reference's do.  ``cast_storage``
to ``row_sparse`` or ``csr`` needs the sparse containers of
``ndarray/sparse.py`` and raises until they are ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .init_random import _gamma, _poisson, per_element_sampler
from .reduce import _axes
from .registry import param, register

__all__ = []


@register("_grad_add", arg_names=("lhs", "rhs"))
def _grad_add(attrs, lhs, rhs):
    """The gradient accumulation add: ``lhs + rhs``."""
    return lhs + rhs


@register("_identity_with_attr_like_rhs", arg_names=("lhs", "rhs"))
def _identity_with_attr_like_rhs(attrs, lhs, rhs):
    """``lhs``; ``rhs`` only lends its attributes in a graph pass."""
    return lhs


@register("_histogram", nout=2,
          params={"bin_cnt": param(int, None),
                  "range": param("floats", None)})
def _histogram(attrs, data, *maybe_bins):
    """(counts as int32, bin edges in ``data``'s dtype) of the flattened
    ``data``: ``bin_cnt`` equal bins over ``range``, or the edges given as
    a second input.  A value on the last edge falls in the last bin, values
    outside the edges in none (``misc_parity.py:37-62``)."""
    flat = data.reshape(-1)
    if attrs["bin_cnt"] is not None:
        if attrs["range"] is None:
            raise MXNetError("_histogram: bin_cnt requires range=(lo, hi)")
        lo, hi = attrs["range"]
        cnt = attrs["bin_cnt"]
        edges = torch.linspace(lo, hi, cnt + 1, dtype=torch.float32,
                               device=data.device)
    elif maybe_bins:
        edges = maybe_bins[0]
        cnt = edges.shape[0] - 1
    else:
        raise MXNetError("_histogram needs bin_cnt+range or a bins input")
    if data.device.type == "meta":
        return (torch.empty((cnt,), dtype=torch.int32, device=data.device),
                torch.empty((cnt + 1,), dtype=data.dtype, device=data.device))
    e = edges.to(flat.dtype)
    idx = (torch.searchsorted(e, flat, right=True) - 1).clamp(0, cnt - 1)
    inside = (flat >= e[0]) & (flat <= e[-1])
    counts = torch.zeros((cnt,), dtype=torch.int32, device=data.device)
    counts.index_add_(0, idx, inside.to(torch.int32))
    return counts, edges.to(data.dtype)


def _strides(shape):
    return np.cumprod([1] + list(shape[::-1][:-1]))[::-1].copy()


@register("_ravel_multi_index", aliases=("ravel_multi_index",),
          params={"shape": param("shape", None, required=True)})
def _ravel_multi_index(attrs, data):
    """(K, N) coordinates -> N flat indices into ``shape``, in ``data``'s
    dtype."""
    strides = torch.as_tensor(_strides(attrs["shape"]), dtype=data.dtype,
                              device=data.device)
    return (data * strides[:, None]).sum(0)


@register("_unravel_index", aliases=("unravel_index",),
          params={"shape": param("shape", None, required=True)})
def _unravel_index(attrs, data):
    """N flat indices -> (K, N) coordinates in ``shape``, in ``data``'s
    dtype (an index is truncated to an integer first)."""
    idx = data.to(torch.int64)
    coords = []
    for dim in reversed(attrs["shape"]):
        coords.append(torch.remainder(idx, dim))
        idx = torch.div(idx, dim, rounding_mode="floor")
    return torch.stack(coords[::-1], 0).to(data.dtype)


_SLICE_PARAMS = {"begin": param("shape", None, required=True),
                 "end": param("shape", None, required=True),
                 "step": param("shape", ())}


def _slice_index(attrs, shape, device):
    """Index tensors, one a dimension, broadcast against each other, of
    ``x[begin:end:step]`` with Python's slice rules (negative bounds and
    steps), every dimension past ``begin`` taken whole."""
    begin, end, step = attrs["begin"], attrs["end"], attrs["step"] or ()
    nd = len(shape)
    index = []
    for i, size in enumerate(shape):
        if i < len(begin):
            st = step[i] if i < len(step) and step[i] else 1
            rng = range(*slice(begin[i], end[i], st).indices(size))
        else:
            rng = range(size)
        view = [1] * nd
        view[i] = len(rng)
        index.append(torch.as_tensor(list(rng), dtype=torch.int64,
                                     device=device).reshape(view))
    return tuple(index)


@register("_slice_assign", arg_names=("lhs", "rhs"),
          params=dict(_SLICE_PARAMS))
def _slice_assign(attrs, lhs, rhs):
    """``lhs`` with ``lhs[begin:end:step] = rhs`` (the functional form of
    ``x[a:b] = y``); differentiable in both."""
    if lhs.device.type == "meta":
        return torch.empty_like(lhs)
    index = _slice_index(attrs, lhs.shape, lhs.device)
    sel = torch.broadcast_shapes(*(i.shape for i in index))
    return lhs.index_put(index, rhs.to(lhs.dtype).expand(sel))


@register("_slice_assign_scalar",
          params={"scalar": param(float, 0.0), **_SLICE_PARAMS})
def _slice_assign_scalar(attrs, lhs):
    """``lhs`` with ``lhs[begin:end:step] = scalar``."""
    if lhs.device.type == "meta":
        return torch.empty_like(lhs)
    index = _slice_index(attrs, lhs.shape, lhs.device)
    return lhs.index_put(index, torch.tensor(attrs["scalar"],
                                             dtype=lhs.dtype,
                                             device=lhs.device))


@register("_scatter_set_nd", arg_names=("lhs", "rhs", "indices"),
          params={"shape": param("shape", None, required=True)})
def _scatter_set_nd(attrs, lhs, rhs, indices):
    """``lhs`` with ``rhs`` set at the (K, N) ``indices`` (the ``x[idx] =
    y`` lowering, three inputs); elements not indexed keep ``lhs``'s
    values."""
    if lhs.device.type == "meta":
        return torch.empty_like(lhs)
    idx = tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))
    return lhs.index_put(idx, rhs.to(lhs.dtype))


@register("_square_sum", aliases=("square_sum",),
          params={"axis": param("shape", None),
                  "keepdims": param(bool, False),
                  "exclude": param(bool, False)})
def _square_sum(attrs, data):
    """``sum(data²)`` over ``axis`` (with ``exclude``, as the reductions),
    the dense form of the reference's row-sparse reduction."""
    return (data * data).sum(dim=_axes(attrs, data.dim()),
                             keepdim=attrs["keepdims"])


@register("_sparse_adagrad_update", nout=2, visible=1, aux_writeback={1: 2},
          arg_names=("weight", "grad", "history"),
          params={"lr": param(float, None, required=True),
                  "epsilon": param(float, 1e-7),
                  "wd": param(float, 0.0),
                  "rescale_grad": param(float, 1.0),
                  "clip_gradient": param(float, -1.0)})
def _sparse_adagrad_update(attrs, weight, grad, history):
    """AdaGrad (``misc_parity.py:165-186``): ``h += g²``, ``w -= lr g /
    (sqrt(h) + eps)`` with ``g`` rescaled and clipped (``clip_gradient >=
    0``); rows whose gradient is zero keep their values, so the dense form
    is the row-sparse update.  Weight decay raises, as in the reference:
    it would touch those rows.  Returns (new weight, new history)."""
    if attrs["wd"] != 0.0:
        raise MXNetError("sparse adagrad_update does not support wd")
    g = grad * attrs["rescale_grad"]
    if attrs["clip_gradient"] >= 0:
        g = g.clamp(-attrs["clip_gradient"], attrs["clip_gradient"])
    new_hist = history + g * g
    return (weight - attrs["lr"] * g / (new_hist.sqrt() + attrs["epsilon"]),
            new_hist)


class _KLSparseReg(torch.autograd.Function):
    """The identity whose backward adds ``penalty * (-target / rho +
    (1 - target) / (1 - rho))`` along axis 1, ``rho`` the updated moving
    average of each unit's mean activation clipped to [1e-6, 1 - 1e-6]
    (``misc_parity.py:218-236``); the average gets no gradient."""

    @staticmethod
    def forward(ctx, data, rho_new, target, penalty, bshape):
        ctx.save_for_backward(rho_new)
        ctx.consts = (target, penalty, bshape)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        rho, = ctx.saved_tensors
        target, penalty, bshape = ctx.consts
        reg = penalty * (-target / rho + (1 - target) / (1 - rho))
        return g + reg.reshape(bshape).to(g.dtype), None, None, None, None


@register("IdentityAttachKLSparseReg", nout=2, visible=1,
          aux_writeback={1: 1},
          params={"sparseness_target": param(float, 0.1),
                  "penalty": param(float, 0.001),
                  "momentum": param(float, 0.9)})
def _identity_attach_kl_sparse_reg(attrs, data, *maybe_avg):
    """The identity with a KL sparseness penalty on the gradient
    (``misc_parity.py:189-238``): outputs (``data``, the new moving
    average ``momentum * avg + (1 - momentum) * rho_hat`` of each unit's
    mean activation ``rho_hat``, clipped to [1e-6, 1 - 1e-6]); the
    average starts at ``sparseness_target`` when not given.  Units lie
    along axis 1 (axis 0 of a 1-D ``data``)."""
    target = attrs["sparseness_target"]
    mom = attrs["momentum"]
    nunit = data.shape[1] if data.dim() > 1 else data.shape[0]
    if maybe_avg:
        avg = maybe_avg[0].reshape(-1)
    else:
        avg = torch.full((nunit,), target, dtype=data.dtype,
                         device=data.device)
    axes = tuple(a for a in range(data.dim()) if a != 1) \
        if data.dim() > 1 else ()
    bshape = [1] * data.dim()
    bshape[1 if data.dim() > 1 else 0] = -1
    with torch.no_grad():
        m = data.mean(dim=axes) if axes else data.detach()
        rho_hat = m.clamp(1e-6, 1 - 1e-6)
        new_avg = mom * avg + (1 - mom) * rho_hat
    out = _KLSparseReg.apply(data, new_avg.clamp(1e-6, 1 - 1e-6), target,
                             attrs["penalty"], tuple(bshape))
    return out, new_avg


@register("cast_storage", aliases=("_cast_storage",),
          params={"stype": param(["default", "row_sparse", "csr"],
                                 "default")})
def _cast_storage(attrs, data):
    """To the ``default`` (dense) storage: the identity.  ``row_sparse``
    and ``csr`` arrays need ``ndarray/sparse.py``, which is not ported."""
    if attrs["stype"] != "default":
        raise MXNetError("cast_storage(stype=%r) is not ported yet: it needs "
                         "ndarray/sparse.py (ROADMAP.md Queue 1 item 9)"
                         % attrs["stype"])
    return data


# the per-element sampling tails (``misc_parity.py:253-281``)
def _sample_exponential(gen, lam):
    """Exponential of per-element rate ``lam``."""
    return torch.empty(lam.shape, device=lam.device).exponential_(
        generator=gen) / lam


def _sample_poisson(gen, lam):
    """Poisson of per-element rate ``lam``."""
    return _poisson(lam, gen)


def _sample_negative_binomial(gen, k, p):
    """Negative binomial of per-element ``k`` and ``p``: a Poisson of a
    Gamma(k, (1 - p) / p) rate."""
    return _poisson(_gamma(k, gen) * (1 - p) / p, gen)


def _sample_generalized_negative_binomial(gen, mu, alpha):
    """Generalized negative binomial of per-element ``mu`` and ``alpha``:
    a Poisson of a Gamma(1 / alpha, mu * alpha) rate."""
    r = 1.0 / alpha.clamp_min(1e-8)
    return _poisson(_gamma(r, gen) * mu * alpha, gen)


for _name, _draw, _args in (
        ("exponential", _sample_exponential, ("lam",)),
        ("poisson", _sample_poisson, ("lam",)),
        ("negative_binomial", _sample_negative_binomial, ("k", "p")),
        ("generalized_negative_binomial",
         _sample_generalized_negative_binomial, ("mu", "alpha"))):
    register("_sample_" + _name, aliases=("sample_" + _name,),
             needs_rng=True, arg_names=_args,
             params={"shape": param("shape", ()),
                     "dtype": param("dtype", None)})(
        per_element_sampler(_draw))
