"""Reductions, broadcasts and ordering (counterpart of
``mxnet_tpu/ops/reduce.py``): ``sum``/``mean``/``prod``/``nansum``/
``nanprod``/``max``/``min`` over ``axis`` (all when unset) or every other
axis with ``exclude``, ``norm``, the arg reductions, ``topk``/``sort``/
``argsort`` and the broadcasts.  A tie in ``max``/``min`` splits the
gradient (``torch.amax``), as the reference's does; the descending orders
are the reference's: ``sort`` flips a stable ascending sort, ``argsort``
and ``topk`` sort ``-x`` stably, so ties keep their first-come order."""
from __future__ import annotations

import torch

from ..ndarray.ndarray import torch_dtype
from .registry import param, register

__all__ = []

_REDUCE_PARAMS = {"axis": param("shape", None),
                  "keepdims": param(bool, False),
                  "exclude": param(bool, False)}


def _axes(attrs, ndim):
    """The reduced axes: ``axis`` (all when unset), or every other axis
    with ``exclude`` (``reduce.py:23-31``)."""
    axis = attrs["axis"]
    axes = tuple(range(ndim)) if not axis else tuple(a % ndim for a in axis)
    if attrs.get("exclude"):
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _over_axes(fn):
    """A reduction one axis at a time, for the torch functions that take a
    single ``dim`` (``prod``, ``nanprod``); the highest axis first."""
    def reduce(x, axes, keepdim):
        for a in sorted(axes, reverse=True):
            x = fn(x, dim=a, keepdim=keepdim)
        return x
    return reduce


def _nanprod(x, dim, keepdim):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim=dim, keepdim=keepdim)


_REDUCERS = {
    "sum": torch.sum,
    "mean": torch.mean,
    "prod": _over_axes(torch.prod),
    "nansum": torch.nansum,
    "nanprod": _over_axes(_nanprod),
    "max": torch.amax,
    "min": torch.amin,
}


def _make_reduce(fn):
    def reduce(attrs, x):
        axes = _axes(attrs, x.dim())
        if not axes:                # nothing to reduce, as jnp's axis=()
            return x
        return fn(x, axes, attrs["keepdims"])
    return reduce


for _name, _fn in _REDUCERS.items():
    register(_name, params=dict(_REDUCE_PARAMS),
             aliases=(_name + "_axis",) if _name in ("sum", "max", "min")
             else ())(_make_reduce(_fn))


@register("norm", params={"ord": param(int, 2), "axis": param("shape", None),
                          "keepdims": param(bool, False)})
def _norm(attrs, x):
    """``ord`` 1: sum of |x|; 2: sqrt of the sum of squares (so its
    gradient at 0 is NaN, as the reference's)."""
    axis = attrs["axis"]
    axes = tuple(a % x.dim() for a in axis) if axis else tuple(range(x.dim()))
    kd = attrs["keepdims"]
    if attrs["ord"] == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=kd)
    return torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=kd))


def _make_arg_reduce(fn):
    def reduce(attrs, x):
        axis = attrs["axis"]
        if axis is None:
            out = fn(x.reshape(-1), dim=0).float()
            return out.reshape((1,)) if attrs["keepdims"] else out
        return fn(x, dim=int(axis[0]), keepdim=attrs["keepdims"]).float()
    return reduce


for _name, _fn in {"argmax": torch.argmax, "argmin": torch.argmin}.items():
    register(_name, params={"axis": param("shape", None),
                            "keepdims": param(bool, False)})(
        _make_arg_reduce(_fn))


@register("argmax_channel")
def _argmax_channel(attrs, x):
    return torch.argmax(x, dim=1).float()


# --------------------------------------------------------------------------
# broadcasts
# --------------------------------------------------------------------------
@register("broadcast_to", params={"shape": param("shape", ())})
def _broadcast_to(attrs, x):
    """``x`` broadcast to ``shape``; a 0 there keeps ``x``'s size."""
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, attrs["shape"]))
    return x.expand(tgt)


@register("broadcast_axis", aliases=("broadcast_axes",),
          params={"axis": param("shape", ()), "size": param("shape", ())})
def _broadcast_axis(attrs, x):
    tgt = list(x.shape)
    for a, s in zip(attrs["axis"], attrs["size"]):
        tgt[a % x.dim()] = s
    return x.expand(tuple(tgt))


@register("broadcast_like")
def _broadcast_like(attrs, x, like):
    """``x`` broadcast to ``like``'s shape (``reduce.py:103``)."""
    return x.expand(tuple(like.shape))


# --------------------------------------------------------------------------
# ordering
# --------------------------------------------------------------------------
def _axis(attrs, x):
    return int(attrs["axis"][0]) % x.dim() if attrs["axis"] else x.dim() - 1


def _order(x, axis, ascend):
    """Indices of a stable sort of ``x`` (of ``-x`` when descending)."""
    return torch.argsort(x if ascend else -x, dim=axis, stable=True)


def _index_dtype(attrs):
    return torch_dtype(attrs["dtype"] or "float32")


@register("topk", params={"axis": param("shape", (-1,)), "k": param(int, 1),
                          "ret_typ": param(["value", "indices", "mask",
                                            "both"], "indices"),
                          "is_ascend": param(bool, False),
                          "dtype": param("dtype", "float32")},
          nout=lambda attrs: 2 if attrs["ret_typ"] == "both" else 1)
def _topk(attrs, x):
    axis = _axis(attrs, x)
    k = attrs["k"] if attrs["k"] > 0 else x.shape[axis]
    idx = _order(x, axis, attrs["is_ascend"]).narrow(axis, 0, k)
    rt = attrs["ret_typ"]
    if rt == "indices":
        return idx.to(_index_dtype(attrs))
    if rt == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1.0)
    vals = torch.gather(x, axis, idx)
    if rt == "value":
        return vals
    return vals, idx.to(_index_dtype(attrs))


@register("sort", params={"axis": param("shape", (-1,)),
                          "is_ascend": param(bool, True)})
def _sort(attrs, x):
    axis = _axis(attrs, x)
    s = torch.sort(x, dim=axis, stable=True).values
    return s if attrs["is_ascend"] else torch.flip(s, dims=(axis,))


@register("argsort", params={"axis": param("shape", (-1,)),
                             "is_ascend": param(bool, True),
                             "dtype": param("dtype", "float32")})
def _argsort(attrs, x):
    return _order(x, _axis(attrs, x), attrs["is_ascend"]).to(
        _index_dtype(attrs))
