"""Initialization ops (counterpart of ``mxnet_tpu/ops/init_random.py``):
``_zeros``, ``_ones`` and ``_full`` (``init_random.py:30-36``; the bucketed
LSTM LM's initial states are a ``zeros`` node) and ``_arange``, which the
transformer LM's position ids start from.

An op with no inputs has no tensor to take its device from, so the graph
plan hands it the executor's device as ``attrs["__device__"]`` (``meta``
during shape inference); its dtype is its own ``dtype`` attribute."""
from __future__ import annotations

import torch

from ..ndarray.ndarray import torch_dtype
from .registry import param, register

__all__ = []

_INIT_PARAMS = {"shape": param("shape", ()),
                "dtype": param("dtype", "float32"),
                "ctx": param(str, None)}


def _filled(attrs, value):
    return torch.full(attrs["shape"], value,
                      dtype=torch_dtype(attrs["dtype"] or "float32"),
                      device=attrs.get("__device__", "cpu"))


@register("_zeros", aliases=("zeros",), params=dict(_INIT_PARAMS))
def _zeros(attrs):
    """Zeros of ``shape`` and ``dtype``."""
    return _filled(attrs, 0.0)


@register("_ones", aliases=("ones",), params=dict(_INIT_PARAMS))
def _ones(attrs):
    """Ones of ``shape`` and ``dtype``."""
    return _filled(attrs, 1.0)


@register("_full", aliases=("full",),
          params={**_INIT_PARAMS, "value": param(float, 0.0)})
def _full(attrs):
    """``value`` everywhere in ``shape``, as ``dtype``."""
    return _filled(attrs, attrs["value"])


@register("_arange", aliases=("arange",),
          params={**_INIT_PARAMS,
                  "start": param(float, 0.0), "stop": param(float, None),
                  "step": param(float, 1.0), "repeat": param(int, 1),
                  "infer_range": param(bool, False)})
def _arange(attrs):
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` when
    ``stop`` is unset), each repeated ``repeat`` times
    (``init_random.py:39-49``)."""
    start, stop = attrs["start"], attrs["stop"]
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, attrs["step"],
                       dtype=torch_dtype(attrs["dtype"] or "float32"),
                       device=attrs.get("__device__", "cpu"))
    if attrs["repeat"] > 1:
        out = out.repeat_interleave(attrs["repeat"])
    return out
