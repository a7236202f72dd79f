"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``download``, which raises: the port reads local files only."""
from __future__ import annotations

import hashlib
import warnings

import numpy as np

from .. import ndarray
from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last one
    takes the remainder unless ``even_split`` requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if not even_split and size < num_slice:
        step, num_slice = 1, size
    bounds = [(i * step, (i + 1) * step if i < num_slice - 1 else size)
              for i in range(num_slice)]
    if batch_axis == 0:
        return [data[b:e] for b, e in bounds]
    return [ndarray.slice_axis(data, axis=batch_axis, begin=b, end=e)
            for b, e in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` (an NDArray or array-like) split into one slice a context,
    each slice on its context."""
    if not isinstance(data, ndarray.NDArray):
        data = ndarray.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the 2-norm of all of them together
    is at most ``max_norm``; returns that norm before scaling (a float when
    ``check_isfinite``, which warns on a non-finite one, else an NDArray
    on the first array's context)."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    ctx = arrays[0].context
    total = ndarray.add_n(*[ndarray.dot(a.reshape((-1,)), a.reshape((-1,)))
                            .as_in_context(ctx) for a in arrays])
    total = ndarray.sqrt(total)
    if check_isfinite:
        value = float(total.asscalar())
        if not np.isfinite(value):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
    scale = max_norm / (total + 1e-8)
    scale = ndarray.minimum(scale, ndarray.ones(1, ctx=ctx))
    for a in arrays:
        a *= scale.as_in_context(a.context)
    return value if check_isfinite else total


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Raises: the port fetches nothing over a network; put the file at
    its path by hand."""
    raise RuntimeError(
        "download() needs network access, which the port does not use; "
        "place the file for %s at its path by hand" % url)
