"""NDArray: a thin handle over a ``torch.Tensor`` on a context
(counterpart of ``mxnet_tpu/ndarray/ndarray.py``), with just what the
serving and training paths use, plus ``save``/``load`` in the reference
package's npz format so a ``.params`` file that ``mxnet_tpu.nd.save`` wrote
loads here.

bfloat16 is a dtype of the port (``astype("bfloat16")``, ``array(...,
dtype="bfloat16")``) though numpy has none without ``ml_dtypes``, which the
port does not import.  So ``asnumpy()`` of a bf16 array returns float32 (a
documented difference: the reference returns an ``ml_dtypes.bfloat16``
array), and a numpy bf16 array, whether ``ml_dtypes.bfloat16`` or the raw
two-byte ``|V2`` that ``np.savez`` writes for one, becomes a bf16 tensor
bit for bit through an ``int16`` view.  ``save`` writes bf16 as that same
``|V2`` payload, byte for byte what the reference's ``save`` writes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, context_of, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "concatenate", "save",
           "load", "is_numpy_bf16", "bf16_from_numpy", "bf16_to_numpy"]

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def is_numpy_bf16(arr) -> bool:
    """Whether a numpy array holds bfloat16: ``ml_dtypes.bfloat16`` (told
    by its name, without importing ``ml_dtypes``) or the raw ``|V2`` that
    ``np.save`` writes for it."""
    dt = arr.dtype
    return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2
                                     and dt.fields is None)


def bf16_from_numpy(arr) -> torch.Tensor:
    """A numpy bf16 array (:func:`is_numpy_bf16`) as a bf16 CPU tensor, bit
    for bit: the two-byte payload viewed as ``int16``, then as bf16."""
    raw = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(raw).view(torch.bfloat16)


def bf16_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as the raw ``|V2`` numpy array that ``np.savez`` writes
    for an ``ml_dtypes.bfloat16`` one (the reference's ``.params`` entry)."""
    raw = t.detach().contiguous().view(torch.int16).cpu().numpy()
    return raw.view(np.dtype("V2"))


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or name, or torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise MXNetError("unsupported dtype %r" % (dtype,)) from e


class NDArray:
    """A tensor bound to a context.  ``_data`` is the ``torch.Tensor``."""

    __slots__ = ("_data",)

    def __init__(self, data: torch.Tensor):
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one; ``torch.bfloat16`` otherwise."""
        return _NP_DTYPES.get(self._data.dtype, self._data.dtype)

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    def wait_to_read(self):
        """Block until the work that produces this array is done."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    def copyto(self, other):
        """A copy on ``other`` (a Context), or into ``other`` (an NDArray,
        whose buffer is replaced as by ``other[:] = self``)."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True))
        if isinstance(other, NDArray):
            other[:] = self
            return other
        raise MXNetError("copyto expects a Context or an NDArray, got %r"
                         % (other,))

    def copy(self) -> "NDArray":
        """A copy on the same context."""
        return NDArray(self._data.detach().clone())

    def __getitem__(self, key):
        """Rows ``a[start:stop]`` along the first axis (a view, as every
        write to an NDArray binds a new buffer)."""
        if not isinstance(key, slice):
            raise MXNetError("only a[start:stop] is supported, got index %r"
                             % (key,))
        return NDArray(self._data[key])

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def as_in_context(self, ctx: Context) -> "NDArray":
        """Self when already on ``ctx`` (no copy), else a copy there."""
        dev = ctx.torch_device
        if self._data.device == dev:
            return self
        return NDArray(self._data.to(dev))

    def astype(self, dtype, copy=True) -> "NDArray":
        t = torch_dtype(dtype)
        if t == self._data.dtype and not copy:
            return self
        return NDArray(self._data.to(t, copy=copy))

    def __setitem__(self, key, value):
        """Whole-array assignment ``a[:] = v`` (v broadcast to a's shape).

        The value lands in a fresh buffer that is then bound, as the
        reference's immutable arrays behave: a tensor adopted elsewhere
        (``Predictor.set_input``) is never written through."""
        if not (isinstance(key, slice) and key == slice(None)):
            raise MXNetError("only whole-array assignment a[:] = v is "
                             "supported, got index %r" % (key,))
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        new = torch.empty_like(self._data)
        new.copy_(value.expand(self._data.shape))
        self._data = new


def _as_tensor(source, dtype) -> torch.Tensor:
    if isinstance(source, NDArray):
        source = source._data
    if not isinstance(source, torch.Tensor) and is_numpy_bf16(
            np.asarray(source)):
        source = bf16_from_numpy(np.asarray(source))
    if not isinstance(source, torch.Tensor):
        arr = np.asarray(source)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)      # the reference's default dtype
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()          # torch.from_numpy shares the buffer
        source = torch.from_numpy(arr)
    return source if dtype is None else source.to(torch_dtype(dtype))


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Copy ``source`` (numpy, list, tensor or NDArray) onto ``ctx``."""
    ctx = ctx or current_context()
    t = _as_tensor(source, dtype)
    return NDArray(t.to(ctx.torch_device, copy=True))


def concatenate(arrays, axis=0) -> NDArray:
    """The arrays joined along ``axis``, on the first one's context."""
    dev = arrays[0]._data.device
    return NDArray(torch.cat([a._data.to(dev) for a in arrays], dim=axis))


def zeros(shape, ctx: Optional[Context] = None, dtype="float32",
          **kwargs) -> NDArray:
    """Zeros on ``ctx``; other keywords (``name``, a ``state_info``'s
    ``__layout__``) are accepted and ignored, as the reference's are."""
    return _full(shape, 0.0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    return _full(shape, 1.0, ctx, dtype)


def _full(shape, value, ctx, dtype) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                              device=ctx.torch_device))


# --------------------------------------------------------------------------
# save / load: the reference package's npz container, entries "arr:<i>" for a
# list and "name:<key>" for a dict (mxnet_tpu/ndarray/ndarray.py:741-816).
# --------------------------------------------------------------------------
def _entry(a: NDArray) -> np.ndarray:
    if a._data.dtype == torch.bfloat16:
        return bf16_to_numpy(a._data)
    return a.asnumpy()


def save(fname, data):
    """Write an NDArray, a list of them or a ``{name: NDArray}`` dict; bf16
    arrays as the reference writes them (``|V2``)."""
    if isinstance(data, NDArray):
        entries = {"arr:0": _entry(data)}
    elif isinstance(data, (list, tuple)):
        entries = {"arr:%d" % i: _entry(a) for i, a in enumerate(data)}
    elif isinstance(data, dict):
        entries = {"name:" + k: _entry(v) for k, v in data.items()}
    else:
        raise MXNetError("save expects NDArray, list, or dict")
    np.savez(_norm(fname), **entries)


def load(fname, ctx: Optional[Context] = None):
    """Read a file ``save`` wrote (path or file-like).  Arrays land on
    ``ctx``, by default the current context, as the reference's do; a bf16
    entry (``|V2``) loads as bf16."""
    ctx = ctx or current_context()
    with np.load(_norm(fname), allow_pickle=False) as z:
        keys = list(z.keys())
        sparse = [k for k in keys if "/" in k]
        if sparse:
            raise MXNetError("sparse entries are not supported yet: %s"
                             % sparse[:3])
        if all(k.startswith("arr:") for k in keys):
            keys.sort(key=lambda k: int(k.split(":")[1]))
            return [array(z[k], ctx) for k in keys]
        return {k.split(":", 1)[1]: array(z[k], ctx) for k in keys}


def _norm(fname):
    if not isinstance(fname, str):
        return fname          # file-like object (Predictor bytes params)
    return fname if fname.endswith(".npz") else fname + ".npz"
