"""NDArray: a handle over a ``torch.Tensor`` on a context (counterpart of
``mxnet_tpu/ndarray/ndarray.py``): the reference's arithmetic, comparison
and in-place operators with scalars on either side, indexing, the shape,
reduction and unary methods (each one op of the registry, run by
:func:`~mxnet_tpu_torch.ndarray.register.invoke`, so recorded under
``autograd.record``), ``attach_grad``/``grad``/``backward``, the creation
functions, and ``save``/``load`` in the reference package's npz format so
a ``.params`` file that ``mxnet_tpu.nd.save`` wrote loads here.

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

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "waitall", "onehot_encode", "save",
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


def _invoke(op_name, *args, **kwargs):
    from .register import invoke
    return invoke(op_name, *args, **kwargs)


_NUMERIC = (int, float, np.integer, np.floating, bool, np.bool_)


def _index(key):
    """An index as PyTorch takes it: an NDArray becomes an integer tensor
    (a float array of positions is truncated, as the reference casts it)."""
    if isinstance(key, NDArray):
        t = key._data
        return t if t.dtype in (torch.bool, torch.int64) else t.long()
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    if isinstance(key, (np.integer, np.bool_)):
        return key.item()
    return key


class NDArray:
    """A tensor bound to a context.  ``_data`` is the ``torch.Tensor``;
    ``_grad``/``_grad_req`` are the gradient buffer and request of a marked
    array (:mod:`mxnet_tpu_torch.autograd`).  ``ctx`` names the context
    where the device alone does not (``cpu(1)``: PyTorch has one CPU
    device); it holds while the tensor stays on that device."""

    __slots__ = ("_data", "_grad", "_grad_req", "_ctx", "__weakref__")

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None):
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._ctx = ctx

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one; ``torch.bfloat16`` otherwise."""
        return _NP_DTYPES.get(self._data.dtype, self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        ctx = self._ctx
        if ctx is not None and ctx.torch_device == self._data.device:
            return ctx
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return _invoke("transpose", self)

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer (``attach_grad``), or None."""
        return self._grad

    @property
    def _ag_entry(self):
        """The node of the recorded graph that made this array (its
        ``grad_fn``), None when no recorded op did."""
        return self._data.grad_fn

    def wait_to_read(self):
        """Block until the work that produces this array is done."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # ---- autograd -------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a zero gradient buffer that :meth:`backward`
        fills (``grad_req`` "write", "add" or "null")."""
        from .. import autograd
        autograd.mark_variables([self], [NDArray(torch.zeros_like(
            self._data, requires_grad=False), self._ctx)], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array (times ``out_grad``, ones by default)
        into the buffers of the marked arrays it was recorded from."""
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self) -> "NDArray":
        """This array's values, cut from the recorded graph."""
        return NDArray(self._data.detach(), self._ctx)

    def _assign(self, t: torch.Tensor):
        """Make ``t`` this array's value: copied in place, under
        ``no_grad``, into a marked leaf (which keeps its identity, so the
        recorded graphs and gradient buffers stay bound to it), else bound
        as the new buffer."""
        d = self._data
        if d.requires_grad and d.is_leaf:
            with torch.no_grad():
                d.copy_(t.expand(d.shape))
        else:
            self._data = t

    # ---- host transfer --------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A numpy copy (never a view: the tensor of a Gluon parameter is
        updated in place)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # ---- copies and conversion ------------------------------------------
    def copyto(self, other):
        """A copy on ``other`` (a Context), or into ``other`` (an NDArray,
        whose buffer is replaced as by ``other[:] = self``)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), other)
        if isinstance(other, NDArray):
            other[:] = self
            return other
        raise MXNetError("copyto expects a Context or an NDArray, got %r"
                         % (other,))

    def copy(self) -> "NDArray":
        """A copy on the same context."""
        return NDArray(self._data.detach().clone(), self._ctx)

    def _traced(self) -> torch.Tensor:
        """The tensor, cut from the recorded graph unless recording."""
        from .. import autograd
        return self._data if autograd.is_recording() else self._data.detach()

    def as_in_context(self, ctx: Context) -> "NDArray":
        """Self when already on ``ctx`` (no copy), else a copy there
        (recorded under ``autograd.record``)."""
        if self.context == ctx:
            return self
        return NDArray(self._traced().to(ctx.torch_device), ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True) -> "NDArray":
        t = torch_dtype(dtype)
        if t == self._data.dtype and not copy:
            return self
        return NDArray(self._traced().to(t, copy=copy), self._ctx)

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage is not ported yet (ROADMAP.md "
                             "Queue 1 item 9)")
        return self

    # ---- shape ops --------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """``Reshape`` with MXNet's codes (0 keep, -1 infer, -2 copy the
        rest, -3 merge two, -4 split one); ``reverse`` matches from the
        right."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = tuple(kwargs["shape"])
        return _invoke("Reshape", self, shape=shape,
                       reverse=kwargs.get("reverse", False))

    def reshape_like(self, other) -> "NDArray":
        return _invoke("reshape_like", self, other)

    def expand_dims(self, axis) -> "NDArray":
        return _invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        return _invoke("squeeze", self, axis=axis)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", self, axes=axes)

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return _invoke("SwapAxis", self, dim1=dim1, dim2=dim2)

    def flatten(self) -> "NDArray":
        return _invoke("Flatten", self)

    def broadcast_to(self, shape) -> "NDArray":
        shape = tuple(shape)
        cur = (1,) * (len(shape) - self.ndim) + self.shape
        src = self if cur == self.shape else self.reshape(cur)
        return _invoke("broadcast_to", src, shape=shape)

    def broadcast_like(self, other) -> "NDArray":
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return _invoke("tile", self, reps=reps)

    def flip(self, axis):
        return _invoke("reverse", self, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("SliceChannel", self, num_outputs=num_outputs,
                       axis=axis, squeeze_axis=squeeze_axis)

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", self, index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, **kwargs):
        return _invoke("one_hot", self, depth=depth, **kwargs)

    # ---- reductions -------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kwargs):
        return _invoke("sum", self, axis=axis, keepdims=keepdims, **kwargs)

    def nansum(self, axis=None, keepdims=False, **kwargs):
        return _invoke("nansum", self, axis=axis, keepdims=keepdims,
                       **kwargs)

    def mean(self, axis=None, keepdims=False, **kwargs):
        return _invoke("mean", self, axis=axis, keepdims=keepdims, **kwargs)

    def prod(self, axis=None, keepdims=False, **kwargs):
        return _invoke("prod", self, axis=axis, keepdims=keepdims, **kwargs)

    def max(self, axis=None, keepdims=False, **kwargs):
        return _invoke("max", self, axis=axis, keepdims=keepdims, **kwargs)

    def min(self, axis=None, keepdims=False, **kwargs):
        return _invoke("min", self, axis=axis, keepdims=keepdims, **kwargs)

    def norm(self, **kwargs):
        return _invoke("norm", self, **kwargs)

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", self, axis=axis, keepdims=keepdims)

    def argsort(self, **kwargs):
        return _invoke("argsort", self, **kwargs)

    def sort(self, **kwargs):
        return _invoke("sort", self, **kwargs)

    def topk(self, **kwargs):
        return _invoke("topk", self, **kwargs)

    def clip(self, a_min, a_max):
        return _invoke("clip", self, a_min=a_min, a_max=a_max)

    def softmax(self, axis=-1, **kwargs):
        return _invoke("softmax", self, axis=axis, **kwargs)

    def log_softmax(self, axis=-1, **kwargs):
        return _invoke("log_softmax", self, axis=axis, **kwargs)

    # ---- arithmetic -------------------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            return _invoke(op, *((other, self) if reverse else (self, other)))
        if isinstance(other, _NUMERIC):
            return _invoke(scalar_op, self, scalar=float(other))
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar", True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar", True)

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "broadcast_mod", "_rmod_scalar", True)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_rpower_scalar", True)

    def __neg__(self):
        return _invoke("negative", self)

    def __abs__(self):
        return _invoke("abs", self)

    def __eq__(self, other):  # type: ignore[override]
        if other is None:
            return False
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):  # type: ignore[override]
        if other is None:
            return True
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace(self, out):
        if out is NotImplemented:
            return NotImplemented
        self._assign(out._data.to(self._data.dtype))
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    def __imod__(self, other):
        return self._inplace(self.__mod__(other))

    # ---- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        """An integer, a slice, a tuple of them, ``None``/``...``, or an
        NDArray of positions (``a[idx]`` gathers along the first axis).
        Under ``autograd.record`` the result is recorded."""
        from .. import autograd
        if autograd.is_recording():
            autograd.lift([self])
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[_index(key)], self._ctx)

    def __setitem__(self, key, value):
        """``a[key] = v``, ``v`` broadcast and cast to ``a``'s dtype.  The
        result lands in a fresh buffer that is then bound, as the
        reference's immutable arrays behave (a tensor adopted elsewhere,
        ``Predictor.set_input``, is never written through), except for a
        marked leaf, which is written in place under ``no_grad`` and keeps
        its identity."""
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        d = self._data
        value = value.detach().to(d.device, d.dtype)
        if d.requires_grad and d.is_leaf:
            with torch.no_grad():
                d[_index(key)] = value
            return
        if isinstance(key, slice) and key == slice(None):
            new = torch.empty_like(d)
            new.copy_(value.expand(d.shape))
        else:
            new = d.detach().clone()
            new[_index(key)] = value
        self._data = new

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]


# unary methods, each the op of its name (``ndarray.py:243-290``)
for _name in ("abs", "sign", "sqrt", "rsqrt", "square", "exp", "expm1",
              "log", "log10", "log2", "log1p", "relu", "sigmoid", "tanh",
              "sin", "cos", "tan", "round", "rint", "floor", "ceil",
              "trunc", "fix", "reciprocal", "softsign", "arcsin", "arccos",
              "arctan", "sinh", "cosh", "arcsinh", "arccosh", "arctanh",
              "degrees", "radians", "cbrt", "rcbrt", "zeros_like",
              "ones_like"):
    setattr(NDArray, _name,
            (lambda n: lambda self: _invoke(n, self))(_name))


def _as_tensor(source, dtype) -> torch.Tensor:
    if isinstance(source, NDArray):
        source = source._data.detach()
    if not isinstance(source, torch.Tensor) and is_numpy_bf16(
            np.asarray(source)):
        source = bf16_from_numpy(np.asarray(source))
    if not isinstance(source, torch.Tensor):
        arr = np.asarray(source)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)      # the reference's default dtype
        arr = np.asarray(arr, order="C")      # 0-d stays 0-d
        if not arr.flags.writeable:
            arr = arr.copy()          # torch.from_numpy shares the buffer
        source = torch.from_numpy(arr)
    return source if dtype is None else source.to(torch_dtype(dtype))


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Copy ``source`` (numpy, list, tensor or NDArray) onto ``ctx``."""
    ctx = ctx or current_context()
    t = _as_tensor(source, dtype)
    return NDArray(t.to(ctx.torch_device, copy=True), ctx)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    """The arrays joined along ``axis``, on the first one's context."""
    dev = arrays[0]._data.device
    return NDArray(torch.cat([a._data.to(dev) for a in arrays], dim=axis))


def zeros(shape, ctx: Optional[Context] = None, dtype="float32",
          **kwargs) -> NDArray:
    """Zeros on ``ctx``; other keywords (``name``, a ``state_info``'s
    ``__layout__``) are accepted and ignored, as the reference's are."""
    return _full(shape, 0.0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype="float32",
         **kwargs) -> NDArray:
    return _full(shape, 1.0, ctx, dtype)


def full(shape, val, ctx: Optional[Context] = None, dtype="float32",
         **kwargs) -> NDArray:
    """``val`` everywhere in ``shape`` on ``ctx``."""
    return _full(shape, val, ctx, dtype)


def empty(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    """An array of ``shape`` on ``ctx`` (zeros, as the reference's)."""
    return _full(shape, 0.0, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx: Optional[Context] = None,
           dtype="float32") -> NDArray:
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` without
    ``stop``), each repeated ``repeat`` times."""
    ctx = ctx or current_context()
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch.float64).to(
        torch_dtype(dtype or "float32"))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray(out.to(ctx.torch_device), ctx)


def moveaxis(tensor: NDArray, source, destination) -> NDArray:
    """``tensor`` with axis ``source`` moved to ``destination``."""
    return NDArray(tensor._data.movedim(source, destination))


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """One-hot rows of ``out.shape[1]`` for ``indices``, written into
    ``out``."""
    from .register import invoke
    res = invoke("one_hot", indices, depth=out.shape[1])
    out._assign(res._data.to(out._data.dtype))
    return out


def waitall():
    """Block until the work queued on every card is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _full(shape, value, ctx, dtype) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


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
