"""Gluon ``Parameter`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py``): a named array per context, with
deferred initialization until the first forward tells the shape, and,
unless ``grad_req`` is ``"null"``, a gradient array per context: each data
array is marked for ``autograd`` with it (``write`` or ``add``), so a
``backward`` under ``autograd.record`` fills it, and ``gluon.Trainer``
reads it with ``lr_mult``/``wd_mult``.  ``FusedTrainer`` trains every
argument of the graph on its own copies and writes the values back with
``sync_params``.  ``ParameterDict.save``/``load`` write and read the
reference's npz container (``nd.save``), so a file moves between the two
packages; ``Constant`` is a parameter that no trainer updates.

A shape that does not fit the known dims raises ``MXNetError`` (the
``shape`` setter) where the reference raises ``AssertionError``.
"""
from __future__ import annotations

from collections import OrderedDict
import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, cpu, current_context
from .. import autograd
from .. import initializer
from ..ndarray import ndarray as nd

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """The parameter's shape is not known yet: run one forward first."""


def _known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A weight or state of a Block, one NDArray per context."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._var = None
        self._data = None               # OrderedDict: Context -> NDArray
        self._grad = None               # OrderedDict: Context -> NDArray
        self._deferred_init = ()
        if stype != "default":
            raise MXNetError("parameter %s: stype %r is not ported yet "
                             "(Queue 1 item 9)" % (name, stype))
        self._stype = stype
        self._grad_req = None
        self.grad_req = grad_req if differentiable else "null"

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, np.dtype(self.dtype).name
            if not str(self.dtype).endswith("bfloat16") else "bfloat16")

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """``write``/``add`` keep a gradient array per context (made now
        when the data exists); ``null`` drops them."""
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            for arr in (self._data or {}).values():
                arr._grad, arr._grad_req = None, "null"
                arr._data = arr._data.detach()
        elif self._data is not None:
            self._init_grad()

    def _init_grad(self):
        """A zero gradient array per context, each data array marked for
        autograd with it."""
        if self._grad_req == "null":
            self._grad = None
            return
        self._grad = OrderedDict(
            (c, nd.zeros(a.shape, ctx=c, dtype=a._data.dtype))
            for c, a in self._data.items())
        autograd.mark_variables(list(self._data.values()),
                                list(self._grad.values()), self._grad_req)

    @property
    def stype(self):
        """The storage type, ``"default"`` (dense): the only one ported."""
        return self._stype

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        """Fill unknown (0) dims; a known dim must not change."""
        new_shape = tuple(new_shape)
        if self._shape is not None:
            if len(self._shape) != len(new_shape) or any(
                    s not in (0, -1) and s != n
                    for s, n in zip(self._shape, new_shape)):
                raise MXNetError("parameter %s: shape %s is incompatible "
                                 "with %s" % (self.name, new_shape,
                                              self._shape))
        self._shape = new_shape

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize on ``ctx`` (a Context or a list; default: the current
        context), deferred until the shape is known."""
        if self._data is not None and not force_reinit:
            return
        self._data = None
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if default_init is None:
            default_init = initializer.Uniform()
        if init is None:
            init = self.init if self.init is not None else default_init
        self._deferred_init = (init, list(ctx))
        if _known(self.shape):
            self._finish_deferred_init()
        elif not self.allow_deferred_init:
            raise MXNetError("cannot initialize parameter %s of unknown "
                             "shape %s" % (self.name, self.shape))

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx = self._deferred_init
        if not _known(self.shape):
            raise MXNetError("cannot initialize parameter %s: shape %s is "
                             "not known" % (self.name, self.shape))
        self._deferred_init = ()
        if isinstance(init, np.ndarray):          # set by set_data
            self._init_impl(init, ctx)
            return
        data = nd.zeros(self.shape, ctx=cpu(), dtype=self.dtype)
        initializer.create(init)(self.name, data)
        self._init_impl(data._data, ctx)

    def _init_impl(self, value, ctx_list):
        self._data = OrderedDict(
            (c, nd.array(value, ctx=c, dtype=self.dtype)) for c in ctx_list)
        self._init_grad()

    def _load_init(self, value, ctx=None):
        """Take ``value`` (numpy, a tensor or an NDArray) in place of an
        initializer's draw (``parameter.py:173``): the shape must fit the
        known dims (else ``MXNetError``, through the ``shape`` setter).
        Made on ``ctx`` (a Context or a list), by default where it lives
        or will live, else on the current context; written in place when
        it already lives on those contexts."""
        value = nd._as_tensor(value, None)
        self.shape = tuple(value.shape)
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None and (ctx is None
                                       or set(ctx) == set(self._data)):
            with torch.no_grad():
                for arr in self._data.values():
                    arr._data.copy_(value)
            return
        if ctx is None:
            ctx = (list(self._deferred_init[1]) if self._deferred_init
                   else [current_context()])
        self._deferred_init = ()
        self._init_impl(value, ctx)

    def _reduce(self):
        """The value on the CPU: the one array's copy, or the mean over
        the contexts (``parameter.py:312``)."""
        arrays = self.list_data()
        if len(arrays) == 1:
            return arrays[0].copyto(cpu())
        mean = sum(a._data.detach().double().cpu() for a in arrays) \
            / len(arrays)
        return nd.array(mean, ctx=cpu(), dtype=self.dtype)

    def _arrays(self, grad=False):
        """The data (or gradient) arrays by context; raises while the
        parameter is not made, or has no gradient."""
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "parameter %s has not been initialized yet: its shape "
                    "comes from the first forward" % self.name)
            raise MXNetError("parameter %s has not been initialized"
                             % self.name)
        if grad and self._grad is None:
            raise MXNetError("parameter %s has no gradient: grad_req is "
                             "'null'" % self.name)
        return self._grad if grad else self._data

    def _on(self, arrays, ctx):
        if ctx is None:
            if len(arrays) == 1:
                return next(iter(arrays.values()))
            ctx = current_context()
        if ctx not in arrays:
            raise MXNetError("parameter %s is not initialized on %s (only on "
                             "%s)" % (self.name, ctx, list(arrays)))
        return arrays[ctx]

    def data(self, ctx=None) -> nd.NDArray:
        """The array on ``ctx`` (default: the only one, else the current
        context)."""
        return self._on(self._arrays(), ctx)

    def list_data(self):
        """The array on every context, in context order."""
        return list(self._arrays().values())

    def grad(self, ctx=None) -> nd.NDArray:
        """The gradient array on ``ctx`` (as :meth:`data`)."""
        return self._on(self._arrays(grad=True), ctx)

    def list_grad(self):
        """The gradient array on every context, in context order."""
        return list(self._arrays(grad=True).values())

    def list_ctx(self):
        """The contexts the parameter lives on (those it will live on when
        its initialization is deferred)."""
        if self._data is None:
            if self._deferred_init:
                return list(self._deferred_init[1])
            raise MXNetError("parameter %s has not been initialized"
                             % self.name)
        return list(self._data.keys())

    def zero_grad(self):
        """Zero every gradient array."""
        for g in (self._grad or {}).values():
            g[:] = 0

    def set_data(self, data):
        """Set the value on every context (deferred to the initialization
        when that is still to come)."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("parameter %s has not been initialized"
                                 % self.name)
            # the value takes the initializer's place
            self._deferred_init = (np.asarray(
                data.asnumpy() if isinstance(data, nd.NDArray) else data),
                self._deferred_init[1])
            return
        for arr in self._data.values():
            arr[:] = data

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a Context or a list), its value
        taken from its first context; gradients start at zero."""
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data:
            value = next(iter(self._data.values()))._data.detach().cpu()
            self._init_impl(value, ctx)
        elif self._deferred_init:
            self._deferred_init = (self._deferred_init[0], list(ctx))
        else:
            raise MXNetError("cannot reset the context of parameter %s: it "
                             "has not been initialized" % self.name)

    def cast(self, dtype):
        """Cast this Parameter's arrays to ``dtype`` (``parameter.py:331``);
        a deferred one is made in ``dtype`` when its shape is known."""
        self.dtype = dtype
        if self._data is None:
            return
        self._data = OrderedDict((c, a.astype(dtype))
                                 for c, a in self._data.items())
        self._init_grad()

    def var(self):
        """The Symbol variable of this parameter."""
        if self._var is None:
            from ..symbol import var
            self._var = var(self.name, shape=self.shape)
        return self._var


class Constant(Parameter):
    """A parameter that holds ``value`` and that no trainer updates
    (``grad_req`` null; ``parameter.py:343``).  Its initializer writes the
    value whatever the name says, as upstream MXNet's does."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(np.asarray(value), ctx=cpu())
        self.value = value

        class Init(initializer.Initializer):
            def __call__(self, _name, arr):
                arr[:] = value.as_in_context(arr.context)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=Init(), differentiable=False)


class ParameterDict:
    """Parameters by full name, all starting with ``prefix``; ``shared``
    is another ParameterDict whose Parameters ``get`` hands out in place
    of new ones (a Block built with ``params=``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "%s(\n%s\n)" % (
            name, "\n".join("  " + repr(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """The Parameter ``prefix + name``, made with ``kwargs`` if new.
        An existing one takes the unknown dims of a given ``shape``, and a
        new ``lr_mult``, ``wd_mult`` or ``grad_req``; another value of any
        other attribute raises (``parameter.py:425-446``)."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = self._params[full] = Parameter(full, **kwargs)
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None and len(v) == len(existing):
                param._shape = tuple(e if e not in (0, -1) else n
                                     for e, n in zip(existing, v))
            elif k in ("lr_mult", "wd_mult", "grad_req"):
                if v is not None and v != existing:
                    setattr(param, k, v)
            elif v is not None and v != existing:
                raise MXNetError(
                    "cannot retrieve parameter %s: attribute %s is %r, not "
                    "the desired %r" % (full, k, existing, v))
        return param

    def get_constant(self, name, value=None) -> Constant:
        """The Constant ``prefix + name``, made from ``value`` if new
        (``parameter.py:447``)."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise MXNetError("no constant named %s: give a value to make "
                                 "one" % full)
            param = self._params[full] = Constant(full, value)
        elif value is not None and not isinstance(param, Constant):
            raise MXNetError("parameter %s exists and is not a constant"
                             % full)
        return param

    def update(self, other):
        """Add every Parameter of ``other``; a name bound to another
        Parameter raises."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("cannot update: two different parameters "
                                 "are named %r" % k)
            self._params[k] = v

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set an attribute (``grad_req``, ``lr_mult``, ...) on every
        Parameter."""
        for p in self.values():
            setattr(p, name, value)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter; ``init`` is the default for those
        that name none.  ``verbose`` is accepted, as in the reference."""
        default = initializer.create(init) if init is not None \
            else initializer.Uniform()
        for p in self.values():
            p.initialize(None, ctx, default, force_reinit=force_reinit)

    def save(self, filename, strip_prefix=""):
        """Write every value, named without ``strip_prefix``, to
        ``filename`` in the reference's npz container
        (``parameter.py:495``)."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError("cannot strip prefix %r from parameter %s"
                                 % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param._reduce()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read the values of a file that ``save`` (or ``export``, whose
        names start with ``arg:`` and ``aux:``) wrote, the names prefixed
        with ``restore_prefix``, onto ``ctx`` (``parameter.py:508``)."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise MXNetError("restore_prefix is %r but parameter %s "
                                     "does not start with it"
                                     % (restore_prefix, name))
        lprefix = len(restore_prefix)
        arg_dict = {}
        for k, v in nd.load(filename, ctx=cpu()).items():
            if k.startswith("arg:") or k.startswith("aux:"):
                k = k[4:]
            arg_dict[restore_prefix + k] = v
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("parameter %s is missing in file %s"
                                     % (name[lprefix:], filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("parameter %s loaded from file %s is "
                                     "not present in this ParameterDict"
                                     % (name[lprefix:], filename))
                continue
            self._params[name]._load_init(value, ctx)
