"""Gluon ``Parameter`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py``): a named array per context, with
deferred initialization until the first forward tells the shape.

Gradients are not kept on the Parameter in this port yet: the fused
trainer holds its own state and writes values back with ``sync_params``.
It trains every argument of the graph, as the reference's does, so the
per-parameter knobs that only ``gluon.Trainer`` reads (``grad_req``,
``lr_mult``, ``wd_mult``) come with that trainer.
"""
from __future__ import annotations

from collections import OrderedDict
import numpy as np

from ..base import MXNetError
from ..context import Context, cpu, current_context
from .. import initializer
from ..ndarray import ndarray as nd

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """The parameter's shape is not known yet: run one forward first."""


def _known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A weight or state of a Block, one NDArray per context."""

    def __init__(self, name, shape=None, dtype=np.float32, init=None,
                 allow_deferred_init=False):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._var = None
        self._data = None               # OrderedDict: Context -> NDArray
        self._deferred_init = ()

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
        data = nd.zeros(self.shape, ctx=cpu(), dtype=self.dtype)
        initializer.create(init)(self.name, data)
        self._data = OrderedDict(
            (c, nd.array(data._data, ctx=c, dtype=self.dtype)) for c in ctx)

    def _load_init(self, value, ctx_list):
        """Make the arrays from ``value`` (numpy) on each context, in place
        of an initializer's draw; the shape must fit the known dims."""
        self.shape = tuple(value.shape)
        self._deferred_init = ()
        self._data = OrderedDict(
            (c, nd.array(value, ctx=c, dtype=self.dtype)) for c in ctx_list)

    def data(self, ctx=None) -> nd.NDArray:
        """The array on ``ctx`` (default: the only one, else the current
        context)."""
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "parameter %s has not been initialized yet: its shape "
                    "comes from the first forward" % self.name)
            raise MXNetError("parameter %s has not been initialized"
                             % self.name)
        if ctx is None:
            if len(self._data) == 1:
                return next(iter(self._data.values()))
            ctx = current_context()
        if ctx not in self._data:
            raise MXNetError("parameter %s is not initialized on %s (only on "
                             "%s)" % (self.name, ctx, list(self._data)))
        return self._data[ctx]

    def cast(self, dtype):
        """Cast this Parameter's arrays to ``dtype`` (``parameter.py:331``);
        a deferred one is made in ``dtype`` when its shape is known."""
        self.dtype = dtype
        if self._data is None:
            return
        self._data = OrderedDict((c, a.astype(dtype))
                                 for c, a in self._data.items())

    def var(self):
        """The Symbol variable of this parameter."""
        if self._var is None:
            from ..symbol import var
            self._var = var(self.name, shape=self.shape)
        return self._var


class ParameterDict:
    """Parameters by full name, all starting with ``prefix``."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = OrderedDict()

    def __getitem__(self, key):
        return self._params[key]

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

    def get(self, name, **kwargs) -> Parameter:
        """The Parameter ``prefix + name``, made with ``kwargs`` if new."""
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = Parameter(full, **kwargs)
        return self._params[full]

    def update(self, other):
        """Add every Parameter of ``other``; a name bound to another
        Parameter raises."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("cannot update: two different parameters "
                                 "are named %r" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """Initialize every Parameter; ``init`` is the default for those
        that name none."""
        default = initializer.create(init) if init is not None \
            else initializer.Uniform()
        for p in self.values():
            p.initialize(None, ctx, default, force_reinit=force_reinit)
