"""Gluon ``Block`` and ``HybridBlock`` (counterpart of
``mxnet_tpu/gluon/block.py``).

A HybridBlock describes its computation once, in ``hybrid_forward(F, x,
...)``; called on a Symbol it builds the graph, and called on an NDArray it
runs that graph through :class:`~mxnet_tpu_torch.cached_op.CachedOp`.  The
port has no per-op imperative layer yet, so an NDArray call takes the
graph path whether or not ``hybridize()`` was called.  Names follow the
reference exactly (``_BlockScope``'s per-scope counters and the ``Prefix``
name scope), so a parameter of a port block has the name of the same
parameter of a reference block, and weights move across by name.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ..base import MXNetError
from .. import name as _name
from .. import symbol as _symbol
from ..ndarray.ndarray import NDArray
from ..symbol import Symbol
from .parameter import ParameterDict

__all__ = ["Block", "HybridBlock"]

_naming = threading.local()


class _BlockScope:
    """Naming scope of a Block's children (``block.py:34-84``): a child
    with no prefix of its own is named ``<hint><count>_`` by a counter
    kept per parent scope, and at top level by the current NameManager."""

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def _current():
        return getattr(_naming, "scope", None)

    @staticmethod
    def create(prefix, hint):
        """(full prefix, ParameterDict) of a new Block."""
        current = _BlockScope._current()
        if current is None:
            if prefix is None:
                prefix = _name.current_scope().get(None, hint) + "_"
            return prefix, ParameterDict(prefix)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        return (current._block.prefix + prefix,
                ParameterDict(current._block.params.prefix + prefix))

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = _BlockScope._current()
        _naming.scope = self
        self._name_scope = _name.Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(*exc)
        self._name_scope = None
        _naming.scope = self._old_scope


class Block:
    """Base class of layers and models: owns Parameters and child Blocks."""

    def __init__(self, prefix=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __setattr__(self, name, value):
        """Registers child Blocks and Parameters set as attributes."""
        from .parameter import Parameter
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """Scope in which children and symbol nodes take this prefix."""
        return self._scope

    @property
    def params(self):
        """This Block's own ParameterDict (children excluded)."""
        return self._params

    def collect_params(self) -> ParameterDict:
        """Parameters of this Block and all its children."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children.values():
            ret.update(child.collect_params())
        return ret

    def register_child(self, block, name=None):
        self._children[name if name is not None
                       else str(len(self._children))] = block

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """Initialize every Parameter of this Block and its children,
        deferred where the shape comes from the first forward."""
        self.collect_params().initialize(init, ctx, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, **params)`` builds a graph."""

    def __init__(self, prefix=None):
        super().__init__(prefix=prefix)
        self._cached_graph = ()
        self._cached_op = None

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise MXNetError("children of a HybridBlock must be HybridBlocks, "
                             "got %s" % type(block).__name__)
        super().register_child(block, name)
        self._clear_cached_op()

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def _get_graph(self):
        """(input variable, output Symbol) of this block on ``data``."""
        if not self._cached_graph:
            data = _symbol.var("data")
            params = {k: p.var() for k, p in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(_symbol, data, **params)
            if not isinstance(out, Symbol):
                raise MXNetError("hybrid_forward must return one Symbol")
            self._cached_graph = data, out
        return self._cached_graph

    def infer_shape(self, x):
        """Set every Parameter's shape from the input's."""
        self._infer_out_shape(tuple(x.shape))

    def _infer_out_shape(self, in_shape):
        """Fill this block's Parameter shapes from its input shape, by shape
        inference over its graph; returns its output shape.  A block whose
        graph needs a size from its input before it can be built (the
        recurrent layers) resolves it here first, and ``HybridSequential``
        walks its children in order, so that each sees its input shape
        before its graph is built."""
        data, out = self._get_graph()
        arg_shapes, out_shapes, aux_shapes = out.infer_shape(
            **{data.name: in_shape})
        shapes = dict(zip(out.list_arguments(), arg_shapes))
        shapes.update(zip(out.list_auxiliary_states(), aux_shapes))
        for p in self.collect_params().values():
            if p.name in shapes:
                p.shape = shapes[p.name]
        return out_shapes[0]

    def _call_cached_op(self, x):
        from ..cached_op import CachedOp
        params = self.collect_params()
        if any(p._deferred_init for p in params.values()):
            self.infer_shape(x)
            for p in params.values():
                p._finish_deferred_init()
        data, out = self._get_graph()
        if self._cached_op is None:
            self._cached_op = CachedOp(out)
        names = out.list_inputs()
        unknown = [n for n in names if n != data.name and n not in params]
        if unknown:
            raise MXNetError("unknown inputs to HybridBlock: %s" % unknown)
        values = [x if n == data.name else params[n].data() for n in names]
        return self._cached_op(*values)

    def forward(self, x, *args):
        """On an NDArray: run the graph (``CachedOp``); on a Symbol: build
        it."""
        if args:
            raise MXNetError("the port's HybridBlock takes one input")
        if isinstance(x, NDArray):
            return self._call_cached_op(x)
        if not isinstance(x, Symbol):
            raise MXNetError("a HybridBlock takes an NDArray or a Symbol, "
                             "got %s" % type(x).__name__)
        params = {k: p.var() for k, p in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(_symbol, x, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
