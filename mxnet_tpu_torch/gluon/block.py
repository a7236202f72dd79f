"""Gluon ``Block`` and ``HybridBlock`` (counterpart of
``mxnet_tpu/gluon/block.py``).

A HybridBlock describes its computation once, in ``hybrid_forward(F, x,
...)``; called on a Symbol it builds the graph.  Called on NDArrays it
runs ``hybrid_forward(nd, x, ..., **params)`` op by op on the input's
context (recorded under ``autograd.record``), or, once ``hybridize()`` was
called, the whole graph through
:class:`~mxnet_tpu_torch.cached_op.CachedOp`.  Either way a parameter
whose shape is still unknown is given it by shape inference over the
block's graph from the inputs' shapes.  Names follow the
reference exactly (``_BlockScope``'s per-scope counters and the ``Prefix``
name scope), so a parameter of a port block has the name of the same
parameter of a reference block, and weights move across by name.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict

from ..base import MXNetError
from .. import name as _name
from .. import ndarray as _ndarray
from .. import symbol as _symbol
from ..ndarray.ndarray import NDArray
from ..symbol import Symbol
from .parameter import DeferredInitializationError, ParameterDict

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
        self._forward_pre_hooks = OrderedDict()
        self._forward_hooks = OrderedDict()

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

    def cast(self, dtype):
        """Cast the parameters of this Block and its children to ``dtype``
        (``block.py:281``)."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, inputs)`` before each forward; returns a
        handle whose ``detach()`` removes it."""
        return _HookHandle(self._forward_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """Call ``hook(block, inputs, outputs)`` after each forward."""
        return _HookHandle(self._forward_hooks, hook)

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def __call__(self, *args):
        for hook in list(self._forward_pre_hooks.values()):
            hook(self, args)
        out = self.forward(*args)
        for hook in list(self._forward_hooks.values()):
            hook(self, args, out)
        return out

    def forward(self, *args):
        """The computation, in user code over ``nd`` (a plain Block)."""
        raise NotImplementedError


class _HookHandle:
    _ids = itertools.count()

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self.id = next(_HookHandle._ids)
        hooks[self.id] = hook

    def detach(self):
        self._hooks.pop(self.id, None)


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, *args, **params)`` runs on
    ``nd`` or builds a graph on ``sym``."""

    def __init__(self, prefix=None):
        super().__init__(prefix=prefix)
        self._cached_graph = ()
        self._cached_op = None
        self._active = False

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
        """Run NDArray calls through the block's graph (``CachedOp``)
        instead of op by op."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _get_graph(self, n_inputs=1):
        """(input variables, output Symbol) of this block: one input is
        named ``data``, several ``data0``, ``data1``, ..."""
        if not self._cached_graph:
            names = ["data"] if n_inputs == 1 else \
                ["data%d" % i for i in range(n_inputs)]
            data = [_symbol.var(n) for n in names]
            params = {k: p.var() for k, p in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(_symbol, *data, **params)
            if isinstance(out, (list, tuple)):
                out = _symbol.Group(list(out))
            if not isinstance(out, Symbol):
                raise MXNetError("hybrid_forward must return Symbols")
            self._cached_graph = data, out
        return self._cached_graph

    def infer_shape(self, *args):
        """Set every Parameter's shape from the inputs'."""
        if len(args) == 1:
            self._infer_out_shape(tuple(args[0].shape))
            return
        data, out = self._get_graph(len(args))
        self._set_shapes(out, {d.name: tuple(a.shape)
                               for d, a in zip(data, args)})

    def _set_shapes(self, out, given):
        arg_shapes, out_shapes, aux_shapes = out.infer_shape(**given)
        shapes = dict(zip(out.list_arguments(), arg_shapes))
        shapes.update(zip(out.list_auxiliary_states(), aux_shapes))
        for p in self.collect_params().values():
            if p.name in shapes:
                p.shape = shapes[p.name]
        return out_shapes[0]

    def _infer_out_shape(self, in_shape):
        """Fill this block's Parameter shapes from its input shape, by shape
        inference over its graph; returns its output shape.  A block whose
        graph needs a size from its input before it can be built (the
        recurrent layers) resolves it here first, and ``HybridSequential``
        walks its children in order, so that each sees its input shape
        before its graph is built."""
        data, out = self._get_graph(1)
        return self._set_shapes(out, {data[0].name: in_shape})

    def _finish_deferred(self, args, params):
        if any(p._deferred_init for p in params):
            self.infer_shape(*args)
            for p in params:
                p._finish_deferred_init()

    def _call_cached_op(self, *args):
        from ..cached_op import CachedOp
        params = self.collect_params()
        self._finish_deferred(args, params.values())
        data, out = self._get_graph(len(args))
        if self._cached_op is None:
            self._cached_op = CachedOp(out)
        given = {d.name: a for d, a in zip(data, args)}
        names = out.list_inputs()
        unknown = [n for n in names if n not in given and n not in params]
        if unknown:
            raise MXNetError("unknown inputs to HybridBlock: %s" % unknown)
        return self._cached_op(*[given[n] if n in given else
                                 params[n].data(args[0].context)
                                 for n in names])

    def forward(self, x, *args):
        """On NDArrays: ``hybrid_forward(nd, ...)`` on the input's context,
        or the graph (``CachedOp``) once hybridized; on Symbols: build the
        graph."""
        if isinstance(x, NDArray):
            if self._active:
                return self._call_cached_op(x, *args)
            try:
                params = {k: p.data(x.context)
                          for k, p in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred((x,) + args, self.params.values())
                params = {k: p.data(x.context)
                          for k, p in self._reg_params.items()}
            return self.hybrid_forward(_ndarray, x, *args, **params)
        if not isinstance(x, Symbol):
            raise MXNetError("a HybridBlock takes NDArrays or Symbols, got "
                             "%s" % type(x).__name__)
        params = {k: p.var() for k, p in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(_symbol, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
