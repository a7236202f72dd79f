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

Files are the reference's npz container (``nd.save``), so each package
reads what the other writes: ``save_parameters`` names each value by its
place in the block tree (``features.0.weight``), ``export`` writes the
graph's JSON and its values under ``arg:``/``aux:`` and the full names,
and :class:`SymbolBlock` (``imports``) runs such a graph as a block.
"""
from __future__ import annotations

import itertools
import re
import threading
from collections import OrderedDict

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import name as _name
from .. import ndarray as _ndarray
from .. import symbol as _symbol
from ..ndarray.ndarray import NDArray
from ..symbol import Symbol
from .parameter import DeferredInitializationError, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

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
    def create(prefix, params, hint):
        """(full prefix, ParameterDict) of a new Block; ``params`` (a
        ParameterDict) is shared: its Parameters are handed out in place of
        new ones of the same name."""
        current = _BlockScope._current()
        if current is None:
            if prefix is None:
                prefix = _name.current_scope().get(None, hint) + "_"
            if params is None:
                return prefix, ParameterDict(prefix)
            return prefix, ParameterDict(params.prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

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

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_pre_hooks = OrderedDict()
        self._forward_hooks = OrderedDict()

    def __repr__(self):
        modstr = "\n".join(
            "  (%s): %s" % (key, re.sub("(?m)^", "  ", repr(block)).strip())
            for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

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

    def collect_params(self, select=None) -> ParameterDict:
        """Parameters of this Block and all its children; ``select``, a
        regular expression, keeps those whose names match it."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by their place in the block tree: the attribute
        names from here down, joined by dots (``features.0.weight``)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Write every Parameter's value, named by its place in the block
        tree, to ``filename`` (``block.py:208``)."""
        params = self._collect_params_with_prefix()
        _ndarray.save(filename, {k: v._reduce() for k, v in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Read a file of ``save_parameters`` onto ``ctx`` (default: where
        each Parameter lives or will live, else the current context); a file
        whose names have no dot is one of ``save_params`` or
        ``ParameterDict.save``, and goes to ``collect_params().load`` with
        this block's prefix (``block.py:214-239``)."""
        loaded = _ndarray.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded):
            del loaded
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("parameter %s is missing in file %s"
                                     % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("parameter %s loaded from file %s is "
                                     "not present in this block"
                                     % (name, filename))
                continue
            params[name]._load_init(value, ctx)

    def save_params(self, filename):
        """The older format: full names less this block's prefix
        (``block.py:241``)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """:meth:`load_parameters` (``block.py:245``)."""
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def register_child(self, block, name=None):
        self._children[name if name is not None
                       else str(len(self._children))] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter of this Block and its children,
        deferred where the shape comes from the first forward."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

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

    def summary(self, *inputs):
        """Print each block's output shape and parameter count over one
        forward of ``inputs``, in the reference's table
        (``block.py:300-353``); a hybridized block's children run inside its
        graph and are not listed, as there."""
        summary = OrderedDict()
        hooks = []

        def shape_str(args):
            flat = _flat(args) if isinstance(args, (list, tuple, NDArray)) \
                else [args]
            shapes = [x.shape if isinstance(x, NDArray) else None
                      for x in flat]
            return str(shapes[0] if len(shapes) == 1 else shapes)

        def register(block):
            def hook(block, _, outputs):
                key = "%s-%i" % (block.__class__.__name__, len(summary))
                n = trainable = 0
                for p in block.params.values():
                    size = int(np.prod(p.shape)) if p.shape else 0
                    n += size
                    if p.grad_req != "null":
                        trainable += size
                summary[key] = OrderedDict(output_shape=shape_str(outputs),
                                           trainable=trainable, n_params=n)
            hooks.append(block.register_forward_hook(hook))

        summary["Input"] = OrderedDict(output_shape=shape_str(inputs),
                                       n_params=0, trainable=0, shared=0)
        try:
            self.apply(register)
            self(*inputs)
            line = "{:>20}  {:>42} {:>15}"
            print("-" * 80)
            print(line.format("Layer (type)", "Output Shape", "Param #"))
            print("=" * 80)
            total = 0
            for layer, rec in summary.items():
                print(line.format(layer, str(rec["output_shape"]),
                                  rec["n_params"]))
                total += rec["n_params"]
            print("=" * 80)
            print("Total params: " + str(total))
            print("-" * 80)
        finally:
            for h in hooks:
                h.detach()


def _flat(args):
    if isinstance(args, NDArray):
        return [args]
    return [a for arg in args for a in _flat(arg)]


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

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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

    def infer_type(self, *args):
        """Accepted, as in the reference (``block.py:494``): a Parameter
        keeps the dtype it was made with, and the ops take their inputs'."""

    def export(self, path, epoch=0):
        """Write the graph to ``path-symbol.json`` and its values to
        ``path-%04d.params`` (the npz container: ``.npz`` is appended), each
        named ``arg:<name>`` or ``aux:<name>`` as a Module checkpoint's
        (``block.py:497-517``).  The block must have run hybridized once."""
        if not self._cached_graph:
            raise MXNetError("export needs the graph: call hybridize() and "
                             "run one forward first")
        sym = self._cached_graph[1]
        sym.save("%s-symbol.json" % path)
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in arg_names:
                arg_dict["arg:%s" % name] = param._reduce()
            elif name in aux_names:
                arg_dict["aux:%s" % name] = param._reduce()
        _ndarray.save("%s-%04d.params" % (path, epoch), arg_dict)

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


def _compose(out, given):
    """``out`` with each variable named in ``given`` replaced by that
    single-output Symbol (``Symbol._compose`` of the reference)."""
    from ..symbol.symbol import _Node
    new = {}
    for node in out._topo():
        if node.is_var:
            continue
        entries = []
        for parent, i in node.inputs:
            if parent.is_var and parent.name in given:
                entries.append(given[parent.name]._outputs[0])
            else:
                entries.append((new.get(id(parent), parent), i))
        new[id(node)] = _Node(node.op, node.name, node.attrs, entries)
    return Symbol([given[n.name]._outputs[0]
                   if n.is_var and n.name in given else (new.get(id(n), n), i)
                   for n, i in out._outputs])


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol graph (``block.py:550``): ``inputs`` are
    its data variables; every other argument becomes a Parameter of its own
    name (auxiliary states with ``grad_req`` null), its shape deferred
    until the first forward or a load.  It always runs the graph as a
    CachedOp."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """The block of a graph file (``export``'s, or a Module
        checkpoint's), its values read from ``param_file`` onto ``ctx``
        (default: the current context)."""
        sym = _symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_symbol.var(n) for n in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx,
                                      allow_missing=False, ignore_extra=True,
                                      restore_prefix="")
        elif ctx is not None:
            ret.collect_params().reset_ctx(ctx)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = _symbol.Group(list(outputs))
        names = set()
        for i in inputs:
            node, _ = i._outputs[0]
            if len(i._outputs) != 1 or not node.is_var:
                raise MXNetError("the inputs of a SymbolBlock must be "
                                 "variables, got %r" % i)
            names.add(node.name)
        for n in outputs.list_arguments():
            if n not in names:
                self.params.get(n, allow_deferred_init=True)
        for n in outputs.list_auxiliary_states():
            if n not in names:
                self.params.get(n, grad_req="null", allow_deferred_init=True)
        self._cached_graph = list(inputs), outputs

    def _clear_cached_op(self):
        graph = self._cached_graph
        super()._clear_cached_op()
        self._cached_graph = graph

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            return self._call_cached_op(x, *args)
        if not isinstance(x, Symbol):
            raise MXNetError("a SymbolBlock takes NDArrays or Symbols, got "
                             "%s" % type(x).__name__)
        data, out = self._cached_graph
        if len(args) + 1 != len(data):
            raise MXNetError("the graph takes %d inputs, got %d"
                             % (len(data), len(args) + 1))
        return _compose(out, {d.name: a for d, a in zip(data, (x,) + args)})

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
