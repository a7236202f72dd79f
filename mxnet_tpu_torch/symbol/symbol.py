"""Symbol: declarative graph construction, shape inference, JSON and binding
(counterpart of ``mxnet_tpu/symbol/symbol.py``).

The graph is a small Python DAG over the op registry.  ``tojson`` writes the
reference's ``nodes``/``arg_nodes``/``heads`` format, byte for byte the
layout the reference package writes, and ``load_json`` reads it, so a graph
moves between the two packages as a string.  Shape inference runs each op on
``meta`` tensors.  ``bind`` and ``simple_bind`` hand the graph to an
:class:`~mxnet_tpu_torch.executor.Executor`; ``simple_bind`` first infers
every argument's shape from the inputs' and allocates zeros for arguments,
gradients and auxiliary states on the context.
"""
from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..attribute import current_attrs
from ..base import MXNetError
from ..name import current_scope
from ..ops.registry import Operator, get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "arange"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op: Optional[Operator], name: str,
                 attrs: Dict[str, Any], inputs: List[Tuple["_Node", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs          # raw user attrs (JSON-serializable)
        self.inputs = inputs

    @property
    def is_var(self):
        return self.op is None

    def parsed_attrs(self) -> Dict[str, Any]:
        return self.op.parse_attrs(
            {k: v for k, v in self.attrs.items() if not k.startswith("__")})

    def num_outputs(self):
        return 1 if self.is_var else self.op.num_outputs(self.parsed_attrs())

    def num_visible(self):
        return 1 if self.is_var else \
            self.op.num_visible_outputs(self.parsed_attrs())


class Symbol:
    """A set of output entries of a graph (parity: mxnet.symbol.Symbol)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group [%d]" % len(self._outputs))

    def _topo(self) -> List[_Node]:
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for parent, _ in reversed(node.inputs):
                if id(parent) not in seen:
                    stack.append((parent, False))
        return order

    def _aux_var_ids(self) -> set:
        aux = set()
        for node in self._topo():
            if node.is_var:
                continue
            for i in node.op.aux_inputs:
                if i < len(node.inputs) and node.inputs[i][0].is_var:
                    aux.add(id(node.inputs[i][0]))
        return aux

    def list_arguments(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) in aux]

    def list_inputs(self) -> List[str]:
        """Every variable, arguments and auxiliary states, in graph order."""
        return [n.name for n in self._topo() if n.is_var]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_var:
                names.append(node.name)
            elif node.num_visible() > 1 or node.num_outputs() > 1:
                names.append("%s_output%d" % (node.name, idx))
            else:
                names.append("%s_output" % node.name)
        return names

    def attr(self, key):
        """The attribute ``key`` of a single-output symbol's node, as it
        was given, or None (``symbol.py:160``)."""
        if len(self._outputs) == 1:
            return self._outputs[0][0].attrs.get(key)
        return None

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """{node name: {attr: string}} of every node with attributes
        (``symbol.py:165``)."""
        out = {}
        for node in self._topo():
            if node.attrs:
                out[node.name] = {k: str(v) for k, v in node.attrs.items()}
        return out

    @property
    def outputs(self) -> List[str]:
        """:meth:`list_outputs` (``symbol.py:134``)."""
        return self.list_outputs()

    def get_internals(self) -> "Symbol":
        outs = []
        for node in self._topo():
            for i in range(node.num_visible()):
                outs.append((node, i))
        return Symbol(outs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                internals = self.get_internals()
                inames = internals.list_outputs()
                if index in inames:
                    return internals[inames.index(index)]
                raise MXNetError("output %r not found; have %s"
                                 % (index, names))
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            return _create(op, [other, self] if reverse else [self, other],
                           {})
        if isinstance(other, (int, float, np.integer, np.floating)):
            return _create(scalar_op, [self], {"scalar": float(other)})
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, other):
        return self._binary(other, "elemwise_add" if isinstance(
            other, Symbol) else "broadcast_add", "_plus_scalar")

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
        return _create("negative", [self], {})

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def reshape(self, shape, **kw):
        """``Reshape`` with MXNet's special codes (0 keep, -1 infer, -2 copy
        the rest, -3 merge two, -4 split one)."""
        return _create("Reshape", [self], {"shape": shape, **kw})

    def transpose(self, axes=()):
        """``transpose``: the axes permuted, reversed when ``axes`` is
        empty."""
        return _create("transpose", [self], {"axes": axes})

    def flatten(self):
        """``Flatten``: (batch, the rest)."""
        return _create("Flatten", [self], {})

    def sum(self, axis=None, keepdims=False):
        """``sum`` over ``axis`` (all axes when None)."""
        return _create("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        """``mean`` over ``axis`` (all axes when None)."""
        return _create("mean", [self], {"axis": axis, "keepdims": keepdims})

    def slice_axis(self, axis, begin, end):
        """``slice_axis``: ``[begin, end)`` along ``axis``."""
        return _create("slice_axis", [self],
                       {"axis": axis, "begin": begin, "end": end})

    def astype(self, dtype):
        """``Cast`` to ``dtype``."""
        return _create("Cast", [self], {"dtype": np.dtype(dtype).name})

    # ---- inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input shapes;
        raises when an argument's shape stays unknown.  Forward-fills by
        running each op on meta tensors, with the ops' shape hints filling
        unknown parameter shapes from the data."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, but a shape that stays unknown comes back
        as None instead of raising (``symbol.py:271``)."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        topo = self._topo()
        shapes: Dict[Tuple[int, int], Optional[tuple]] = {}
        for node in topo:
            if not node.is_var:
                continue
            if node.name in known:
                shapes[(id(node), 0)] = known[node.name]
            elif node.attrs.get("__shape__") is not None:
                declared = node.attrs["__shape__"]
                if isinstance(declared, str):
                    declared = ast.literal_eval(declared)
                declared = tuple(declared)
                if all(d > 0 for d in declared):
                    shapes[(id(node), 0)] = declared

        for _pass in range(3):
            changed = False
            for node in topo:
                if node.is_var:
                    continue
                attrs = node.parsed_attrs()
                in_sh = [shapes.get((id(p), i)) for p, i in node.inputs]
                if node.op.shape_hint is not None and any(
                        s is None for s in in_sh):
                    filled = node.op.shape_hint(attrs, in_sh)
                    for (p, pi), s in zip(node.inputs, filled):
                        if s is not None and shapes.get((id(p), pi)) is None:
                            shapes[(id(p), pi)] = tuple(s)
                            changed = True
                    in_sh = [shapes.get((id(p), i)) for p, i in node.inputs]
                if all(s is not None for s in in_sh) and \
                        shapes.get((id(node), 0)) is None:
                    for i, s in enumerate(_abstract_node(node, attrs, in_sh)):
                        shapes[(id(node), i)] = s
                    changed = True
            if not changed:
                break

        aux_names = self.list_auxiliary_states()
        var_shapes = {n.name: shapes.get((id(n), 0)) for n in topo if n.is_var}
        arg_shapes = [var_shapes.get(n) for n in arg_names]
        aux_shapes = [var_shapes.get(n) for n in aux_names]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._outputs]
        if not partial and (any(s is None for s in arg_shapes) or
                            any(s is None for s in out_shapes)):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown args: %s"
                             % missing)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as the reference gives them
        (``mxnet_tpu/symbol/symbol.py:346``): ``np.dtype`` of each given
        argument dtype (a numpy or torch dtype, or a name), ``np.float32``
        for the rest, the auxiliary states and the outputs.  bfloat16,
        which numpy lacks, is ``torch.bfloat16``, as ``NDArray.dtype``
        gives it."""
        arg_names = self.list_arguments()
        known = {n: _np_type(t) for n, t in zip(arg_names, args)
                 if t is not None}
        known.update({k: _np_type(v) for k, v in kwargs.items()
                      if v is not None})
        arg_types = [known.get(n, np.float32) for n in arg_names]
        out_types = [np.float32] * len(self._outputs)
        aux_types = [np.float32] * len(self.list_auxiliary_states())
        return arg_types, out_types, aux_types

    # ---- serialization --------------------------------------------------
    def tojson(self) -> str:
        """Reference-format graph JSON (nodes/arg_nodes/heads)."""
        topo = self._topo()
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            nodes.append({
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(p)], i, 0] for p, i in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(topo) if n.is_var]
        heads = [[nid[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(topo) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10200]}},
                          indent=2)

    def save(self, fname: str):
        """Write :meth:`tojson` to ``fname`` (``symbol.py:384``)."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ---- binding --------------------------------------------------------
    def bind(self, ctx=None, args=None, aux_states=None, args_grad=None,
             grad_req="write", group2ctx=None, shared_exec=None):
        """An Executor over the given arrays (lists follow
        ``list_arguments``/``list_auxiliary_states`` order); gradients go
        to ``args_grad`` for the arguments ``grad_req`` asks them for.
        ``group2ctx`` maps ``ctx_group`` names (``AttrScope``) to the
        contexts their nodes run on."""
        from ..context import current_context
        from ..executor import Executor
        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, ctx, dict(args or {}), dict(aux_states or {}),
                        dict(args_grad or {}), _norm_grad_req(grad_req,
                                                              arg_names),
                        group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        """The outputs (NDArrays) of one inference forward with the
        keyword arrays bound as the arguments (``symbol.py:433``)."""
        return self.bind(ctx, args=kwargs, grad_req="null").forward()

    def simple_eval(self, ctx=None, **kwargs):
        """:meth:`eval` (``symbol.py:438``)."""
        return self.eval(ctx, **kwargs)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **shapes):
        """Infer every shape from the given input shapes, allocate zeros
        for arguments, gradients (where ``grad_req`` is not ``"null"``)
        and auxiliary states on ``ctx``, and bind (``symbol.py:389``).
        Dtypes come from :meth:`infer_type` over ``type_dict``: an
        argument and its gradient take its entry, everything else is
        float32.

        With ``shared_exec``, each argument named in ``shared_arg_names``
        and each auxiliary state that ``shared_exec`` holds at the same
        shape and dtype is bound to its very NDArray (an argument's
        gradient too), so that the two executors read and write one
        tensor; anything else is allocated.  Every array lives on ``ctx``;
        ``group2ctx`` places the nodes (:meth:`bind`)."""
        from ..context import current_context
        from ..executor import Executor
        from ..ndarray import ndarray as nd
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        arg_types, _, aux_types = (
            [nd.torch_dtype(t) for t in ts]
            for ts in self.infer_type(**(type_dict or {})))
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        req = _norm_grad_req(grad_req, arg_names)
        shared = set(shared_arg_names or ()) if shared_exec is not None \
            else set()

        def alloc(name, shape, dtype, pool):
            # the shared executor's array where it fits, else zeros
            have = pool.get(name) if pool is not None else None
            if have is not None and have.shape == tuple(shape) and \
                    have._data.dtype == dtype:
                return have
            return nd.zeros(shape, ctx=ctx, dtype=dtype)

        args, grads = {}, {}
        for n, s, t in zip(arg_names, arg_shapes, arg_types):
            own = n in shared
            args[n] = alloc(n, s, t, shared_exec.arg_dict if own else None)
            if req.get(n, "null") != "null":
                grads[n] = alloc(n, s, t,
                                 shared_exec.grad_dict if own else None)
        auxs = {n: alloc(n, s, t, shared_exec.aux_dict
                         if shared_exec is not None else None)
                for n, s, t in zip(aux_names, aux_shapes, aux_types)}
        return Executor(self, ctx, args, auxs, grads, req,
                        group2ctx=group2ctx)


def _np_type(dtype):
    """A dtype as the reference's ``infer_type`` gives it: ``np.dtype``,
    or ``torch.bfloat16`` for bfloat16, which numpy lacks."""
    if str(dtype) in ("bfloat16", "torch.bfloat16"):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        from ..ndarray.ndarray import _NP_DTYPES
        if dtype not in _NP_DTYPES:
            raise MXNetError("unsupported dtype %r" % (dtype,))
        return _NP_DTYPES[dtype]
    return np.dtype(dtype)


def _norm_grad_req(grad_req, arg_names):
    """{argument: request} from one request, a list, or a partial dict
    (missing names get "null")."""
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    out = {n: "null" for n in arg_names}
    out.update(grad_req or {})
    return out


def _abstract_node(node: _Node, attrs, in_shapes):
    """Output shapes of one node: its op run on meta tensors (an op with no
    inputs is told the device, as the plan tells it)."""
    ins = [torch.empty(s, device="meta") for s in in_shapes]
    if not ins:
        attrs = dict(attrs, __device__=torch.device("meta"))
    if node.op.needs_rng:
        ins.insert(0, None)
    out = node.op.fn(attrs, *ins)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return [tuple(o.shape) for o in out]


# --------------------------------------------------------------------------
# symbol creation
# --------------------------------------------------------------------------
def _create(op_name: str, sym_inputs: Sequence[Optional[Symbol]],
            kwargs: Dict[str, Any], name: Optional[str] = None,
            attr: Optional[Dict[str, str]] = None) -> Symbol:
    op = get_op(op_name)
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    name = name or kwargs.pop("name", None)
    kwargs.pop("name", None)
    # explicit names go through the scope too, so that a Prefix scope (a
    # Gluon block's name_scope) prepends its prefix, as the reference does
    name = current_scope().get(name, op.name.lower())

    entries: List[Tuple[_Node, int]] = []
    for s in sym_inputs:
        if s is None:
            # interior gap from keyword placement: a variable named after
            # the node and the argument
            argname = op.arg_names[len(entries)] if op.arg_names and \
                len(entries) < len(op.arg_names) else "arg%d" % len(entries)
            entries.append((_Node(None, "%s_%s" % (name, argname), {}, []), 0))
            continue
        if len(s._outputs) != 1:
            raise MXNetError("op inputs must be single-output symbols")
        entries.append(s._outputs[0])

    # missing parameter variables are created (sym.Convolution(data=x,
    # name='c1') makes c1_weight / c1_bias), as the reference does
    if op.arg_names:
        needed = len(op.arg_names)
        if op.name in ("Convolution", "Deconvolution", "FullyConnected") \
                and op.parse_attrs(dict(kwargs)).get("no_bias"):
            needed -= 1
        if op.name == "LeakyReLU" and op.parse_attrs(dict(kwargs)).get(
                "act_type") != "prelu":
            needed -= 1     # gamma exists only for the prelu variant
        while len(entries) < needed:
            argname = op.arg_names[len(entries)]
            entries.append((_Node(None, "%s_%s" % (name, argname), {}, []), 0))

    # the scope's attributes (ctx_group, ...), then the explicit attr
    # dict, then the op's own keywords (``symbol.py:514-523``)
    attrs = current_attrs()
    attrs.update(attr or {})
    attrs.update(kwargs)
    node = _Node(op, name, attrs, entries)
    return Symbol([(node, i) for i in range(node.num_visible())])


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    """A free variable (``symbol.py:529``).  ``lr_mult``, ``wd_mult``,
    ``dtype`` and ``init`` are stored under the reference's attribute names
    (``__lr_mult__``, ``__wd_mult__``, ``__dtype__``, ``__init__``: the
    initializer's ``dumps()``, or the string given), which the optimizer
    and ``Module.init_params`` read; ``stype`` is accepted and ignored, as
    there.  The attributes of the current ``AttrScope`` come first."""
    attrs = current_attrs()
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = np.dtype(dtype).name
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs, []), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname: str) -> Symbol:
    """The Symbol in a JSON file that :meth:`Symbol.save` (or the reference
    package's) wrote."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """Load reference-format graph JSON ('attrs', 'attr' or legacy 'param'
    node keys)."""
    g = json.loads(json_str)
    built: List[_Node] = []
    for nj in g["nodes"]:
        attrs = dict(nj.get("attrs") or nj.get("attr")
                     or nj.get("param") or {})
        inputs = [(built[int(e[0])], int(e[1])) for e in nj.get("inputs", [])]
        if nj["op"] == "null":
            built.append(_Node(None, nj["name"], attrs, []))
        else:
            built.append(_Node(get_op(nj["op"]), nj["name"], attrs, inputs))
    heads = g.get("heads") or [[len(built) - 1, 0, 0]]
    return Symbol([(built[int(h[0])], int(h[1])) for h in heads])


def arange(start, stop=None, step=1.0, name=None, dtype="float32") -> Symbol:
    """``_arange`` as a graph node with no inputs (``symbol.py:596``)."""
    return _create("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "dtype": dtype}, name)
