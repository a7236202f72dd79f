"""Symbol: declarative graph construction, shape inference, JSON and binding
(counterpart of ``mxnet_tpu/symbol/symbol.py``).

The graph is a small Python DAG over the op registry.  ``tojson`` writes the
reference's ``nodes``/``arg_nodes``/``heads`` format, byte for byte the
layout the reference package writes, and ``load_json`` reads it, so a graph
moves between the two packages as a string.  Shape inference runs each op on
``meta`` tensors.  ``bind`` hands the graph to a forward-only
:class:`~mxnet_tpu_torch.executor.Executor`.
"""
from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..name import current_scope
from ..ops.registry import Operator, get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load_json"]


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

    def __add__(self, other):
        if isinstance(other, Symbol):
            return _create("elemwise_add", [self, other], {})
        if isinstance(other, (int, float)):
            return _create("_plus_scalar", [self], {"scalar": float(other)})
        raise TypeError("unsupported operand type %s" % type(other))

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return _create("_mul_scalar", [self], {"scalar": float(other)})
        raise TypeError("unsupported operand type %s" % type(other))

    __rmul__ = __mul__

    def reshape(self, shape, **kw):
        """``Reshape`` with MXNet's special codes (0 keep, -1 infer, -2 copy
        the rest, -3 merge two, -4 split one)."""
        return _create("Reshape", [self], {"shape": shape, **kw})

    # ---- inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input shapes;
        raises when an argument's shape stays unknown.  Forward-fills by
        running each op on meta tensors, with the ops' shape hints filling
        unknown parameter shapes from the data."""
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
        if any(s is None for s in arg_shapes) or \
                any(s is None for s in out_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown args: %s"
                             % missing)
        return arg_shapes, out_shapes, aux_shapes

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

    # ---- binding --------------------------------------------------------
    def bind(self, ctx=None, args=None, aux_states=None):
        """Forward-only Executor over the given arrays (lists follow
        ``list_arguments``/``list_auxiliary_states`` order)."""
        from ..context import current_context
        from ..executor import Executor
        ctx = ctx or current_context()
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.list_arguments(), args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, ctx, dict(args or {}), dict(aux_states or {}))


def _abstract_node(node: _Node, attrs, in_shapes):
    """Output shapes of one node: its op run on meta tensors."""
    ins = [torch.empty(s, device="meta") for s in in_shapes]
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
        if op.name in ("Convolution", "FullyConnected") and \
                op.parse_attrs(dict(kwargs)).get("no_bias"):
            needed -= 1
        while len(entries) < needed:
            argname = op.arg_names[len(entries)]
            entries.append((_Node(None, "%s_%s" % (name, argname), {}, []), 0))

    attrs = dict(attr or {})
    attrs.update(kwargs)
    node = _Node(op, name, attrs, entries)
    return Symbol([(node, i) for i in range(node.num_visible())])


def Variable(name: str, attr=None, shape=None, **kwargs) -> Symbol:
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs, []), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


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
