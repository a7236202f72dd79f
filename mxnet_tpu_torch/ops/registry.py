"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

Each op is one plain function ``fn(attrs, *tensors) -> tensor | tuple`` on
``torch.Tensor``s.  ``attrs`` is a dict parsed by a typed parameter spec
(:class:`param`) that coerces strings exactly as the reference package does,
so the attribute strings of a Symbol JSON file (``"(3, 3)"``, ``"True"``,
``"relu"``) mean the same thing in both packages.  Shape inference runs the
same function on ``meta`` tensors, so there is no separate shape code to
keep in step.
"""
from __future__ import annotations

import ast
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["Operator", "register", "get_op", "param", "OPS"]

OPS: Dict[str, "Operator"] = {}


class param:
    """One typed op parameter: ``param(type, default)``.

    type is one of: int, float, bool, str, 'shape' (tuple of ints),
    'dtype' (numpy dtype name) or a list of allowed strings (an enum).
    Values arriving as strings (what Symbol JSON stores) are coerced.
    """

    def __init__(self, ptype, default=None, required=False):
        self.ptype = ptype
        self.default = default
        self.required = required

    def coerce(self, v):
        t = self.ptype
        if v is None:
            return None
        if t == "shape":
            if isinstance(v, str):
                v = ast.literal_eval(v)
            if isinstance(v, (int, np.integer)):
                return (int(v),)
            return tuple(int(x) for x in v)
        if t == "dtype":
            if v in (None, "None"):
                return None
            return np.dtype(v).name
        if t is bool:
            if isinstance(v, str):
                return v.lower() in ("1", "true", "yes", "on")
            return bool(v)
        if t is int:
            return int(v)
        if t is float:
            return float(v)
        if t is str:
            return str(v)
        if isinstance(t, (list, tuple)):  # enum
            v = str(v)
            if v not in t:
                raise MXNetError("invalid enum value %r (expected one of %s)"
                                 % (v, t))
            return v
        return v


class Operator:
    """A registered operator.

    ``arg_names`` name the inputs (``data``, ``weight``, ...) so that
    symbol construction creates ``<node>_<arg>`` variables for missing
    ones; ``aux_inputs`` are the input indices that are auxiliary states
    (BatchNorm's moving statistics); ``shape_hint(attrs, in_shapes)``
    fills unknown parameter shapes from the data shape; ``nout``/``visible``
    count outputs as the reference does (BatchNorm has three, one visible).
    A ``train_aware`` op reads ``attrs["__train__"]``, which the training
    plan sets; ``aux_writeback`` maps an output index to the input index of
    the auxiliary state it replaces after a training step (BatchNorm's new
    moving statistics, ``{1: 3, 2: 4}``).  A ``needs_rng`` op takes a
    ``torch.Generator`` on its data's device as its first argument, before
    its inputs (``None`` where no randomness is drawn: inference and shape
    inference), as the reference's takes a key.
    """

    def __init__(self, name: str, fn: Callable, *,
                 params: Optional[Dict[str, param]] = None,
                 nout: Any = 1, visible: Any = None,
                 arg_names: Optional[Sequence[str]] = None,
                 aux_inputs: Sequence[int] = (),
                 shape_hint: Optional[Callable] = None,
                 aliases: Sequence[str] = (), train_aware: bool = False,
                 aux_writeback: Optional[Dict[int, int]] = None,
                 needs_rng: bool = False):
        self.name = name
        self.fn = fn
        self.params = params or {}
        self.nout = nout
        self.visible = visible
        self.arg_names = list(arg_names) if arg_names else None
        self.aux_inputs: Tuple[int, ...] = tuple(aux_inputs)
        self.shape_hint = shape_hint
        self.aliases = tuple(aliases)
        self.train_aware = train_aware
        self.aux_writeback = dict(aux_writeback or {})
        self.needs_rng = needs_rng
        self.doc = fn.__doc__ or ""

    def parse_attrs(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, spec in self.params.items():
            if k in kwargs:
                out[k] = spec.coerce(kwargs.pop(k))
            elif spec.required:
                raise MXNetError("op %s: required param %r missing"
                                 % (self.name, k))
            else:
                out[k] = spec.default
        # unknown attrs pass through (the reference tolerates extras such
        # as __layout__ on symbols)
        for k, v in kwargs.items():
            if k.startswith("__") or k in ("name", "ctx", "out"):
                continue
            out[k] = tuple(v) if isinstance(v, list) else v
        return out

    def num_outputs(self, attrs) -> int:
        return self.nout(attrs) if callable(self.nout) else self.nout

    def num_visible_outputs(self, attrs) -> int:
        if self.visible is None:
            return self.num_outputs(attrs)
        return self.visible(attrs) if callable(self.visible) else self.visible

    def __repr__(self):
        return "<Operator %s>" % self.name


def register(name: str, *, params=None, nout=1, visible=None, arg_names=None,
             aux_inputs=(), shape_hint=None, aliases=(), train_aware=False,
             aux_writeback=None, needs_rng=False):
    """Decorator: register a function on tensors as an operator."""

    def deco(fn):
        op = Operator(name, fn, params=params, nout=nout, visible=visible,
                      arg_names=arg_names, aux_inputs=aux_inputs,
                      shape_hint=shape_hint, aliases=aliases,
                      train_aware=train_aware, aux_writeback=aux_writeback,
                      needs_rng=needs_rng)
        OPS[name] = op
        for a in aliases:
            OPS[a] = op
        return fn

    return deco


def get_op(name: str) -> Operator:
    op = OPS.get(name)
    if op is None:
        raise MXNetError("Operator %r is not registered (have %d ops)"
                         % (name, len(OPS)))
    return op

