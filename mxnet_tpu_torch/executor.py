"""Executor: a bound symbolic graph, run forward on tensors (counterpart of
``mxnet_tpu/executor.py``, forward-only), and the graph plan that the
training step and ``CachedOp`` share.

The reference package traces its plan into one XLA program; here the plan
is a topological walk that calls each op's function eagerly, so every op
launches its own kernels on the calling thread's current stream.  The
Executor runs it under ``torch.inference_mode()``; the training step runs
the ``train=True`` plan with autograd on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


class _Plan:
    """Precomputed plan of a symbol graph (``mxnet_tpu/executor.py:64-160``):
    the op nodes in topological order with their parsed attrs, and for each
    the entries it reads last, which are dropped after it runs so that
    activations do not outlive their use.

    With ``train=True`` every ``train_aware`` op sees ``__train__`` in its
    attrs, and each op output that an ``aux_writeback`` maps onto a bound
    auxiliary state replaces that state in the ``new_aux`` that
    :meth:`execute` returns (BatchNorm's moving statistics).  Each
    ``needs_rng`` op gets a slot (``n_rng`` in all), as in the reference
    (``executor.py:79-100``): :meth:`execute` hands it the generator of its
    slot, or ``None`` when it is given none."""

    def __init__(self, symbol, train: bool = False):
        self.train = train
        self.topo = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.out_entries = [(id(n), i) for n, i in symbol._outputs]
        aux_ids = {id(n): n.name for n in self.topo
                   if n.is_var and n.name in set(self.aux_names)}
        ops = [node for node in self.topo if not node.is_var]
        last_use: Dict[Tuple[int, int], int] = {}
        for s, node in enumerate(ops):
            for p, i in node.inputs:
                last_use[(id(p), i)] = s
        keep = set(self.out_entries)
        release: List[List[Tuple[int, int]]] = [[] for _ in ops]
        for entry, s in last_use.items():
            if entry not in keep:
                release[s].append(entry)
        self.steps = []
        self.n_rng = 0
        for s, node in enumerate(ops):
            attrs = node.parsed_attrs()
            if node.op.train_aware:
                attrs = dict(attrs, __train__=train)
            writeback = {}
            if train:
                for oi, ii in node.op.aux_writeback.items():
                    if ii < len(node.inputs) and \
                            id(node.inputs[ii][0]) in aux_ids:
                        writeback[oi] = aux_ids[id(node.inputs[ii][0])]
            slot = None
            if node.op.needs_rng:
                slot = self.n_rng
                self.n_rng += 1
            self.steps.append((node, attrs, writeback, release[s], slot))

    def execute(self, values: Dict[str, torch.Tensor],
                generators: Optional[Sequence[torch.Generator]] = None
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """Run the plan on {variable name: tensor}, arguments and auxiliary
        states alike, with one generator per rng slot (or none); returns
        (heads, new auxiliary states)."""
        env: Dict[Tuple[int, int], Any] = {}
        for node in self.topo:
            if node.is_var:
                if node.name not in values:
                    raise MXNetError("unbound variable %r" % node.name)
                env[(id(node), 0)] = values[node.name]
        new_aux = {n: values[n] for n in self.aux_names}
        for node, attrs, writeback, release, slot in self.steps:
            ins = [env[(id(p), i)] for p, i in node.inputs]
            if slot is not None:
                ins.insert(0, generators[slot] if generators else None)
            res = node.op.fn(attrs, *ins)
            outs = res if isinstance(res, tuple) else (res,)
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
            for oi, aux_name in writeback.items():
                new_aux[aux_name] = outs[oi]
            for entry in release:
                del env[entry]
        return [env[e] for e in self.out_entries], new_aux


class Executor:
    """A bound forward-only executor (parity: mxnet.executor.Executor)."""

    def __init__(self, symbol, ctx: Context, args: Dict[str, NDArray],
                 aux_states: Dict[str, NDArray]):
        self.ctx = ctx
        self.arg_dict = args
        self.aux_dict = aux_states
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        missing = [n for n in self.aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        self._plan = _Plan(symbol)
        self.outputs: List[NDArray] = []

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; keyword arguments replace bound inputs first
        (an NDArray is adopted as is when its dtype matches, anything
        else is copied in)."""
        if is_train:
            raise MXNetError("the port's Executor is forward-only "
                             "(is_train=False)")
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            dst = self.arg_dict[k]
            if isinstance(v, NDArray):
                dst._data = v._data.to(dst._data.device, dst._data.dtype)
            else:
                dst[:] = np.asarray(v)
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        with torch.inference_mode():
            outs, _ = self._plan.execute(values)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown parameter %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % k)
