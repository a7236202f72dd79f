"""Executor: a bound symbolic graph run forward, backward, or both in one
step (counterpart of ``mxnet_tpu/executor.py``), and the graph plan that
the training steps and ``CachedOp`` share.

The reference package traces its plan into XLA programs; here the plan is a
topological walk that calls each op's function eagerly, so every op
launches its own kernels on the calling thread's current stream.  A forward
runs under ``torch.inference_mode()`` (or ``no_grad`` when training, which
also writes BatchNorm's moving statistics back); ``backward`` and
``forward_backward`` run the ``train=True`` plan with autograd on and take
the gradients of every argument whose ``grad_req`` is not ``"null"`` with
``torch.autograd.grad``.  ``backward`` runs the forward again (as the
reference recomputes it inside its fused program), with the generators of
the last forward, so a step with dropout sees the same masks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import random as _random
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
        device = next(iter(values.values())).device if values else None
        for node, attrs, writeback, release, slot in self.steps:
            ins = [env[(id(p), i)] for p, i in node.inputs]
            if not ins:
                attrs = dict(attrs, __device__=device)
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
    """A bound executor (parity: ``mxnet.executor.Executor``).

    ``arg_dict``/``grad_dict``/``aux_dict`` map names to NDArrays on the
    executor's context; ``grad_req`` maps each argument to ``"write"``,
    ``"add"`` or ``"null"`` (the arguments with a gradient array and a
    request other than ``"null"`` get gradients)."""

    def __init__(self, symbol, ctx: Context, args: Dict[str, NDArray],
                 aux_states: Dict[str, NDArray],
                 args_grad: Optional[Dict[str, NDArray]] = None,
                 grad_req: Optional[Dict[str, str]] = None):
        self.ctx = ctx
        self._symbol = symbol
        self.arg_dict = args
        self.aux_dict = aux_states
        self.grad_dict = dict(args_grad or {})
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        missing = [n for n in self.aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        self._grad_req = {n: "null" for n in self.arg_names}
        self._grad_req.update(grad_req or {})
        self._grad_args = [n for n in self.arg_names
                           if self._grad_req[n] != "null"
                           and n in self.grad_dict]
        self._plans: Dict[bool, _Plan] = {}
        self._last_seeds: Optional[List[int]] = None
        self.outputs: List[NDArray] = []

    def _plan(self, train: bool) -> _Plan:
        plan = self._plans.get(train)
        if plan is None:
            plan = self._plans[train] = _Plan(self._symbol, train)
        return plan

    def _feed(self, kwargs):
        """Bind new input values: an NDArray's tensor is adopted as is when
        its device and dtype match (else converted), anything else is
        copied in."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            dst = self.arg_dict[k]
            if isinstance(v, NDArray):
                dst._data = v._data.to(dst._data.device, dst._data.dtype)
            else:
                dst[:] = np.asarray(v)

    def _generators(self, plan, reuse=False):
        """One generator per rng slot on the executor's device, from fresh
        seeds (:func:`mxnet_tpu_torch.random.next_seed`), or from the last
        forward's seeds with ``reuse``."""
        if not plan.n_rng:
            return None
        if not reuse or self._last_seeds is None:
            self._last_seeds = [_random.next_seed() for _ in range(plan.n_rng)]
        dev = self.ctx.torch_device
        return [torch.Generator(device=dev).manual_seed(s)
                for s in self._last_seeds]

    def _values(self):
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        return values

    def _writeback_aux(self, new_aux):
        for n in self.aux_names:
            self.aux_dict[n]._data = new_aux[n].detach()

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; keyword arguments replace bound inputs first (an
        NDArray is adopted as is when its device and dtype match, anything
        else is copied in).  ``is_train`` runs the training plan (batch
        statistics, dropout) without gradients and writes the new moving
        statistics back."""
        self._feed(kwargs)
        plan = self._plan(bool(is_train))
        if is_train:
            gens = self._generators(plan)
            with torch.no_grad():
                outs, new_aux = plan.execute(self._values(), gens)
            self._writeback_aux(new_aux)
        else:
            with torch.inference_mode():
                outs, _ = plan.execute(self._values())
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def _head_grads(self, outs, out_grads):
        """Head gradients: ones for every head when none are given (a
        ``make_loss`` head seeds ones, ``executor.py:725-735``)."""
        if out_grads is None:
            return [torch.ones_like(o) for o in outs]
        if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
            out_grads = [out_grads]
        gs = []
        for g, o in zip(out_grads, outs):
            if isinstance(g, NDArray):
                g = g._data
            elif not isinstance(g, torch.Tensor):
                g = torch.from_numpy(np.asarray(g))
            gs.append(g.to(o.device, o.dtype))
        return gs

    def _run_with_grads(self, out_grads, gens):
        """The training plan under autograd: (outputs, new aux states,
        {argument: gradient})."""
        plan = self._plan(True)
        values = {n: t.detach() for n, t in self._values().items()}
        leaves = [values[n].requires_grad_() for n in self._grad_args]
        with torch.enable_grad():
            outs, new_aux = plan.execute(values, gens)
            heads = [(o, g) for o, g in zip(outs, self._head_grads(
                outs, out_grads)) if o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in heads], leaves, [g for _, g in heads],
                allow_unused=True) if heads and leaves else [None] * len(leaves)
        return ([o.detach() for o in outs], new_aux,
                dict(zip(self._grad_args, grads)))

    def _apply_grads(self, grads):
        for n, g in grads.items():
            dst = self.grad_dict[n]
            g = torch.zeros_like(dst._data) if g is None \
                else g.to(dst._data.dtype)
            if self._grad_req[n] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g

    def backward(self, out_grads=None):
        """Gradients of the heads (ones unless ``out_grads``) with respect
        to every argument with a gradient request, written into
        ``grad_dict`` (added for ``"add"``).  The forward is run again with
        the last forward's generators."""
        gens = self._generators(self._plan(True), reuse=True)
        _, _, grads = self._run_with_grads(out_grads, gens)
        self._apply_grads(grads)

    def forward_backward(self, out_grads=None, **kwargs) -> List[NDArray]:
        """One training step's forward and backward in one pass
        (``executor.py:763``): outputs, new moving statistics and
        gradients."""
        self._feed(kwargs)
        gens = self._generators(self._plan(True))
        outs, new_aux, grads = self._run_with_grads(out_grads, gens)
        self._writeback_aux(new_aux)
        self._apply_grads(grads)
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
