"""CachedOp: a Symbol graph called on NDArrays (counterpart of
``mxnet_tpu/cached_op.py``).

The reference compiles the graph with ``jax.jit``; here it is an eager walk
of the executor's plan, each op launching its own kernels.  Outside
``autograd.record`` and training mode the inference plan runs under
``torch.no_grad()`` (each ResNet v1 identity bottleneck as one step, the
served path).  Under ``record`` the plan of ``autograd.is_training()``'s
mode runs with grad mode on, so the outputs carry the graph ``backward``
differentiates: on the card each 3x3 convolution and LSTM recurrence goes
through its kernel's ``torch.autograd.Function``, as in the fused step.  In
training mode BatchNorm's new moving statistics are written back into the
arrays bound to them (``cached_op.py:111-153``), and each op that draws
random numbers gets a fresh generator seeded from
:func:`mxnet_tpu_torch.random.next_seed`, as ``FusedTrainer`` gives its
own.
"""
from __future__ import annotations

import torch

from . import autograd
from . import random as _random
from .base import MXNetError
from .executor import _Plan
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp"]


class CachedOp:
    """A callable over a Symbol graph, inputs in ``list_inputs()`` order."""

    def __init__(self, sym):
        self._sym = sym
        self.input_names = sym.list_inputs()
        self._plan = _Plan(sym, train=False)
        self._plans = {}

    def _recording_plan(self, train: bool) -> _Plan:
        plan = self._plans.get(train)
        if plan is None:
            plan = self._plans[train] = _Plan(self._sym, train=train,
                                              fuse=False)
        return plan

    def __call__(self, *args):
        if len(args) != len(self.input_names):
            raise MXNetError("CachedOp expects %d inputs (%s), got %d" % (
                len(self.input_names), self.input_names, len(args)))
        recording, training = autograd.is_recording(), autograd.is_training()
        if not (recording or training):
            values = {n: a._data for n, a in zip(self.input_names, args)}
            with torch.no_grad():
                outs, _ = self._plan.execute(values)
            return self._wrap(outs, args)
        if recording:
            autograd.lift(args)
        plan = self._recording_plan(training)
        given = dict(zip(self.input_names, args))
        values = {n: a._data for n, a in given.items()}
        gens = None
        if plan.n_rng:
            dev = next(iter(values.values())).device
            gens = [torch.Generator(device=dev).manual_seed(
                _random.next_seed()) for _ in range(plan.n_rng)]
        with torch.set_grad_enabled(recording):
            outs, new_aux = plan.execute(values, gens)
        if training:
            for n in plan.aux_names:
                if new_aux[n] is not values[n]:
                    given[n]._assign(new_aux[n].detach())
        return self._wrap(outs, args)

    @staticmethod
    def _wrap(outs, args):
        ctx = args[0]._ctx if args else None
        outs = [NDArray(o, ctx) for o in outs]
        return outs[0] if len(outs) == 1 else outs
