"""CachedOp: a Symbol graph called on NDArrays (counterpart of
``mxnet_tpu/cached_op.py``).

The reference compiles the graph with ``jax.jit``; here it is an eager walk
of the executor's inference plan, each op launching its own kernels, under
``torch.no_grad()``.  The training step does not go through it: the fused
trainer runs the ``train=True`` plan itself.
"""
from __future__ import annotations

import torch

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

    def __call__(self, *args):
        if len(args) != len(self.input_names):
            raise MXNetError("CachedOp expects %d inputs (%s), got %d" % (
                len(self.input_names), self.input_names, len(args)))
        values = {n: a._data for n, a in zip(self.input_names, args)}
        with torch.no_grad():
            outs, _ = self._plan.execute(values)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs
