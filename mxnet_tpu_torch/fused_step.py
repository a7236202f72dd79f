"""Module's fused training step (counterpart of ``mxnet_tpu/fused_step.py``,
its single-device ``ModuleFusedStep``).

The reference compiles forward, backward and every optimizer update into one
XLA program with donated buffers.  Here the step is eager: the executor's
training plan runs under autograd, ``torch.autograd.grad`` takes the
gradients of every ``"write"`` parameter, and the optimizer's
``fused_update`` updates all of them at once in place with foreach kernels
(one launch chain for the whole model instead of a Python loop of
per-parameter updates).  As in the reference, the gradients are not written
to ``grad_dict``.  ``forward_backward`` only stages the batch; ``update``
runs the step; anything that needs the staged batch's outputs or gradients
before ``update`` replays it on the eager path (``flush_eager``).

A multi-precision slot (a bf16 weight under ``multi_precision``) hands the
update its flat state with the master fp32 leaf first, ``(master,
*inner_leaves)`` (``fused_step.py:315-366``); a slot whose state has
another structure (a ``.states`` file of an fp32 run, say) sends the step
to the eager path, as the reference's does.

``MXNET_TPU_FUSED_STEP`` (default on, read as the reference reads it)
selects this path; with ``0`` the eager path (executor backward, then the
updater one parameter at a time) trains instead, and is the oracle the
tests hold this one to.  A Module on several contexts, or with
``group2ctxs``, trains on the eager path, as the reference's
(``fused_step.py:276``; its mesh arm waits for the port's multi-device
layer).
"""
from __future__ import annotations

import os

import torch

from .ndarray.ndarray import NDArray
from .optimizer import fused_state_leaves

__all__ = ["ENV_FLAG", "enabled", "ModuleFusedStep"]

ENV_FLAG = "MXNET_TPU_FUSED_STEP"


def enabled() -> bool:
    """The ``MXNET_TPU_FUSED_STEP`` gate; default on."""
    return os.environ.get(ENV_FLAG, "1").lower() not in \
        ("0", "false", "off", "")


def _tensors(state):
    """An updater state as the fused update takes it: None, a tensor, or a
    tuple of tensors."""
    if isinstance(state, (tuple, list)):
        return tuple(_tensors(x) for x in state)
    return None if state is None else state._data


class ModuleFusedStep:
    """Drives a Module's fused step on its one executor."""

    def __init__(self, module):
        self._mod = module
        self._eg = module._exec_group
        self._pending = None
        req = self._eg.grad_req
        self._pnames = [n for n in module._param_names
                        if req.get(n) == "write"]
        self._has_add = any(req.get(n) == "add" for n in module._param_names)
        self._structural_ok = None

    def stale(self) -> bool:
        return self._eg is not self._mod._exec_group

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def stage(self, data_batch):
        self._pending = data_batch

    def flush_eager(self):
        """Run a staged batch through the eager forward and backward, so
        that its outputs and gradients become observable."""
        if self._pending is None:
            return
        batch, self._pending = self._pending, None
        self._eg.forward_backward(batch)

    def eligible(self) -> bool:
        if not enabled() or self._mod._updater is None:
            return False
        if self._structural_ok is None:
            ex = self._eg.execs[0]
            opt_ = self._mod._optimizer
            self._structural_ok = bool(
                self._pnames and len(self._eg.execs) == 1
                and not ex._group2ctx
                and not self._eg.inputs_need_grad
                and not self._has_add and all(opt_.supports_fused(ex.arg_dict[n])
                        for n in self._pnames))
        return self._structural_ok

    def _states(self, indices, weights):
        """Each slot's state as the fused update takes it (made now if the
        slot has none), or None when one is not fusable."""
        m = self._mod
        out = []
        for i, w in zip(indices, weights):
            st = m._updater.state(i, w)
            if m._optimizer.fused_mp(w):
                leaves = fused_state_leaves(st, mp=True)
                if leaves is None:
                    return None
                out.append(tuple(leaf._data for leaf in leaves))
            else:
                out.append(_tensors(st))
        return out

    def step(self) -> bool:
        """Consume the staged batch: forward and gradients under autograd,
        then one fused optimizer update over every parameter.  Returns
        False, after replaying the batch on the eager path, when a slot's
        state is not fusable."""
        m = self._mod
        ex = self._eg.execs[0]
        weights = [ex.arg_dict[n] for n in self._pnames]
        ndev = len(m._context)
        indices = [m._optimizer.slot_index(m._param_names.index(n), ndev, 0)
                   for n in self._pnames]
        states = self._states(indices, weights)
        if states is None:
            self.flush_eager()
            return False
        batch, self._pending = self._pending, None
        ex._feed(self._eg.feeds(batch)[0])
        # the eligible structure makes the executor's gradient arguments
        # exactly the "write" parameters
        outs, new_aux, grads = ex._run_with_grads(
            None, ex._generators(ex._plan(True)))
        grads = [torch.zeros_like(w._data) if grads[n] is None else grads[n]
                 for n, w in zip(self._pnames, weights)]
        m._optimizer.fused_update(indices, [w._data for w in weights],
                                  grads, states)
        ex._writeback_aux(new_aux)
        ex.outputs = [NDArray(o) for o in outs]
        return True
