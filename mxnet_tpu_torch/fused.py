"""FusedTrainer: the training step over a hybridizable Gluon block
(counterpart of ``mxnet_tpu/fused.py:46-257``).

    net = vision.resnet50_v1(); net.initialize(ctx=ctx); net.hybridize()
    net(x).wait_to_read()                 # shapes known, parameters made
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    for x, y in batches:
        loss = ft.step(x, y)
    ft.sync_params()                      # trained values back into the Block

The reference compiles forward, loss, backward and the SGD update into one
XLA program with donated buffers.  Here one step is eager: the ``train=True``
graph plan runs with autograd on (each op launching its own kernels, the
3x3 convolutions forward and backward on the hand-written ones), the loss
is the mean of :func:`~mxnet_tpu_torch.ops.nn.streaming_ce`, autograd takes
the gradients, and the update runs in place under ``no_grad`` on the
trainer's private copies of the parameters; then BatchNorm's new moving
statistics replace the old.  No CUDA graph yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["FusedTrainer"]


def _softmax_ce(logits, labels):
    from .ops.nn import streaming_ce
    return torch.mean(streaming_ce(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1)))


class FusedTrainer:
    """SGD training step (learning rate, momentum, weight decay) over a
    Gluon block whose parameters are already made."""

    def __init__(self, net, loss: str = "softmax_cross_entropy",
                 optimizer: str = "sgd",
                 optimizer_params: Optional[dict] = None,
                 dtype: str = "float32"):
        from . import symbol as sym_mod
        from .executor import _Plan

        if dtype != "float32":
            raise MXNetError("the port's FusedTrainer trains in float32 only "
                             "(got %r); bf16 comes in a later slice" % (dtype,))
        p = dict(optimizer_params or {})
        self._lr = float(p.pop("learning_rate", 0.01))
        self._momentum = float(p.pop("momentum", 0.0))
        self._wd = float(p.pop("wd", 0.0))
        if optimizer != "sgd" or p:
            raise MXNetError(
                "FusedTrainer supports optimizer='sgd' with learning_rate/"
                "momentum/wd (got %r with extras %s)" % (optimizer, sorted(p)))
        if loss != "softmax_cross_entropy":
            raise MXNetError("the port's FusedTrainer has one loss, "
                             "'softmax_cross_entropy' (got %r)" % (loss,))

        self._plan = _Plan(net(sym_mod.var("data")), train=True)
        self._params = net.collect_params()
        self._arg_names = [n for n in self._plan.arg_names if n != "data"]
        try:
            # private copies, so that a step never writes the Block's arrays
            self._args = {n: self._params[n].data()._data.detach().clone()
                          .requires_grad_() for n in self._arg_names}
            self._auxs = {n: self._params[n].data()._data.detach().clone()
                          for n in self._plan.aux_names}
        except MXNetError as e:
            raise MXNetError("FusedTrainer needs made parameters: run one "
                             "forward batch first (%s)" % e) from e
        self._moms = {n: torch.zeros_like(v) for n, v in self._args.items()} \
            if self._momentum != 0.0 else {}
        # gluon.Trainer's convention: weight decay on weights and gammas only
        self._decayed = [n for n in self._arg_names
                         if n.endswith(("_weight", "_gamma"))]

    def _as_tensor(self, v, like):
        if isinstance(v, NDArray):
            v = v._data
        elif not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v))
        return v.to(like.device)

    def step(self, data, labels) -> NDArray:
        """One training step on a batch; returns the loss (before the
        update) as a 0-d NDArray on the parameters' device."""
        first = next(iter(self._args.values()))
        d = self._as_tensor(data, first).to(first.dtype)
        lab = self._as_tensor(labels, first)
        names = self._arg_names
        with torch.enable_grad():
            outs, new_aux = self._plan.execute(
                {**self._args, **self._auxs, "data": d})
            loss = _softmax_ce(outs[0], lab)
            grads = torch.autograd.grad(loss, [self._args[n] for n in names])
        with torch.no_grad():
            params = [self._args[n] for n in names]
            grads = list(grads)
            if self._wd:
                for i, n in enumerate(names):
                    if n in self._decayed:
                        grads[i] = grads[i] + self._wd * params[i]
            if self._momentum != 0.0:
                moms = [self._moms[n] for n in names]
                torch._foreach_mul_(moms, self._momentum)
                torch._foreach_add_(moms, grads, alpha=-self._lr)
                torch._foreach_add_(params, moms)
            else:
                torch._foreach_add_(params, grads, alpha=-self._lr)
            for n in self._plan.aux_names:
                self._auxs[n] = new_aux[n].detach()
        return NDArray(loss.detach())

    def sync_params(self):
        """Write the trained values back into the Block's Parameters (as
        copies, so that later steps do not write through them)."""
        for n in self._arg_names:
            self._params[n].data()._data = self._args[n].detach().clone()
        for n in self._plan.aux_names:
            self._params[n].data()._data = self._auxs[n].clone()
