"""FusedTrainer: the training step over a hybridizable Gluon block
(counterpart of ``mxnet_tpu/fused.py:46-257``).

    net = vision.resnet50_v1(); net.initialize(ctx=ctx); net.hybridize()
    net(x).wait_to_read()                 # shapes known, parameters made
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    for x, y in batches:
        loss = ft.step(x, y)
    ft.sync_params()                      # trained values back into the Block

The loss is ``"softmax_cross_entropy"`` (the mean of
:func:`~mxnet_tpu_torch.ops.nn.streaming_ce` over the examples), a Gluon
``Loss`` block (the mean of its per-example output), or a callable
``(logits, labels) -> scalar`` on tensors.

The reference compiles forward, loss, backward and the SGD update into one
XLA program with donated buffers.  Here one step is eager: the ``train=True``
graph plan runs with autograd on (each op launching its own kernels: the
3x3 convolutions and the LSTM recurrence forward and backward on the
hand-written ones), autograd takes the gradients of the loss, and the
update runs in place under ``no_grad`` on the trainer's private copies of
the parameters; then BatchNorm's new moving statistics replace the old.
Each op that draws random numbers (the RNN op's dropout) gets a fresh
generator every step, seeded from :func:`mxnet_tpu_torch.random.next_seed`,
as the reference draws fresh keys (``fused.py:196-202``).  No CUDA graph
yet.

``dtype="bfloat16"`` is the reference's mixed precision (``fused.py:58-63,
133-170``): the private parameters and momenta stay fp32 masters; inside the
differentiated step every argument (gammas and betas too) and the data are
cast to bf16, so the gradients arrive in fp32 through the casts; BatchNorm's
moving statistics keep their fp32 dtype, and the loss is the fp32 mean of
the streaming cross-entropy.  ``dtype="float16"`` raises: the port's
kernels have no fp16 arm yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["FusedTrainer"]


def _softmax_ce(logits, labels):
    from .ops.nn import streaming_ce
    return torch.mean(streaming_ce(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1)))


def _block_loss(block):
    """The mean of a Gluon loss block's per-example output, its graph run
    by a training plan (``fused.py:81-91``)."""
    from .executor import _Plan
    plan = _Plan(block.graph()[2], train=True)

    def loss(logits, labels):
        outs, _ = plan.execute({"pred": logits, "label": labels})
        return torch.mean(outs[0].float())
    return loss


class FusedTrainer:
    """SGD training step (learning rate, momentum, weight decay) over a
    Gluon block whose parameters are already made."""

    def __init__(self, net, loss="softmax_cross_entropy",
                 optimizer: str = "sgd",
                 optimizer_params: Optional[dict] = None,
                 dtype: str = "float32"):
        from . import symbol as sym_mod
        from .executor import _Plan

        if dtype == "float16":
            raise MXNetError("FusedTrainer(dtype='float16') is not ported: "
                             "fp16 comes with a later bf16/fp16 slice (the "
                             "port's kernels have no fp16 arm); use "
                             "'bfloat16' or 'float32'")
        if dtype not in ("float32", "bfloat16"):
            raise MXNetError("FusedTrainer dtype must be float32 or bfloat16, "
                             "got %r" % (dtype,))
        # the compute dtype of the differentiated step (None: fp32 as is)
        self._compute_dtype = torch.bfloat16 if dtype == "bfloat16" else None
        p = dict(optimizer_params or {})
        self._lr = float(p.pop("learning_rate", 0.01))
        self._momentum = float(p.pop("momentum", 0.0))
        self._wd = float(p.pop("wd", 0.0))
        if optimizer != "sgd" or p:
            raise MXNetError(
                "FusedTrainer supports optimizer='sgd' with learning_rate/"
                "momentum/wd (got %r with extras %s)" % (optimizer, sorted(p)))
        from .gluon.loss import Loss
        if isinstance(loss, Loss):
            self._loss = _block_loss(loss)
        elif loss == "softmax_cross_entropy":
            self._loss = _softmax_ce
        elif callable(loss) and not isinstance(loss, str):
            self._loss = loss
        else:
            raise MXNetError("unknown loss %r: pass 'softmax_cross_entropy', "
                             "a gluon.loss.Loss block or a callable(logits, "
                             "labels) -> scalar" % (loss,))

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
        cdt = self._compute_dtype
        d = self._as_tensor(data, first).to(cdt or first.dtype)
        lab = self._as_tensor(labels, first)
        names = self._arg_names
        gens = [torch.Generator(device=first.device).manual_seed(
            _random.next_seed()) for _ in range(self._plan.n_rng)]
        with torch.enable_grad():
            args = self._args if cdt is None else \
                {k: v.to(cdt) for k, v in self._args.items()}
            outs, new_aux = self._plan.execute(
                {**args, **self._auxs, "data": d}, gens)
            loss = self._loss(outs[0], lab)
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
                self._auxs[n] = new_aux[n].detach().to(self._auxs[n].dtype)
        return NDArray(loss.detach())

    def sync_params(self):
        """Write the trained values back into the Block's Parameters (as
        copies, so that later steps do not write through them)."""
        for n in self._arg_names:
            self._params[n].data()._data = self._args[n].detach().clone()
        for n in self._plan.aux_names:
            self._params[n].data()._data = self._auxs[n].clone()
