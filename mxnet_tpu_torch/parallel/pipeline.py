"""Pipeline parallelism: GPipe microbatching over mesh stages (counterpart
of ``mxnet_tpu/parallel/pipeline.py``).

Stage ``s`` of ``S`` lives on the ``s``-th device of the ``pp`` axis.  The
schedule is the reference's: ``m + S - 1`` ticks; at each, stage 0 takes
the next microbatch, every other stage the activation its left neighbour
made at the last tick, the last stage banks the microbatch it finished,
and the activations shift one stage right (``ppermute``).  The reference is
one SPMD program, so every stage computes at every tick and the fill and
drain ticks compute on values nobody reads; one controller skips them:
stage ``s`` runs at tick ``t`` only when ``0 <= t - s < m``.  The banked
outputs are the same.  For the same reason the microbatches go to stage 0's
device only, and the last stage's bank is returned as it is, where the
reference zeroes every other stage's bank and ``psum``s all of them: the
sum it gets is that one bank.

Usage::

    mesh = make_mesh({"pp": 4}, devices=[torch.device("cuda", 0)] * 4)
    y = pipeline_apply(mesh, "pp", stage_fn, stage_params, x, n_micro=8)

``stage_fn(params, x) -> x`` is one stage's computation; all stages share
one activation shape.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .mesh import Mesh, ppermute

__all__ = ["Pipeline", "pipeline_apply"]


class Pipeline:
    """The GPipe loop over ``num_stages`` stages of one pipeline."""

    def __init__(self, stage_fn: Callable, num_stages: int,
                 num_microbatches: int, axis: str = "pp"):
        if num_microbatches < 1:
            raise ValueError("need at least one microbatch")
        self.stage_fn = stage_fn
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.axis = axis

    def __call__(self, stage_params: Sequence, micro_in: torch.Tensor,
                 devices: Sequence[torch.device]):
        """``stage_params[s]``: stage ``s``'s params, on ``devices[s]``;
        ``micro_in``: the ``(m, mb, ...)`` microbatches, on ``devices[0]``.
        Returns the last stage's ``(m, mb, ...)`` bank of outputs, on
        ``devices[-1]``."""
        s, m = self.num_stages, self.num_microbatches
        if len(stage_params) != s or len(devices) != s:
            raise ValueError("Pipeline of %d stages got %d params and %d "
                             "devices" % (s, len(stage_params), len(devices)))
        mb_shape = micro_in.shape[1:]
        acts = [None] * s            # what enters each stage this tick
        bank = [None] * m
        for t in range(m + s - 1):
            ys = []
            for st in range(s):
                if 0 <= t - st < m:
                    x = micro_in[t] if st == 0 else acts[st]
                    ys.append(self.stage_fn(stage_params[st], x))
                else:                # a bubble: nothing to compute
                    ys.append(torch.zeros(mb_shape, dtype=micro_in.dtype,
                                          device=devices[st]))
            if t >= s - 1:
                bank[t - (s - 1)] = ys[-1]
            acts = ppermute(ys, [(i, (i + 1) % s) for i in range(s)])
        return torch.stack(bank)


def pipeline_apply(mesh: Mesh, axis: str, stage_fn: Callable, stage_params,
                   x, n_micro: int):
    """GPipe forward end to end: ``x`` split into ``n_micro`` microbatches,
    run through ``mesh[axis]`` stages, the last stage's outputs returned on
    x's device.
    ``stage_params``: a dict of ``(S, ...)`` tensors, stage ``s`` taking
    slice ``s`` of each on its own device."""
    devs = mesh.axis_devices(axis)
    s = len(devs)
    n = x.shape[0]
    if n % n_micro:
        raise ValueError("batch %d not divisible by %d microbatches"
                         % (n, n_micro))
    for name, p in stage_params.items():
        if p.shape[0] != s:
            raise ValueError("stage parameter %s has %d stages, the mesh %s=%d"
                             % (name, p.shape[0], axis, s))
    micro = x.reshape((n_micro, n // n_micro) + tuple(x.shape[1:]))
    params = [{k: p[i].to(d) for k, p in stage_params.items()}
              for i, d in enumerate(devs)]
    out = Pipeline(stage_fn, s, n_micro, axis)(
        params, micro.to(devs[0]), devs).to(x.device)
    return out.reshape((n,) + tuple(out.shape[2:]))
