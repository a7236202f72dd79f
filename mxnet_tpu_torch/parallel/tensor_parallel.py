"""Tensor (model) parallelism helpers (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``): Megatron's column- and
row-parallel dense layers over a mesh axis, written with the port's
collectives (``mesh.py``) where the reference writes ``shard_map`` bodies.
Inputs and outputs are whole tensors; the result lands on ``x``'s device.
"""
from __future__ import annotations

import torch

from .mesh import Mesh, psum, replicate, shard, unshard

__all__ = ["column_parallel_dense", "row_parallel_dense", "mlp_block"]


def column_parallel_dense(x, w, mesh: Mesh, axis: str = "tp"):
    """``x @ w`` with ``w`` ``[in, out]`` split on ``out``: each device
    computes its output features from the whole ``x``; no collective."""
    ys = [xs @ ws for xs, ws in zip(replicate(x, mesh, axis),
                                    shard(w, mesh, axis, 1))]
    return unshard(ys, 1, x.device)


def row_parallel_dense(x, w, mesh: Mesh, axis: str = "tp"):
    """``x @ w`` with ``x`` split on its features and ``w`` ``[in, out]`` on
    ``in``: one ``psum`` of the partial products."""
    ys = [xs @ ws for xs, ws in zip(shard(x, mesh, axis, 1),
                                    shard(w, mesh, axis, 0))]
    return psum(ys)[0].to(x.device)


def mlp_block(x, w1, w2, mesh: Mesh, axis: str = "tp", act=torch.relu):
    """``act(x @ w1) @ w2`` as a column-parallel up-projection and a
    row-parallel down-projection: the hidden features never leave their
    device, and the block makes exactly one ``psum``."""
    ys = [act(xs @ w1s) @ w2s for xs, w1s, w2s in zip(
        replicate(x, mesh, axis), shard(w1, mesh, axis, 1),
        shard(w2, mesh, axis, 0))]
    return psum(ys)[0].to(x.device)
