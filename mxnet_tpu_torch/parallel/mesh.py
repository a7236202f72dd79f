"""Device mesh, sharding rules and collectives (counterpart of
``mxnet_tpu/parallel/mesh.py``).

Axis conventions as the reference's: ``dp`` (data/batch), ``tp``
(tensor/model), ``sp`` (sequence/context), ``pp`` (pipeline stage), ``ep``
(expert).

The port is single-controller, as JAX is: one process drives every device
of a mesh.  Where the reference writes a per-shard body under ``shard_map``
and lets XLA place the collectives, the port holds the shards as a Python
list (entry ``i`` on the ``i``-th device along the axis) and runs the
collectives below on that list:

- :func:`shard` splits a tensor into ``n`` pieces, one on each device of the
  axis, and :func:`unshard` concatenates them onto one device;
- :func:`ppermute` moves shard ``src`` to ``dst`` for each pair of a
  permutation, :func:`all_to_all` exchanges chunks with ``tiled=True``
  semantics and :func:`psum` leaves the sum of all shards on every device.

Copies use ``Tensor.to``, which is a no-op when both ends are the same
device, so a mesh whose entries repeat one device (``[cuda:0] * 8``, or
``[cpu] * 4`` in the tests) runs every step of a parallel program on that
device.  All of them are differentiable by plain autograd.  On a mesh with
several axes, a collective over one axis runs in the group of devices at
index 0 of the others (the reference runs the same program in every group
and returns the same values).

:func:`make_mesh` with no ``devices`` takes every CUDA device of the process
and raises when there is none; pass ``devices=[torch.device("cpu")] * n`` to
build a mesh on the host.  Multi-process meshes (``torch.distributed``) are
not here yet.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "PartitionSpec", "P", "NamedSharding", "make_mesh",
           "data_parallel_sharding", "replicated_sharding", "ShardingRules",
           "megatron_rules", "host_shard_hint", "shard", "unshard",
           "replicate", "ppermute", "all_to_all", "psum"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: a name, a tuple of names, or
    None (not split), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


class Mesh:
    """Named axes over an ndarray of ``torch.device``s."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of shape %s needs %d axis names, got %s"
                             % (self.devices.shape, self.devices.ndim,
                                self.axis_names))

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError("mesh has no axis %r (axes %s)"
                             % (axis, self.axis_names))
        d = self.devices
        i = self.axis_names.index(axis)
        return list(np.moveaxis(d, i, 0).reshape(d.shape[i], -1)[:, 0])


def _as_device(d) -> torch.device:
    if isinstance(d, torch.device):
        return d
    if hasattr(d, "torch_device"):          # a Context
        return d.torch_device
    return torch.device(d)


def host_shard_hint(mesh: Optional[Mesh] = None,
                    axis: str = "dp") -> Tuple[int, int]:
    """(rank, nranks) for per-host sharded data loading: (0, 1) here, since
    one process drives the whole mesh and reads the whole batch."""
    return 0, 1


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A Mesh with named axes, e.g. ``make_mesh({'dp': 4, 'tp': 2})``.

    Axis sizes must multiply to the device count; an axis size of -1 takes
    the remainder (like reshape).  ``devices`` (``torch.device``s, strings
    or Contexts; entries may repeat) defaults to every CUDA device of the
    process, in index order."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise MXNetError("make_mesh: this process sees no CUDA device; "
                             "pass devices=[torch.device('cpu')] * n to "
                             "build a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [_as_device(d) for d in devices]
    names = list(axes)
    sizes = list(axes.values())
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError("mesh %s does not fit %d devices" % (axes, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), tuple(names))


class NamedSharding:
    """A PartitionSpec over a mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec


def data_parallel_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Batch-dim sharding for inputs."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class ShardingRules:
    """Name-pattern -> PartitionSpec rules for parameters: the first rule
    whose regex matches the name and whose spec divides the shape wins,
    else ``default``."""

    def __init__(self, mesh: Mesh, rules: Optional[Sequence] = None,
                 default: PartitionSpec = P()):
        self.mesh = mesh
        self.rules = [(re.compile(pat), spec) for pat, spec in (rules or [])]
        self.default = default

    def spec_for(self, name: str, shape: Tuple[int, ...]) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(name) and self._fits(spec, shape):
                return spec
        return self.default

    def sharding_for(self, name: str, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(name, tuple(shape)))

    def _fits(self, spec: PartitionSpec, shape) -> bool:
        if len(spec) > len(shape):
            return False
        for dim, ax in zip(shape, spec):
            if ax is None:
                continue
            size = self.mesh.shape[ax] if isinstance(ax, str) else \
                int(np.prod([self.mesh.shape[a] for a in ax]))
            if dim % size != 0:
                return False
        return True


def megatron_rules(mesh: Mesh, tp_axis: str = "tp") -> ShardingRules:
    """Default TP rules for the model zoo's parameter names."""
    t = tp_axis
    return ShardingRules(mesh, rules=[
        # the row-parallel (input-split) rule first: out_proj/fc2/down names
        # also end in proj_weight/fc2_weight, which the column rule would
        # claim, and the first match wins
        (r"(out_proj|fc2|down)\w*_weight$", P(None, t)),
        (r"(fc|dense|proj|query|key|value)\d*_weight$", P(t, None)),
        (r"conv\w*_weight$", P(t, None, None, None)),
        (r"embedding\w*_weight$", P(None, t)),
    ])


# --------------------------------------------------------------------------
# collectives on lists of per-shard tensors
# --------------------------------------------------------------------------
def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # asynchronous only between CUDA devices: a copy to the host must be
    # complete when the caller reads it
    return t.to(device, non_blocking=t.device.type == "cuda"
                and device.type == "cuda")


def shard(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
          ) -> List[torch.Tensor]:
    """``x`` split along ``dim`` into ``mesh.shape[axis]`` equal contiguous
    pieces, piece ``i`` on the ``i``-th device of the axis."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if x.shape[dim] % n:
        raise ValueError("dimension %d of size %d does not split over %s=%d"
                         % (dim, x.shape[dim], axis, n))
    return [_move(p, d).contiguous()
            for p, d in zip(torch.split(x, x.shape[dim] // n, dim), devs)]


def replicate(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``x`` on every device of the axis (``PartitionSpec()``)."""
    return [_move(x, d) for d in mesh.axis_devices(axis)]


def unshard(shards: Sequence[torch.Tensor], dim: int,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``device`` (the first
    shard's by default)."""
    device = shards[0].device if device is None else device
    return torch.cat([_move(s, device) for s in shards], dim)


def ppermute(shards: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """For each ``(src, dst)`` of ``perm``, shard ``src`` moved to shard
    ``dst``'s device; a shard that receives nothing becomes zeros, as
    ``jax.lax.ppermute``."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError("ppermute: shard %d receives twice in %s"
                             % (dst, list(perm)))
        out[dst] = _move(shards[src], shards[dst].device)
    return [torch.zeros_like(s) if o is None else o
            for s, o in zip(shards, out)]


def all_to_all(shards: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(..., tiled=True)``: shard ``i`` splits along
    ``split_axis`` into ``n`` chunks, chunk ``j`` goes to shard ``j``, which
    concatenates what it receives along ``concat_axis`` in the order of
    ``i``."""
    n = len(shards)
    size = shards[0].shape[split_axis]
    if size % n:
        raise ValueError("all_to_all: dimension %d of size %d does not split "
                         "%d ways" % (split_axis, size, n))
    chunks = [torch.split(s, size // n, split_axis) for s in shards]
    return [torch.cat([_move(chunks[i][j], shards[j].device)
                       for i in range(n)], concat_axis).contiguous()
            for j in range(n)]


def psum(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of all shards, in shard order, on every shard's device
    (computed once for each distinct device)."""
    sums: Dict[torch.device, torch.Tensor] = {}
    for s in shards:
        if s.device not in sums:
            total = _move(shards[0], s.device)
            for t in shards[1:]:
                total = total + _move(t, s.device)
            sums[s.device] = total
    return [sums[s.device] for s in shards]
