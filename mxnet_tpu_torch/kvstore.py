"""Key-value store for one process (counterpart of ``mxnet_tpu/kvstore.py``,
its ``local`` and ``device`` arms): ``init`` a key with a value, ``push``
a list of per-context values (their sum, on the first one's device,
replaces the stored value), ``pull`` the stored value into arrays on any
context.  ``Module`` pushes each parameter's gradients
from every context and pulls the sum back before its updater runs, as the
reference's local store reduces across devices.  The distributed stores
(``dist_*``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")


def _local_sum(value) -> NDArray:
    """The sum of a value list on its first entry's device."""
    vlist = value if isinstance(value, (list, tuple)) else [value]
    acc = vlist[0]._data
    dev = acc.device
    for v in vlist[1:]:
        acc = acc + v._data.to(dev)
    return NDArray(acc if len(vlist) > 1 else acc.clone())


class KVStore:
    """A single-process store (``kvstore.py:144``)."""

    def __init__(self, kind="local"):
        self.kind = kind
        self._store: Dict[str, NDArray] = {}

    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return [str(k) for k in key], list(value)
        return [str(key)], [value]

    def init(self, key, value):
        for k, v in zip(*self._normalize(key, value)):
            if k in self._store:
                raise MXNetError("key %r already initialized" % k)
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = v0.copy()

    def push(self, key, value, priority=0):
        """Replace each key's stored value with the sum of its list."""
        with torch.no_grad():
            for k, v in zip(*self._normalize(key, value)):
                if k not in self._store:
                    raise MXNetError("key %r not initialized" % k)
                self._store[k] = _local_sum(v)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into ``out`` (one array or a list,
        on any contexts)."""
        for k, o in zip(*self._normalize(key, out)):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % k)
            src = self._store[k]
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                src.copyto(dst)

    @property
    def type(self):
        return self.kind


def create(name="local") -> KVStore:
    """A store by name (``kvstore.py:800``): the local and device kinds;
    ``dist_*`` raises until the port's multi-process layer lands."""
    name = name.lower()
    if name in _LOCAL:
        return KVStore(name)
    if name.startswith("dist"):
        raise MXNetError("kvstore %r is not ported yet: the port's stores "
                         "are single-process (local, device)" % name)
    raise MXNetError("unknown kvstore type %r" % name)
