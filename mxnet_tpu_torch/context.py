"""Device context over ``torch.device`` (counterpart of
``mxnet_tpu/context.py``).

``gpu(i)`` is CUDA device *i* and ``cpu()`` the host.  The default context
is ``gpu(0)``: code that names no context runs on the card, and raises where
there is none.  It never carries on on the CPU by itself; a caller who wants
the CPU passes ``ctx=cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    """Device type and id; usable as a scope (``with mx.cpu():``),
    comparable and hashable."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devstr2type:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``; raises for a GPU context the process
        cannot address."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.device_id >= n:
            raise MXNetError(
                "%s: this process sees %d CUDA device(s); pass ctx=cpu() to "
                "run on the host" % (self, n))
        return torch.device("cuda", self.device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count()


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else gpu(0)


def context_of(device: torch.device) -> Context:
    """The Context of a tensor's device."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu()
