"""Branch selection by platform (counterpart of
``mxnet_tpu/parallel/_compat.py``), and kernel 10, its probe.

:func:`platform_dependent` calls the branch named for the platform of its
arguments' device: ``gpu`` for CUDA tensors, ``cpu`` for tensors on the host
or ``meta`` tensors, ``default`` where that branch is not given.  The
reference's ``tpu=`` branch has no meaning here; callers pass ``gpu=``.

Kernel 10 (``csrc/zero_fill.cu``) replaces the reference's probe
``_platform_dependent_prunes`` (``_compat.py:36-60``), which compiles a
Pallas zero-fill of an (8, 128) fp32 block once a process to learn whether
a kernel branch can be carried.  Here the first call that picks the ``gpu``
branch on a device launches :func:`zero_fill` over an (8, 128) buffer
filled with NaN there and checks that it holds zeros, once a process and
device.  A build or launch that fails raises; it never turns into the
``default`` branch, which would hide the card.  :func:`zero_fill` takes its
plain version, ``fill_(0)``, for a tensor on the CPU or ``meta``;
``zero_fill_launches`` counts the kernel's launches.

The reference's ``shard_map`` shim has no counterpart: the port's parallel
modules run per-shard code on lists of shards (``mesh.py``).  Nor has
``pvary``, which only types a value as device-varying for ``shard_map``'s
checker.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..base import MXNetError
from ..ops.hopper_conv import _stream

__all__ = ["platform_dependent", "zero_fill", "zero_fill_plain",
           "zero_fill_launches"]

#: kernel 10 launches so far (CUDA arm of :func:`zero_fill` only)
zero_fill_launches = 0
_lock = threading.Lock()
_probe_lock = threading.Lock()
_probed = set()
_fn = None


def zero_fill_plain(out: torch.Tensor) -> torch.Tensor:
    """Kernel 10's plain version: ``out`` filled with 0.0 in place."""
    return out.fill_(0.0)


def _zero_fill_cuda(out: torch.Tensor) -> torch.Tensor:
    global _fn, zero_fill_launches
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise MXNetError("zero_fill: the CUDA kernel takes a contiguous "
                         "float32 tensor, got %s" % out.dtype)
    if _fn is None:
        from .. import _build
        fn = _build.load("zero_fill").mxtt_zero_fill
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _fn = fn
    launched = ctypes.c_int(0)
    err = _fn(out.data_ptr(), out.numel(), out.device.index,
              _stream(out.device), ctypes.byref(launched))
    with _lock:
        zero_fill_launches += launched.value
    if err != 0:
        raise MXNetError("zero_fill launch failed: CUDA error %d" % err)
    return out


def zero_fill(out: torch.Tensor) -> torch.Tensor:
    """``out`` filled with zeros in place (kernel 10 for a tensor on the
    card, the plain version on the CPU or ``meta``)."""
    if out.device.type in ("cpu", "meta"):
        return zero_fill_plain(out)
    if out.device.type == "cuda":
        return _zero_fill_cuda(out)
    raise MXNetError("zero_fill: no arm for device %s" % out.device)


def _probe(device: torch.device) -> None:
    """Kernel 10 over an (8, 128) NaN buffer on ``device``, once a process
    and device; raises unless it left zeros."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index in _probed:
        return
    with _probe_lock:
        if index in _probed:
            return
        buf = torch.full((8, 128), math.nan, dtype=torch.float32,
                         device=torch.device("cuda", index))
        zero_fill(buf)
        if not bool((buf == 0).all()):
            raise MXNetError("platform_dependent: the zero-fill probe "
                             "(kernel 10) left non-zero values on cuda:%d"
                             % index)
        _probed.add(index)


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            d = _device_of(a)
            if d is not None:
                return d
    return None


def platform_dependent(*args, default=None, **platform_branches):
    """``platform_branches[p](*args)`` for the platform ``p`` of the first
    tensor among ``args`` (lists and tuples searched in order): ``gpu`` for
    CUDA, ``cpu`` for the host and ``meta``, the device type otherwise;
    with no tensor, ``gpu`` when the process sees a CUDA device.  Falls
    back to ``default``; raises when neither is given.  The first call that
    takes the ``gpu`` branch on a device runs kernel 10 there first."""
    dev = _device_of(args)
    if dev is None:
        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    platform = {"cuda": "gpu", "meta": "cpu"}.get(dev.type, dev.type)
    fn = platform_branches.get(platform, default)
    if fn is None:
        raise ValueError("platform_dependent: no branch for backend %r and "
                         "no default" % platform)
    if platform == "gpu" and "gpu" in platform_branches:
        _probe(dev)
    return fn(*args)
