"""The ResNet v1 identity bottleneck at inference as one hand-written Hopper
kernel (counterpart of the TPU kernel ``_kernel`` of
``tools/probe_fused_block.py``, its ``pallas_call`` at :74).

:func:`fused_bottleneck` computes, on NHWC activations, the probe's
function with BatchNorm folded into the weights
(:func:`mxnet_tpu_torch.weights.fold_bottleneck`)::

    h1  = relu(x @ w1.T + b[0, :Cm])                   rounded to x's dtype
    h2  = relu(sum_taps pad(h1)[tap] @ w2[tap].T + b[1, :Cm])   rounded
    out = relu(h2 @ w3.T + b[2] + x)                    rounded

with x (N, H, W, Cin), the weights as (out, in), like the convolutions'
own: w1 (Cm, Cin), w2 (9, Cm, Cm) (tap ``3 * dy + dx``), w3 (Cin, Cm) (the
probe's arrays are their transposes: ``weights.from_probe_block``), and b
(3, Cin) fp32; every product and sum in fp32, the 3x3's zero padding
applied to h1 after its bias and ReLU.  For a tensor on the
card it launches ``csrc/fused_bottleneck.cu`` (bf16 only; ``launches``
counts its launches) and raises if it cannot; for a tensor on the CPU (or
``meta``) it runs :func:`fused_bottleneck_plain`, fp32 matmuls with the
same roundings.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["fused_bottleneck", "fused_bottleneck_plain", "launches"]

#: kernel launches so far (CUDA arm of :func:`fused_bottleneck` only)
launches = 0
_count_lock = threading.Lock()
_fn = None
#: channel counts the kernel takes are multiples of this (its warp tile)
CHANNEL_MULTIPLE = 32


def fused_bottleneck_plain(x, w1, w2, w3, b):
    """Reference block: x (N, H, W, Cin) NHWC -> (N, H, W, Cin) in x.dtype,
    fp32 matmuls on the given values, h1 and h2 rounded to x's dtype after
    their ReLUs, the residual added in fp32 (what the probe's ``_kernel``
    and ``xla_block`` compute)."""
    N, H, W, C = x.shape
    Cm = w1.shape[0]
    f32 = torch.float32
    x32 = x.reshape(-1, C).to(f32)
    b = b.to(f32)
    h1 = torch.relu(x32 @ w1.to(f32).t() + b[0, :Cm]).to(x.dtype)
    h1p = F.pad(h1.reshape(N, H, W, Cm), (0, 0, 1, 1, 1, 1)).to(f32)
    w2 = w2.to(f32)
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = h1p[:, dy:dy + H, dx:dx + W, :].reshape(-1, Cm)
            p = tap @ w2[3 * dy + dx].t()
            acc = p if acc is None else acc + p
    h2 = torch.relu(acc + b[1, :Cm]).to(x.dtype)
    h3 = h2.to(f32) @ w3.to(f32).t() + b[2] + x32
    return torch.relu(h3).to(x.dtype).reshape(N, H, W, C)


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("fused_bottleneck").mxtt_fused_bottleneck
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _fused_bottleneck_cuda(x, w1, w2, w3, b):
    global launches
    bf16 = torch.bfloat16
    if x.dtype != bf16 or w1.dtype != bf16 or w2.dtype != bf16 \
            or w3.dtype != bf16 or b.dtype != torch.float32:
        raise MXNetError("fused_bottleneck: the CUDA kernel takes bf16 x and "
                         "weights and an fp32 b, got %s, %s, %s, %s, %s"
                         % (x.dtype, w1.dtype, w2.dtype, w3.dtype, b.dtype))
    if x.dim() != 4:
        raise MXNetError("fused_bottleneck: x must be NHWC, got %s"
                         % (tuple(x.shape),))
    N, H, W, C = x.shape
    Cm = w1.shape[0]
    if tuple(w1.shape) != (Cm, C) or tuple(w2.shape) != (9, Cm, Cm) \
            or tuple(w3.shape) != (C, Cm) or tuple(b.shape) != (3, C):
        raise MXNetError("fused_bottleneck: x %s, w1 %s, w2 %s, w3 %s and b "
                         "%s do not form an identity bottleneck" % tuple(
                             tuple(t.shape) for t in (x, w1, w2, w3, b)))
    for name, n in (("Cin", C), ("Cm", Cm)):
        if n % CHANNEL_MULTIPLE:
            raise MXNetError("fused_bottleneck: %s = %d; the CUDA kernel "
                             "takes multiples of %d"
                             % (name, n, CHANNEL_MULTIPLE))
    ts = (x, w1, w2, w3, b)
    if any(t.device != x.device for t in ts):
        raise MXNetError("fused_bottleneck: every operand must be on x's "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("fused_bottleneck: operands must be contiguous")
    if any(t.data_ptr() % 32 for t in ts):
        raise MXNetError("fused_bottleneck: operands must start on a 32-byte "
                         "boundary (the kernel's wmma loads)")
    out = torch.empty_like(x)
    info = (ctypes.c_int * 2)()
    err = _kernel()(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                    b.data_ptr(), out.data_ptr(), N, H, W, C, Cm,
                    x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream, info)
    if err != 0:
        raise MXNetError("fused_bottleneck launch failed: CUDA error %d" % err)
    with _count_lock:
        launches += 1
    return out


def fused_bottleneck(x, w1, w2, w3, b):
    """Identity bottleneck, x (N, H, W, Cin) NHWC -> (N, H, W, Cin): the
    CUDA kernel (bf16; Cin and Cm multiples of 32) for a tensor on the card,
    the plain version for one on the CPU or ``meta``."""
    if x.device.type == "cuda":
        return _fused_bottleneck_cuda(x, w1, w2, w3, b)
    if x.device.type in ("cpu", "meta"):
        return fused_bottleneck_plain(x, w1, w2, w3, b)
    raise MXNetError("fused_bottleneck: no arm for device %s" % x.device)
