"""Implicit-GEMM 3x3 convolution on a hand-written Hopper kernel
(counterpart of ``mxnet_tpu/ops/pallas_conv.py``).

``conv3x3_same`` (3x3 / stride 1 / pad 1) and ``conv3x3_s2`` (3x3 /
stride 2 / pad 1) take NCHW data and OIHW weights, as in the reference
package.  Both reduce to one stride-1 convolution with ``KH x KW`` taps over
NHWC activations, :func:`taps_conv`, the function the TPU kernel
``_taps_kernel`` computes:

- stride 1: the OIHW weight becomes 9 taps of (C, O)
  (``pallas_conv.py:299``) and the pads are ((1, 1), (1, 1));
- stride 2: the exact space-to-depth(2) rewrite (``pallas_conv.py:327-355``)
  turns the input into (N, H/2, W/2, 4C) in parity-major (p, q, c) channel
  order and the weight into 2x2 taps on 4C channels, with pads
  ((1, 0), (1, 0)).

:func:`taps_conv` launches the CUDA kernel in
``mxnet_tpu_torch/csrc/implicit_gemm_conv.cu`` for a tensor on the card,
and raises if it cannot; for a tensor on the CPU (or a ``meta`` tensor,
during shape inference) it runs :func:`taps_conv_plain`, a per-tap loop of
(rows, C) @ (C, O) products with fp32 accumulation.  There is no fallback
from one to the other.  ``launches`` counts kernel launches.

The layout work around the kernel (NHWC views, the tap and space-to-depth
rewrites) is plain PyTorch shared by both arms, so the CPU tests reach it.
The NHWC view of a channels-last tensor is free, and the kernel's output is
returned as an NCHW view of NHWC memory, so consecutive kernels hand each
other channels-last tensors without a copy.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["conv3x3_same", "conv3x3_same_plain", "conv3x3_s2",
           "conv3x3_s2_plain", "taps_conv", "taps_conv_plain", "launches"]

#: kernel launches so far (CUDA arm of :func:`taps_conv` only)
launches = 0
_count_lock = threading.Lock()

_Pads = Tuple[Tuple[int, int], Tuple[int, int]]
S1_PADS: _Pads = ((1, 1), (1, 1))
S2_PADS: _Pads = ((1, 0), (1, 0))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _out_hw(H, W, KH, KW, pads: _Pads):
    (pt, pb), (pl, pr) = pads
    return H + pt + pb - KH + 1, W + pl + pr - KW + 1


def taps_conv_plain(x, taps, pads: _Pads, KH: int, KW: int):
    """Reference stride-1 conv: x (N, H, W, C), taps (KH*KW, C, O) ->
    (N, Ho, Wo, O) in x.dtype; one fp32 (rows, C) @ (C, O) product per
    tap, summed in fp32 (what ``_taps_kernel`` computes)."""
    N, H, W, C = x.shape
    O = taps.shape[-1]
    (pt, pb), (pl, pr) = pads
    Ho, Wo = _out_hw(H, W, KH, KW, pads)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).float()
    t32 = taps.float()
    acc = None
    for dh in range(KH):
        for dw in range(KW):
            xs = xp[:, dh:dh + Ho, dw:dw + Wo, :].reshape(N * Ho * Wo, C)
            p = xs @ t32[dh * KW + dw]
            acc = p if acc is None else acc + p
    return acc.reshape(N, Ho, Wo, O).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("implicit_gemm_conv").mxtt_taps_conv
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _taps_conv_cuda(x, taps, pads: _Pads, KH: int, KW: int):
    global launches
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("taps_conv: dtype %s is not supported on CUDA "
                         "(float32, bfloat16)" % x.dtype)
    if taps.dtype != x.dtype or taps.device != x.device:
        raise MXNetError("taps_conv: taps must match x in dtype and device")
    if x.dim() != 4 or taps.dim() != 3 or taps.shape[0] != KH * KW \
            or taps.shape[1] != x.shape[3]:
        raise MXNetError("taps_conv: x %s and taps %s do not form a %dx%d "
                         "conv" % (tuple(x.shape), tuple(taps.shape), KH, KW))
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise MXNetError("taps_conv: x and taps must be contiguous")
    N, H, W, C = x.shape
    O = taps.shape[2]
    Ho, Wo = _out_hw(H, W, KH, KW, pads)
    if Ho < 1 or Wo < 1:
        raise MXNetError("taps_conv: empty output for input %s"
                         % (tuple(x.shape),))
    y = torch.empty((N, Ho, Wo, O), dtype=x.dtype, device=x.device)
    fn = _kernel()
    err = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
             N, H, W, C, O, KH, KW, pads[0][0], pads[1][0], Ho, Wo,
             x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise MXNetError("implicit_gemm_conv launch failed: CUDA error %d"
                         % err)
    with _count_lock:
        launches += 1
    return y


def taps_conv(x, taps, pads: _Pads, KH: int, KW: int):
    """Stride-1 conv, x (N, H, W, C) NHWC, taps (KH*KW, C, O) ->
    (N, Ho, Wo, O) in x.dtype: the CUDA kernel for a tensor on the card,
    the plain version for one on the CPU or ``meta``."""
    if x.device.type == "cuda":
        return _taps_conv_cuda(x, taps, pads, KH, KW)
    if x.device.type in ("cpu", "meta"):
        return taps_conv_plain(x, taps, pads, KH, KW)
    raise MXNetError("taps_conv: no arm for device %s" % x.device)


def _nhwc(x):
    """NHWC contiguous tensor; free for a channels-last NCHW tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y):
    return y.permute(0, 3, 1, 2)


def _same(data, weight, conv):
    O, C = weight.shape[:2]
    taps = weight.permute(2, 3, 1, 0).reshape(9, C, O)
    taps = taps.to(data.dtype).contiguous()
    return _nchw(conv(_nhwc(data), taps, S1_PADS, 3, 3))


def s2d_nhwc(x):
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel index p*2C + q*C + c for
    the input pixel (2i + p, 2j + q): the parity-major layout of
    ``pallas_conv._s2d_data``, computed in NHWC."""
    N, H, W, C = x.shape
    xs = x.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(N, H // 2, W // 2, 4 * C)


def s2d_taps(weight):
    """(O, C, 3, 3) stride-2 pad-1 weight -> (4, 4C, O) taps of the
    stride-1 2x2 conv on the s2d input with pads ((1, 0), (1, 0))
    (``pallas_conv._s2d_weight`` followed by the taps transform)."""
    O, C = weight.shape[:2]
    wp = F.pad(weight, (1, 0, 1, 0))                   # (O, C, 4, 4)
    w4 = wp.reshape(O, C, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
    w4 = w4.reshape(O, 4 * C, 2, 2)
    return w4.permute(2, 3, 1, 0).reshape(4, 4 * C, O)


def _s2(data, weight, conv):
    N, C, H, W = data.shape
    if H % 2 or W % 2:
        raise MXNetError("conv3x3_s2 needs even H and W, got %dx%d" % (H, W))
    taps = s2d_taps(weight).to(data.dtype).contiguous()
    x = s2d_nhwc(data.permute(0, 2, 3, 1)).contiguous()
    return _nchw(conv(x, taps, S2_PADS, 2, 2))


def conv3x3_same(data, weight):
    """3x3 / stride-1 / pad-1 / ungrouped conv, NCHW data, OIHW weight."""
    return _same(data, weight, taps_conv)


def conv3x3_same_plain(data, weight):
    """:func:`conv3x3_same` through the plain version on any device."""
    return _same(data, weight, taps_conv_plain)


def conv3x3_s2(data, weight):
    """3x3 / stride-2 / pad-1 / ungrouped conv on even H, W through the
    exact space-to-depth rewrite, NCHW data, OIHW weight."""
    return _s2(data, weight, taps_conv)


def conv3x3_s2_plain(data, weight):
    """:func:`conv3x3_s2` through the plain version on any device."""
    return _s2(data, weight, taps_conv_plain)
