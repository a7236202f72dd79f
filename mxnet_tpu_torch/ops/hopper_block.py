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
counts its launches) as :func:`fused_bottleneck_plan` lays it out, and
raises if it cannot; for a tensor on the CPU (or ``meta``) it runs
:func:`fused_bottleneck_plain`, fp32 matmuls with the same roundings.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["fused_bottleneck", "fused_bottleneck_plain",
           "fused_bottleneck_plan", "launches"]

#: kernel launches so far (CUDA arm of :func:`fused_bottleneck` only)
launches = 0
_count_lock = threading.Lock()
_fn = None
#: channel counts the kernel takes are multiples of this (its k-slice)
CHANNEL_MULTIPLE = 32
#: dynamic shared memory a block may opt into on an H100 (sm_90); the card's
#: own attribute bounds the kernel's entry, and chip_smoke.py checks it is this
SMEM_LIMIT = 232448
#: warps along a chunk's rows the kernel has (a chunk is 64 * wm rows by
#: 512 / wm columns, each warp a 64 x 64 tile), and the depths of its ring
_LAYOUTS = (1, 2, 4, 8)
_STAGES = (2, 3, 4)
#: reduction channels of a ring slice (BK in fused_bottleneck.cu); a Cin or
#: Cm off it leaves the last slice of a reduction part zero
_BK = 64


class FusedBottleneckPlan(NamedTuple):
    """Launch of ``fused_bottleneck.cu``: ``wm`` warps along a chunk's rows
    (chunks of 64 * wm rows by 512 / wm columns); bands of ``rows`` output
    rows, ``bands`` to an image (the last may be shorter); the ring's depth
    in slices; its dynamic shared memory; the persistent grid, each CTA
    taking units (image, band) ``k, k + grid, ...``; the cost model's
    slices of the busiest CTA."""
    wm: int
    rows: int
    bands: int
    stages: int
    smem: int
    grid: int
    slices: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _h2_in_h1(wm: int, R: int, W: int, Cm: int) -> bool:
    """``h2_in_h1`` of fused_bottleneck.cu: whether a band's h2 is one chunk
    (its rows and Cm fit one) that the band's h1 buffer can hold, so that
    h2 is written over h1 once the 3x3 has read it."""
    bm = 64 * wm
    return R * W <= bm and Cm <= 512 // wm and (R + 2) * (W + 2) >= bm


def _smem_bytes(wm: int, R: int, W: int, Cm: int, stages: int) -> int:
    """``smem_bytes`` of fused_bottleneck.cu: h1 of a band with its halo
    ((R + 2) x (W + 2) rows), the h2 tile of a chunk's rows unless h2 shares
    h1's buffer, and the ring's slices, rows of 2 * Cm + 16 bytes."""
    bm, bn = 64 * wm, 512 // wm
    h2 = 0 if _h2_in_h1(wm, R, W, Cm) else bm
    return ((R + 2) * (W + 2) + h2) * (2 * Cm + 16) \
        + stages * 2 * _BK * (bm + bn)


def _unit_slices(H, W, Cin, Cm, wm, R, band):
    """The k-slices of one unit (a band of up to ``R`` output rows): stage
    1 over the band's rows and its halo rows inside the image, stages 2 and
    3 over the band's rows, each in chunks of 64 * wm rows by 512 / wm
    columns."""
    bm, bn = 64 * wm, 512 // wm
    r0 = band * R
    rows = min(R, H - r0)
    m1 = (min(r0 + rows, H - 1) - max(r0 - 1, 0) + 1) * W
    m2 = rows * W
    n1, n3 = _cdiv(Cm, bn), _cdiv(Cin, bn)
    k1, km = _cdiv(Cin, _BK), _cdiv(Cm, _BK)
    return _cdiv(m1, bm) * n1 * k1 + _cdiv(m2, bm) * (n1 * 9 * km + n3 * km)


def _plan_for(N, H, W, Cin, Cm, sms, wm, R, stages):
    """The launch at ``wm`` warps along the rows, bands of ``R`` rows and a
    ring of ``stages`` slices, whether or not it fits (the tests and
    chip_smoke.py force each arm with it)."""
    bands = _cdiv(H, R)
    units = N * bands
    grid = min(units, sms)
    per_band = [_unit_slices(H, W, Cin, Cm, wm, R, b) for b in range(bands)]
    busiest = max(sum(per_band[u % bands] for u in range(k, units, grid))
                  for k in range(grid))
    return FusedBottleneckPlan(wm, R, bands, stages,
                               _smem_bytes(wm, R, W, Cm, stages), grid,
                               busiest)


@functools.lru_cache(maxsize=64)
def fused_bottleneck_plan(N: int, H: int, W: int, Cin: int, Cm: int,
                          sms: int) -> FusedBottleneckPlan:
    """Kernel 13's launch for N images of H x W, Cin and Cm channels, on
    ``sms`` SMs of ``SMEM_LIMIT`` bytes of shared memory a block.  For each
    layout of the warps and each band height (evened out over the image:
    ``ceil(H / ceil(H / R))``), the deepest ring (up to 4 slices) whose
    buffers fit; of those it takes the launch whose busiest CTA walks the
    fewest k-slices (every slice is the same MMA work, 64 * wm x 512 / wm x
    64), then the deeper ring, then the fewer units.  Raises where nothing
    fits."""
    best = None
    for wm in _LAYOUTS:
        for R in sorted({_cdiv(H, _cdiv(H, r)) for r in range(1, H + 1)}):
            fits = [st for st in _STAGES
                    if _smem_bytes(wm, R, W, Cm, st) <= SMEM_LIMIT]
            if not fits:
                continue
            plan = _plan_for(N, H, W, Cin, Cm, sms, wm, R, max(fits))
            key = (plan.slices, -plan.stages, N * plan.bands)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise MXNetError("fused_bottleneck: no band of a %dx%d map at Cm %d "
                         "fits %d bytes of shared memory"
                         % (H, W, Cm, SMEM_LIMIT))
    return best[1]


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _fused_bottleneck_cuda(x, w1, w2, w3, b,
                           plan: Optional[FusedBottleneckPlan] = None):
    """The CUDA arm of :func:`fused_bottleneck`; ``plan`` (a
    :func:`fused_bottleneck_plan`'s, or one made by ``_plan_for``) in place
    of the shape's, to check each layout on the card."""
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
    if any(t.data_ptr() % 16 for t in ts):
        raise MXNetError("fused_bottleneck: operands must start on a 16-byte "
                         "boundary (the kernel's 16-byte copies)")
    from .hopper_conv import _sm_count, _stream
    dev = x.device
    if plan is None:
        plan = fused_bottleneck_plan(N, H, W, C, Cm, _sm_count(dev))
    out = torch.empty_like(x)
    info = (ctypes.c_int * 1)()
    err = _kernel()(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                    b.data_ptr(), out.data_ptr(), N, H, W, C, Cm, plan.wm,
                    plan.rows, plan.stages, plan.grid, dev.index,
                    _stream(dev), info)
    if err != 0:
        raise MXNetError("fused_bottleneck launch failed: CUDA error %d" % err)
    with _count_lock:
        launches += 1
    if info[0] != plan.smem:
        raise MXNetError("fused_bottleneck: the kernel took %d bytes of "
                         "shared memory, its plan %d" % (info[0], plan.smem))
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
