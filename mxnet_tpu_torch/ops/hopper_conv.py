"""Implicit-GEMM 3x3 convolution and its gradients on hand-written Hopper
kernels (counterpart of ``mxnet_tpu/ops/pallas_conv.py``).

``conv3x3_same`` (3x3 / stride 1 / pad 1) and ``conv3x3_s2`` (3x3 /
stride 2 / pad 1) take NCHW data and OIHW weights, as in the reference
package.  Both are one convolution with ``KH x KW`` taps over NHWC
activations, :func:`taps_conv`, the function the TPU kernel
``_taps_kernel`` computes, with a stride: the OIHW weight becomes 9 taps of
(C, O) (``pallas_conv.py:299``) and the pads are ((1, 1), (1, 1)).  The
reference runs stride 2 as a stride-1 2x2 conv over 4C channels after a
space-to-depth rewrite (``pallas_conv.py:327-355``); the port's kernels take
the stride natively, which is the same function with 9/16 of the products
and no copy of the input.

Both are ``torch.autograd.Function``s, as the reference's are
``custom_vjp``s.  The stride-1 backward runs on kernels too
(``pallas_conv.py:308-320``): dgrad is :func:`taps_conv` on the cotangent
with spatially flipped, io-swapped taps, and wgrad is :func:`taps_wgrad`,
the function of the TPU kernel ``_wgrad_kernel``.  The stride-2 backward is
plain PyTorch (``torch.nn.grad``), because the reference's is XLA's
transposed convolution, not a Pallas kernel.

:func:`taps_conv` and :func:`taps_wgrad` launch CUDA kernels for a tensor
on the card, and raise if they cannot: float32 goes to
``mxnet_tpu_torch/csrc/implicit_gemm_conv.cu`` and ``taps_wgrad.cu`` (fp32
FMA on the CUDA cores), bfloat16 to ``taps_conv_bf16.cu`` and
``taps_wgrad_bf16.cu`` (the tensor cores, fp32 sums).  For a tensor on the
CPU (or a ``meta`` tensor, during shape inference) they run
:func:`taps_conv_plain` and :func:`taps_wgrad_plain`, per-tap loops of fp32
matmuls.  There is no fallback from one arm to another.  ``launches``
counts launches of the convolution kernels (forward and dgrad, both
dtypes), ``launches_bf16`` those of the bf16 one; ``wgrad_launches`` and
``wgrad_reduce_launches`` count launches of the wgrad kernels' two passes,
the partial sums and, when the rows are split, their reduction, as the
CUDA entry points report them, and ``wgrad_launches_bf16`` and
``wgrad_reduce_launches_bf16`` those of the bf16 kernel.  The kernels' host
plans (:func:`conv_fp32_plan`, :func:`conv_bf16_plan`,
:func:`wgrad_bf16_plan`, :func:`wgrad_fp32_plan`,
:func:`conv1x1_wgrad_plan`: tile, split, workspace and load path) are pure
Python.  ``conv_reduce_launches`` counts the fp32 convolution's split
sums.

The layout work around the kernels (NHWC views, the tap rewrite) is plain
PyTorch shared by both arms, so the CPU tests reach it.
The NHWC view of a channels-last tensor is free, and the kernel's output is
returned as an NCHW view of NHWC memory, so consecutive kernels hand each
other channels-last tensors without a copy.  A cotangent that reaches the
backward in NCHW memory is copied to NHWC once per convolution.

Kernels 1 and 2 take float32 or bfloat16 (both operands the same); kernel
2 returns fp32 for either, as the reference's ``dot_general(...,
preferred_element_type=f32)`` does.

``conv1x1`` is the bf16 training step's 1x1 convolution (stride 1, or
stride 2 on even H and W, which is the 1x1 on ``x[:, :, ::2, ::2]`` as
``tools/probe_conv_fixes.py:139-142`` rewrites it), a
``torch.autograd.Function`` whose forward and data gradient are
``F.conv2d`` and ``torch.nn.grad.conv2d_input`` (cuDNN; the reference
leaves both to XLA) and whose weight gradient is :func:`conv1x1_wgrad`, the
function of the TPU kernel ``wgrad_kernel`` of
``tools/probe_conv_fixes.py:164-181``: ``x(R, C)^T @ g(R, O)`` over NHWC
rows, bf16 in, fp32 out.  On the card it launches ``csrc/conv1x1_wgrad.cu``
(``conv1x1_wgrad_launches`` and ``conv1x1_wgrad_reduce_launches`` count its
two passes); on the CPU it runs :func:`conv1x1_wgrad_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["conv3x3_same", "conv3x3_same_plain", "conv3x3_s2",
           "conv3x3_s2_plain", "taps_conv", "taps_conv_plain", "taps_wgrad",
           "taps_wgrad_plain", "dgrad_taps", "conv1x1", "conv1x1_wgrad",
           "conv1x1_wgrad_plain", "conv_fp32_plan", "conv_bf16_plan",
           "wgrad_bf16_plan", "wgrad_fp32_plan", "conv1x1_wgrad_plan",
           "bf16_vec_path", "fp32_vec_path", "launches", "launches_bf16",
           "conv_reduce_launches", "wgrad_launches", "wgrad_reduce_launches",
           "wgrad_launches_bf16", "wgrad_reduce_launches_bf16",
           "conv1x1_wgrad_launches", "conv1x1_wgrad_reduce_launches"]

#: convolution kernel launches so far (CUDA arm of :func:`taps_conv`, both
#: dtypes; the fp32 kernel's split sums not included)
launches = 0
#: split-sum launches of the fp32 convolution (calls whose plan splits the
#: reduction)
conv_reduce_launches = 0
#: launches of the bf16 convolution kernel (``taps_conv_bf16.cu``) so far
launches_bf16 = 0
#: wgrad partial-pass launches so far (CUDA arm of :func:`taps_wgrad`, both
#: dtypes)
wgrad_launches = 0
#: wgrad reduction-pass launches so far (CUDA arm, calls with splits > 1)
wgrad_reduce_launches = 0
#: partial-pass launches of the bf16 wgrad kernel (``taps_wgrad_bf16.cu``)
wgrad_launches_bf16 = 0
#: reduction-pass launches of the bf16 wgrad kernel (calls with splits > 1)
wgrad_reduce_launches_bf16 = 0
#: 1x1 wgrad partial-pass launches so far (CUDA arm of :func:`conv1x1_wgrad`)
conv1x1_wgrad_launches = 0
#: 1x1 wgrad reduction-pass launches so far (CUDA arm, calls with splits > 1)
conv1x1_wgrad_reduce_launches = 0
_count_lock = threading.Lock()

_Pads = Tuple[Tuple[int, int], Tuple[int, int]]
S1_PADS: _Pads = ((1, 1), (1, 1))
#: the pads of the reference's stride-2 form, a 2x2 conv after space-to-depth
#: (``pallas_conv._S2_PADS``); the tests hold kernel 2 at 2x2 taps with them
S2_PADS: _Pads = ((1, 0), (1, 0))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_wgrad_fn = None
_conv_bf16_fn = None
_wgrad_bf16_fn = None
_w1x1_fn = None


def _out_hw(H, W, KH, KW, pads: _Pads, stride: int = 1):
    (pt, pb), (pl, pr) = pads
    return ((H + pt + pb - KH) // stride + 1,
            (W + pl + pr - KW) // stride + 1)


def taps_conv_plain(x, taps, pads: _Pads, KH: int, KW: int, stride: int = 1):
    """Reference conv: x (N, H, W, C), taps (KH*KW, C, O) -> (N, Ho, Wo, O)
    in x.dtype at ``stride``; one fp32 (rows, C) @ (C, O) product per tap,
    summed in fp32 (what ``_taps_kernel`` computes at stride 1)."""
    N, H, W, C = x.shape
    O = taps.shape[-1]
    (pt, pb), (pl, pr) = pads
    Ho, Wo = _out_hw(H, W, KH, KW, pads, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).float()
    t32 = taps.float()
    acc = None
    for dh in range(KH):
        for dw in range(KW):
            xs = xp[:, dh:dh + stride * (Ho - 1) + 1:stride,
                    dw:dw + stride * (Wo - 1) + 1:stride, :]
            xs = xs.reshape(N * Ho * Wo, C)
            p = xs @ t32[dh * KW + dw]
            acc = p if acc is None else acc + p
    return acc.reshape(N, Ho, Wo, O).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("implicit_gemm_conv").mxtt_taps_conv
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 18
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _conv_bf16_kernel():
    global _conv_bf16_fn
    if _conv_bf16_fn is None:
        from .. import _build
        fn = _build.load("taps_conv_bf16").mxtt_taps_conv_bf16
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _conv_bf16_fn = fn
    return _conv_bf16_fn


#: SMs of each CUDA device by index, read once
_SMS = {}


def _stream(device) -> int:
    """The raw handle of ``device``'s current stream, from the CUDA build's
    direct accessor: a fortieth of ``current_stream(device).cuda_stream``'s
    host time (``chip_ab.py stream``), paid by every kernel call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _sm_count(device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = sms
    return sms


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: output pixels per block of the bf16 convolution kernel (BM in
#: taps_conv_bf16.cu)
_CONV_BF16_BM = 128
#: its instantiations: (column tile BN, blocks an SM holds, an SM's rate
#: relative to the 128-column tile's).  The blocks an SM holds follow from
#: the shared memory (3 stages of 32 or 24 KB) and the
#: ``__launch_bounds__``, and chip_smoke.py's phase 2g checks them on the
#: card; the rate is the two tiles' times where both fill whole waves (28x28
#: at 128 channels, batch 128), which phase 2g prints.
_CONV_BF16_TILES = ((128, 2, 1.0), (64, 3, 0.89))


def bf16_vec_path(C: int, O: int, *ptrs: int) -> bool:
    """Whether the bf16 kernels take their 16-byte copy path: C and O
    multiples of 8 and every operand 16-byte aligned; otherwise the same
    kernel loads element by element."""
    return C % 8 == 0 and O % 8 == 0 and all(p % 16 == 0 for p in ptrs)


class ConvBf16Plan(NamedTuple):
    """Launch of ``taps_conv_bf16.cu``: column tile, load path and grid."""
    bn: int
    vec: bool
    grid: Tuple[int, int]


def conv_bf16_plan(M: int, C: int, O: int, sms: int,
                   ptrs: Tuple[int, ...] = ()) -> ConvBf16Plan:
    """The bf16 convolution kernel's launch for ``M`` output pixels, ``C``
    input and ``O`` output channels on ``sms`` SMs.  Of the 128 x 128 and
    128 x 64 tiles it takes the one whose grid costs least: its waves (at
    least one: a grid smaller than the SMs' resident blocks still takes a
    wave's time) times the columns an SM computes in a wave over its rate.
    At 7x7 the 128-column tile leaves a quarter of its one wave empty, and
    at 56x56 (O = 64) half of each tile; 128 columns on a tie, which read
    fewer bytes.  ``ptrs`` are the operands' addresses, for the load
    path."""
    best = None
    for bn, per_sm, rate in _CONV_BF16_TILES:
        grid = (max(1, _cdiv(M, _CONV_BF16_BM)), _cdiv(O, bn))
        waves = max(1.0, grid[0] * grid[1] / (per_sm * sms))
        cost = waves * per_sm * bn / rate
        if best is None or cost < best[0]:
            best = (cost, bn, grid)
    _, bn, grid = best
    return ConvBf16Plan(bn, bf16_vec_path(C, O, *ptrs), grid)


#: input channels a stage of the fp32 convolution kernel (BK in
#: implicit_gemm_conv.cu)
_CONV_FP32_BK = 16
#: its tiles (BM, BN), the blocks an SM holds of each (``__launch_bounds__``
#: and 4 stages of shared memory; chip_smoke.py's phase 2 reads it back from
#: the card) and an SM's FMA rate at each relative to the 128 x 64 tile's, as
#: phase 2 measured them where the grids give every SM the same work
_CONV_FP32_TILES = ((128, 64, 2, 1.0), (64, 64, 4, 0.89))
#: the fewest stages a split of the fp32 convolution walks
_CONV_FP32_MIN_STAGES = 8
#: the most splits the plan considers
_CONV_FP32_MAX_SPLITS = 16
#: stages of a block's ring fill and epilogue, in the plan's cost model
_CONV_FP32_FILL = 3
#: how much slower an SM runs when it holds fewer blocks than it can (a lone
#: block's warps hide less latency), in the plan's cost model
_CONV_FP32_UNDERFILL = 1.2


class ConvFp32Plan(NamedTuple):
    """Launch of ``implicit_gemm_conv.cu``: the (BM, BN) output tile; split
    ``s`` walks stages ``[s * kper, (s + 1) * kper)`` of the reduction's
    ``KH * KW * ceil(C / 16)``; the grid; the fp32 workspace of the partial
    outputs (None with one split, which writes y itself); the load path."""
    tile: Tuple[int, int]
    splits: int
    kper: int
    grid: Tuple[int, int, int]
    workspace: Optional[Tuple[int, int, int]]
    vec: bool


def _conv_fp32_cost(M, O, ks, tile, splits, sms):
    """The fp32 convolution's cost in SM clocks at ``tile`` (one of
    ``_CONV_FP32_TILES``) and ``splits``, and the stages a split walks: the
    busiest SM's blocks (the grid dealt evenly over the SMs), each its
    stages plus the ring's fill at the tile's rate, slower where an SM holds
    fewer blocks than it can, plus the split sum's bytes and launch."""
    bm, bn, per_sm, rate = tile
    kper = _cdiv(ks, splits)
    blocks = _cdiv(M, bm) * _cdiv(O, bn) * _cdiv(ks, kper)
    busiest = _cdiv(blocks, sms)
    stage_clk = _CONV_FP32_BK * bm * bn / _FMA_PER_SM_CLK
    cost = busiest * (kper + _CONV_FP32_FILL) * stage_clk / rate
    if busiest < per_sm:
        cost *= _CONV_FP32_UNDERFILL
    if splits > 1:
        cost += ((2 * splits + 1) * 4.0 * M * O / _SUM_BYTES_PER_CLK
                 + _SUM_LAUNCH_CLK)
    return cost, kper


@functools.lru_cache(maxsize=256)
def _conv_fp32_split(M: int, C: int, O: int, KH: int, KW: int, sms: int):
    """(tile, splits, kper) of :func:`conv_fp32_plan`."""
    ks = KH * KW * _cdiv(C, _CONV_FP32_BK)
    most = max(1, min(ks // _CONV_FP32_MIN_STAGES, _CONV_FP32_MAX_SPLITS))
    best = None
    for tile in _CONV_FP32_TILES:
        for splits in range(1, most + 1):
            cost, kper = _conv_fp32_cost(M, O, ks, tile, splits, sms)
            if _cdiv(ks, kper) != splits:
                continue
            if best is None or cost < best[0]:
                best = (cost, tile[:2], splits, kper)
    return best[1:]


def conv_fp32_plan(M: int, C: int, O: int, KH: int, KW: int, sms: int,
                   ptrs: Tuple[int, ...] = (),
                   tile: Optional[Tuple[int, int]] = None,
                   splits: Optional[int] = None) -> ConvFp32Plan:
    """The fp32 convolution kernel's launch for ``M`` output pixels, ``C``
    input and ``O`` output channels and ``KH x KW`` taps on ``sms`` SMs.  Of
    the tiles 128 x 64 and 64 x 64 and the splits of the
    reduction that leave every split at least 8 stages of 16 channels (up
    to 16 splits), it takes the pair whose launch costs least in SM clocks
    (:func:`_conv_fp32_cost`); the first tile and the fewest splits on a
    tie.  ``tile`` and ``splits`` set either in place of the plan's (to
    check and time each on the card).  ``ptrs`` are the operands'
    addresses, for the load path (:func:`fp32_vec_path`)."""
    ks = KH * KW * _cdiv(C, _CONV_FP32_BK)
    if tile is None and splits is None:
        tile, splits, kper = _conv_fp32_split(M, C, O, KH, KW, sms)
    else:
        tiles = {t[:2]: t for t in _CONV_FP32_TILES}
        tile = tuple(tile) if tile is not None else _conv_fp32_split(
            M, C, O, KH, KW, sms)[0]
        if tile not in tiles:
            raise MXNetError("conv_fp32_plan: tile %s; the kernel has %s"
                             % (tile, sorted(tiles)))
        splits = splits or 1
        kper = _cdiv(ks, splits)
        if not 1 <= splits <= ks or _cdiv(ks, kper) != splits:
            raise MXNetError("conv_fp32_plan: %d splits of %d stages leave "
                             "one empty" % (splits, ks))
    grid = (_cdiv(M, tile[0]), _cdiv(O, tile[1]), splits)
    return ConvFp32Plan(tile, splits, kper, grid,
                        (splits, M, O) if splits > 1 else None,
                        fp32_vec_path(C, O, *ptrs))


def _taps_conv_cuda(x, taps, pads: _Pads, KH: int, KW: int, stride: int = 1,
                    bn: Optional[int] = None,
                    plan: Optional[ConvFp32Plan] = None):
    """The CUDA arm of :func:`taps_conv`.  ``bn`` (64 or 128) sets the
    bf16 kernel's column tile in place of the plan's, and ``plan`` the fp32
    kernel's launch (a :func:`conv_fp32_plan` with its ``tile`` and
    ``splits`` set), to time and check each on one shape."""
    global launches, launches_bf16, conv_reduce_launches
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("taps_conv: dtype %s is not supported on CUDA "
                         "(float32, bfloat16)" % x.dtype)
    if taps.dtype != x.dtype or taps.device != x.device:
        raise MXNetError("taps_conv: taps must match x in dtype and device")
    if x.dim() != 4 or taps.dim() != 3 or taps.shape[0] != KH * KW \
            or taps.shape[1] != x.shape[3]:
        raise MXNetError("taps_conv: x %s and taps %s do not form a %dx%d "
                         "conv" % (tuple(x.shape), tuple(taps.shape), KH, KW))
    if stride not in (1, 2):
        raise MXNetError("taps_conv: stride %s; the kernels take 1 and 2"
                         % (stride,))
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise MXNetError("taps_conv: x and taps must be contiguous")
    N, H, W, C = x.shape
    O = taps.shape[2]
    Ho, Wo = _out_hw(H, W, KH, KW, pads, stride)
    if Ho < 1 or Wo < 1:
        raise MXNetError("taps_conv: empty output for input %s"
                         % (tuple(x.shape),))
    bf16 = x.dtype == torch.bfloat16
    if bn is not None and (not bf16 or bn not in (64, 128)):
        raise MXNetError("taps_conv: a column tile of %s for %s; the bf16 "
                         "kernel has 64 and 128" % (bn, x.dtype))
    if plan is not None and bf16:
        raise MXNetError("taps_conv: an fp32 plan for a bf16 convolution")
    y = torch.empty((N, Ho, Wo, O), dtype=x.dtype, device=x.device)
    dev = x.device
    if bf16:
        bplan = conv_bf16_plan(N * Ho * Wo, C, O, _sm_count(dev),
                               (x.data_ptr(), taps.data_ptr(), y.data_ptr()))
        err = _conv_bf16_kernel()(
            x.data_ptr(), taps.data_ptr(), y.data_ptr(), N, H, W, C, O, KH,
            KW, pads[0][0], pads[1][0], Ho, Wo, bn or bplan.bn,
            int(bplan.vec), stride, dev.index, _stream(dev))
        launched = (1, 0)
    else:
        if plan is None:
            plan = conv_fp32_plan(N * Ho * Wo, C, O, KH, KW, _sm_count(dev),
                                  (x.data_ptr(), taps.data_ptr(),
                                   y.data_ptr()))
        ws = (torch.empty(plan.workspace, dtype=torch.float32, device=dev)
              if plan.workspace else None)
        counts = (ctypes.c_int * 2)()
        err = _kernel()(
            x.data_ptr(), taps.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, N, H, W, C, O, KH, KW,
            stride, pads[0][0], pads[1][0], Ho, Wo, plan.tile[0],
            plan.tile[1], plan.splits, plan.kper, int(plan.vec), dev.index,
            _stream(dev), counts)
        launched = (counts[0], counts[1])
    with _count_lock:
        if bf16:
            launches += err == 0
            launches_bf16 += err == 0
        else:
            launches += launched[0]
            conv_reduce_launches += launched[1]
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (
            "taps_conv_bf16" if bf16 else "implicit_gemm_conv", err))
    return y


def taps_conv(x, taps, pads: _Pads, KH: int, KW: int, stride: int = 1):
    """Conv at ``stride`` (1 or 2), x (N, H, W, C) NHWC, taps (KH*KW, C, O)
    -> (N, Ho, Wo, O) in x.dtype: the CUDA kernel for a tensor on the card,
    the plain version for one on the CPU or ``meta``."""
    if x.device.type == "cuda":
        return _taps_conv_cuda(x, taps, pads, KH, KW, stride)
    if x.device.type in ("cpu", "meta"):
        return taps_conv_plain(x, taps, pads, KH, KW, stride)
    raise MXNetError("taps_conv: no arm for device %s" % x.device)


def taps_wgrad_plain(x, dy, pads: _Pads, KH: int, KW: int):
    """Reference weight gradient: x (N, H, W, C), dy (N, Ho, Wo, O) ->
    (KH*KW, C, O) fp32, one fp32 ``x_tapᵀ @ dy`` product per tap (what
    ``_wgrad_kernel`` computes)."""
    N, H, W, C = x.shape
    O = dy.shape[-1]
    (pt, pb), (pl, pr) = pads
    Ho, Wo = _out_hw(H, W, KH, KW, pads)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).float()
    g = dy.reshape(N * Ho * Wo, O).float()
    taps = []
    for dh in range(KH):
        for dw in range(KW):
            xs = xp[:, dh:dh + Ho, dw:dw + Wo, :].reshape(N * Ho * Wo, C)
            taps.append(xs.t() @ g)
    return torch.stack(taps)


def _wgrad_kernel():
    global _wgrad_fn
    if _wgrad_fn is None:
        from .. import _build
        fn = _build.load("taps_wgrad").mxtt_taps_wgrad
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _wgrad_fn = fn
    return _wgrad_fn


#: rows per stage of the fp32 wgrad kernel (BK in taps_wgrad.cu)
_WGRAD_FP32_BK = 16
#: its tiles: input = output channels of a block -> taps of a row it takes
_WGRAD_FP32_TAPS = {128: 1, 64: 3}
#: blocks of the fp32 wgrad kernel an SM holds (256 threads under
#: ``__launch_bounds__(256, 2)``, 64 KB of shared memory each); chip_smoke.py's
#: phase 2b reads it back from the card
_WGRAD_FP32_PER_SM = 2
#: the fewest stages a split of the fp32 wgrad kernel walks
_WGRAD_FP32_MIN_STAGES = 8
#: the most splits (the grid's z extent)
_WGRAD_FP32_MAX_SPLITS = 65535
#: the plan's cost model, in SM clocks: a block's ring fill and epilogue in
#: stages; fp32 FMAs an SM issues a clock; bytes of the split sum the card
#: moves a clock (80% of 3.35 TB/s at 1.755 GHz); one launch of the sum.
#: At 7 px it splits where the whole-wave rule of ``wgrad_bf16_plan`` does
#: not, and runs 1.4-1.7x faster there (chip_smoke.py's phase 2b times both)
_WGRAD_FP32_FILL = 3
_FMA_PER_SM_CLK = 128
_SUM_BYTES_PER_CLK = 1527
_SUM_LAUNCH_CLK = 5000


def fp32_vec_path(C: int, O: int, *ptrs: int) -> bool:
    """Whether the fp32 wgrad kernel takes its 16-byte copy path: C and O
    multiples of 4 and every operand 16-byte aligned; otherwise the same
    kernel copies 4 bytes at a time."""
    return C % 4 == 0 and O % 4 == 0 and all(p % 16 == 0 for p in ptrs)


class WgradFp32Plan(NamedTuple):
    """Launch of ``taps_wgrad.cu``: the channel tile (128: one tap a
    block; 64: the 3 taps of a row a block); split ``s`` sums rows
    ``[s * rows, (s + 1) * rows)`` of the ``M``; the grid; the fp32
    workspace of the partial sums (None with one split, which writes dw
    itself); the load path."""
    tile: int
    splits: int
    rows: int
    grid: Tuple[int, int, int]
    workspace: Optional[Tuple[int, int, int, int]]
    vec: bool


@functools.lru_cache(maxsize=256)
def _wgrad_fp32_split(M: int, C: int, O: int, KH: int, KW: int, sms: int):
    """(tile, splits, rows, grid) of :func:`wgrad_fp32_plan`."""
    tile = 64 if min(C, O) <= 64 else 128
    taps = _WGRAD_FP32_TAPS[tile]
    grid_xy = (_cdiv(C, tile) * _cdiv(O, tile), KH * _cdiv(KW, taps))
    blocks = grid_xy[0] * grid_xy[1]
    slots = _WGRAD_FP32_PER_SM * sms
    bk = _WGRAD_FP32_BK
    stage_clk = bk * taps * tile * tile / _FMA_PER_SM_CLK
    sum_bytes = 4.0 * KH * KW * C * O
    most = max(1, min(_cdiv(M, _WGRAD_FP32_MIN_STAGES * bk),
                      _WGRAD_FP32_MAX_SPLITS, _cdiv(8 * slots, blocks)))
    best = None
    for want in range(1, most + 1):
        rows = _cdiv(_cdiv(M, want), bk) * bk
        splits = _cdiv(M, rows)
        if splits != want:
            continue
        waves = _cdiv(blocks * splits, slots)
        cost = (waves * _WGRAD_FP32_PER_SM * (rows // bk + _WGRAD_FP32_FILL)
                * stage_clk)
        if splits > 1:
            cost += ((2 * splits + 1) * sum_bytes / _SUM_BYTES_PER_CLK
                     + _SUM_LAUNCH_CLK)
        if best is None or cost < best[0]:
            best = (cost, splits, rows)
    _, splits, rows = best
    return tile, splits, rows, grid_xy + (splits,)


def wgrad_fp32_plan(M: int, C: int, O: int, KH: int, KW: int, sms: int,
                    ptrs: Tuple[int, ...] = ()) -> WgradFp32Plan:
    """The fp32 wgrad kernel's launch for ``M`` rows on ``sms`` SMs.  The
    64-channel tile with the 3 taps of a row where C or O is at most 64,
    else the 128-channel tile.  Of the row splits whose rows are dealt in
    whole 16-row stages, every split at least 8 stages (or one split), it
    takes the one whose launch costs least in SM clocks: whole waves of the
    blocks the SMs hold (a partly filled wave costs a full one, since a
    block alone on an SM leaves half its FMA issue idle), each the busiest
    SM's stages plus the ring's fill, plus the split sum's bytes (partials
    written and read, dw written) and launch.  ``ptrs`` are the operands'
    addresses, for the load path."""
    tile, splits, rows, grid = _wgrad_fp32_split(M, C, O, KH, KW, sms)
    return WgradFp32Plan(tile, splits, rows, grid,
                         (splits, KH * KW, C, O) if splits > 1 else None,
                         fp32_vec_path(C, O, *ptrs))


def _wgrad_bf16_kernel():
    global _wgrad_bf16_fn
    if _wgrad_bf16_fn is None:
        from .. import _build
        fn = _build.load("taps_wgrad_bf16").mxtt_taps_wgrad_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _wgrad_bf16_fn = fn
    return _wgrad_bf16_fn


#: rows per stage of the bf16 wgrad kernel (BK in taps_wgrad_bf16.cu)
_WGRAD_BF16_BK = 32
#: input and output channels per block tile of the bf16 wgrad kernel
_WGRAD_BF16_TILE = 64
#: taps of one row a block of the bf16 wgrad kernel computes
_WGRAD_BF16_TAPS = 3
#: blocks of the bf16 wgrad kernel an SM holds (4 x 16 KB of shared memory,
#: 128 threads)
_WGRAD_BF16_PER_SM = 3
#: the fewest stages a split of the bf16 wgrad kernel walks
_WGRAD_BF16_MIN_STAGES = 8
#: the most splits (the grid's z extent)
_WGRAD_BF16_MAX_SPLITS = 65535


class WgradBf16Plan(NamedTuple):
    """Launch of ``taps_wgrad_bf16.cu``: split ``s`` sums rows ``[s * rows,
    (s + 1) * rows)`` of the ``M``; the grid; the fp32 workspace of the
    partial sums (None with one split, which writes dw itself)."""
    splits: int
    rows: int
    grid: Tuple[int, int, int]
    workspace: Optional[Tuple[int, int, int, int]]


def wgrad_bf16_plan(M: int, C: int, O: int, KH: int, KW: int,
                    sms: int) -> WgradBf16Plan:
    """The bf16 wgrad kernel's launch for ``M`` rows on ``sms`` SMs: as
    many row splits as fill the SMs' resident blocks once (whole waves),
    each at least 8 stages of 32 rows, rows dealt in whole stages so that
    every split has rows."""
    taps = KH * KW
    grid_xy = (_cdiv(C, _WGRAD_BF16_TILE) * _cdiv(O, _WGRAD_BF16_TILE),
               KH * _cdiv(KW, _WGRAD_BF16_TAPS))
    want = max(1, _WGRAD_BF16_PER_SM * sms // (grid_xy[0] * grid_xy[1]))
    splits = max(1, min(want, _cdiv(M, _WGRAD_BF16_MIN_STAGES
                                    * _WGRAD_BF16_BK),
                        _WGRAD_BF16_MAX_SPLITS))
    stage = _WGRAD_BF16_BK
    rows = max(stage, _cdiv(_cdiv(M, splits), stage) * stage)
    splits = max(1, _cdiv(M, rows))
    return WgradBf16Plan(splits, rows, grid_xy + (splits,),
                         (splits, taps, C, O) if splits > 1 else None)


def _taps_wgrad_cuda(x, dy, pads: _Pads, KH: int, KW: int):
    global wgrad_launches, wgrad_reduce_launches
    global wgrad_launches_bf16, wgrad_reduce_launches_bf16
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype:
        raise MXNetError("taps_wgrad: the CUDA kernel takes float32 or "
                         "bfloat16 x and dy of one dtype, got %s and %s"
                         % (x.dtype, dy.dtype))
    if dy.device != x.device:
        raise MXNetError("taps_wgrad: dy must be on x's device")
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, KH, KW, pads)
    if x.dim() != 4 or dy.dim() != 4 or tuple(dy.shape[:3]) != (N, Ho, Wo):
        raise MXNetError("taps_wgrad: x %s and dy %s do not form a %dx%d "
                         "conv" % (tuple(x.shape), tuple(dy.shape), KH, KW))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("taps_wgrad: x and dy must be contiguous")
    O = dy.shape[3]
    sms = _sm_count(x.device)
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((KH * KW, C, O), dtype=torch.float32, device=x.device)
    launched = (ctypes.c_int * 2)()
    if bf16:
        plan = wgrad_bf16_plan(N * Ho * Wo, C, O, KH, KW, sms)
        ws = (torch.empty(plan.workspace, dtype=torch.float32,
                          device=x.device) if plan.workspace else None)
        err = _wgrad_bf16_kernel()(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, N, H, W, C, O, KH,
            KW, pads[0][0], pads[1][0], Ho, Wo, plan.splits, plan.rows,
            int(bf16_vec_path(C, O, x.data_ptr(), dy.data_ptr())),
            x.device.index, _stream(x.device), launched)
    else:
        plan = wgrad_fp32_plan(N * Ho * Wo, C, O, KH, KW, sms,
                               (x.data_ptr(), dy.data_ptr()))
        ws = (torch.empty(plan.workspace, dtype=torch.float32,
                          device=x.device) if plan.workspace else None)
        err = _wgrad_kernel()(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, N, H, W, C, O, KH, KW,
            pads[0][0], pads[1][0], Ho, Wo, plan.tile, plan.splits, plan.rows,
            int(plan.vec), x.device.index, _stream(x.device), launched)
    with _count_lock:
        wgrad_launches += launched[0]
        wgrad_reduce_launches += launched[1]
        if bf16:
            wgrad_launches_bf16 += launched[0]
            wgrad_reduce_launches_bf16 += launched[1]
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (
            "taps_wgrad_bf16" if bf16 else "taps_wgrad", err))
    return out


def taps_wgrad(x, dy, pads: _Pads, KH: int, KW: int):
    """Weight gradient of :func:`taps_conv`, x (N, H, W, C), dy
    (N, Ho, Wo, O), both NHWC, fp32 or bf16 -> (KH*KW, C, O) fp32: the CUDA
    kernel for a tensor on the card, the plain version for one on the CPU or
    ``meta``."""
    if x.device.type == "cuda":
        return _taps_wgrad_cuda(x, dy, pads, KH, KW)
    if x.device.type in ("cpu", "meta"):
        return taps_wgrad_plain(x, dy, pads, KH, KW)
    raise MXNetError("taps_wgrad: no arm for device %s" % x.device)


def _nhwc(x):
    """NHWC contiguous tensor; free for a channels-last NCHW tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y):
    return y.permute(0, 3, 1, 2)


def _s1_taps(weight, dtype):
    O, C = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9, C, O).to(dtype).contiguous()


def dgrad_taps(weight, dtype=None):
    """(O, C, 3, 3) weight -> (9, O, C) taps whose stride-1 pad-1
    convolution of the cotangent is the data gradient: the weight flipped
    in space with input and output swapped (``pallas_conv.py:314-316``)."""
    O, C = weight.shape[:2]
    taps = weight.flip((2, 3)).permute(2, 3, 0, 1).reshape(9, O, C)
    return taps.to(dtype or weight.dtype).contiguous()


class _Conv3x3Same(torch.autograd.Function):
    """3x3 / stride-1 / pad-1 conv whose forward, dgrad and wgrad all run
    on the kernels (``pallas_conv.conv3x3_same`` and ``_c3s_bwd``)."""

    @staticmethod
    def forward(ctx, data, weight):
        x = _nhwc(data)
        y = taps_conv(x, _s1_taps(weight, data.dtype), S1_PADS, 3, 3)
        ctx.save_for_backward(x, weight)
        return _nchw(y)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        O, C = weight.shape[:2]
        gh = _nhwc(g.to(x.dtype))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _nchw(taps_conv(gh, dgrad_taps(weight, gh.dtype),
                                 S1_PADS, 3, 3))
        if ctx.needs_input_grad[1]:
            dwf = taps_wgrad(x, gh, S1_PADS, 3, 3)
            dw = dwf.reshape(3, 3, C, O).permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


def _same(data, weight, conv):
    return _nchw(conv(_nhwc(data), _s1_taps(weight, data.dtype),
                      S1_PADS, 3, 3))


def _s2(data, weight, conv):
    N, C, H, W = data.shape
    if H % 2 or W % 2:
        raise MXNetError("conv3x3_s2 needs even H and W, got %dx%d" % (H, W))
    return _nchw(conv(_nhwc(data), _s1_taps(weight, data.dtype), S1_PADS,
                      3, 3, 2))


class _Conv3x3S2(torch.autograd.Function):
    """3x3 / stride-2 / pad-1 conv: forward on the kernel at stride 2,
    backward in plain PyTorch, as the reference's ``_c3s2_bwd`` leaves it
    to XLA's transposed convolution."""

    @staticmethod
    def forward(ctx, data, weight):
        ctx.save_for_backward(data, weight)
        return _s2(data, weight, taps_conv)

    @staticmethod
    def backward(ctx, g):
        data, weight = ctx.saved_tensors
        g = g.to(data.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(data.shape, weight.to(g.dtype), g,
                                            stride=2, padding=1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(data, weight.shape, g,
                                             stride=2, padding=1)
            dw = dw.to(weight.dtype)
        return dx, dw


def conv3x3_same(data, weight):
    """3x3 / stride-1 / pad-1 / ungrouped conv, NCHW data, OIHW weight;
    differentiable, with both gradients on the kernels."""
    return _Conv3x3Same.apply(data, weight)


def conv3x3_same_plain(data, weight):
    """:func:`conv3x3_same` through the plain version on any device."""
    return _same(data, weight, taps_conv_plain)


def conv3x3_s2(data, weight):
    """3x3 / stride-2 / pad-1 / ungrouped conv on even H, W (the
    reference's space-to-depth form needs them), NCHW data, OIHW weight;
    differentiable."""
    return _Conv3x3S2.apply(data, weight)


def conv3x3_s2_plain(data, weight):
    """:func:`conv3x3_s2` through the plain version on any device."""
    return _s2(data, weight, taps_conv_plain)


# --------------------------------------------------------------------------
# 1x1 convolution with the weight gradient on kernel 12
# --------------------------------------------------------------------------
#: rows per stage of the 1x1 wgrad kernel (BK in conv1x1_wgrad.cu)
_W1X1_BK = 64
#: blocks of the 1x1 wgrad kernel the plan puts on an SM: one block keeps
#: 64-96 KB of its ring in flight, enough for its share of device memory, and
#: a second would double the partials' round trip; the card holds at least
#: this many (chip_smoke.py's phase 2g reads it back)
_W1X1_PER_SM = 1
#: the fewest stages a split of the 1x1 wgrad kernel walks
_W1X1_MIN_STAGES = 4
#: the most splits (the grid's y extent)
_W1X1_MAX_SPLITS = 65534
#: blocks of consecutive splits that sum their tiles on chip (CLUSTER in
#: conv1x1_wgrad.cu) when the rows are split
_W1X1_CLUSTER = 2
#: channel counts the 1x1 wgrad kernel takes: multiples of 8 in [8, 2048]
W1X1_MAX_CHANNELS = 2048


def _out_1x1(H: int, W: int, stride: int):
    return (H - 1) // stride + 1, (W - 1) // stride + 1


def conv1x1_wgrad_plain(x, g, stride: int = 1):
    """Reference 1x1 weight gradient: x (N, H, W, C), g (N, Ho, Wo, O), both
    NHWC -> (C, O) fp32, one fp32 ``x_rows^T @ g_rows`` product over the
    pixels ``x[:, ::stride, ::stride]`` (what ``wgrad_kernel`` computes)."""
    C, O = x.shape[3], g.shape[3]
    xs = x[:, ::stride, ::stride, :].reshape(-1, C).float()
    return xs.t() @ g.reshape(-1, O).float()


def _w1x1_kernel():
    global _w1x1_fn
    if _w1x1_fn is None:
        from .. import _build
        fn = _build.load("conv1x1_wgrad").mxtt_conv1x1_wgrad
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _w1x1_fn = fn
    return _w1x1_fn


class Conv1x1WgradPlan(NamedTuple):
    """Launch of ``conv1x1_wgrad.cu``: the (input, output) channel tile;
    split ``s`` sums rows ``[s * rows, (s + 1) * rows)`` of the ``M``; the
    grid; the blocks of consecutive splits in a cluster, which sum their
    tiles on chip into one partial (2 when the rows are split, the last
    split then possibly empty); the fp32 workspace of the partials (None
    with one, which is dw itself); the load path."""
    tile: Tuple[int, int]
    splits: int
    rows: int
    grid: Tuple[int, int]
    cluster: int
    workspace: Optional[Tuple[int, int, int]]
    vec: bool


def _conv1x1_wgrad_tile(C: int, O: int) -> Tuple[int, int]:
    """The 1x1 wgrad kernel's (input, output) channel tile, as wide as the
    channels allow, since each operand is read again once per tile of the
    other's channels: 64 x 256 or 256 x 64 where one side has at most 64
    channels and the other more than 128 (ResNet's 64 <-> 256 layers at 56
    px, which then read x and g once), 64 x 64 where both are small, 256 x
    128 or 128 x 256 (16 warps) where both sides are wider, the 256 along
    the wider side, else 128 x 128."""
    if C <= 64:
        return (64, 256) if O > 128 else (64, 64)
    if O <= 64:
        return (256, 64) if C > 128 else (64, 64)
    if C >= 256 and O >= 128 and C >= O:
        return 256, 128
    if O >= 256:
        return 128, 256
    return 128, 128


@functools.lru_cache(maxsize=256)
def _conv1x1_wgrad_split(M: int, C: int, O: int, sms: int):
    """(tile, splits, rows, grid, cluster) of :func:`conv1x1_wgrad_plan`."""
    bc, bo = _conv1x1_wgrad_tile(C, O)
    tiles = _cdiv(C, bc) * _cdiv(O, bo)
    want = max(1, _W1X1_PER_SM * sms // tiles)
    splits = max(1, min(want, _cdiv(M, _W1X1_MIN_STAGES * _W1X1_BK),
                        _W1X1_MAX_SPLITS))
    cluster = _W1X1_CLUSTER if splits > 1 else 1
    splits = splits // cluster * cluster        # whole clusters, in the wave
    rows = max(_W1X1_BK, _cdiv(_cdiv(M, splits), _W1X1_BK) * _W1X1_BK)
    splits = _cdiv(_cdiv(M, rows), cluster) * cluster
    return (bc, bo), splits, rows, (tiles, splits), cluster


def conv1x1_wgrad_plan(M: int, C: int, O: int, sms: int,
                       ptrs: Tuple[int, ...] = ()) -> Conv1x1WgradPlan:
    """Kernel 12's launch for ``M`` rows on ``sms`` SMs: the tile, and as
    many row splits as fill one wave of one block an SM, each at least 4
    stages of 64 rows, rows dealt in whole stages so that every split but
    a cluster's last has rows; split rows go in clusters of 2 blocks, so
    the workspace holds half as many partials.  ``ptrs`` are the operands'
    addresses: 16-byte copies where all are 16-byte aligned, else the
    element path."""
    tile, splits, rows, grid, cluster = _conv1x1_wgrad_split(M, C, O, sms)
    partials = splits // cluster
    return Conv1x1WgradPlan(tile, splits, rows, grid, cluster,
                            (partials, C, O) if partials > 1 else None,
                            all(p % 16 == 0 for p in ptrs))


def _conv1x1_wgrad_cuda(x, g, stride: int):
    global conv1x1_wgrad_launches, conv1x1_wgrad_reduce_launches
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise MXNetError("conv1x1_wgrad: the CUDA kernel takes bfloat16 x "
                         "and g, got %s and %s" % (x.dtype, g.dtype))
    dev = x.device
    if g.device != dev:
        raise MXNetError("conv1x1_wgrad: g must be on x's device")
    if x.dim() != 4 or g.dim() != 4:
        raise MXNetError("conv1x1_wgrad: x and g must be NHWC, got %s and %s"
                         % (tuple(x.shape), tuple(g.shape)))
    N, H, W, C = x.shape
    O = g.shape[3]
    Ho, Wo = _out_1x1(H, W, stride)
    if stride not in (1, 2) or tuple(g.shape[:3]) != (N, Ho, Wo):
        raise MXNetError("conv1x1_wgrad: x %s and g %s do not form a 1x1 "
                         "conv at stride %d"
                         % (tuple(x.shape), tuple(g.shape), stride))
    for name, n in (("C", C), ("O", O)):
        if n % 8 or not 8 <= n <= W1X1_MAX_CHANNELS:
            raise MXNetError("conv1x1_wgrad: %s = %d; the CUDA kernel takes "
                             "multiples of 8 from 8 to %d"
                             % (name, n, W1X1_MAX_CHANNELS))
    if not (x.is_contiguous() and g.is_contiguous()):
        raise MXNetError("conv1x1_wgrad: x and g must be contiguous")
    x_ptr, g_ptr = x.data_ptr(), g.data_ptr()
    plan = conv1x1_wgrad_plan(N * Ho * Wo, C, O, _sm_count(dev),
                              (x_ptr, g_ptr))
    out = torch.empty((C, O), dtype=torch.float32, device=dev)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=dev)
          if plan.workspace else None)
    launched = (ctypes.c_int * 2)()
    err = _w1x1_kernel()(
        x_ptr, g_ptr, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        N, H, W, C, O, Ho, Wo, stride, plan.tile[0], plan.tile[1],
        plan.splits, plan.rows, plan.cluster, int(plan.vec), dev.index,
        _stream(dev), launched)
    with _count_lock:
        conv1x1_wgrad_launches += launched[0]
        conv1x1_wgrad_reduce_launches += launched[1]
    if err != 0:
        raise MXNetError("conv1x1_wgrad launch failed: CUDA error %d" % err)
    return out


def conv1x1_wgrad(x, g, stride: int = 1):
    """Weight gradient of a 1x1 convolution at ``stride``, x (N, H, W, C)
    and g (N, Ho, Wo, O), both NHWC -> (C, O) fp32: the CUDA kernel (bf16
    only) for a tensor on the card, the plain version for one on the CPU or
    ``meta``."""
    if x.device.type == "cuda":
        return _conv1x1_wgrad_cuda(x, g, stride)
    if x.device.type in ("cpu", "meta"):
        return conv1x1_wgrad_plain(x, g, stride)
    raise MXNetError("conv1x1_wgrad: no arm for device %s" % x.device)


class _Conv1x1(torch.autograd.Function):
    """1x1 / pad-0 / ungrouped conv at stride 1 or 2: forward and data
    gradient on cuDNN, weight gradient on kernel 12 (:func:`conv1x1_wgrad`)."""

    @staticmethod
    def forward(ctx, data, weight, stride):
        ctx.save_for_backward(data, weight)
        ctx.stride = stride
        return F.conv2d(data, weight.to(data.dtype), stride=stride)

    @staticmethod
    def backward(ctx, g):
        data, weight = ctx.saved_tensors
        s = ctx.stride
        g = g.to(data.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(data.shape, weight.to(g.dtype), g,
                                            stride=s)
        if ctx.needs_input_grad[1]:
            O, C = weight.shape[:2]
            dwf = conv1x1_wgrad(_nhwc(data), _nhwc(g), s)
            dw = dwf.t().to(weight.dtype).reshape(O, C, 1, 1)
        return dx, dw, None


def conv1x1(data, weight, stride: int = 1):
    """1x1 / pad-0 / ungrouped conv at stride 1 or 2, NCHW data, OIHW
    weight; differentiable, the weight gradient on kernel 12 (which takes
    bf16) for a tensor on the card."""
    return _Conv1x1.apply(data, weight, stride)
