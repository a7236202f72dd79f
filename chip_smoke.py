#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: compile every CUDA kernel source of the port with nvcc, all at
   once, and print the build seconds and ptxas' register/shared-memory use.
2. kernels: at each of the 7 distinct 3x3 convolution shapes of a
   ResNet-50 forward, batch 32, fp32, run the hand-written implicit-GEMM
   kernel (through ``hopper_conv``) against its plain PyTorch version on
   the same CUDA tensors, within rtol = atol = 1e-4.  Print the kernel's,
   the plain version's and cuDNN's time (``F.conv2d``, the yardstick only:
   the port never calls it for these shapes) and the bound.
2b. backward kernels: at each of the 4 stride-1 3x3 shapes of a Gluon
   ResNet-50 v1, batch 32, fp32, kernel 2 (wgrad) against
   ``taps_wgrad_plain`` (within 1e-4 of the largest |dw|) and kernel 1 as
   dgrad (flipped, io-swapped taps) against the plain version (rtol = atol
   = 1e-4), after ragged shapes; kernel, plain and cuDNN times
   (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, the yardsticks
   only) and the fp32 bound.
2c. LSTM kernels: kernel 8 (``lstm_fwd.cu``) and kernel 9 (``lstm_bwd.cu``)
   against their plain versions (``hopper_rnn.lstm_fwd_plain`` /
   ``lstm_bwd_plain``) at two ragged shapes, at the edges of their
   envelope (B=1024; H=2048, where R does not stay in shared memory) and
   at the LM's (T=35, B=128, H=650): every forward output within 1e-5,
   every backward output within
   1e-4 of its largest |value|; kernel, plain and cuDNN times
   (``torch.nn.LSTM`` of one layer, the yardstick only, with its input
   projection's matmul timed apart) and the fp32 bound.
3. serving: serve the full-width ResNet-50 (224 px, 1000 classes, fp32,
   seeded random weights) through ``ModelServer`` on gpu(0) with buckets
   up to 32; answer 8 concurrent requests of 1-8 rows of mixed SLO classes
   and check every answer against a ``Predictor`` on the CPU (the plain
   versions): same top-1, probabilities within 1e-4.  Then a closed loop
   of 8 clients measures images/s and latency.  The kernel launch counter,
   zeroed just before, must read 16 per executed forward.
4. profile: one batch-32 forward as the server runs it (host copy in,
   forward, host copy out), timed on the host and traced with
   torch.profiler: device busy share and device time by kernel group.
5. training: full-width Gluon ResNet-50 v1 (224 px, batch 32, fp32,
   weights from ``initialize()`` after ``random.seed(0)``) trained by
   ``FusedTrainer`` (SGD, lr 0.1, momentum 0.9) on gpu(0).  The first
   step must match the same step on the CPU from the same weights and
   batch (loss within rtol 1e-4, each 3x3 weight's update within 5% of
   its norm); then 2 warm-up and 10 timed steps give train images/s.  The
   launch counters, zeroed just before the first step, must read per step
   32 kernel-1 launches, 16 launches of kernel 2's partial pass and one
   launch of its reduction pass for each of those 16 whose rows are split
   (13 on a 132-SM card).
6. training profile: two steps under torch.profiler, device time and
   launches by group (kernel 1 forward, kernel 1 dgrad, kernel 2's two
   passes, cuDNN, BatchNorm and elementwise, layout copies, optimizer),
   the same kernel launch counts read from the trace, and the device's
   idle share of an unprofiled step.

7. LM training: bench.py's ``bench_lstm_lm`` net at full width (vocab
   33278, embed = hidden = 650, 2 layers, dropout 0.2, bptt 35, batch 128,
   fp32) built through the port's Gluon with deferred shapes, hybridized,
   trained by ``FusedTrainer`` with ``SoftmaxCrossEntropyLoss`` (SGD lr
   0.5) on one batch of token ids below 256: kernels 8 and 9 must launch 2
   times each a step (one per layer), the loss must stay finite and fall
   over 12 steps; train tokens/s from the median of 10 timed steps after 2
   warm-up steps.  Dropout's keep rate at one layer's shape must be 0.8
   within 0.005, and one seed must give the same first loss twice.
7b. LM vs CPU: the first step of the same net without dropout, from the
   same weights, on the card and on the CPU: loss within rtol 1e-4, every
   parameter's update within 1% of its norm.
8. LM profile: one step under torch.profiler, device time and launches by
   group (kernel 8, kernel 9, cuBLAS, cross-entropy, embedding, dropout
   and elementwise, optimizer, memcpy), the ten longest kernels, and the
   idle share.

It then prints the ``kernels`` JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.  TF32 is off for
cuDNN and for matmuls throughout, so every comparison is fp32 against fp32.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

KERNEL_TOL = 1e-4      # rtol = atol, kernel vs plain (fp32 FMA vs fp32 GEMM)
PROB_TOL = 1e-4        # max |p_gpu - p_cpu| of served probabilities
PEAK_FP32 = 67e12      # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12    # H100 SXM device memory bytes/s
BATCH = 32
SEED = 0

# the 3x3 convolutions of one ResNet-50 forward: (class, C = O, input H = W,
# instances per forward)
RESNET50_3X3 = [("s1", 64, 56, 3), ("s1", 128, 28, 3), ("s1", 256, 14, 5),
                ("s1", 512, 7, 2), ("s2", 128, 56, 1), ("s2", 256, 28, 1),
                ("s2", 512, 14, 1)]
# the 3x3 convolutions of a Gluon ResNet-50 v1 (stride on the 1x1, so all
# stride 1): (C = O, H = W, instances per step)
GLUON_3X3 = [(64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3)]
WGRAD_TOL = 1e-4       # max |dw_kernel - dw_plain| / max |dw_plain|
# first training step on the card vs the CPU: the loss, and each 3x3
# weight's update in Frobenius norm (the one-step gradient of a 53-layer
# BatchNorm net is ill-conditioned in fp32: tests/test_torch_train.py)
LOSS_RTOL = 1e-4
UPDATE_TOL = 0.05
WARMUP_STEPS = 2
TIMED_STEPS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fp32_exact():
    """cuDNN convolutions and matmuls in full fp32 (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _bound(flops, nbytes):
    ops_s, bytes_s = flops / PEAK_FP32, nbytes / HBM_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    info = _build.build()
    print("[build] %d source(s) in %.2f s" % (len(info),
                                             time.perf_counter() - t0))
    for name, rec in info.items():
        print("[build] %s: %.2f s, built=%s" % (name, rec["seconds"],
                                                rec["built"]))
        for line in rec["log"].splitlines():
            if "registers" in line or "stack frame" in line \
                    or "spill" in line:
                print("[build]   " + line.strip())
    return info


def phase_kernels():
    """Kernel vs plain at the 7 ResNet-50 3x3 shapes; returns the
    ``kernels`` entry (without ``launches``)."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = []
    for kind, C, H, count in RESNET50_3X3:
        O = C
        stride = 1 if kind == "s1" else 2
        fn, plain = ((hc.conv3x3_same, hc.conv3x3_same_plain) if kind == "s1"
                     else (hc.conv3x3_s2, hc.conv3x3_s2_plain))
        # channels-last, as the kernel's own outputs reach the next conv
        x = torch.randn(BATCH, C, H, H, device=dev, generator=gen) \
            .contiguous(memory_format=torch.channels_last)
        w = torch.randn(O, C, 3, 3, device=dev, generator=gen) \
            / math.sqrt(9 * C)
        y = fn(x, w)
        yp = plain(x, w)
        yl = F.conv2d(x, w, stride=stride, padding=1)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        rel = err / yp.abs().max().item()
        err_lib = (y - yl).abs().max().item()
        ok = torch.allclose(y, yp, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        ms = time_ms(lambda: fn(x, w))
        plain_ms = time_ms(lambda: plain(x, w))
        lib_ms = time_ms(lambda: F.conv2d(x, w, stride=stride, padding=1))
        Ho = H // stride
        flops = 2.0 * BATCH * Ho * Ho * O * C * 9
        bound_ms, bound_by = _bound(
            flops, 4.0 * (x.numel() + w.numel() + BATCH * O * Ho * Ho))
        rec = {"class": kind, "N": BATCH, "C": C, "O": O, "H": H, "W": H,
               "Ho": Ho, "instances_per_forward": count,
               "max_abs_err": err, "max_rel_err": rel,
               "max_abs_err_vs_cudnn": err_lib, "tol": KERNEL_TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "tflops": flops / ms / 1e9}
        shapes.append(rec)
        print("[kernels] %s C=O=%d %dx%d->%dx%d N=%d: max_abs_err %.3g "
              "(rel %.3g, tol %g) vs cuDNN fp32 %.3g | kernel %.4f ms "
              "(%.1f TFLOP/s), plain %.4f ms, cuDNN %.4f ms, bound %.4f ms "
              "(%s)" % (kind, C, H, H, Ho, Ho, BATCH, err, rel, KERNEL_TOL,
                        err_lib, ms, rec["tflops"], plain_ms, lib_ms,
                        rec["bound_ms"], rec["bound_by"]))
        check(ok, "kernel disagrees with its plain version at %s C=%d H=%d: "
              "max abs err %g > tol %g" % (kind, C, H, err, KERNEL_TOL))
        del x, w, y, yp, yl
    per_fwd = lambda key: sum(s[key] * s["instances_per_forward"]
                              for s in shapes)
    flops_fwd = per_fwd("gflop") * 1e9
    return {
        "name": "implicit_gemm_conv",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/implicit_gemm_conv.cu",
        "replaces": "mxnet_tpu/ops/pallas_conv.py:152",
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        # times of the 16 instances of one ResNet-50 forward at batch 32
        "ms": per_fwd("ms"),
        "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in shapes) else "bytes"),
        "library_ms": per_fwd("library_ms"),
        "tflops_per_forward": flops_fwd / per_fwd("ms") / 1e9,
        "shapes": shapes,
    }


# --------------------------------------------------------------------------
def _ragged_backward_checks(hc, dev, gen):
    """Kernel 2 and the dgrad against their plain versions at ragged
    channel counts, odd spatial dims and a ragged row split, fp32."""
    for N, C, H, W, O in [(3, 20, 7, 9, 70), (1, 3, 1, 1, 5),
                          (5, 33, 11, 13, 129)]:
        x = torch.randn(N, H, W, C, device=dev, generator=gen)
        dy = torch.randn(N, H, W, O, device=dev, generator=gen)
        w = torch.randn(O, C, 3, 3, device=dev, generator=gen) * 0.1
        got = hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3)
        want = hc.taps_wgrad_plain(x, dy, hc.S1_PADS, 3, 3)
        err = (got - want).abs().max().item() / want.abs().max().item()
        check(err <= WGRAD_TOL, "wgrad kernel disagrees at N=%d C=%d %dx%d "
              "O=%d: %g of max |dw| > %g" % (N, C, H, W, O, err, WGRAD_TOL))
        taps = hc.dgrad_taps(w)
        got = hc.taps_conv(dy, taps, hc.S1_PADS, 3, 3)
        want = hc.taps_conv_plain(dy, taps, hc.S1_PADS, 3, 3)
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              "dgrad disagrees at N=%d C=%d %dx%d O=%d: max abs err %g"
              % (N, C, H, W, O, (got - want).abs().max().item()))
    print("[backward] ragged shapes: kernel 2 and dgrad match their plain "
          "versions")


def phase_backward_kernels():
    """Kernel 2 (wgrad) and kernel 1 as dgrad against their plain versions
    at the 4 stride-1 3x3 shapes of a Gluon ResNet-50 v1, batch 32, fp32;
    returns per-shape records."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    _ragged_backward_checks(hc, dev, gen)
    wgrad, dgrad = [], []
    for C, H, count in GLUON_3X3:
        O = C
        x = torch.randn(BATCH, H, H, C, device=dev, generator=gen)
        dy = torch.randn(BATCH, H, H, O, device=dev, generator=gen)
        w = torch.randn(O, C, 3, 3, device=dev, generator=gen) \
            / math.sqrt(9 * C)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        flops = 2.0 * BATCH * H * H * C * O * 9
        common = {"N": BATCH, "C": C, "O": O, "H": H, "W": H,
                  "instances_per_step": count, "gflop": flops / 1e9}

        # wgrad: kernel 2 vs x_tap^T @ dy per tap
        got = hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3)
        want = hc.taps_wgrad_plain(x, dy, hc.S1_PADS, 3, 3)
        lib = torch.nn.grad.conv2d_weight(xn, w.shape, dyn, padding=1)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        err_lib = (got.reshape(3, 3, C, O).permute(3, 2, 0, 1)
                   - lib).abs().max().item()
        ms = time_ms(lambda: hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3))
        plain_ms = time_ms(lambda: hc.taps_wgrad_plain(x, dy, hc.S1_PADS,
                                                       3, 3))
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
            xn, w.shape, dyn, padding=1))
        bound_ms, bound_by = _bound(
            flops, 4.0 * (x.numel() + dy.numel() + 9 * C * O))
        splits = hc.wgrad_splits(BATCH * H * H, C, O, 9, torch.cuda
                                 .get_device_properties(dev)
                                 .multi_processor_count)
        rec = dict(common, max_abs_err=err, max_rel_err=err / scale,
                   tol_rel=WGRAD_TOL, max_abs_err_vs_cudnn=err_lib,
                   splits=splits, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        wgrad.append(rec)
        print("[backward] wgrad C=O=%d %dx%d N=%d (%d splits): max_abs_err "
              "%.3g (%.3g of max |dw|, tol %g) vs cuDNN %.3g | kernel %.4f "
              "ms (%.1f TFLOP/s), plain %.4f ms, cuDNN %.4f ms, bound %.4f "
              "ms (%s)" % (C, H, H, BATCH, splits, err, err / scale,
                           WGRAD_TOL, err_lib, ms, rec["tflops"], plain_ms,
                           lib_ms, bound_ms, bound_by))
        check(err <= WGRAD_TOL * scale, "wgrad kernel disagrees with its "
              "plain version at C=%d H=%d: %g > %g of max |dw|"
              % (C, H, err / scale, WGRAD_TOL))

        # dgrad: kernel 1 on the cotangent with flipped, io-swapped taps
        taps = hc.dgrad_taps(w)
        got = hc.taps_conv(dy, taps, hc.S1_PADS, 3, 3)
        want = hc.taps_conv_plain(dy, taps, hc.S1_PADS, 3, 3)
        lib = torch.nn.grad.conv2d_input(xn.shape, w, dyn, padding=1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_lib = (got.permute(0, 3, 1, 2) - lib).abs().max().item()
        ok = torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        ms = time_ms(lambda: hc.taps_conv(dy, hc.dgrad_taps(w), hc.S1_PADS,
                                          3, 3))
        plain_ms = time_ms(lambda: hc.taps_conv_plain(
            dy, hc.dgrad_taps(w), hc.S1_PADS, 3, 3))
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
            xn.shape, w, dyn, padding=1))
        bound_ms, bound_by = _bound(
            flops, 4.0 * (dy.numel() + w.numel() + x.numel()))
        rec = dict(common, max_abs_err=err, tol=KERNEL_TOL,
                   max_abs_err_vs_cudnn=err_lib, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        dgrad.append(rec)
        print("[backward] dgrad C=O=%d %dx%d N=%d: max_abs_err %.3g (tol "
              "%g) vs cuDNN %.3g | kernel %.4f ms (%.1f TFLOP/s), plain "
              "%.4f ms, cuDNN %.4f ms, bound %.4f ms (%s)"
              % (C, H, H, BATCH, err, KERNEL_TOL, err_lib, ms, rec["tflops"],
                 plain_ms, lib_ms, bound_ms, bound_by))
        check(ok, "dgrad disagrees with its plain version at C=%d H=%d: max "
              "abs err %g > tol %g" % (C, H, err, KERNEL_TOL))
        del x, dy, w, got, want, lib
    return wgrad, dgrad


# --------------------------------------------------------------------------
LSTM_FWD_TOL = 1e-5     # max |kernel 8 - plain|, every output
LSTM_BWD_TOL = 1e-4     # max |kernel 9 - plain| / max |plain|, every output
# the bench's LM (bench.py:205-224): vocab, embed = hidden, layers, bptt,
# batch, dropout, SGD learning rate
LM = dict(vocab=33278, hidden=650, layers=2, bptt=35, batch=128,
          dropout=0.2, lr=0.5)
LM_UPDATE_TOL = 0.01    # first step on the card vs the CPU, per parameter
KEEP_TOL = 0.005        # dropout keep rate 0.8 within this


def _lstm_inputs(T, B, H, gen, dev):
    """Seeded fp32 inputs of kernels 8 and 9 at (T, B, H), LSTM-scaled:
    projections of unit scale, R ~ N(0, 1/H)."""
    r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=gen) \
        * scale  # noqa: E731
    return dict(xp=r(T, B, 4 * H), h0=r(B, H, scale=0.3),
                c0=r(B, H, scale=0.3), R=r(4 * H, H, scale=H ** -0.5),
                bR=r(4 * H, scale=0.1), dys=r(T, B, H), dhT=r(B, H),
                dcT=r(B, H))


def _lstm_check(hr, c, T, B, H):
    """Kernels 8 and 9 against their plain versions on the same inputs;
    returns (max forward abs err, max backward err / max |value|)."""
    got = hr.lstm_fwd(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    want = hr.lstm_fwd_plain(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    torch.cuda.synchronize()
    ferr = {n: (g - w).abs().max().item() for n, g, w in
            zip(("ys", "hT", "cT", "gates", "cs"), got, want)}
    check(max(ferr.values()) <= LSTM_FWD_TOL, "kernel 8 disagrees with its "
          "plain version at T=%d B=%d H=%d: %s > %g" % (T, B, H, ferr,
                                                        LSTM_FWD_TOL))
    args = (want[3], want[4], c["c0"], c["dys"], c["dhT"], c["dcT"], c["R"])
    got = hr.lstm_bwd(*args)
    want_b = hr.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    berr = {n: (g - w).abs().max().item() / w.abs().max().item() for n, g, w
            in zip(("dxp", "dh0", "dc0"), got, want_b)}
    check(max(berr.values()) <= LSTM_BWD_TOL, "kernel 9 disagrees with its "
          "plain version at T=%d B=%d H=%d: %s > %g of max |value|"
          % (T, B, H, berr, LSTM_BWD_TOL))
    return max(ferr.values()), max(berr.values()), args


def phase_lstm_kernels():
    """Kernels 8 and 9 against their plain versions at two ragged shapes,
    at the edges of their envelope, and at the LM's (T=35, B=128, H=650:
    both layers' recurrences have this shape, since embed = hidden), with
    times, bounds, and cuDNN's LSTM as the yardstick; returns the two
    ``kernels`` entries (without ``launches``)."""
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    # ragged shapes, then the envelope's edges: B = 1024 (batch tiles) and
    # H = 2048 (R streamed, not resident)
    for T, B, H in [(7, 3, 100), (5, 33, 257), (2, 1024, 40), (3, 64, 2048)]:
        ferr, berr, _ = _lstm_check(hr, _lstm_inputs(T, B, H, gen, dev),
                                    T, B, H)
        print("[lstm-kernels] T=%d B=%d H=%d: kernel 8 max abs err %.3g (tol "
              "%g), kernel 9 %.3g of max |value| (tol %g)"
              % (T, B, H, ferr, LSTM_FWD_TOL, berr, LSTM_BWD_TOL))
    T, B, H = LM["bptt"], LM["batch"], LM["hidden"]
    c = _lstm_inputs(T, B, H, gen, dev)
    ferr, berr, bargs = _lstm_check(hr, c, T, B, H)
    for name in ("lstm_fwd", "lstm_bwd"):
        print("[lstm-kernels] %s geometry at B=%d H=%d: %s"
              % (name, B, H, hr.geometry(name, B, H)))
    fwd_args = (c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    ms = time_ms(lambda: hr.lstm_fwd(*fwd_args))
    plain_ms = time_ms(lambda: hr.lstm_fwd_plain(*fwd_args))
    bms = time_ms(lambda: hr.lstm_bwd(*bargs))
    bplain_ms = time_ms(lambda: hr.lstm_bwd_plain(*bargs))

    # the yardstick: cuDNN's one-layer LSTM on the same function (its
    # input weights make x @ W^T + bW the projection the kernels are given)
    lstm = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev, generator=gen)
    W = torch.randn(4 * H, H, device=dev, generator=gen) * H ** -0.5
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W)
        lstm.bias_ih_l0.zero_()
        lstm.weight_hh_l0.copy_(c["R"])
        lstm.bias_hh_l0.copy_(c["bR"])
    h0, c0 = c["h0"][None], c["c0"][None]
    xp = torch.matmul(x, W.t()).contiguous()
    ys = hr.lstm_fwd(xp, c["h0"], c["c0"], c["R"], c["bR"])[0]
    with torch.no_grad():
        y_lib = lstm(x, (h0, c0))[0]
    err_lib = (ys - y_lib).abs().max().item()
    with torch.no_grad():
        lib_ms = time_ms(lambda: lstm(x, (h0, c0)))
    proj_ms = time_ms(lambda: torch.matmul(x, W.t()))
    # cuDNN's backward of the data and states only (its weights need no
    # gradient): the recurrence backward plus dx = dxp @ W
    xg = x.clone().requires_grad_()
    h0g, c0g = h0.clone().requires_grad_(), c0.clone().requires_grad_()
    for p in lstm.parameters():
        p.requires_grad_(False)
    y, (hT, cT) = lstm(xg, (h0g, c0g))
    grads = (c["dys"], c["dhT"][None], c["dcT"][None])
    lib_bms = time_ms(lambda: torch.autograd.grad(
        (y, hT, cT), (xg, h0g, c0g), grads, retain_graph=True))
    dx_ms = time_ms(lambda: torch.matmul(bargs[0], W))

    flops = 2.0 * T * B * H * 4 * H
    f4 = 4.0
    fbytes = f4 * (T * B * 4 * H * 2 + T * B * H * 2 + 4 * H * H + 4 * H
                   + 4 * B * H)
    bbytes = f4 * (T * B * 4 * H * 2 + T * B * H * 2 + 4 * H * H + 5 * B * H)
    fbound, fby = _bound(flops, fbytes)
    bbound, bby = _bound(flops, bbytes)
    print("[lstm-kernels] T=%d B=%d H=%d fp32: kernel 8 %.4f ms (%.2f TFLOP/s"
          "), plain %.4f ms, bound %.4f ms (%s); kernel 9 %.4f ms (%.2f "
          "TFLOP/s), plain %.4f ms, bound %.4f ms (%s); max err %.3g / %.3g "
          "of max (tol %g / %g)" % (T, B, H, ms, flops / ms / 1e9, plain_ms,
                                    fbound, fby, bms, flops / bms / 1e9,
                                    bplain_ms, bbound, bby, ferr, berr,
                                    LSTM_FWD_TOL, LSTM_BWD_TOL))
    print("[lstm-kernels] cuDNN LSTM (one layer, TF32 off, same weights): "
          "forward %.4f ms with its input projection (the projection's "
          "matmul alone %.4f ms), output within %.3g of kernel 8's; data and "
          "state backward %.4f ms with dx (dxp @ W alone %.4f ms)"
          % (lib_ms, proj_ms, err_lib, lib_bms, dx_ms))
    common = {"route": "cuda", "T": T, "B": B, "H": H,
              "calls_per_step": LM["layers"]}
    k8 = dict(common, name="lstm_fwd", source="mxnet_tpu_torch/csrc/"
              "lstm_fwd.cu", replaces="mxnet_tpu/ops/pallas_rnn.py:82",
              max_abs_err=ferr, call_ms=ms, call_plain_ms=plain_ms,
              call_bound_ms=fbound, bound_by=fby, call_library_ms=lib_ms,
              library="torch.nn.LSTM forward (cuDNN), input projection "
                      "included", projection_ms=proj_ms,
              max_abs_err_vs_cudnn=err_lib, tflops=flops / ms / 1e9)
    k9 = dict(common, name="lstm_bwd", source="mxnet_tpu_torch/csrc/"
              "lstm_bwd.cu", replaces="mxnet_tpu/ops/pallas_rnn.py:157",
              max_abs_err=berr, max_err_is="of max |value|", call_ms=bms,
              call_plain_ms=bplain_ms, call_bound_ms=bbound, bound_by=bby,
              call_library_ms=lib_bms,
              library="torch.autograd.grad of torch.nn.LSTM (cuDNN) for "
                      "data and states, dx included",
              dx_ms=dx_ms, tflops=flops / bms / 1e9)
    for k in (k8, k9):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            k[key] = k["call_" + key] * LM["layers"]    # a training step
    return [k8, k9]


# --------------------------------------------------------------------------
def gluon_lm(ctx, dropout):
    """bench.py's LM (bench.py:218-238) on ``ctx``: Embedding(33278, 650)
    -> LSTM(650, 2 layers) -> Dense(33278, flatten=False), weights from
    ``initialize()`` after ``random.seed(SEED)``, deferred shapes resolved
    by one batch, then hybridized; token ids from numpy seed 0, all below
    256, as the bench makes them."""
    from mxnet_tpu_torch import gluon, name, nd, random
    from mxnet_tpu_torch.gluon import nn, rnn
    random.seed(SEED)
    with name.NameManager():
        net = gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Embedding(LM["vocab"], LM["hidden"]))
            net.add(rnn.LSTM(LM["hidden"], num_layers=LM["layers"],
                             dropout=dropout))
            net.add(nn.Dense(LM["vocab"], flatten=False))
    net.initialize(ctx=ctx)
    np.random.seed(SEED)
    toks = np.random.randint(0, min(256, LM["vocab"]),
                             (LM["bptt"], LM["batch"]))
    x, y = nd.array(toks, ctx=ctx), nd.array(toks, ctx=ctx)
    net(x).wait_to_read()
    net.hybridize()
    return net, x, y


def _lm_trainer(net):
    from mxnet_tpu_torch import FusedTrainer, gluon
    return FusedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": LM["lr"]})


def phase_lm_training(card):
    """Train the bench's LM at full width on gpu(0): launch counts, train
    tokens/s, falling losses, and dropout on the card."""
    from mxnet_tpu_torch import gpu, random
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    fp32_exact()
    t0 = time.perf_counter()
    net, x, y = gluon_lm(gpu(0), LM["dropout"])
    params = net.collect_params()
    n_params = sum(int(np.prod(p.shape)) for p in params.values())
    ft = _lm_trainer(net)
    print("[lm-training] %d parameters in %d arrays, made on gpu(0) in "
          "%.2f s" % (n_params, len(params), time.perf_counter() - t0))
    tokens = LM["bptt"] * LM["batch"]

    # the main path: counts zeroed just before the first step, read after
    # the last timed one
    hr.lstm_fwd_launches = 0
    hr.lstm_bwd_launches = 0
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ft.step(x, y)
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss.asnumpy()))
    steps = len(losses)
    launches = {"lstm_fwd": hr.lstm_fwd_launches,
                "lstm_bwd": hr.lstm_bwd_launches}
    want = LM["layers"]
    print("[lm-training] %d steps ran %s launches (expected %d each a step)"
          % (steps, launches, want))
    check(all(v == want * steps for v in launches.values()),
          "launch counts %s over %d steps, expected %d each a step"
          % (launches, steps, want))
    check(all(math.isfinite(v) for v in losses), "non-finite loss: %s"
          % losses)
    check(losses[-1] < losses[0], "the loss did not fall over %d steps: %s"
          % (steps, losses))
    step_ms = float(np.median(times)) * 1e3
    tps = tokens / (step_ms / 1e3)
    print("[lm-training] vocab %d, hidden %d, %d layers, bptt %d, batch %d, "
          "fp32: %d timed steps after %d warm-up, median %.2f ms (min %.2f, "
          "max %.2f), %.1f train tokens/s on %s; losses %s"
          % (LM["vocab"], LM["hidden"], LM["layers"], LM["bptt"],
             LM["batch"], TIMED_STEPS, WARMUP_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, tps, card,
             ["%.4f" % v for v in losses]))

    # dropout on the card: the keep rate of one layer's mask, and the same
    # first loss from one seed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ones = torch.ones((LM["bptt"], LM["batch"], LM["hidden"]), device="cuda")
    keep = (rnn_ops.dropout(ones, LM["dropout"], gen) != 0).float().mean()
    keep = keep.item()
    firsts = []
    for s in (SEED + 7, SEED + 7, SEED + 8):
        random.seed(s)
        firsts.append(float(_lm_trainer(net).step(x, y).asnumpy()))
    print("[lm-training] dropout: keep rate %.5f (want %.1f within %g); "
          "first losses %s for seeds 7, 7, 8"
          % (keep, 1 - LM["dropout"], KEEP_TOL, firsts))
    check(abs(keep - (1 - LM["dropout"])) <= KEEP_TOL,
          "dropout keep rate %g" % keep)
    check(firsts[0] == firsts[1] and firsts[0] != firsts[2],
          "dropout does not follow the seed: %s" % firsts)
    return launches, {
        "tokens_per_s": tps, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "steps": steps, "losses": losses, "dropout_keep_rate": keep,
        "config": dict(LM, dtype="float32")}, (ft, x, y)


def phase_lm_vs_cpu(card):
    """The first step of the full-width LM without dropout, on the card
    and on the CPU (plain versions), from the same weights and batch."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.weights import from_jax_block
    fp32_exact()
    net, x, y = gluon_lm(gpu(0), 0.0)
    w_init = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    ft = _lm_trainer(net)
    loss = float(ft.step(x, y).asnumpy())
    ft.sync_params()
    w_gpu = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    del ft, net
    cnet, cx, cy = gluon_lm(cpu(), 0.0)
    from_jax_block(w_init, cnet, cpu())
    cft = _lm_trainer(cnet)
    t0 = time.perf_counter()
    closs = float(cft.step(cx, cy).asnumpy())
    cpu_s = time.perf_counter() - t0
    cft.sync_params()
    rel_loss = abs(loss - closs) / abs(closs)
    worst, worst_name = 0.0, None
    for k, p in cnet.collect_params().items():
        want = p.data().asnumpy() - w_init[k]
        got = w_gpu[k] - w_init[k]
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if err > worst:
            worst, worst_name = err, k
    print("[lm-vs-cpu] first step without dropout vs the CPU (plain "
          "versions, %.1f s): loss %.6f vs %.6f (rel %.3g, tol %g); every "
          "update within %.3g of its norm (tol %g; largest: %s)"
          % (cpu_s, loss, closs, rel_loss, LOSS_RTOL, worst, LM_UPDATE_TOL,
             worst_name))
    check(rel_loss <= LOSS_RTOL, "first-step loss differs from the CPU by "
          "%g > %g" % (rel_loss, LOSS_RTOL))
    check(worst <= LM_UPDATE_TOL, "the update of %s differs from the CPU's "
          "by %g > %g of its norm" % (worst_name, worst, LM_UPDATE_TOL))
    return {"loss_rel_err": rel_loss, "update_rel_err_max": worst,
            "update_rel_err_max_param": worst_name, "cpu_step_s": cpu_s}


def _lm_group(name: str) -> str:
    lname = name.lower()
    if "lstm_fwd_kernel" in name:
        return "kernel 8 (lstm_fwd)"
    if "lstm_bwd_kernel" in name:
        return "kernel 9 (lstm_bwd)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "multi_tensor_apply" in lname or "foreach" in lname:
        return "optimizer (SGD)"
    if any(k in lname for k in ("gemm", "xmma", "cutlass", "sm80_", "sm90_",
                                "nvjet", "splitk")):
        return "cuBLAS (projections, decoder, dR)"
    if "embedding" in lname or "indexing_backward" in lname \
            or "radix" in lname or "sort" in lname:
        return "embedding"
    if any(k in lname for k in ("logsumexp", "softmax", "gather", "scatter",
                                "log_", "exp")):
        return "cross-entropy"
    return "dropout and elementwise"


def phase_lm_profile(card, trainer, step_ms):
    """One profiled LM step: device time and launches by group, and the
    device's idle share against the unprofiled median step."""
    from torch.profiler import ProfilerActivity, profile
    ft, x, y = trainer
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ft.step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups, counts, by_name = {}, {}, {}
    for e in kernels:
        g = _lm_group(e.name)
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    device_ms = sum(groups.values()) / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    traced = (counts.get("kernel 8 (lstm_fwd)", 0),
              counts.get("kernel 9 (lstm_bwd)", 0))
    check(traced == (LM["layers"], LM["layers"]), "profile saw %d kernel-8 "
          "and %d kernel-9 launches in one step" % traced)
    idle = max(0.0, 1 - device_ms / step_ms)
    print("[lm-profile] one step: %.2f ms device busy, %.2f ms wall "
          "unprofiled (%.1f%% idle), %.2f ms wall profiled; %d launches on "
          "%s" % (device_ms, step_ms, 100 * idle, wall_ms, len(kernels),
                  card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[lm-profile]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (g, us / 1e3, 100.0 * us / 1e3 / device_ms, counts[g]))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print("[lm-profile]   top: %7.3f ms/step, %3d launches  %s [%s]"
              % (us / 1e3, n, name[:80], _lm_group(name)))
    return {"step_device_ms": device_ms, "idle_share": idle,
            "step_wall_ms_profiled": wall_ms, "launches_per_step":
            len(kernels), "device_ms_by_group": {g: us / 1e3 for g, us in
                                                 groups.items()},
            "launches_by_group": counts}


# --------------------------------------------------------------------------
def resnet_params(arg_names, arg_shapes, aux_names, aux_shapes, seed):
    """Seeded weights that keep a random pre-activation ResNet-50's
    activations near unit scale (He-normal convs, the last conv of each
    residual branch scaled down, logits a few units wide) with positive
    moving variances, under the checkpoint's arg:/aux: prefixes."""
    r = np.random.default_rng(seed)
    out = {}
    for n, s in zip(arg_names, arg_shapes):
        if n == "data":
            continue
        if n.endswith("_weight") and len(s) == 4:
            v = r.standard_normal(s) * math.sqrt(2.0 / np.prod(s[1:]))
            if n.endswith("_conv3_weight"):
                v *= 0.2
        elif n.endswith("_weight"):
            v = r.standard_normal(s) / math.sqrt(s[1])
        elif n.endswith("_gamma"):
            v = r.uniform(0.8, 1.2, s)
        else:                                  # betas and biases
            v = r.standard_normal(s) * 0.05
        out["arg:" + n] = v.astype(np.float32)
    for n, s in zip(aux_names, aux_shapes):
        v = (r.uniform(0.5, 1.5, s) if n.endswith("_moving_var")
             else r.standard_normal(s) * 0.05)
        out["aux:" + n] = v.astype(np.float32)
    return out


def resnet50_probs():
    """The served graph, full-width ResNet-50's softmax over ``fc1_output``,
    and its seeded weights."""
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.models import resnet
    net = resnet.get_symbol(num_classes=1000, num_layers=50)
    probs = sym.softmax(net.get_internals()["fc1_output"], axis=1)
    args, outs, auxs = probs.infer_shape(data=(1, 3, 224, 224))
    check(outs == [(1, 1000)], "ResNet-50 output shape %s" % outs)
    params = resnet_params(probs.list_arguments(), args,
                           probs.list_auxiliary_states(), auxs, SEED)
    return probs, params


def phase_serving(card):
    """Serve full-width ResNet-50 on gpu(0); returns (launches, summary)."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.ops import hopper_conv as hc
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.weights import from_jax_params
    fp32_exact()

    probs, params = resnet50_probs()
    print("[serving] ResNet-50: %d parameters, %d aux states" % (
        sum(v.size for k, v in params.items() if k.startswith("arg:")),
        sum(k.startswith("aux:") for k in params)))
    js = probs.tojson()

    server = ModelServer(js, from_jax_params(params, gpu(0)),
                         {"data": (3, 224, 224)}, ctx=gpu(0),
                         max_batch_size=BATCH, batch_timeout_ms=5.0)
    server.start()
    print("[serving] buckets %s warmed up in %.2f s"
          % (server.stats()["buckets"], server.warmup_seconds))

    rng = np.random.default_rng(SEED + 1)
    rows = [1, 3, 8, 2, 5, 4, 7, 6]
    classes = ["realtime", "standard", "batch"]
    images = rng.standard_normal((sum(rows), 3, 224, 224)).astype(np.float32)
    offsets = np.cumsum([0] + rows)

    def burst(n_clients, per_client, make_request):
        """n_clients threads, each submitting per_client requests in turn;
        returns [(client, i, latency_s, outputs)] and the wall seconds."""
        results, errors = [], []
        lock = threading.Lock()
        go = threading.Barrier(n_clients + 1)

        def client(c):
            go.wait()
            try:
                for i in range(per_client):
                    inputs, slo = make_request(c, i)
                    t0 = time.perf_counter()
                    out = server.predict(inputs, slo_class=slo, timeout=300)
                    with lock:
                        results.append((c, i, time.perf_counter() - t0, out))
            except Exception as e:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        go.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not errors, "requests failed: %s" % errors[:3])
        check(not any(t.is_alive() for t in threads), "clients hung")
        return results, wall

    # the main path: counts zeroed just before, read just after
    hc.launches = 0
    batches0 = server.batches
    answers, wall = burst(len(rows), 1, lambda c, i: (
        {"data": images[offsets[c]:offsets[c + 1]]}, classes[c % 3]))
    loop_rows, n_clients, per_client = 8, 8, 8
    loop_img = rng.standard_normal((loop_rows, 3, 224, 224)) \
        .astype(np.float32)
    loop, loop_wall = burst(n_clients, per_client, lambda c, i: (
        {"data": loop_img}, "standard"))
    launches = hc.launches
    batches = server.batches - batches0
    server.stop()
    print("[serving] %d forwards ran %d kernel launches (%.2f per forward)"
          % (batches, launches, launches / max(batches, 1)))
    check(batches > 0 and launches == 16 * batches,
          "expected 16 conv kernel launches per forward, got %d over %d "
          "forwards" % (launches, batches))

    lat = sorted(r[2] * 1e3 for r in answers)
    print("[serving] %d concurrent requests (%d images, rows %s, classes "
          "%s): latencies ms %s, %.1f images/s on %s" % (
              len(rows), sum(rows), rows, [classes[c % 3] for c in
                                           range(len(rows))],
              ["%.2f" % v for v in lat], sum(rows) / wall, card))
    loop_lat = np.array([r[2] * 1e3 for r in loop])
    loop_ips = n_clients * per_client * loop_rows / loop_wall
    print("[serving] closed loop, %d clients x %d requests of %d images: "
          "%.1f images/s, latency p50 %.2f ms p99 %.2f ms on %s" % (
              n_clients, per_client, loop_rows, loop_ips,
              np.percentile(loop_lat, 50), np.percentile(loop_lat, 99), card))

    # reference: the same graph and weights on the CPU (plain versions)
    t0 = time.perf_counter()
    ref_pred = Predictor(js, from_jax_params(params, cpu()), ctx=cpu(),
                         input_shapes={"data": images.shape})
    ref = ref_pred.forward(data=images)[0].asnumpy()
    print("[serving] CPU reference forward of %d images in %.2f s"
          % (len(images), time.perf_counter() - t0))
    worst = 0.0
    for c, _, _, out in answers:
        got = out[0]
        want = ref[offsets[c]:offsets[c + 1]]
        check(got.shape == want.shape and np.isfinite(got).all(),
              "request %d: bad answer shape %s" % (c, got.shape))
        check((got.argmax(1) == want.argmax(1)).all(),
              "request %d: top-1 differs from the CPU run" % c)
        worst = max(worst, float(np.abs(got - want).max()))
    print("[serving] all %d answers match the CPU run: same top-1, max "
          "|dp| %.3g (tol %g), max p %.4f" % (len(answers), worst, PROB_TOL,
                                              float(ref.max())))
    check(worst <= PROB_TOL, "probabilities differ by %g > %g"
          % (worst, PROB_TOL))
    return launches, {"images_per_s": loop_ips,
                      "latency_p50_ms": float(np.percentile(loop_lat, 50)),
                      "latency_p99_ms": float(np.percentile(loop_lat, 99))}


def _kernel_group(name: str) -> str:
    if "taps_conv_kernel" in name:
        return "implicit_gemm_conv (port)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    lname = name.lower()
    if any(k in lname for k in ("conv", "gemm", "xmma", "cudnn", "cutlass")):
        return "cuDNN/cuBLAS (7x7, 1x1, fc)"
    return "elementwise, pooling, layout"


def phase_profile(card):
    """Where a batch-32 forward's time goes: host wall per forward (H2D
    copy, forward, D2H copy, as the server runs it) against device busy
    time from torch.profiler, by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.weights import from_jax_params
    fp32_exact()
    probs, params = resnet50_probs()
    shape = (BATCH, 3, 224, 224)
    pred = Predictor(probs.tojson(), from_jax_params(params, gpu(0)),
                     ctx=gpu(0), input_shapes={"data": shape})
    feed = np.random.default_rng(SEED + 2).standard_normal(shape) \
        .astype(np.float32)
    step = lambda: pred.forward(data=feed)[0].asnumpy()
    for _ in range(3):
        step()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        groups[_kernel_group(e.key)] = groups.get(_kernel_group(e.key),
                                                  0.0) + us
        top.append((us, e.count, e.key))
    device_ms = sum(groups.values()) / n / 1e3
    print("[profile] batch %d forward as served: %.2f ms wall, %.2f ms "
          "device busy (%.1f%% idle), %.1f images/s on %s" % (
              BATCH, wall_ms, device_ms,
              100.0 * max(0.0, 1 - device_ms / wall_ms),
              BATCH / wall_ms * 1e3, card))
    check(device_ms > 0, "the profiler recorded no device time")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[profile]   %-30s %7.3f ms/forward (%.1f%% of device time)"
              % (g, us / n / 1e3, 100.0 * us / n / 1e3 / device_ms))
    for us, count, key in sorted(top, reverse=True)[:8]:
        print("[profile]   top: %7.3f ms/forward, %4d launches/forward  %s"
              % (us / n / 1e3, count // n, key[:90]))
    return {"forward_wall_ms": wall_ms, "forward_device_ms": device_ms,
            "device_ms_by_group": {g: us / n / 1e3
                                   for g, us in groups.items()}}


# --------------------------------------------------------------------------
def gluon_resnet50(ctx, batch):
    """Full-width Gluon ResNet-50 v1 on ``ctx`` with the weights that
    ``net.initialize()`` draws after ``random.seed(SEED)`` (Uniform(0.07)
    weights, BatchNorm at gamma 1, beta 0, moving mean 0 and variance 1),
    and one seeded batch: 224 px images from U[0, 1) and class labels as
    float32, as bench.py makes them."""
    from mxnet_tpu_torch import name, nd, random
    from mxnet_tpu_torch.gluon.model_zoo import vision
    random.seed(SEED)
    with name.NameManager():
        net = vision.resnet50_v1()
    net.initialize(ctx=ctx)
    net.hybridize()
    r = np.random.default_rng(SEED + 4)
    x = r.uniform(size=(batch, 3, 224, 224)).astype(np.float32)
    y = r.integers(0, 1000, (batch,)).astype(np.float32)
    return net, nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)


def wgrad_reductions_per_step():
    """Launches of kernel 2's reduction pass in one batch-32 training step:
    one for each 3x3 convolution whose wgrad rows are split."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(count for C, H, count in GLUON_3X3
               if hc.wgrad_splits(BATCH * H * H, C, C, 9, sms) > 1)


def _conv3x3_weights(net):
    return {k: p for k, p in net.collect_params().items()
            if k.endswith("_weight") and p.shape[2:] == (3, 3)}


def phase_training(card):
    """Train full-width ResNet-50 v1 (224 px, batch 32, fp32) with
    FusedTrainer SGD (lr 0.1, momentum 0.9) on gpu(0): the first step is
    checked against the same step on the CPU (the plain versions), then
    timed steps with the launch counters read around them."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.fused import FusedTrainer
    from mxnet_tpu_torch.ops import hopper_conv as hc
    from mxnet_tpu_torch.weights import from_jax_block
    fp32_exact()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    t0 = time.perf_counter()
    net, x, y = gluon_resnet50(gpu(0), BATCH)
    net(x).wait_to_read()                     # deferred shapes, weights made
    w_init = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    convs = sorted(_conv3x3_weights(net))
    check(len(w_init) == 299 and len(convs) == 16,
          "resnet50_v1 has %d parameters, %d 3x3 weights"
          % (len(w_init), len(convs)))
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd", dict(opt))
    print("[training] resnet50_v1: %d parameters in %d arrays, made on "
          "gpu(0) in %.2f s" % (sum(v.size for v in w_init.values()),
                               len(w_init), time.perf_counter() - t0))

    # the main path: counts zeroed just before the first step, read after
    # the last timed one
    hc.launches = 0
    hc.wgrad_launches = 0
    hc.wgrad_reduce_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0 = float(ft.step(x, y).asnumpy())
    first_s = time.perf_counter() - t0
    ft.sync_params()
    w_gpu = {k: net.collect_params()[k].data().asnumpy() for k in convs}
    losses, times = [loss0], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ft.step(x, y)
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss.asnumpy()))
    steps = 1 + WARMUP_STEPS + TIMED_STEPS
    launches = {"implicit_gemm_conv": hc.launches,
                "taps_wgrad": hc.wgrad_launches,
                "taps_wgrad reduction": hc.wgrad_reduce_launches}
    want = {"implicit_gemm_conv": 32, "taps_wgrad": 16,
            "taps_wgrad reduction": wgrad_reductions_per_step()}
    print("[training] %d steps ran %s launches (per step %s; expected %s)"
          % (steps, launches, {k: v / steps for k, v in launches.items()},
             want))
    check(all(launches[k] == want[k] * steps for k in want),
          "launch counts %s over %d steps, expected %s per step"
          % (launches, steps, want))
    check(all(math.isfinite(v) for v in losses),
          "non-finite loss: %s" % losses)
    step_ms = float(np.median(times)) * 1e3
    ips = BATCH / (step_ms / 1e3)
    print("[training] batch %d, first step %.1f ms, then %d timed steps: "
          "median %.2f ms (min %.2f, max %.2f), %.1f images/s on %s; "
          "losses %s" % (BATCH, first_s * 1e3, TIMED_STEPS, step_ms,
                         min(times) * 1e3, max(times) * 1e3, ips, card,
                         ["%.4f" % v for v in losses]))

    # reference: the same first step on the CPU from the same weights
    cnet, cx, cy = gluon_resnet50(cpu(), BATCH)
    from_jax_block(w_init, cnet, cpu())
    cft = FusedTrainer(cnet, "softmax_cross_entropy", "sgd", dict(opt))
    t0 = time.perf_counter()
    closs = float(cft.step(cx, cy).asnumpy())
    cpu_s = time.perf_counter() - t0
    cft.sync_params()
    rel_loss = abs(loss0 - closs) / abs(closs)
    worst = 0.0
    for k in convs:
        want = cnet.collect_params()[k].data().asnumpy() - w_init[k]
        got = w_gpu[k] - w_init[k]
        worst = max(worst, float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
    print("[training] first step vs the CPU (plain versions, %.1f s): loss "
          "%.6f vs %.6f (rel %.3g, tol %g); 3x3 weight updates within %.3g "
          "of their norm (tol %g)" % (cpu_s, loss0, closs, rel_loss,
                                       LOSS_RTOL, worst, UPDATE_TOL))
    check(rel_loss <= LOSS_RTOL, "first-step loss differs from the CPU by "
          "%g > %g" % (rel_loss, LOSS_RTOL))
    check(worst <= UPDATE_TOL, "a 3x3 weight update differs from the CPU's "
          "by %g > %g of its norm" % (worst, UPDATE_TOL))
    del cnet, cft, cx, cy
    return launches, {
        "images_per_s": ips, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "first_step_ms": first_s * 1e3, "losses": losses,
        "cpu_check": {"batch": BATCH, "loss_rel_err": rel_loss,
                      "update_rel_err_max": worst, "cpu_step_s": cpu_s}}, \
        (ft, x, y)


def _train_group(name: str) -> str:
    lname = name.lower()
    if "taps_wgrad_kernel" in name:
        return "kernel 2 wgrad partial pass"
    if "sum_splits_kernel" in name:
        return "kernel 2 wgrad reduction pass"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "copy" in lname or "nchwtonhwc" in lname or "nhwctonchw" in lname:
        return "layout copies"
    if "multi_tensor_apply" in lname or "foreach" in lname:
        return "optimizer (SGD)"
    if any(k in lname for k in ("conv", "gemm", "xmma", "cudnn", "cutlass",
                                "sm80_", "sm90_")):
        return "cuDNN/cuBLAS (7x7 stem, 1x1, fc)"
    return "BN and elementwise"


def phase_training_profile(card, trainer, step_ms):
    """Where one training step's device time goes (torch.profiler): kernel
    1 forward and dgrad told apart by order (a step's first 16 launches are
    the forward).  The idle share is taken against ``step_ms``, the median
    unprofiled step, since the profiler slows the host's dispatch."""
    from torch.profiler import ProfilerActivity, profile
    ft, x, y = trainer
    n = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ft.step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    groups, counts, taps_seen = {}, {}, 0
    for e in kernels:
        if "taps_conv_kernel" in e.name:
            g = ("kernel 1 forward" if taps_seen % 32 < 16
                 else "kernel 1 dgrad")
            taps_seen += 1
        else:
            g = _train_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        counts[g] = counts.get(g, 0) + 1
    check(taps_seen == 32 * n, "profile saw %d kernel-1 launches in %d "
          "steps" % (taps_seen, n))
    traced = (counts.get("kernel 2 wgrad partial pass", 0),
              counts.get("kernel 2 wgrad reduction pass", 0))
    check(traced == (16 * n, wgrad_reductions_per_step() * n),
          "profile saw %d wgrad partial and %d reduction launches in %d "
          "steps" % (traced + (n,)))
    device_ms = sum(groups.values()) / n / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    idle = max(0.0, 1 - device_ms / step_ms)
    print("[train-profile] one batch-%d step: %.2f ms device busy, %.2f ms "
          "wall unprofiled (%.1f%% idle), %.2f ms wall profiled; %d "
          "launches a step on %s" % (BATCH, device_ms, step_ms, 100 * idle,
                                     wall_ms, len(kernels) // n, card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[train-profile]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (g, us / n / 1e3, 100.0 * us / n / 1e3 / device_ms,
                 counts[g] // n))
    return {"step_device_ms": device_ms, "idle_share": idle,
            "step_wall_ms_profiled": wall_ms,
            "launches_per_step": len(kernels) // n,
            "device_ms_by_group": {g: us / n / 1e3
                                   for g, us in groups.items()},
            "launches_by_group": {g: c // n for g, c in counts.items()}}


def _kernel_entries(fwd, wgrad, dgrad, launches, serving_launches):
    """The ``kernels`` line: times summed over one training step's calls
    at batch 32 (kernel 1: the 16 forwards and 16 dgrads; kernel 2: the 16
    wgrads, both passes), launches from the training run (kernel 2: its
    partial and reduction passes together, and each apart)."""
    by_shape = {(s["C"], s["H"]): s for s in fwd["shapes"]
                if s["class"] == "s1"}

    def step_sum(records, key, fwd_too=False):
        total = sum(r[key] * r["instances_per_step"] for r in records)
        if fwd_too:
            total += sum(by_shape[(C, H)][key] * count
                         for C, H, count in GLUON_3X3)
        return total

    k1 = {"name": "implicit_gemm_conv", "route": "cuda",
          "source": fwd["source"], "replaces": fwd["replaces"],
          "launches": launches["implicit_gemm_conv"],
          "max_abs_err": max([fwd["max_abs_err"]]
                             + [r["max_abs_err"] for r in dgrad])}
    k2 = {"name": "taps_wgrad", "route": "cuda",
          "source": "mxnet_tpu_torch/csrc/taps_wgrad.cu",
          "replaces": "mxnet_tpu/ops/pallas_conv.py:165",
          "launches": (launches["taps_wgrad"]
                       + launches["taps_wgrad reduction"]),
          "partial_launches": launches["taps_wgrad"],
          "reduce_launches": launches["taps_wgrad reduction"],
          "max_abs_err": max(r["max_abs_err"] for r in wgrad)}
    for entry, records, fwd_too in ((k1, dgrad, True), (k2, wgrad, False)):
        for key in ("ms", "plain_ms", "bound_ms"):
            entry[key] = step_sum(records, key, fwd_too)
        entry["bound_by"] = "operations" if all(
            r["bound_by"] == "operations" for r in records) else "bytes"
        entry["library_ms"] = step_sum(records, "library_ms", fwd_too)
    k1["dgrad_shapes"] = dgrad
    k1["serving_forward"] = {"launches": serving_launches, **{
        k: fwd[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                            "tflops_per_forward", "shapes")}}
    k2["shapes"] = wgrad
    return [k1, k2]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import mxnet_tpu_torch  # noqa: F401  (fails outside the repository)
    card = card_line()
    print("[device] %s | %s | torch %s, CUDA %s" % (
        torch.cuda.get_device_name(0), card, torch.__version__,
        torch.version.cuda))
    t0 = time.perf_counter()
    phase_build()
    fwd = phase_kernels()
    wgrad, dgrad = phase_backward_kernels()
    lstm = phase_lstm_kernels()
    serving_launches, served = phase_serving(card)
    served["profile"] = phase_profile(card)
    print("[serving] summary " + json.dumps(dict(served, card=card)))
    launches, trained, trainer = phase_training(card)
    trained["profile"] = phase_training_profile(card, trainer,
                                                trained["step_ms"])
    del trainer
    print("[training] summary " + json.dumps(dict(trained, card=card)))
    lm_launches, lm, trainer = phase_lm_training(card)
    lm["profile"] = phase_lm_profile(card, trainer, lm["step_ms"])
    del trainer
    lm["cpu_check"] = phase_lm_vs_cpu(card)
    print("[lm-training] summary " + json.dumps(dict(lm, card=card)))
    for k in lstm:
        k["launches"] = lm_launches[k["name"]]
    print("[done] all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": _kernel_entries(
        fwd, wgrad, dgrad, launches, serving_launches) + lstm}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
