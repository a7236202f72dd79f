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
        nbytes = 4.0 * (x.numel() + w.numel() + BATCH * O * Ho * Ho)
        bound_ops, bound_bytes = flops / PEAK_FP32, nbytes / HBM_BYTES
        rec = {"class": kind, "N": BATCH, "C": C, "O": O, "H": H, "W": H,
               "Ho": Ho, "instances_per_forward": count,
               "max_abs_err": err, "max_rel_err": rel,
               "max_abs_err_vs_cudnn": err_lib, "tol": KERNEL_TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(bound_ops, bound_bytes) * 1e3,
               "bound_by": "operations" if bound_ops >= bound_bytes
               else "bytes",
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
    entry = phase_kernels()
    launches, served = phase_serving(card)
    served["profile"] = phase_profile(card)
    entry = {"name": entry.pop("name"), "route": entry.pop("route"),
             "source": entry.pop("source"), "replaces": entry.pop("replaces"),
             "launches": launches, **entry}
    print("[serving] summary " + json.dumps(dict(served, card=card)))
    print("[done] all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
