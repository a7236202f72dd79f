#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in turns, so that two versions
are measured on the same card and host.  Each TREE is a checkout's root
directory; each is measured in a process of its own, in the order given
(``OLD NEW NEW OLD``), which builds that checkout's kernels and imports its
``mxnet_tpu_torch``.  The timing and profiling are ``chip_smoke.py``'s own
(``timed_steps``, ``profiled_kernels``, ``time_ms``), from the
``chip_smoke.py`` beside this script.  It needs a CUDA card.

    python3 chip_ab.py steps TREE...   # ResNet-50 training steps
    python3 chip_ab.py served TREE...  # the batch-32 fp32 served forward
    python3 chip_ab.py infer16 TREE... # the batch-128 bf16 inference forward
    python3 chip_ab.py w1x1 TREE...    # kernel 12 at a bf16 step's 15 shapes
    python3 chip_ab.py stream          # host cost of a stream handle

``steps`` trains each checkout's Gluon ``resnet50_v1`` with
``FusedTrainer`` (SGD lr 0.1, momentum 0.9, ``chip_smoke.gluon_resnet50``'s
weights and batch): fp32 at batch 32 (``chip_smoke.py``'s phase 5) and
bf16 at batch 128 (phase 14); the median timed step gives images/s, and two
profiled steps the device busy time and the idle share.  ``served`` runs
the served ResNet-50 (``chip_smoke.resnet50_probs``' graph and weights)
through a ``Predictor`` at batch 32, fp32, as the server runs a batch
(host copy in, forward, host copy out; ``chip_smoke.py``'s phase 4):
images/s from the median timed forward, and two profiled forwards the
busy time, the idle share and kernel 1's share (its convolution and split
sum).  ``infer16`` binds ``chip_smoke._bf16_module``'s bf16 Module
(``bench.py --bf16``'s, under ``MXNET_TPU_BF16``) and times its inference
forward at batch 128 (phase 16's, every identity bottleneck on kernel 13):
images/s, busy time, idle share and kernel 13's share.  ``w1x1`` times
kernel 12 (``hopper_conv.conv1x1_wgrad``) at the 15 shapes of
``chip_smoke.RESNET50_1X1`` at batch 128, each checked against its plain
version.  Each checkout prints one line ``AB {json}``.  ``stream`` prints
the host microseconds a call of the CUDA build's raw stream accessor and of
``torch.cuda.current_stream(...).cuda_stream`` take, as ``STREAM {json}``.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke(tree):
    """``chip_smoke`` from beside this script, with ``tree``'s port first
    on the path; the port's kernels built."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mxnet_tpu_torch
    if not mxnet_tpu_torch.__file__.startswith(tree):
        raise RuntimeError("imported %s, not %s's port"
                           % (mxnet_tpu_torch.__file__, tree))
    cs.fp32_exact()
    cs.phase_build()
    return cs


def steps(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.fused import FusedTrainer

    def run(batch, dtype):
        torch.cuda.empty_cache()
        net, x, y = cs.gluon_resnet50(gpu(0), batch)
        net(x).wait_to_read()
        ft = FusedTrainer(net, "softmax_cross_entropy", "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          **({"dtype": dtype} if dtype else {}))
        ft.step(x, y)
        times = cs.timed_steps(lambda: ft.step(x, y))
        step_ms = float(np.median(times)) * 1e3
        n = 2
        kernels, _ = cs.profiled_kernels(lambda: ft.step(x, y), n)
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
        return {"step_ms": step_ms, "images_per_s": batch / step_ms * 1e3,
                "busy_ms": busy_ms, "idle": max(0.0, 1 - busy_ms / step_ms),
                "steps_ms": [round(t * 1e3, 2) for t in times]}

    return {"card": cs.card_line(), "fp32_b32": run(32, None),
            "bf16_b128": run(128, "bfloat16")}


def _forward_profile(cs, step, step_ms, names):
    """Busy ms a call of ``step`` over two profiled calls, the idle share
    against ``step_ms``, and the busy ms of the kernels whose names hold
    one of ``names``."""
    n = 2
    kernels, _ = cs.profiled_kernels(step, n)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
    mine = sum(e.time_range.elapsed_us() for e in kernels
               if any(k in e.name for k in names)) / n / 1e3
    return {"busy_ms": busy, "idle": max(0.0, 1 - busy / step_ms),
            "kernel_ms": mine}


def served(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.weights import from_jax_params
    probs, params = cs.resnet50_probs()
    shape = (cs.BATCH, 3, 224, 224)
    pred = Predictor(probs.tojson(), from_jax_params(params, gpu(0)),
                     ctx=gpu(0), input_shapes={"data": shape})
    feed = np.random.default_rng(cs.SEED + 2).standard_normal(shape) \
        .astype(np.float32)

    def step():
        return pred.forward(data=feed)[0].asnumpy()
    times = cs.timed_steps(step)
    step_ms = float(np.median(times)) * 1e3
    out = {"card": cs.card_line(), "forward_ms": step_ms,
           "images_per_s": cs.BATCH / step_ms * 1e3,
           "forwards_ms": [round(t * 1e3, 3) for t in times]}
    out.update(_forward_profile(cs, step, step_ms,
                                ("taps_conv_kernel", "fp32_3x3_conv")))
    torch.cuda.synchronize()
    return out


def infer16(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch import gpu
    mod = cs._bf16_module(gpu(0), True)
    batch, _ = cs._bf16_batch(gpu(0))

    def step():
        mod.forward(batch, is_train=False)
        mod.get_outputs()[0].wait_to_read()
    step()
    times = cs.timed_steps(step)
    step_ms = float(np.median(times)) * 1e3
    B = cs.BF16MOD["batch"]
    out = {"card": cs.card_line(), "forward_ms": step_ms,
           "images_per_s": B / step_ms * 1e3,
           "forwards_ms": [round(t * 1e3, 3) for t in times]}
    out.update(_forward_profile(cs, step, step_ms, ("fused_bottleneck",)))
    torch.cuda.synchronize()
    return out


def w1x1(tree):
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch.ops import hopper_conv as hc
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    shapes, total = {}, 0.0
    for C, O, H, stride, count in cs.RESNET50_1X1:
        Hi = H * stride
        x = torch.randn(cs.BF16_BATCH, Hi, Hi, C, device=dev,
                        generator=gen).bfloat16()
        g = torch.randn(cs.BF16_BATCH, H, H, O, device=dev,
                        generator=gen).bfloat16()
        got = hc.conv1x1_wgrad(x, g, stride)
        want = hc.conv1x1_wgrad_plain(x, g, stride)
        err = ((got - want).abs().max() / want.abs().max()).item()
        cs.check(err <= cs.W1X1_TOL, "kernel 12 disagrees at C=%d O=%d %d "
                 "px: %g" % (C, O, H, err))
        ms = cs.time_ms(lambda: hc.conv1x1_wgrad(x, g, stride))
        shapes["%dx%d %dpx s%d" % (C, O, H, stride)] = ms
        total += ms * count
        del x, g, got, want
    return {"card": cs.card_line(), "ms": shapes, "step_ms": total}


def stream():
    import torch
    raw = torch._C._cuda_getCurrentRawStream
    dev = torch.device("cuda", 0)
    n = 100000
    out = {}
    for name, fn in (("raw", lambda: raw(0)),
                     ("current_stream", lambda: torch.cuda.current_stream(
                         dev).cuda_stream)):
        for _ in range(1000):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name + "_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def main(argv):
    modes = {"steps": steps, "served": served, "infer16": infer16,
             "w1x1": w1x1}
    if len(argv) == 4 and argv[1] == "--one":
        tree = os.path.abspath(argv[3])
        print("AB " + json.dumps(dict(modes[argv[2]](tree), tree=argv[3])),
              flush=True)
        return 0
    if len(argv) == 2 and argv[1] == "stream":
        print("STREAM " + json.dumps(stream()), flush=True)
        return 0
    if len(argv) < 3 or argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[2:]:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", argv[1], tree])
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
