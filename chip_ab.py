#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in turns, so that two versions
are measured on the same card and host.  Each TREE is a checkout's root
directory; each is measured in a process of its own, in the order given
(``OLD NEW NEW OLD``), which builds that checkout's kernels and imports its
``mxnet_tpu_torch``.  The timing and profiling are ``chip_smoke.py``'s own
(``timed_steps``, ``profiled_kernels``, ``time_ms``), from the
``chip_smoke.py`` beside this script.  It needs a CUDA card.

    python3 chip_ab.py steps TREE...   # ResNet-50 training steps
    python3 chip_ab.py w1x1 TREE...    # kernel 12 at a bf16 step's 15 shapes
    python3 chip_ab.py stream          # host cost of a stream handle

``steps`` trains each checkout's Gluon ``resnet50_v1`` with
``FusedTrainer`` (SGD lr 0.1, momentum 0.9, ``chip_smoke.gluon_resnet50``'s
weights and batch): fp32 at batch 32 (``chip_smoke.py``'s phase 5) and
bf16 at batch 128 (phase 14); the median timed step gives images/s, and two
profiled steps the device busy time and the idle share.  ``w1x1`` times
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
    modes = {"steps": steps, "w1x1": w1x1}
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
