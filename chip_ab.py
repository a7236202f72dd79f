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
    python3 chip_ab.py tfm TREE...     # gpt2-small training steps
    python3 chip_ab.py ring TREE...    # the long-context ring's forward+backward
    python3 chip_ab.py lm TREE...      # the LSTM LM's training steps
    python3 chip_ab.py stream          # host cost of a stream handle
    python3 chip_ab.py ablate          # what limits the flash attention forward
    python3 chip_ab.py ablate bwd      # what limits the fused attention backward
    python3 chip_ab.py ablate lstm     # what limits kernels 8 and 9 (the LSTM)

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
version.  ``tfm`` trains ``chip_smoke.tfm_module``'s gpt2-small (``bench.py
--transformer``'s Module: batch 16, T 1,024, fp32, SGD) through the fused
step, as phase 9 does: train tokens/s from the median timed step, and two
profiled steps the busy time, the idle share, and the attention
backward's and forward's ms and shares of the busy time (the fused backward
and its dq sum, or the two kernels it replaced, whichever the checkout has;
kernel 5, ``flash_fwd_kernel``).  ``ring`` runs phase 11's main path,
``models.long_context_attention`` at ``chip_smoke.LONG`` (T 32,768, causal,
sp 8 entries of cuda:0), forward and backward of ``sum(out * g)``: the
median of 5 timed forward+backward calls after 2 warm-ups, and one
profiled call's busy time and kernel 4's ms.  ``lm`` trains phase 7's LSTM
LM (``chip_smoke.gluon_lm``: ``bench.py``'s 2-layer LSTM of 650, vocabulary
33,278, bptt 35, batch 128, fp32, dropout 0.2) with ``FusedTrainer`` (SGD
lr 0.5): train tokens/s from the median timed step, and two profiled steps
the busy time, the idle share, and kernels 8's and 9's ms and shares of
the busy time.  Each checkout prints one line ``AB {json}``.  ``stream``
prints the host microseconds a call of the CUDA build's raw stream
accessor and of ``torch.cuda.current_stream(...).cuda_stream`` take, as
``STREAM {json}``.
``ablate`` builds variants of this checkout's ``csrc/flash_attn_fwd.cu``,
each with one change made by text substitution (``FWD_VARIANTS``: one
phase emptied, so that its time against the source's is what the phase
costs: the S product, the softmax's expf and row max, the P.V product,
the K/V copies; other unroll factors, a 3-slot ring, 8 rows a lane with
64- or 32-key tiles, d-outer S, 2-CTA launch bounds), and the forward as it
was before its redesign (``ablation/flash_attn_fwd_4x4.cu``: 4 x 4
register tiles, K and V loaded between barriers); it checks the correct
ones against ``flash_fwd_plain`` or ``flash_stats_plain`` and times all of
them in turns at gpt2-small's call (kernel 5) and the ring's two per-shard
calls (kernel 4), one line ``ABLATION {json}`` a shape with each variant's
ms and TFLOP/s and each emptied phase's ms and TFLOP/s.  ``ablate bwd``
does the same for ``csrc/flash_attn_bwd.cu`` (``BWD_VARIANTS``: one phase's
loop emptied; other unroll factors; 512 threads at 4 x 4 register tiles)
against ``flash_bwd_plain``.  ``ablate lstm`` builds kernels 8 and 9 as
they stood before their redesign (``ablation/lstm_fwd_before.cu``,
``lstm_bwd_before.cu``) and variants of each, and the redesigned
``csrc/lstm_fwd.cu`` and ``lstm_bwd.cu`` (``lstm_common.cuh`` pasted in)
with their variants: one phase emptied or skipped (the product, the
barriers or grid sync, the exchange's copies, the stores, the gathers or
prefetches, the groups' partial sums; a few cumulatively), other splits
of the product forced on ``hopper_rnn.lstm_plan``, other unrolls, thread
mappings, launch bounds, fast-math activations.  The correct ones are
checked against ``lstm_fwd_plain`` / ``lstm_bwd_plain``; all are timed in
turns at the LM's call (T 35, B 128, H 650), one line ``ABLATION {json}``
a kernel with each variant's ms, µs a step, and each emptied phase's µs a
step.  All three build under ``mxnet_tpu_torch/build/ablation``.
"""
import ctypes
import importlib.util
import json
import math
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


def _forward_profile(cs, step, step_ms, groups):
    """Busy ms a call of ``step`` over two profiled calls, the idle share
    against ``step_ms``, and for each ``key: names`` of ``groups`` the busy
    ms of the kernels whose names hold one of ``names``, as ``key_ms``."""
    n = 2
    kernels, _ = cs.profiled_kernels(step, n)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
    out = {"busy_ms": busy, "idle": max(0.0, 1 - busy / step_ms)}
    for key, names in groups.items():
        out[key + "_ms"] = sum(e.time_range.elapsed_us() for e in kernels
                               if any(k in e.name for k in names)) / n / 1e3
    return out


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
    out.update(_forward_profile(cs, step, step_ms, {
        "kernel": ("taps_conv_kernel", "fp32_3x3_conv")}))
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
    out.update(_forward_profile(cs, step, step_ms,
                                {"kernel": ("fused_bottleneck",)}))
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


#: kernel names of the attention backward in either checkout: the fused
#: kernel and its dq sum, or the dq and dk/dv kernels they replaced
_ATTN_BWD_KERNELS = ("flash_bwd_kernel", "dq_sum_kernel", "flash_dq_kernel",
                     "flash_dkv_kernel")


def tfm(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch import gpu
    torch.cuda.empty_cache()
    cfg, mod, it = cs.tfm_module(gpu(0), cs.TFM["batch"])

    def step():
        mod.forward_backward(cs._next_batch(it))
        mod.update()
        mod.get_outputs()[0].wait_to_read()
    step()
    times = cs.timed_steps(step)
    step_ms = float(np.median(times)) * 1e3
    tokens = cs.TFM["batch"] * cfg.seq_len
    out = {"card": cs.card_line(), "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "steps_ms": [round(t * 1e3, 2) for t in times]}
    out.update(_forward_profile(cs, step, step_ms, {
        "attn_bwd": _ATTN_BWD_KERNELS, "attn_fwd": ("flash_fwd_kernel",)}))
    for key in ("attn_bwd", "attn_fwd"):
        out[key + "_share"] = out[key + "_ms"] / out["busy_ms"]
    torch.cuda.synchronize()
    return out


def lm(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch import gpu
    torch.cuda.empty_cache()
    net, x, y = cs.gluon_lm(gpu(0), cs.LM["dropout"])
    ft = cs._lm_trainer(net)

    def step():
        return ft.step(x, y)
    step()
    times = cs.timed_steps(step)
    step_ms = float(np.median(times)) * 1e3
    tokens = cs.LM["bptt"] * cs.LM["batch"]
    out = {"card": cs.card_line(), "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "steps_ms": [round(t * 1e3, 2) for t in times]}
    out.update(_forward_profile(cs, step, step_ms, {
        "kernel8": ("lstm_fwd_kernel",), "kernel9": ("lstm_bwd_kernel",)}))
    for key in ("kernel8", "kernel9"):
        out[key + "_share"] = out[key + "_ms"] / out["busy_ms"]
    torch.cuda.synchronize()
    return out


def ring(tree):
    import numpy as np
    import torch
    cs = _smoke(tree)
    from mxnet_tpu_torch.models import long_context_attention
    from mxnet_tpu_torch.parallel import make_mesh
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    B, H, T, D, sp = (cs.LONG[k] for k in ("B", "H", "T", "D", "sp"))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    q, k, v, g = (torch.randn(B, H, T, D, device=dev, generator=gen)
                  for _ in range(4))
    mesh = make_mesh({"sp": sp}, devices=[dev] * sp)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def step():
        out = long_context_attention(qg, kg, vg, mesh, axis="sp")
        torch.autograd.grad(out, (qg, kg, vg), g)
    for _ in range(2):
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    out = {"card": cs.card_line(), "fwd_bwd_ms": ms,
           "tokens_per_s": B * T / ms * 1e3,
           "runs_ms": [round(t * 1e3, 3) for t in times]}
    out.update(_forward_profile(cs, step, ms, {
        "kernel4": ("flash_fwd_kernel",), "attn_bwd": _ATTN_BWD_KERNELS}))
    torch.cuda.synchronize()
    return out


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


# the fused attention backward's variants for ``ablate bwd``
S_LOOP = "    for (int d = 0; d < D; d += 4) {"
ACC_LOOP = "    for (int qq = 0; qq < BQ; ++qq) {"
DQ_LOOP = "    for (int kk = 0; kk < BK; kk += 4) {"

# name -> (substitutions (old, new, count), correct)
BWD_VARIANTS = {
    "base": ((), True),
    "no_s_dp": (((S_LOOP, S_LOOP.replace("d < D", "d < 0"), 1),), False),
    "no_dv_dk": (((ACC_LOOP, ACC_LOOP.replace("qq < BQ", "qq < 0"), 1),),
                 False),
    "no_dq": (((DQ_LOOP, DQ_LOOP.replace("kk < BK", "kk < 0"), 1),), False),
    "only_s_dp": (((ACC_LOOP, ACC_LOOP.replace("qq < BQ", "qq < 0"), 1),
                   (DQ_LOOP, DQ_LOOP.replace("kk < BK", "kk < 0"), 1)), False),
    "s_unroll_full": ((("#pragma unroll 2\n" + S_LOOP,
                        "#pragma unroll\n" + S_LOOP, 1),), True),
    "s_unroll_1": ((("#pragma unroll 2\n" + S_LOOP,
                     "#pragma unroll 1\n" + S_LOOP, 1),), True),
    "acc_unroll_8": ((("#pragma unroll 4\n" + ACC_LOOP,
                       "#pragma unroll 8\n" + ACC_LOOP, 1),
                      ("#pragma unroll 2\n" + DQ_LOOP,
                       "#pragma unroll 4\n" + DQ_LOOP, 1)), True),
    "acc_unroll_2": ((("#pragma unroll 4\n" + ACC_LOOP,
                       "#pragma unroll 2\n" + ACC_LOOP, 1),
                      ("#pragma unroll 2\n" + DQ_LOOP,
                       "#pragma unroll 1\n" + DQ_LOOP, 1)), True),
    "threads_512": ((("64 * (a >> 2)", "128 * (a >> 2)", 3),
                     ("64 * s", "128 * s", 3), ("s < SK;", "s < SK / 2;", 2),
                     ("KEYS = 4 * SK;", "KEYS = 2 * SK;", 1),
                     ("RQ = BQ / 16;", "RQ = BQ / 32;", 1),
                     ("constexpr int NT = 256;", "constexpr int NT = 512;",
                      1)), True),
}


# the flash attention forward's variants for ``ablate``
FS_LOOP = "      for (int d = 0; d < D; d += 4) {"
FP_LOOP = "      for (int kk = 0; kk < BK; kk += 4) {"
COPY = "    if (h + NS - 1 < n_ph) load_phase(h + NS - 1);\n"
S_BODY = """#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(Qw + 4 * i * SD + d);
#pragma unroll
          for (int j = 0; j < RK; ++j) s[i][j] = dot4(a, b[j], s[i][j]);
        }"""
# S with the d lane outermost: 4 RQ RK independent FMAs between dependent ones
S_OUTER = """        float4 a[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qw + 4 * i * SD + d);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j)
              s[i][j] = fmaf(lane4(a[i], u), lane4(b[j], u), s[i][j]);"""
RQ8 = ("static constexpr int RQ = 4;", "static constexpr int RQ = 8;", 1)
LB2 = ("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 2)", 1)

# name -> (substitutions (old, new, count), correct, (query rows of a CTA,
# keys of a tile) or None for the plan's); "4x4" is the forward before its
# redesign, another source
FWD_VARIANTS = {
    "base": ((), True, None),
    "4x4": (None, True, None),
    "no_s": (((FS_LOOP, FS_LOOP.replace("d < D", "d < 0"), 1),), False,
             None),
    "no_exp": ((("expf(s[i][j] - m_safe)", "(s[i][j] - m_safe)", 1),
                ("expf(m[i] - m_safe)", "1.f", 1),
                ("mx = row_max8(mx);", "", 1)), False, None),
    "no_pv": (((FP_LOOP, FP_LOOP.replace("kk < BK", "kk < 0"), 1),), False,
              None),
    "no_copy": (((COPY, "", 1),), False, None),
    "unroll_1": ((("#pragma unroll 2\n" + FS_LOOP,
                   "#pragma unroll 1\n" + FS_LOOP, 1),
                  ("#pragma unroll 2\n" + FP_LOOP,
                   "#pragma unroll 1\n" + FP_LOOP, 1)), True, None),
    "unroll_4": ((("#pragma unroll 2\n" + FS_LOOP,
                   "#pragma unroll 4\n" + FS_LOOP, 1),
                  ("#pragma unroll 2\n" + FP_LOOP,
                   "#pragma unroll 4\n" + FP_LOOP, 1)), True, None),
    "ring_3": ((("constexpr int NS = 2;", "constexpr int NS = 3;", 1),), True,
               None),
    "lb_2": ((LB2,), True, None),
    "rows_8": ((RQ8, LB2), True, (128, 64)),
    "rows_8_bk_32": ((RQ8, ("static constexpr int BK = D == 128 ? 32 : 64;",
                            "static constexpr int BK = 32;", 1)), True,
                     (128, 32)),
    "s_outer": (((S_BODY, S_OUTER, 1),), True, None),
}
#: the phases an emptied variant takes out
FWD_PHASES = {"no_s": "S = Q K^T", "no_exp": "softmax's expf and row max",
              "no_pv": "P.V", "no_copy": "K/V copies"}


def _sources(csrc, out_dir, source, variants):
    """Write each variant of ``csrc/<source>`` (those whose substitutions
    are not None); raises if a substitution does not match the committed
    source as many times as it expects."""
    with open(os.path.join(csrc, source)) as f:
        base = f.read()
    paths = {}
    for name, spec in variants.items():
        if spec[0] is None:
            continue
        src = base
        for old, new, count in spec[0]:
            if src.count(old) != count:
                raise RuntimeError("variant %s: %r found %d times, expected %d"
                                   % (name, old, src.count(old), count))
            src = src.replace(old, new)
        paths[name] = os.path.join(out_dir, name + ".cu")
        with open(paths[name], "w") as f:
            f.write(src)
    return paths


def _build_variants(paths, csrc, out_dir, nvcc, flags, bind,
                    entry_has="ILi64E"):
    """Each variant's library, all ``nvcc`` processes running together,
    bound by ``bind(name, lib)``; prints the register use of each build's
    entry functions whose mangled names hold ``entry_has``."""
    procs = {}
    for name, src in paths.items():
        lib = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", csrc, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        entry = ""
        for line in log.splitlines():       # head dim 64's instantiations
            if "Compiling entry function" in line:
                entry = line
            elif ("registers" in line or "spill" in line) and (
                    entry_has in entry):
                at = entry.find("ILb")         # an LSTM kernel's RES argument
                tmpl = entry[at:at + 5] if at >= 0 else ""
                print("[ablate-build] %s %s: %s" % (name, tmpl, line.strip()))
        fns[name] = bind(name, ctypes.CDLL(lib))
    return fns


def _bind_fwd(lib, old=False):
    """``mxtt_flash_attn_fwd`` of a forward build, typed: the package's
    (with the plan's tile) or, ``old``, the 4 x 4 build's (without)."""
    fn = lib.mxtt_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * (3 if old else 5)
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def ablate_fwd():
    import torch
    cs = _smoke(HERE)
    from mxnet_tpu_torch import _build as build
    from mxnet_tpu_torch.ops import hopper_attention as ha
    out_dir = os.path.join(str(build.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(build.CSRC)
    paths = _sources(csrc, out_dir, "flash_attn_fwd.cu", FWD_VARIANTS)
    paths["4x4"] = os.path.join(HERE, "ablation", "flash_attn_fwd_4x4.cu")
    fns = _build_variants(paths, csrc, out_dir, build._nvcc(), build.FLAGS,
                          lambda name, lib: _bind_fwd(lib, name == "4x4"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    launched = ctypes.c_int(0)
    # kernel 5 at gpt2-small's call, kernel 4 at the ring's two
    for shape, mode in ((cs.ATTN_SHAPES[0], 1), (cs.RING_STATS_SHAPES[0], 2),
                        (cs.RING_STATS_SHAPES[1], 2)):
        B, H, Tq, Tk, D, causal = shape
        r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa
        q, k, v = r(B, H, Tq, D), r(B, H, Tk, D), r(B, H, Tk, D)
        sc = 1.0 / math.sqrt(D)
        if mode == 1:
            want = ha.flash_fwd_plain(q, k, v, causal, sc)
        else:
            want = ha.flash_stats_plain(q, k, v, causal, sc)
        plan = ha.flash_fwd_plan(Tq, Tk, D, causal)
        runs, errs, kept = {}, {}, []
        for name, fn in fns.items():
            outs = (torch.empty_like(q), torch.empty((B, H, Tq), device=dev),
                    torch.empty((B, H, Tq), device=dev))
            kept.append(outs)           # alive while the launches write them
            ptrs = [t.data_ptr() for t in (q, k, v, *outs)]
            tile = () if name == "4x4" else (
                FWD_VARIANTS[name][2] or (plan.bq, plan.bk))

            def run(fn=fn, ptrs=ptrs, tile=tile):
                rc = fn(*ptrs, B * H, Tq, Tk, D, sc, int(causal), mode, *tile,
                        0, torch.cuda.current_stream().cuda_stream,
                        ctypes.byref(launched))
                if rc != 0:
                    raise RuntimeError("launch failed: CUDA error %d" % rc)
            run()
            torch.cuda.synchronize()
            runs[name] = run
            if FWD_VARIANTS[name][1]:
                got = outs[:2] if mode == 1 else outs
                if mode == 1:
                    errs[name] = max((g - w).abs().max().item()
                                     for g, w in zip(got, want))
                    tol = cs.ATTN_FWD_TOL
                else:
                    errs[name] = max(cs._stats_err(got, want))
                    tol = cs.STATS_TOL
                if errs[name] > tol:
                    raise RuntimeError("variant %s disagrees with plain at "
                                       "%s: %g" % (name, shape, errs[name]))
        times = {name: [] for name in runs}
        for _ in range(3):                    # in turns
            for name, run in runs.items():
                times[name].append(cs.time_ms(run, iters=10, warmup=2))
        ms = {n: min(t) for n, t in times.items()}
        flops = 4.0 * cs._visible_pairs(Tq, Tk, causal) * B * H * D
        phase_ms = {FWD_PHASES[n]: ms["base"] - ms[n] for n in FWD_PHASES}
        print("ABLATION " + json.dumps({
            "shape": shape, "kernel": 5 if mode == 1 else 4,
            "gflop": flops / 1e9, "ms": ms, "ms_runs": times,
            "max_err": errs,
            "tflops": {n: flops / t / 1e9 for n, t in ms.items()},
            "phase_ms": phase_ms,
            "phase_tflops": {p: flops / 2 / t / 1e9 for p, t in
                             phase_ms.items() if p in ("S = Q K^T", "P.V")
                             and t > 0}}), flush=True)
        del q, k, v, want, runs, kept
        torch.cuda.empty_cache()
    print(cs.card_line())


def ablate_bwd():
    import torch
    cs = _smoke(HERE)
    from mxnet_tpu_torch import _build as build
    from mxnet_tpu_torch.ops import hopper_attention as ha
    out_dir = os.path.join(str(build.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(build.CSRC)
    fns = _build_variants(
        _sources(csrc, out_dir, "flash_attn_bwd.cu", BWD_VARIANTS), csrc,
        out_dir, build._nvcc(), build.FLAGS,
        lambda name, lib: ha._bind_bwd(lib))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for shape in [cs.ATTN_SHAPES[0]] + cs.RING_STATS_SHAPES[:2]:
        B, H, Tq, Tk, D, causal = shape
        r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa
        q, k, v, do = r(B, H, Tq, D), r(B, H, Tk, D), r(B, H, Tk, D), \
            r(B, H, Tq, D)
        sc = 1.0 / math.sqrt(D)
        out, lse = ha.flash_fwd_lse(q, k, v, causal, sc)
        delta = (do * out).sum(-1)
        plan = ha.flash_bwd_plan(Tq, Tk, D, causal)
        want = ha.flash_bwd_plain(q, k, v, do, lse, delta, causal, sc)
        ws = torch.empty((B * H, plan.ws_rows, D), device=dev)
        launched = (ctypes.c_int * 2)()
        runs, errs, kept = {}, {}, []
        for name, fn in fns.items():
            outs = (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v))
            kept.append(outs)           # alive while the launches write them
            ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs,
                                           ws)]

            def run(fn=fn, ptrs=ptrs):
                rc = fn(*ptrs, B * H, Tq, Tk, D, sc, int(causal), plan.bk,
                        plan.ws_rows, 0, torch.cuda.current_stream()
                        .cuda_stream, launched)
                if rc != 0:
                    raise RuntimeError("launch failed: CUDA error %d" % rc)
            run()
            torch.cuda.synchronize()
            runs[name] = run
            if BWD_VARIANTS[name][1]:
                errs[name] = max(((g - w).abs().max() / w.abs().max()).item()
                                 for g, w in zip(outs, want))
                if errs[name] > cs.ATTN_BWD_TOL:
                    raise RuntimeError("variant %s disagrees with plain at "
                                       "%s: %g" % (name, shape, errs[name]))
        times = {name: [] for name in runs}
        for _ in range(3):                    # in turns
            for name, run in runs.items():
                times[name].append(cs.time_ms(run, iters=10, warmup=2))
        flops = 10.0 * cs._visible_pairs(Tq, Tk, causal) * B * H * D
        print("ABLATION " + json.dumps({
            "shape": shape, "gflop": flops / 1e9,
            "ms": {n: min(t) for n, t in times.items()},
            "ms_runs": times, "max_rel_err": errs,
            "tflops": {n: flops / min(t) / 1e9 for n, t in times.items()}}),
            flush=True)
        del q, k, v, do, out, lse, delta, want, ws, runs, kept
        torch.cuda.empty_cache()
    print(cs.card_line())


# kernels 8 and 9 as they stood before their redesign (ablation/*_before.cu):
# one phase emptied or skipped a variant, for timing only
K_LOOP = "for (int kk = kg * KCG; kk < (kg + 1) * KCG; ++kk) {"
NO_K_LOOP = (K_LOOP, K_LOOP.replace("kk < (kg + 1) * KCG", "kk < kg * KCG"), 1)
NO_EXCHANGE = ("ok ? 16 : 0);", "0);", 1)
BEFORE_FWD_STORES = """            gr[u] = ig;
            gr[H + u] = fg;
            gr[2 * H + u] = gg;
            gr[3 * H + u] = og;
            cs[row * H + u] = c;
            ys[row * H + u] = h;
"""
BEFORE_FWD_GATHERS = "c_prev at 40 + 4 p + j\n      if (kg == 0 && in_tile) {"
BEFORE_BWD_LOADS = """          v[p][j][0] = gr[u];
          v[p][j][1] = gr[H + u];
          v[p][j][2] = gr[2 * H + u];
          v[p][j][3] = gr[3 * H + u];
          v[p][j][4] = cs[row * H + u];
          v[p][j][5] = t > 0 ? cs[(row - B) * H + u] : c0[bu];
          v[p][j][6] = t == T - 1 ? dhT[bu] : dh0[bu];
          v[p][j][7] = t == T - 1 ? dcT[bu] : dc0[bu];
          v[p][j][8] = dys[row * H + u];
"""
BEFORE_BWD_STORES = """            dr[k * H + u] = dp[k];
            dpre_w[(size_t)(k * H + u) * Bp + b] = dp[k];
"""
# name -> (substitutions, correct)
BEFORE_FWD_VARIANTS = {
    "base": ((), True),
    "no_product": ((NO_K_LOOP,), False),
    "no_sync": ((("    grid.sync();\n  }\n}", "  }\n}", 1),), False),
    "no_stores": (((BEFORE_FWD_STORES, "", 1),), False),
    "no_gathers": (((BEFORE_FWD_GATHERS, BEFORE_FWD_GATHERS.replace(
        "kg == 0 && in_tile", "false"), 1),), False),
    "no_exchange": ((NO_EXCHANGE,), False),
}
BEFORE_BWD_VARIANTS = {
    "base": ((), True),
    "no_product": ((NO_K_LOOP,), False),
    "no_sync": ((("    grid.sync();\n", "", 1),), False),
    "no_stores": (((BEFORE_BWD_STORES, "", 1),), False),
    "no_loads": (((BEFORE_BWD_LOADS, "".join(
        "          v[p][j][%d] = 0.5f;\n" % i for i in range(9)), 1),), False),
    "no_exchange": ((NO_EXCHANGE,), False),
}
#: what an emptied variant takes out
LSTM_PHASES = {"no_product": "the product", "no_sync": "the grid sync",
               "no_stores": "the epilogue's stores",
               "no_gathers": "the gate inputs' gathers",
               "no_loads": "the reserve loads",
               "no_exchange": "the exchange's copies (zero-filled)"}
# the redesigned kernels (csrc/lstm_fwd.cu, lstm_bwd.cu with
# csrc/lstm_common.cuh inlined): a phase emptied or skipped, or another
# split of the product (kg, sc) forced on the plan
PRODUCT_LOOP = "for (int kk = 0; kk < SC; ++kk) {"
NO_PRODUCT = (PRODUCT_LOOP, PRODUCT_LOOP.replace("kk < SC", "kk < 0"), 1)
NO_BARRIER = ("    } while (v < target);", "    } while (false);", 1)
NO_STAGE_COPY = ("const bool ok = m0 + kk < K && row0 + r4 < rcap;",
                 "const bool ok = false;", 1)
NO_GROUP_SUM = ("v[g] = g < KG ? src[g * step] : 0.f;",
                "v[g] = g < 1 ? src[g * step] : 0.f;", 1)
UNROLL = "#pragma unroll 4\n      for (int kk = 0; kk < SC; ++kk) {"
RELAXED_SIGNAL = ("red.release.gpu.global", "red.relaxed.gpu.global", 1)
LB640 = ("return fwd ? 512 : 640;", "return 640;", 1)
CG_FAST = ("const int rg = item % d.NRG, cg = item / d.NRG;",
           "const int cg = item % d.NCG, rg = item / d.NCG;", 1)
RG_FAST = (CG_FAST[1], CG_FAST[0], 1)
SIGMOID = ("__device__ __forceinline__ float sigmoid_f(float x) { "
           "return 1.f / (1.f + expf(-x)); }")
FAST_SIGMOID = (SIGMOID, SIGMOID.replace("1.f / (1.f + expf(-x))",
                                         "__frcp_rn(1.f + __expf(-x))")
                + "\n__device__ __forceinline__ float tanh_fast(float x) { "
                "return 1.f - 2.f * __frcp_rn(__expf(2.f * x) + 1.f); }", 1)
FWD_STORES = ("lstm_for3(6, nbt, nu,", "lstm_for3(0, nbt, nu,", 1)
FWD_XP = ("lstm_for3(4, nbt, nu,", "lstm_for3(0, nbt, nu,", 1)
BWD_RESERVE = ("lstm_for3(7, nbc, nuq,", "lstm_for3(0, nbc, nuq,", 1)
BWD_STORES = ("lstm_for3(4, nbc, nuq,", "lstm_for3(0, nbc, nuq,", 1)
# name -> (substitutions, correct, lstm_plan's keywords or None for its plan)
FWD_VARIANTS_LSTM = {
    "base": ((), True, None),

    "kg5_sc19": ((), True, dict(kg=5, sc=19)),
    "unroll_2": (((UNROLL, UNROLL.replace("unroll 4", "unroll 2"), 1),), True,
                 None),
    "cg_fast": ((CG_FAST,), True, None),
    "no_product": ((NO_PRODUCT,), False, None),
    "no_barrier": ((NO_BARRIER,), False, None),
    "no_exchange": ((NO_STAGE_COPY,), False, None),
    "no_group_sum": ((NO_GROUP_SUM,), False, None),
    "no_stores": ((FWD_STORES,), False, None),
    "no_xp_copy": ((FWD_XP,), False, None),
    # cumulative: what is left without the product, the copies, the barrier
    "only_syncs_epilogue": ((NO_PRODUCT, NO_STAGE_COPY, NO_GROUP_SUM, FWD_XP,
                             FWD_STORES, NO_BARRIER), False, None),
    "only_exchange": ((NO_PRODUCT, NO_GROUP_SUM, FWD_XP, FWD_STORES), False,
                      None),
    "lb640_kg8": ((LB640,), True, dict(kg=8, sc=14)),
    "kg6_sc14": ((), True, dict(kg=6, sc=14)),
    "relaxed_signal": ((RELAXED_SIGNAL,), False, None),
    "fast_math": ((FAST_SIGMOID, ("tanhf(", "tanh_fast(", 2)), True, None),
}
BWD_PARTIALS = ("          for (int j = 1; j < 4; ++j) "
                "dh += __ldcg(part_of(j) + off);")
BWD_VARIANTS_LSTM = {
    "base": ((), True, None),
    "kg7_sc12": ((), True, dict(kg=7, sc=12)),
    "unroll_2": (((UNROLL, UNROLL.replace("unroll 4", "unroll 2"), 1),), True,
                 None),
    "rg_fast": ((RG_FAST,), True, None),
    "relaxed_signal": ((RELAXED_SIGNAL,), False, None),
    "fast_math": ((("tanhf(rsv[4 * RSZ + s])", "(1.f - 2.f * __frcp_rn(__expf("
                    "2.f * rsv[4 * RSZ + s]) + 1.f))", 1),), True, None),
    "no_product": ((NO_PRODUCT,), False, None),
    "no_barriers": (((NO_BARRIER[0], NO_BARRIER[1], 1),), False, None),
    "no_exchange": ((NO_STAGE_COPY,), False, None),
    "no_group_sum": ((NO_GROUP_SUM,), False, None),
    "no_partials": (((BWD_PARTIALS, "", 1),), False, None),
    "no_reserve": ((BWD_RESERVE,), False, None),
    "no_stores": ((BWD_STORES,), False, None),
    "only_syncs_epilogue": ((NO_PRODUCT, NO_STAGE_COPY, NO_GROUP_SUM,
                             (BWD_PARTIALS, "", 1), BWD_RESERVE, BWD_STORES,
                             NO_BARRIER), False, None),
}
LSTM_PHASES.update({
    "no_barrier": "the half's barrier", "no_barriers": "both barriers",
    "no_group_sum": "the groups' partial sums (group 0's only)",
    "no_partials": "the group's partial dh (one of four)",
    "no_reserve": "the reserve's copies", "no_xp_copy": "xp's copies"})
#: (kernel, source directory, source, variants, entry style)
LSTM_ABLATION = [
    ("fwd", "ablation", "lstm_fwd_before.cu", BEFORE_FWD_VARIANTS, "before"),
    ("bwd", "ablation", "lstm_bwd_before.cu", BEFORE_BWD_VARIANTS, "before"),
    ("fwd", "csrc", "lstm_fwd.cu", FWD_VARIANTS_LSTM, "after"),
    ("bwd", "csrc", "lstm_bwd.cu", BWD_VARIANTS_LSTM, "after"),
]


def _bind_lstm(lib, kind, style):
    """The entry point of an LSTM build, typed: the kernels before their
    redesign take 11 tensors, T, B, H, device, stream, launched; after it,
    the tensors and scratch pointers, T, B, H, the plan, device, stream,
    launched."""
    fn = getattr(lib, "mxtt_lstm_" + kind)
    if style == "before":
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    else:
        fn.argtypes = ([ctypes.c_void_p] * (12 if kind == "fwd" else 13)
                       + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def _inline_common(csrc, out_dir, source):
    """``csrc/<source>`` with ``lstm_common.cuh`` pasted in, written to
    ``out_dir`` (so that a variant may edit the shared product too)."""
    with open(os.path.join(csrc, source)) as f:
        text = f.read()
    with open(os.path.join(csrc, "lstm_common.cuh")) as f:
        common = f.read().replace("#pragma once\n", "")
    include = '#include "lstm_common.cuh"\n'
    if text.count(include) != 1:
        raise RuntimeError("%s does not include lstm_common.cuh once" % source)
    with open(os.path.join(out_dir, source), "w") as f:
        f.write(text.replace(include, common))


def ablate_lstm():
    """Kernels 8 and 9 and their variants at the LM's shape, in turns."""
    import torch
    cs = _smoke(HERE)
    from mxnet_tpu_torch import _build as build
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    out_dir = os.path.join(str(build.BUILD_DIR), "ablation")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(build.CSRC)
    variants, paths = {}, {}
    for kind, where, source, table, style in LSTM_ABLATION:
        src_dir = os.path.join(HERE, where)
        if where == "csrc":
            src_dir = os.path.join(out_dir, "src")
            os.makedirs(src_dir, exist_ok=True)
            _inline_common(csrc, src_dir, source)
        tag = source[:-3]
        named = {"%s.%s" % (tag, n): v[:2] for n, v in table.items()}
        paths.update(_sources(src_dir, out_dir, source, named))
        for n, v in table.items():
            variants["%s.%s" % (tag, n)] = (kind, style, n, v[1],
                                            v[2] if len(v) > 2 else None)
    fns = _build_variants(paths, csrc, out_dir, build._nvcc(), build.FLAGS,
                          lambda name, lib: _bind_lstm(
                              lib, variants[name][0], variants[name][1]),
                          entry_has="lstm")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    T, B, H = cs.LM["bptt"], cs.LM["batch"], cs.LM["hidden"]
    c = cs._lstm_inputs(T, B, H, gen, dev)
    fwd_in = (c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    want_f = hr.lstm_fwd_plain(*fwd_in)
    bwd_in = (want_f[3], want_f[4], c["c0"], c["dys"], c["dhT"], c["dcT"],
              c["R"])
    want_b = hr.lstm_bwd_plain(*bwd_in)
    f32 = dict(dtype=torch.float32, device=dev)
    Bp = (B + 3) // 4 * 4
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    plans = {}
    for kind in ("fwd", "bwd"):
        runs, errs, kept = {}, {}, []
        for name, (k, style, short, correct, split) in variants.items():
            if k != kind:
                continue
            if kind == "fwd":
                outs = (torch.empty((T, B, H), **f32),
                        torch.empty((T, B, 4 * H), **f32),
                        torch.empty((T, B, H), **f32),
                        torch.empty((B, H), **f32), torch.empty((B, H), **f32))
                scratch = torch.empty((2, H, Bp), **f32)
                ptrs = [t.data_ptr() for t in (*fwd_in, *outs, scratch)]
                order = (0, 3, 4, 1, 2)       # as lstm_fwd_plain returns them
                want = want_f
            else:
                outs = (torch.empty((T, B, 4 * H), **f32),
                        torch.empty((B, H), **f32), torch.empty((B, H), **f32))
                scratch = torch.empty((2, 4 * H, Bp), **f32)
                ptrs = [t.data_ptr() for t in (*bwd_in, *outs, scratch)]
                order = (0, 1, 2)
                want = want_b
            args = ()
            if style == "after":
                plan = hr.lstm_plan(kind, B, H, sms, optin, **(split or {}))
                plans[name] = plan._asdict()
                extra = torch.zeros(plan.blocks * plan.units * plan.rows
                                    + 2 * (1 + plan.groups), **f32)
                kept.append(extra)
                ptrs += ([extra.data_ptr()] if kind == "fwd" else
                         [extra.data_ptr(), extra.data_ptr() + 4 * (
                             plan.blocks * plan.units * plan.rows)])
                args = (ctypes.addressof(hr._plan_ints(plan)),)
            kept.append((outs, scratch))

            def run(fn=fns[name], ptrs=ptrs, args=args):
                rc = fn(*ptrs, T, B, H, *args, 0, stream,
                        ctypes.byref(launched))
                if rc != 0:
                    raise RuntimeError("launch failed: CUDA error %d" % rc)
            run()
            torch.cuda.synchronize()
            runs[name] = run
            if correct:
                if kind == "fwd":
                    errs[name] = max((outs[i] - w).abs().max().item()
                                     for i, w in zip(order, want))
                    tol = cs.LSTM_FWD_TOL
                else:
                    errs[name] = max(((outs[i] - w).abs().max()
                                      / w.abs().max()).item()
                                     for i, w in zip(order, want))
                    tol = cs.LSTM_BWD_TOL
                if errs[name] > tol:
                    raise RuntimeError("variant %s disagrees with plain: %g"
                                       % (name, errs[name]))
        times = {name: [] for name in runs}
        for _ in range(3):                    # in turns
            for name, run in runs.items():
                times[name].append(cs.time_ms(run, iters=10, warmup=2))
        ms = {n: min(t) for n, t in times.items()}
        phase_ms = {}
        for name in ms:
            tag, short = name.split(".", 1)
            if short in LSTM_PHASES:
                phase_ms[name] = {"phase": LSTM_PHASES[short],
                                  "ms": ms[tag + ".base"] - ms[name],
                                  "us_a_step": (ms[tag + ".base"] - ms[name])
                                  / T * 1e3}
        print("ABLATION " + json.dumps({
            "kernel": 8 if kind == "fwd" else 9, "T": T, "B": B, "H": H,
            "ms": ms, "us_a_step": {n: t / T * 1e3 for n, t in ms.items()},
            "ms_runs": times, "max_err": errs, "phases": phase_ms,
            "plans": {n: p for n, p in plans.items() if n in ms}}),
            flush=True)
        del runs, kept
        torch.cuda.empty_cache()
    print(cs.card_line())


def main(argv):
    modes = {"steps": steps, "served": served, "infer16": infer16,
             "w1x1": w1x1, "tfm": tfm, "ring": ring, "lm": lm}
    if len(argv) == 4 and argv[1] == "--one":
        tree = os.path.abspath(argv[3])
        print("AB " + json.dumps(dict(modes[argv[2]](tree), tree=argv[3])),
              flush=True)
        return 0
    if len(argv) == 2 and argv[1] == "stream":
        print("STREAM " + json.dumps(stream()), flush=True)
        return 0
    if len(argv) in (2, 3) and argv[1] == "ablate":
        ablation = {(): ablate_fwd, ("bwd",): ablate_bwd,
                    ("lstm",): ablate_lstm}.get(tuple(argv[2:]))
        if ablation is None:
            print(__doc__, file=sys.stderr)
            return 2
        ablation()
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
