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
    python3 chip_ab.py stream          # host cost of a stream handle
    python3 chip_ab.py ablate          # what limits the flash attention forward
    python3 chip_ab.py ablate bwd      # what limits the fused attention backward

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
profiled call's busy time and kernel 4's ms.  Each checkout prints one line
``AB {json}``.  ``stream`` prints the host microseconds a call of the CUDA
build's raw stream accessor and of
``torch.cuda.current_stream(...).cuda_stream`` take, as ``STREAM {json}``.
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
against ``flash_bwd_plain``.  Both build under
``mxnet_tpu_torch/build/ablation``.
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


def _build_variants(paths, csrc, out_dir, nvcc, flags, bind):
    """Each variant's library, all ``nvcc`` processes running together,
    bound by ``bind(name, lib)``; prints each build's register use."""
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
                    "ILi64E" in entry):
                print("[ablate-build] %s: %s" % (name, line.strip()))
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


def main(argv):
    modes = {"steps": steps, "served": served, "infer16": infer16,
             "w1x1": w1x1, "tfm": tfm, "ring": ring}
    if len(argv) == 4 and argv[1] == "--one":
        tree = os.path.abspath(argv[3])
        print("AB " + json.dumps(dict(modes[argv[2]](tree), tree=argv[3])),
              flush=True)
        return 0
    if len(argv) == 2 and argv[1] == "stream":
        print("STREAM " + json.dumps(stream()), flush=True)
        return 0
    if len(argv) in (2, 3) and argv[1] == "ablate":
        if argv[2:] not in ([], ["bwd"]):
            print(__doc__, file=sys.stderr)
            return 2
        (ablate_bwd if argv[2:] else ablate_fwd)()
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
