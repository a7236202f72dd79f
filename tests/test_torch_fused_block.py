"""Kernel 13's path in the port (mxnet_tpu_torch) against the reference
(mxnet_tpu), on the CPU: the fused ResNet v1 identity bottleneck at
inference (``ops/hopper_block.py``), its BatchNorm folding
(``weights.fold_bottleneck``), the inference plan's matching
(``executor._find_bottlenecks``), and bf16 ``Module.predict``/``score`` on
a small bottleneck ResNet, from the same seeded numpy inputs.

- ``fused_bottleneck_plain`` against the TPU kernel itself:
  ``tools/probe_fused_block.py``'s ``_kernel`` in a ``pallas_call(...,
  interpret=True)`` built here as the probe builds it, with the probe's
  shape globals set to N 2, HW 8, 64/16 (batch tile 2) and N 2, HW 7,
  32/8 (batch tile 1, an odd map whose border taps read the zero halo).
  Both round three fp32 sums to bf16, in another order: within one bf16
  step (rtol 2^-7) plus 1e-3 of the largest |out|, the tolerance
  ``chip_smoke.py`` holds the CUDA kernel to.
- The folded block in fp32 against the reference's per-op symbolic block
  (Convolution, BatchNorm at inference, Activation, broadcast_add) within
  1e-5 of the largest |out|, with ``fix_gamma`` True and False and
  ``eps`` other than either default.
- A plan of a ResNet with 2 identity units and 1 projection unit fuses
  exactly 2 blocks; reading an intermediate (``get_internals()``) keeps
  that block unfused, ``use_global_stats`` fuses; ``train=True`` plans fuse
  nothing, and fp32 inputs run the original steps, bit for bit.
- bf16 ``Module.predict``/``score`` under ``MXNET_TPU_BF16=1`` with the
  reference Module's weights (``weights.from_jax_module``): the port's
  probabilities lie within 3x the reference's own bf16 distance from its
  fp32 probabilities + one bf16 step (the band of test_torch_bf16.py),
  top-1 matches the fp32 run wherever its margin exceeds that band, and
  after ``set_params`` the next ``predict`` follows the new weights.
- Under ``torch.enable_grad()`` with an input that requires grad, the
  fused step raises.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _Plan
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ndarray.ndarray import bf16_from_numpy
from mxnet_tpu_torch.ops import hopper_block as hb
from mxnet_tpu_torch.weights import (fold_bottleneck, from_jax_module,
                                     from_probe_block)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 2.0 ** -7
BLOCK_ATOL_REL = 1e-3
FOLD_TOL = 1e-5
BAND_FACTOR = 3.0
BF16_STEP = 2.0 ** -7
SHAPE = (8, 3, 9, 7)            # odd H and W: the halo rows and columns


def _probe(monkeypatch, N, HW, C_IN, C_MID, TB):
    spec = importlib.util.spec_from_file_location(
        "probe_fused_block", os.path.join(_REPO, "tools",
                                          "probe_fused_block.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for k, v in dict(N=N, HW=HW, C_IN=C_IN, C_MID=C_MID, TB=TB).items():
        monkeypatch.setattr(probe, k, v)
    return probe


def _probe_call(probe, x, w1, w2, w3, b):
    """The probe's ``pallas_call`` (``probe_fused_block.py:66-85``) of its
    own ``_kernel``, in interpret mode."""
    rows = probe.TB * probe.HW * probe.HW
    nt = probe.N * probe.HW * probe.HW // rows
    C_IN, C_MID = probe.C_IN, probe.C_MID
    return pl.pallas_call(
        probe._kernel, grid=(nt,),
        in_specs=[pl.BlockSpec((1, rows, C_IN), lambda t: (t, 0, 0)),
                  pl.BlockSpec((C_IN, C_MID), lambda t: (0, 0)),
                  pl.BlockSpec((9, C_MID, C_MID), lambda t: (0, 0, 0)),
                  pl.BlockSpec((C_MID, C_IN), lambda t: (0, 0)),
                  pl.BlockSpec((3, C_IN), lambda t: (0, 0))],
        out_specs=pl.BlockSpec((1, rows, C_IN), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nt, rows, C_IN), x.dtype),
        interpret=True)(x.reshape(nt, rows, C_IN), w1, w2, w3, b) \
        .reshape(probe.N * probe.HW * probe.HW, C_IN)


def _assert_block_close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    atol = BLOCK_ATOL_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol)


@pytest.mark.parametrize("N,HW,C_IN,C_MID,TB", [(2, 8, 64, 16, 2),
                                                (2, 7, 32, 8, 1)])
def test_plain_matches_probe_kernel(monkeypatch, N, HW, C_IN, C_MID, TB):
    probe = _probe(monkeypatch, N, HW, C_IN, C_MID, TB)
    r = np.random.default_rng(40)
    bf = jnp.bfloat16
    x = jnp.asarray(r.standard_normal((N * HW * HW, C_IN)) * 0.5, bf)
    w1 = jnp.asarray(r.standard_normal((C_IN, C_MID)) * 0.1, bf)
    w2 = jnp.asarray(r.standard_normal((9, C_MID, C_MID)) * 0.1, bf)
    w3 = jnp.asarray(r.standard_normal((C_MID, C_IN)) * 0.1, bf)
    b = jnp.asarray(r.standard_normal((3, C_IN)) * 0.1, jnp.float32)
    want = np.asarray(_probe_call(probe, x, w1, w2, w3, b).astype(
        jnp.float32))
    tw = from_probe_block(*(np.asarray(a) for a in (w1, w2, w3, b)), cpu())
    assert [t.dtype for t in tw] == [torch.bfloat16] * 3 + [torch.float32]
    tx = bf16_from_numpy(np.asarray(x)).reshape(N, HW, HW, C_IN)
    before = hb.launches
    got = hb.fused_bottleneck(tx, *tw)
    assert hb.launches == before and got.dtype == torch.bfloat16
    _assert_block_close(got.reshape(-1, C_IN), want)
    # the reference's own unfused formulation (XLA) agrees as well
    xla = np.asarray(probe.xla_block(x, w1, w2, w3, b).astype(jnp.float32))
    _assert_block_close(got.reshape(-1, C_IN), xla)


def _bottleneck(pkg, eps, fix_gamma):
    """One identity bottleneck as the Gluon v1 block lowers it: 1x1 convs
    with bias, a 3x3 without, BatchNorm after each, the input added."""
    s = pkg.sym
    x = s.var("data")
    h = x
    for i, (k, p, bias) in enumerate(((1, 0, True), (3, 1, False),
                                      (1, 0, True))):
        h = s.Convolution(h, kernel=(k, k), pad=(p, p), no_bias=not bias,
                          num_filter=16 if i == 2 else 4, name="conv%d" % i)
        h = s.BatchNorm(h, eps=eps, fix_gamma=fix_gamma, name="bn%d" % i)
        if i < 2:
            h = s.Activation(h, act_type="relu", name="relu%d" % i)
    return s.Activation(s.broadcast_add(h, x, name="add"), act_type="relu",
                        name="out")


def _seeded(net, data_shape, seed):
    """He-scaled conv weights, gamma in [0.5, 1.5], small betas, biases and
    means, variances in [0.5, 1.5], by name with the reference's shapes."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    r = np.random.default_rng(seed)
    arg = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight") and len(s) == 4:
            v = r.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_weight"):
            v = r.standard_normal(s) / np.sqrt(s[1])
        elif n.endswith("_gamma"):
            v = r.uniform(0.5, 1.5, s)
        else:
            v = r.standard_normal(s) * 0.1
        arg[n] = v.astype(np.float32)
    aux = {n: (r.uniform(0.5, 1.5, s) if n.endswith("_var")
               else r.standard_normal(s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return arg, aux


@pytest.mark.parametrize("fix_gamma,eps", [(False, 2e-3), (True, 3e-4)])
def test_folded_block_matches_reference_per_op(fix_gamma, eps):
    shape = (2, 16, 5, 7)
    net = _bottleneck(mx, eps, fix_gamma)
    arg, aux = _seeded(net, shape, seed=41)
    x = np.random.default_rng(42).standard_normal(shape).astype(np.float32)
    jpred = JaxPredictor(net.tojson(), {
        **{"arg:" + k: mx.nd.array(v) for k, v in arg.items()},
        **{"aux:" + k: mx.nd.array(v) for k, v in aux.items()}},
        ctx=mx.cpu(), input_shapes={"data": shape})
    want = jpred.forward(data=x)[0].asnumpy()
    t = {k: torch.from_numpy(v) for k, v in {**arg, **aux}.items()}

    def bn(i):
        return tuple(t["bn%d_%s" % (i, k)] for k in
                     ("gamma", "beta", "moving_mean", "moving_var")) \
            + (eps, fix_gamma)

    folded = fold_bottleneck(t["conv0_weight"], t["conv0_bias"], bn(0),
                             t["conv1_weight"], None, bn(1),
                             t["conv2_weight"], t["conv2_bias"], bn(2),
                             dtype=torch.float32)
    assert [tuple(f.shape) for f in folded] == [(4, 16), (9, 4, 4), (16, 4),
                                                (3, 16)]
    got = hb.fused_bottleneck(torch.from_numpy(x).permute(0, 2, 3, 1),
                              *folded).permute(0, 3, 1, 2).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=FOLD_TOL)


def _net(pkg, classes=5):
    """A ResNet v1 of one stage of 3 bottlenecks (16 -> 64 channels, Cm 16):
    one projection unit, then 2 identity units, -> SoftmaxOutput."""
    with pkg.name.NameManager():
        body = (jvision if pkg is mx else vision).ResNetV1(
            (jvision if pkg is mx else vision).BottleneckV1, [3], [16, 64],
            classes=classes, thumbnail=True)
        out = body(pkg.sym.var("data"))
    return pkg.sym.SoftmaxOutput(out, pkg.sym.var("softmax_label"),
                                 name="softmax")


def _count_kernel_calls(monkeypatch):
    calls = []
    real = hb.fused_bottleneck

    def counting(*args):
        calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(hb, "fused_bottleneck", counting)
    return calls


def test_plan_fuses_identity_bottlenecks_only(monkeypatch):
    net = _net(tmx)
    assert _Plan(net, train=False).n_fused == 2
    assert _Plan(net, train=True).n_fused == 0
    # reading an inner ReLU of the second unit keeps that unit unfused; a
    # second head at a block's output (its last ReLU) keeps it fused
    internals = net.get_internals()
    inner = internals["resnetv10_stage1_relu3_fwd_output"]
    block_out = internals["resnetv10_stage1_activation2_output"]
    assert _Plan(tmx.sym.Group([net, inner]), train=False).n_fused == 1
    assert _Plan(tmx.sym.Group([net, block_out]), train=False).n_fused == 2
    # use_global_stats changes nothing at inference: the moving statistics
    # normalize either way
    js = net.tojson().replace('"use_global_stats": "False"',
                              '"use_global_stats": "True"')
    gs = tmx.sym.load_json(js)
    assert sum(n.parsed_attrs()["use_global_stats"] for n in gs._topo()
               if not n.is_var and n.op.name == "BatchNorm") == 10
    assert _Plan(gs, train=False).n_fused == 2

    # fp32 runs the ten original steps (bit for bit), bf16 the fused block
    arg, aux = _seeded(_net(mx), SHAPE, seed=43)
    vals = {k: torch.from_numpy(v) for k, v in {**arg, **aux}.items()}
    vals["data"] = torch.from_numpy(np.random.default_rng(44).standard_normal(
        SHAPE).astype(np.float32))
    vals["softmax_label"] = torch.zeros(SHAPE[0])
    calls = _count_kernel_calls(monkeypatch)
    with torch.inference_mode():
        fused = _Plan(net, train=False).execute(vals)[0][0]
    unfused_plan = _Plan(tmx.sym.Group([
        net, inner, internals["resnetv10_stage1_relu5_fwd_output"]]),
        train=False)
    assert unfused_plan.n_fused == 0
    with torch.inference_mode():
        unfused = unfused_plan.execute(vals)[0][0]
    assert calls == [] and torch.equal(fused, unfused)
    with torch.inference_mode():
        _Plan(net, train=False).execute(_bf16(vals))
    assert calls == [torch.bfloat16] * 2


def _bf16(vals):
    """``amp.type_dict_for``'s dtypes: bf16 but for gammas, betas, moving
    statistics and labels."""
    return {k: v.to(torch.bfloat16) if k.endswith("_weight") or
            k.endswith("_bias") or k == "data" else v for k, v in vals.items()}


def test_fused_step_raises_under_autograd():
    net = _net(tmx)
    arg, aux = _seeded(_net(mx), SHAPE, seed=45)
    vals = _bf16({k: torch.from_numpy(v) for k, v in {**arg, **aux}.items()})
    vals["data"] = torch.ones(SHAPE, dtype=torch.bfloat16,
                              requires_grad=True)
    vals["softmax_label"] = torch.zeros(SHAPE[0])
    plan = _Plan(net, train=False)
    with torch.enable_grad(), pytest.raises(MXNetError, match="no backward"):
        plan.execute(vals)
    with torch.no_grad():
        out = plan.execute(vals)[0][0]
    assert out.shape == (SHAPE[0], 5)


def _module(pkg, monkeypatch, bf16, arg, aux):
    if bf16:
        monkeypatch.setenv("MXNET_TPU_BF16", "1")
    else:
        monkeypatch.delenv("MXNET_TPU_BF16", raising=False)
    mod = pkg.mod.Module(_net(pkg), context=[mx.cpu() if pkg is mx
                                             else cpu()])
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))],
             for_training=False)
    c = {} if pkg is mx else {"ctx": cpu()}
    mod.init_params(arg_params={k: pkg.nd.array(v, **c)
                                for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v, **c)
                                for k, v in aux.items()})
    return mod


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def _iter(pkg, X, Y):
    c = {} if pkg is mx else {"ctx": cpu()}
    return pkg.io.NDArrayIter(X, Y, batch_size=SHAPE[0], **c)


def _predict_and_score(pkg, mod, X, Y):
    p = np.asarray(mod.predict(_iter(pkg, X, Y)).asnumpy(), np.float32)
    return p, dict(mod.score(_iter(pkg, X, Y), "acc"))["accuracy"]


def test_module_bf16_predict_and_score_match_reference(monkeypatch):
    r = np.random.default_rng(46)
    X = r.standard_normal((16,) + SHAPE[1:]).astype(np.float32)
    Y = r.integers(0, 5, 16).astype(np.float32)
    sets = [_seeded(_net(mx), SHAPE, seed=s) for s in (47, 48)]
    calls = _count_kernel_calls(monkeypatch)

    def run(arg, aux):
        j16 = _module(mx, monkeypatch, True, arg, aux)
        j32 = _module(mx, monkeypatch, False, arg, aux)
        t16 = _module(tmx, monkeypatch, True, arg, aux)
        from_jax_module(j16, cpu(), mod=t16)
        ex = t16._exec_group.execs[0]
        assert ex.arg_dict["resnetv10_stage1_conv0_weight"]._data.dtype == \
            torch.bfloat16
        return [_predict_and_score(pkg, m, X, Y)
                for pkg, m in ((mx, j16), (mx, j32), (tmx, t16))], t16

    ((p16, _), (p32, acc32), (got, acc)), t16 = run(*sets[0])
    assert calls == [torch.bfloat16] * 8      # 2 blocks x 2 batches x 2 calls
    band = _rel(p16, p32)
    assert 0 < band < 0.2
    assert _rel(got, p32) <= BAND_FACTOR * band + BF16_STEP, (
        _rel(got, p32), band)
    # top-1 agrees wherever the fp32 run's margin is wider than the band
    top2 = np.sort(p32, axis=1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > 2 * BAND_FACTOR * np.abs(
        p16 - p32).max()
    assert wide.sum() >= 8
    assert (got.argmax(1) == p32.argmax(1))[wide].all()
    assert acc == pytest.approx(float(np.mean(got.argmax(1) == Y)))
    assert abs(acc - acc32) <= float(np.mean(~wide)) + 1e-9

    # set_params with the second weight set: the next predict follows it
    arg, aux = sets[1]
    t16.set_params({k: tmx.nd.array(v, cpu()) for k, v in arg.items()},
                   {k: tmx.nd.array(v, cpu()) for k, v in aux.items()})
    after, _ = _predict_and_score(tmx, t16, X, Y)
    ((q16, _), (q32, _), (fresh, _)), _ = run(arg, aux)
    np.testing.assert_array_equal(after, fresh)
    assert _rel(after, q32) <= BAND_FACTOR * _rel(q16, q32) + BF16_STEP
    assert _rel(after, got) > 10 * BAND_FACTOR * band


# --------------------------------------------------------------------------
# kernel 13's host plan, and a plain walk of it against the plain version
# --------------------------------------------------------------------------
H100_SMS = 132
# ResNet-50 v1's identity bottlenecks at batch 128, (H = W, Cin, Cm), and
# each one's plan on an H100: (warps along a chunk's rows, band rows, ring
# depth)
RESNET50_IDENTITY_PLANS = [((56, 256, 64), (8, 7, 2)),
                           ((28, 512, 128), (4, 7, 3)),
                           ((14, 1024, 256), (2, 7, 3)),
                           ((7, 2048, 512), (1, 7, 2))]


@pytest.mark.parametrize("shape,want", RESNET50_IDENTITY_PLANS)
def test_plan_at_the_resnet50_blocks(shape, want):
    """At the 4 identity-bottleneck shapes of a batch-128 ResNet-50: the
    layout, band and ring depth, buffers within the H100's shared memory,
    a chunk's columns no wider than the stages' own (no idle warps), one
    chunk of rows per stage (no weight slice read twice by a CTA), at
    least a CTA for every SM, and no layout or band the cost model prices
    lower."""
    H, Cin, Cm = shape
    plan = hb.fused_bottleneck_plan(128, H, H, Cin, Cm, H100_SMS)
    assert (plan.wm, plan.rows, plan.stages) == want
    assert plan.smem == hb._smem_bytes(plan.wm, plan.rows, H, Cm,
                                       plan.stages) <= hb.SMEM_LIMIT
    assert plan.bands == -(-H // plan.rows)
    bm, bn = 64 * plan.wm, 512 // plan.wm
    assert bn <= Cm and Cm % bn == 0
    assert (min(plan.rows + 1, H) + (plan.rows < H)) * H <= bm
    assert plan.grid == min(H100_SMS, 128 * plan.bands) >= 128
    for wm in hb._LAYOUTS:
        for R in range(1, H + 1):
            if hb._smem_bytes(wm, R, H, Cm, 2) <= hb.SMEM_LIMIT:
                other = hb._plan_for(128, H, H, Cin, Cm, H100_SMS, wm, R, 2)
                assert plan.slices <= other.slices


def test_plan_raises_where_nothing_fits_and_is_cached():
    with pytest.raises(MXNetError):
        hb.fused_bottleneck_plan(1, 4, 4000, 64, 512, H100_SMS)
    assert hb.fused_bottleneck_plan(2, 9, 9, 64, 32, H100_SMS) is \
        hb.fused_bottleneck_plan(2, 9, 9, 64, 32, H100_SMS)


def _walk_fused_plan(x, w1, w2, w3, b, plan):
    """Kernel 13's arithmetic in plain PyTorch as its plan lays it out: each
    CTA of the persistent grid keeps one h1 buffer ((R + 2) x (W + 2) rows,
    zero pad columns) and one h2 tile across its units (image, band); per
    unit it zeroes the h1 rows outside the image, computes h1 over the
    band's rows and its halo rows inside the image in chunks of 64 * wm
    rows by 512 / wm columns, then per chunk of the band's rows h2 (each
    output pixel gathering its 9 h1 rows) and out; fp32 sums, bf16 after
    each ReLU, the residual added in fp32."""
    N, H, W, C = x.shape
    Cm = w1.shape[0]
    bm, bn = 64 * plan.wm, 512 // plan.wm
    R, WP = plan.rows, W + 2
    f32, bf = torch.float32, torch.bfloat16
    xs, b = x.reshape(N, H * W, C).to(f32), b.to(f32)
    out = torch.full((N, H * W, C), float("nan"))
    units = N * plan.bands
    for k in range(plan.grid):
        h1 = torch.zeros(((R + 2) * WP, Cm))
        h2 = torch.zeros((bm, Cm))
        for u in range(k, units, plan.grid):
            img, band = divmod(u, plan.bands)
            r0 = band * R
            rows = min(R, H - r0)
            lo, hi = max(r0 - 1, 0), min(r0 + rows, H - 1)
            m1, m2 = (hi - lo + 1) * W, rows * W
            if r0 == 0:
                h1[:WP] = 0
            if r0 + rows == H:
                h1[(rows + 1) * WP:(rows + 2) * WP] = 0
            for mc in range(-(-m1 // bm)):
                m = torch.arange(mc * bm, min(mc * bm + bm, m1))
                for n0 in range(0, Cm, bn):
                    n1 = min(n0 + bn, Cm)
                    acc = xs[img, lo * W + m] @ w1[n0:n1].to(f32).t()
                    hrow = (lo + m // W - r0 + 1) * WP + m % W + 1
                    h1[hrow, n0:n1] = torch.relu(acc + b[0, n0:n1]) \
                        .to(bf).to(f32)
            for mc in range(-(-m2 // bm)):
                p = torch.arange(mc * bm, min(mc * bm + bm, m2))
                base = p // W * WP + p % W
                for n0 in range(0, Cm, bn):
                    n1 = min(n0 + bn, Cm)
                    acc = torch.zeros((len(p), n1 - n0))
                    for tap in range(9):
                        rows_h1 = base + tap // 3 * WP + tap % 3
                        acc += h1[rows_h1] @ w2[tap, n0:n1].to(f32).t()
                    h2[:len(p), n0:n1] = torch.relu(acc + b[1, n0:n1]) \
                        .to(bf).to(f32)
                for n0 in range(0, C, bn):
                    n1 = min(n0 + bn, C)
                    pix = r0 * W + p
                    acc = h2[:len(p)] @ w3[n0:n1].to(f32).t()
                    out[img, pix, n0:n1] = torch.relu(
                        acc + b[2, n0:n1] + xs[img, pix, n0:n1])
    assert not out.isnan().any()
    return out.to(bf).reshape(N, H, W, C)


def _seeded_block(N, H, W, Cin, Cm, seed):
    r = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(shape, scale):
        return torch.from_numpy((r.standard_normal(shape) * scale)
                                .astype(np.float32))
    x = torch.relu(t((N, H, W, Cin), 1.0)).to(bf)
    w1 = t((Cm, Cin), np.sqrt(2.0 / Cin)).to(bf)
    w2 = t((9, Cm, Cm), np.sqrt(2.0 / (9 * Cm))).to(bf)
    w3 = t((Cin, Cm), 0.2 * np.sqrt(2.0 / Cm)).to(bf)
    return x, w1, w2, w3, t((3, Cin), 0.1)


# (N, H, W, Cin, Cm, wm, band rows, grid): every layout, bands that leave a
# ragged last one, several chunks of rows a stage, columns off the chunk,
# fewer CTAs than units
@pytest.mark.parametrize("N,H,W,Cin,Cm,wm,R,grid", [
    (3, 7, 5, 64, 32, 8, 7, 2),      # whole images, Cm off the 64 columns
    (2, 9, 11, 128, 64, 1, 4, 3),    # 3 bands of 4, 4, 1 rows; 2 chunks
    (2, 6, 10, 64, 64, 2, 5, 2),     # a 1-row last band
    (1, 11, 9, 96, 32, 4, 3, 2),     # Cin off the 128 columns
])
def test_plan_walk_matches_plain(N, H, W, Cin, Cm, wm, R, grid):
    """The plain walk of kernel 13's launch (bands, halo rows, the gathered
    3x3, chunks, a persistent grid) against ``fused_bottleneck_plain``, in
    the tolerance chip_smoke.py holds the kernel to."""
    args = _seeded_block(N, H, W, Cin, Cm, 41)
    plan = hb._plan_for(N, H, W, Cin, Cm, grid, wm, R, 2)
    assert plan.grid == grid and plan.bands == -(-H // R)
    got = _walk_fused_plan(*args, plan)
    want = hb.fused_bottleneck_plain(*args)
    _assert_block_close(got.reshape(-1, Cin), want.float().reshape(-1, Cin))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel 13 against ``fused_bottleneck_plain`` on the same bf16 card
    tensors: the plan's own launch at ragged shapes, then each layout, band
    and ring depth forced at one shape, each call one launch, within one
    bf16 step plus 1e-3 of the largest |out|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [((1, 9, 11, 256, 64), None), ((3, 15, 17, 128, 32), None),
             ((2, 7, 7, 512, 128), None), ((4, 14, 14, 256, 64), None)]
    # every layout, h2 in h1's buffer and apart, several bands and chunks,
    # every ring depth (chip_smoke.py's FB_FORCED)
    cases += [((3, 9, 11, 128, 64), forced) for forced in (
        (1, 9, 2), (1, 3, 3), (2, 9, 4), (2, 2, 3), (4, 4, 3), (4, 9, 2),
        (8, 2, 2), (8, 1, 2))]
    for (N, H, W, Cin, Cm), forced in cases:
        args = [a.cuda() for a in _seeded_block(N, H, W, Cin, Cm, 42)]
        plan = (hb._plan_for(N, H, W, Cin, Cm, min(sms, 5), *forced)
                if forced else None)
        before = hb.launches
        got = hb._fused_bottleneck_cuda(*args, plan=plan)
        want = hb.fused_bottleneck_plain(*args)
        torch.cuda.synchronize()
        assert hb.launches == before + 1
        _assert_block_close(got.cpu().reshape(-1, Cin),
                            want.float().cpu().reshape(-1, Cin))


def test_cuda_arm_passes_the_plan(monkeypatch):
    """The CUDA arm on CPU tensors with the library, stream and SM count
    faked: the plan's layout, band, ring depth and grid reach the entry
    point, which takes as many arguments as its ctypes signature says and
    reports the plan's shared memory, and the launch counts; an operand off
    a 16-byte boundary or a channel count off 32 raises before any
    launch."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import hopper_conv as hc
    calls = []

    class Entry:
        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            calls.append(args)
            W, (Cm, wm, R, stages) = args[8], args[10:14]
            args[-1][0] = hb._smem_bytes(wm, R, W, Cm, stages)
            return 0

    class Lib:
        mxtt_fused_bottleneck = Entry()

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(hb, "_fn", None)
    monkeypatch.setattr(hb, "launches", 0)
    monkeypatch.setattr(hc, "_stream", lambda device: 0)
    monkeypatch.setattr(hc, "_sm_count", lambda device: H100_SMS)
    args = _seeded_block(128, 14, 14, 1024, 256, 43)
    out = hb._fused_bottleneck_cuda(*args)
    assert out.shape == args[0].shape and hb.launches == 1
    plan = hb.fused_bottleneck_plan(128, 14, 14, 1024, 256, H100_SMS)
    assert calls[0][6:15] == (128, 14, 14, 1024, 256, plan.wm, plan.rows,
                              plan.stages, plan.grid)
    buf = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16)
    misaligned = buf[1:].view(args[0].shape)
    with pytest.raises(MXNetError):
        hb._fused_bottleneck_cuda(misaligned, *args[1:])
    x, w1, w2, w3, b = _seeded_block(1, 5, 5, 48, 32, 44)
    with pytest.raises(MXNetError):
        hb._fused_bottleneck_cuda(x, w1, w2, w3, b)
    assert len(calls) == 1 and hb.launches == 1
