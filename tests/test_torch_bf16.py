"""bf16 mixed precision in the port (mxnet_tpu_torch) against the reference
(mxnet_tpu), on the CPU, from the same seeded numpy inputs.

- ``amp.type_dict_for`` gives the reference's dtypes; SGD's multi-precision
  state and update (``mp_sgd_update``/``mp_sgd_mom_update``) match the
  reference's (masters within rtol 1e-6: fp32 arithmetic, which XLA may
  contract into fused multiply-adds; bf16 weights within one bf16 step,
  2^-7), and inside the port the fused multi-precision update is
  bit-identical to the eager one.
- BatchNorm's bf16 training statistics are the reference's one-pass
  ``E[x^2] - E[x]^2`` (mean within 1e-6, var within 16 fp32 steps of
  E[x^2], the precision of that formula), also where mean^2 >> var; the
  output within one bf16 step of the largest ``|x * inv|`` (the folded
  normalization rounds that product before the shift cancels it), and no
  fp32 copy of the input is saved for the backward.  Global average
  pooling, FullyConnected, Activation, elementwise add and SoftmaxOutput
  give the reference's output dtypes on bf16 inputs, values within one
  bf16 step.
- A small bottleneck ResNet (widths 8-32, batch 8, 64 px) trained 3 steps
  by ``FusedTrainer(dtype="bfloat16")``, and a conv net trained 3 steps by
  ``Module`` under ``MXNET_TPU_BF16=1`` with multi-precision SGD.  bf16
  rounds at other places in the two packages, and the reference's own bf16
  run is far from exact here: its BatchNorm parameters' first-step
  gradients in the conv net are 70-200% of their norm away from its fp32
  ones (it reduces bf16 products in bf16), the port's 2-3%; and one bf16
  step of the bottleneck net is ill-conditioned in both.  So the port's
  bf16 run is held to the fp32 run (the reference's in the Module test;
  in the FusedTrainer test the port's, which equals the reference's fp32
  step within 1e-5): each loss and each parameter's update within
  ``BAND_FACTOR`` x the reference's own bf16-vs-fp32 distance + 2^-7 of
  its size, the band the reference's bf16 itself needs (measured: the
  port uses at most two thirds of that tolerance, at the bottleneck net's
  third loss; the median quantity a quarter and a twentieth in the two
  tests).  The port's fused and eager Module steps are bit-identical.
- bf16 weights carry across by ``weights.py`` and ``.params`` files bit for
  bit; a bf16 checkpoint with multi-precision ``.states`` round-trips;
  ``asnumpy`` of bf16 gives fp32 (a documented difference: the port does
  not import ``ml_dtypes``); ``FusedTrainer(dtype="float16")`` raises.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp, cpu, nd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import bf16_from_numpy
from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.weights import from_jax_block, from_jax_module

from test_torch_gluon import seeded_pair
from test_torch_module import make_module, seeded_params

BF16_STEP = 2.0 ** -7
BAND_FACTOR = 3.0
JBF16 = jamp.compute_dtype()


def _name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _conv_net(pkg, classes=4):
    """1x1 conv (bf16: kernel 12's path) and 3x3 conv, each with
    BatchNorm and relu, global pooling, FC, SoftmaxOutput."""
    s = pkg.sym
    x = s.var("data")
    for i, (k, p, c) in enumerate(((1, 0, 8), (3, 1, 8))):
        x = s.Convolution(x, kernel=(k, k), pad=(p, p), num_filter=c,
                          no_bias=True, name="conv%d" % i)
        x = s.BatchNorm(x, fix_gamma=False, name="bn%d" % i)
        x = s.Activation(x, act_type="relu", name="relu%d" % i)
    x = s.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg",
                  name="pool")
    x = s.FullyConnected(s.Flatten(x, name="flat"), num_hidden=classes,
                         name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def test_type_dict_matches_reference():
    want = {k: np.dtype(v).name for k, v in jamp.type_dict_for(
        _conv_net(mx), ["data"], ["softmax_label"]).items()}
    got = {k: _name(v) for k, v in amp.type_dict_for(
        _conv_net(tmx), ["data"], ["softmax_label"]).items()}
    assert got == want
    assert got["softmax_label"] == got["bn0_gamma"] == "float32"
    assert got["conv0_weight"] == got["data"] == "bfloat16"
    assert amp.is_low_precision(torch.bfloat16) and \
        amp.is_low_precision("float16") and not amp.is_low_precision("int8")


SGD_CONFIGS = [{"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
               {"learning_rate": 0.05}]


@pytest.mark.parametrize("kwargs", SGD_CONFIGS, ids=["momentum", "plain"])
def test_sgd_multi_precision_matches_reference(kwargs):
    rs = np.random.RandomState(3)
    w = rs.randn(4, 5).astype(np.float32)
    grads = [rs.randn(4, 5).astype(np.float32) for _ in range(5)]
    jo = jopt.create("sgd", multi_precision=True, **kwargs)
    to = topt.create("sgd", multi_precision=True, **kwargs)
    jw = mx.nd.array(w).astype(JBF16)
    tw = nd.array(w, cpu()).astype("bfloat16")
    jst = jo.create_state_multi_precision(0, jw)
    tst = to.create_state_multi_precision(0, tw)
    assert isinstance(tst, tuple) and len(tst) == 2
    assert (tst[0] is None) == (jst[0] is None)
    assert tst[1]._data.dtype == torch.float32
    for g in grads:
        jo.update_multi_precision(0, jw, mx.nd.array(g).astype(JBF16), jst)
        to.update_multi_precision(0, tw, nd.array(g, cpu()).astype(
            "bfloat16"), tst)
    np.testing.assert_allclose(tst[1].asnumpy(), jst[1].asnumpy(),
                               rtol=1e-6, atol=1e-7)
    if jst[0] is not None:
        np.testing.assert_allclose(tst[0].asnumpy(), jst[0].asnumpy(),
                                   rtol=1e-5, atol=1e-7)
    assert tw._data.dtype == torch.bfloat16
    np.testing.assert_allclose(tw.asnumpy(),
                               jw.asnumpy().astype(np.float32),
                               rtol=BF16_STEP, atol=0)


@pytest.mark.parametrize("kwargs", [
    {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    {"learning_rate": 0.05},
    {"learning_rate": 0.05, "momentum": 0.9, "clip_gradient": 0.5},
], ids=["momentum_wd", "plain", "momentum_clip"])
def test_fused_mp_update_is_bit_identical_to_eager(kwargs):
    """The fused update's multi-precision arm (foreach kernels over the flat
    state ``(master, mom)``) against the eager ``mp_sgd`` ops, 20 steps."""
    rs = np.random.RandomState(5)
    w = rs.randn(6, 7).astype(np.float32)
    grads = [nd.array(rs.randn(6, 7).astype(np.float32), cpu())
             .astype("bfloat16") for _ in range(20)]
    oe, of = (topt.create("sgd", multi_precision=True, rescale_grad=0.125,
                          **kwargs) for _ in range(2))
    we, wf = (nd.array(w, cpu()).astype("bfloat16") for _ in range(2))
    se = oe.create_state_multi_precision(0, we)
    sf = of.create_state_multi_precision(0, wf)
    assert of.supports_fused(wf)
    assert not topt.create("sgd", **kwargs).supports_fused(wf)
    leaves = topt.fused_state_leaves(sf, mp=True)
    assert leaves[0] is sf[1] and len(leaves) == 1 + (sf[0] is not None)
    for g in grads:
        oe.update_multi_precision(0, we, g, se)
        of.fused_update([0], [wf._data], [g._data.clone()],
                        [tuple(leaf._data for leaf in leaves)])
    assert torch.equal(sf[1]._data, se[1]._data)
    assert torch.equal(wf._data, we._data)
    if se[0] is not None:
        assert torch.equal(sf[0]._data, se[0]._data)
    assert oe._index_update_count == of._index_update_count


@pytest.mark.parametrize("offset,scale", [(0.0, 1.0), (16.0, 0.1)],
                         ids=["unit", "mean2_gg_var"])
def test_batchnorm_bf16_statistics_match_reference(offset, scale):
    r = np.random.default_rng(21)
    x = (offset + scale * r.standard_normal((6, 5, 7, 7))).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = bf16_from_numpy(np.asarray(xj))
    gamma = r.uniform(0.8, 1.2, 5).astype(np.float32)
    beta = (0.1 * r.standard_normal(5)).astype(np.float32)
    mm, mv = np.zeros(5, np.float32), np.ones(5, np.float32)
    raw = {"fix_gamma": "False", "eps": "1e-5", "momentum": "0.0"}
    jop, top = jax_get_op("BatchNorm"), get_op("BatchNorm")
    want = jop.fn(jop.parse_attrs(dict(raw, __train__=True)), xj,
                  *[jnp.asarray(a) for a in (gamma, beta, mm, mv)])
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t

    xt.requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        got = top.fn(dict(top.parse_attrs(dict(raw)), __train__=True), xt,
                     *[torch.from_numpy(a) for a in (gamma, beta, mm, mv)])
    # momentum 0: outputs 1 and 2 are the batch mean and variance
    mean, var = got[1].numpy(), got[2].numpy()
    np.testing.assert_allclose(mean, np.asarray(want[1]), rtol=1e-6,
                               atol=1e-6)
    ex2 = np.mean(np.square(np.asarray(xj, np.float64)), axis=(0, 2, 3))
    np.testing.assert_allclose(var, np.asarray(want[2]), rtol=0,
                               atol=float(16 * 2.0 ** -24 * ex2.max()))
    assert (var >= 0).all()
    assert got[0].dtype == torch.bfloat16
    # the folded normalization rounds x * inv to bf16 before the shift
    # cancels it: one bf16 step of the largest |x * inv|
    inv = gamma / np.sqrt(np.asarray(want[2]) + 1e-5)
    np.testing.assert_allclose(got[0].detach().float().numpy(),
                               np.asarray(want[0], np.float32), rtol=0,
                               atol=BF16_STEP * np.abs(x).max() * inv.max())
    assert saved and not any(dt == torch.float32 and n == x.size
                             for dt, n in saved), saved


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_band(got, ref16, ref32, what):
    """``got`` (the port in bf16) against ``ref32`` (the reference in fp32)
    within BAND_FACTOR x the reference's own bf16 distance from it (``ref16``)
    + one bf16 step, relative."""
    band = _rel(ref16, ref32)
    err = _rel(got, ref32)
    assert err <= BAND_FACTOR * band + BF16_STEP, (what, err, band)


def _zero_grad_bias(name):
    # conv biases feeding BatchNorm: zero gradient, rounding residue only
    return re.search(r"conv\d+_bias$", name) is not None


def test_fused_trainer_bf16_matches_reference():
    make = lambda pkg: pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1],
                                    [8, 16, 24, 28, 32], classes=10)
    r = np.random.default_rng(0)
    x = r.uniform(size=(8, 3, 64, 64)).astype(np.float32)
    y = r.integers(0, 10, 8).astype(np.float32)
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    runs = {}
    # the fp32 anchor is the port's run, which matches the reference's
    # fp32 step within 1e-5 (test_torch_train.py), without a third compile
    for pkg, dtype in ((mx, "bfloat16"), (tmx, "float32"), (tmx, "bfloat16")):
        jnet, net = seeded_pair(make, x)
        net = jnet if pkg is mx else net
        net.hybridize()
        ft = pkg.FusedTrainer(net, "softmax_cross_entropy", "sgd", dict(opt),
                              dtype=dtype)
        c = {} if pkg is mx else {"ctx": cpu()}
        w0 = {k: np.asarray(p.data().asnumpy(), np.float32)
              for k, p in net.collect_params().items()}
        losses = [float(ft.step(pkg.nd.array(x, **c),
                                pkg.nd.array(y, **c)).asnumpy())
                  for _ in range(3)]
        ft.sync_params()
        w3 = {k: np.asarray(p.data().asnumpy(), np.float32)
              for k, p in net.collect_params().items()}
        runs[pkg.__name__, dtype] = (losses, w3, w0)
        if pkg is tmx and dtype == "bfloat16":
            assert {str(v.dtype) for v in ft._args.values()} == \
                {"torch.float32"}
            assert {str(v.dtype) for v in ft._auxs.values()} == \
                {"torch.float32"}
    jl, jw, w0 = runs["mxnet_tpu", "bfloat16"]
    jl32, jw32, _ = runs["mxnet_tpu_torch", "float32"]
    tl, tw, _ = runs["mxnet_tpu_torch", "bfloat16"]
    for i in range(3):
        _check_band(np.float64(tl[i]), np.float64(jl[i]), np.float64(jl32[i]),
                    "loss %d" % i)
    for k in w0:
        if "running" in k or _zero_grad_bias(k):
            continue
        _check_band(tw[k] - w0[k], jw[k] - w0[k], jw32[k] - w0[k], k)


def test_fused_trainer_float16_raises():
    net = tmx.gluon.nn.Dense(2)
    with pytest.raises(MXNetError, match="float16.*not ported"):
        tmx.FusedTrainer(net, dtype="float16")


def _train(pkg, mod, data):
    losses = []
    for x, y in data:
        c = {} if pkg is mx else {"ctx": cpu()}
        mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x, **c)],
                                              [pkg.nd.array(y, **c)]))
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float64)
        losses.append(float(np.mean(-np.log(p[np.arange(len(y)),
                                               y.astype(int)]))))
    return losses


def _module(pkg, net, shape, params, monkeypatch, bf16, fused="1"):
    if bf16:
        monkeypatch.setenv("MXNET_TPU_BF16", "1")
    else:
        monkeypatch.delenv("MXNET_TPU_BF16", raising=False)
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", fused)
    return make_module(pkg, net, shape, params,
                       ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                "multi_precision": bf16}))


def _host(mod):
    arg, _ = mod.get_params()
    return {k: np.asarray(v.asnumpy(), np.float32) for k, v in arg.items()}


def test_module_bf16_matches_reference(monkeypatch):
    shape = (8, 3, 8, 8)
    params = seeded_params(_conv_net(mx), shape, seed=31)
    r = np.random.default_rng(32)
    data = [(r.standard_normal(shape).astype(np.float32),
             r.integers(0, 4, 8).astype(np.float32)) for _ in range(3)]
    jmod = _module(mx, _conv_net(mx), shape, params, monkeypatch, True)
    jl = _train(mx, jmod, data)
    j32 = _module(mx, _conv_net(mx), shape, params, monkeypatch, False)
    jl32 = _train(mx, j32, data)
    tmod = _module(tmx, _conv_net(tmx), shape, params, monkeypatch, True)
    ex = tmod._exec_group.execs[0]
    assert ex.arg_dict["conv0_weight"]._data.dtype == torch.bfloat16
    assert ex.arg_dict["bn0_gamma"]._data.dtype == torch.float32
    assert ex.arg_dict["softmax_label"]._data.dtype == torch.float32
    assert ex.aux_dict["bn0_moving_var"]._data.dtype == torch.float32
    tl = _train(tmx, tmod, data)
    st = tmod._updater.states[0]
    assert isinstance(st, tuple) and st[1]._data.dtype == torch.float32
    emod = _module(tmx, _conv_net(tmx), shape, params, monkeypatch, True,
                   fused="0")
    el = _train(tmx, emod, data)
    assert el == tl
    for k, w in _host(emod).items():
        assert np.array_equal(w, _host(tmod)[k]), k
    masters = [(i, st[1]) for i, st in emod._updater.states.items()
               if isinstance(st, tuple)]
    assert len(masters) == 4          # conv0, conv1, fc weight and bias
    for i, w32 in masters:
        assert torch.equal(w32._data, tmod._updater.states[i][1]._data)
    jw, jw32, tw = _host(jmod), _host(j32), _host(tmod)
    w0 = params[0]
    for i in range(3):
        _check_band(np.float64(tl[i]), np.float64(jl[i]), np.float64(jl32[i]),
                    "loss %d" % i)
    for k in w0:
        _check_band(tw[k] - w0[k], jw[k] - w0[k], jw32[k] - w0[k], k)

    # the reference Module's bf16 weights and multi-precision states carry
    # into a bound port Module bit for bit
    cmod = _module(tmx, _conv_net(tmx), shape, params, monkeypatch, True)
    from_jax_module(jmod, cpu(), mod=cmod, optimizer_states=True)
    cex = cmod._exec_group.execs[0]
    for k, v in jmod.get_params()[0].items():
        want = np.asarray(v.asnumpy())
        got = cex.arg_dict[k]._data
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), k
        else:
            assert np.array_equal(got.numpy(), want), k
    carried = 0
    for i, jst in jmod._updater.states.items():
        tst = cmod._updater.state(i, cex.arg_dict[cmod._param_names[i]])
        if isinstance(jst, tuple):
            carried += 1
            np.testing.assert_array_equal(tst[1].asnumpy(), jst[1].asnumpy())
            tst, jst = tst[0], jst[0]
        np.testing.assert_array_equal(tst.asnumpy(), jst.asnumpy())
    assert carried == 4


def test_bf16_checkpoint_with_mp_states_round_trips(tmp_path, monkeypatch):
    shape = (8, 3, 8, 8)
    params = seeded_params(_conv_net(tmx), shape, seed=41)
    r = np.random.default_rng(42)
    data = [(r.standard_normal(shape).astype(np.float32),
             r.integers(0, 4, 8).astype(np.float32)) for _ in range(2)]
    mod = _module(tmx, _conv_net(tmx), shape, params, monkeypatch, True)
    _train(tmx, mod, data[:1])
    prefix = str(tmp_path / "bf16")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    with np.load(prefix + "-0001.params.npz", allow_pickle=False) as z:
        assert z["name:arg:conv0_weight"].dtype.str == "|V2"
        assert z["name:arg:bn0_gamma"].dtype == np.float32
    lmod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=[cpu()])
    lmod.bind(data_shapes=[("data", shape)],
              label_shapes=[("softmax_label", (shape[0],))])
    lmod.init_optimizer(kvstore="local", optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9, "multi_precision": True})
    lex, ex = lmod._exec_group.execs[0], mod._exec_group.execs[0]
    for k in mod._param_names:
        assert lex.arg_dict[k]._data.dtype == ex.arg_dict[k]._data.dtype
        assert torch.equal(lex.arg_dict[k]._data, ex.arg_dict[k]._data), k
    masters = 0
    for i, st in mod._updater.states.items():
        lst = lmod._updater.state(i, lex.arg_dict[mod._param_names[i]])
        if isinstance(st, tuple):
            masters += 1
            assert torch.equal(lst[1]._data, st[1]._data)
            st, lst = st[0], lst[0]
        assert torch.equal(lst._data, st._data)
    assert masters == 4
    assert _train(tmx, lmod, data[1:]) == _train(tmx, mod, data[1:])
    assert all(torch.equal(lex.arg_dict[k]._data, ex.arg_dict[k]._data)
               for k in mod._param_names)


def test_bf16_weights_and_files_carry_over_bit_for_bit(tmp_path):
    x = np.zeros((1, 3, 32, 32), np.float32)
    make = lambda pkg: pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1],
                                    [8, 16, 24, 28, 32], classes=10)
    jnet, net = seeded_pair(make, x)
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    from_jax_block(jnet, net, cpu())
    for k, p in jnet.collect_params().items():
        want = np.asarray(p.data().asnumpy())
        got = net.collect_params()[k].data()._data
        assert want.dtype.name == "bfloat16" and got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), k

    # a .params file the reference wrote, and one the port writes
    w = np.random.default_rng(51).standard_normal((3, 4)).astype(np.float32)
    jarr = mx.nd.array(w).astype(JBF16)
    mx.nd.save(str(tmp_path / "ref.params"), {"w": jarr})
    loaded = nd.load(str(tmp_path / "ref.params"), cpu())["w"]
    assert loaded._data.dtype == torch.bfloat16
    assert np.array_equal(loaded._data.view(torch.int16).numpy(),
                          np.asarray(jarr.asnumpy()).view(np.int16))
    nd.save(str(tmp_path / "port.params"), {"w": loaded})
    with np.load(str(tmp_path / "ref.params.npz")) as a, \
            np.load(str(tmp_path / "port.params.npz")) as b:
        assert a["name:w"].dtype.str == b["name:w"].dtype.str == "|V2"
        assert a["name:w"].tobytes() == b["name:w"].tobytes()


def test_asnumpy_of_bf16_is_float32():
    """A documented difference: without ``ml_dtypes`` the port returns a
    bf16 array's values as float32, exactly; the reference returns
    ``ml_dtypes.bfloat16``."""
    w = np.array([1.5, -2.25, 3.0078125], np.float32)
    t = nd.array(w, cpu(), dtype="bfloat16")
    assert t._data.dtype == torch.bfloat16 and t.dtype == torch.bfloat16
    got = t.asnumpy()
    want = mx.nd.array(w).astype(JBF16).asnumpy()
    assert got.dtype == np.float32 and want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_module_bf16_init_draws_fp32_then_casts(monkeypatch):
    """``init_params`` draws the initializer in fp32 and casts the draw to
    the bound dtype, as the reference's does: under the flag every weight
    is the fp32 run's rounded to bf16, gammas and betas stay fp32."""
    shape = (8, 3, 8, 8)
    runs = {}
    for bf16 in (False, True):
        if bf16:
            monkeypatch.setenv("MXNET_TPU_BF16", "1")
        mod = tmx.mod.Module(_conv_net(tmx), context=[cpu()])
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (shape[0],))])
        tmx.random.seed(7)
        mod.init_params(tmx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
        ex = mod._exec_group.execs[0]
        runs[bf16] = {k: ex.arg_dict[k]._data for k in mod._param_names}
    for k, w in runs[False].items():
        want = torch.bfloat16 if amp.type_dict_for(
            _conv_net(tmx), ["data"], ["softmax_label"])[k] \
            == torch.bfloat16 else torch.float32
        assert runs[True][k].dtype == want, k
        assert torch.equal(runs[True][k], w.to(want)), k


@pytest.mark.parametrize("name,attrs,shapes", [
    ("Pooling", {"global_pool": "True", "kernel": "(1, 1)",
                 "pool_type": "avg"}, [(4, 6, 5, 5)]),
    ("FullyConnected", {"num_hidden": "7"}, [(4, 12), (7, 12), (7,)]),
    ("Activation", {"act_type": "relu"}, [(4, 6, 3)]),
    ("elemwise_add", {}, [(4, 6), (4, 6)]),
    ("SoftmaxOutput", {}, [(4, 10), (4,)]),
], ids=["global_avg_pool", "fc", "relu", "add", "softmax_output"])
def test_ops_in_bf16_match_reference(name, attrs, shapes):
    """The other ops of the bf16 ResNet step on bf16 inputs: the output
    dtype is the reference's (SoftmaxOutput's probabilities fp32, the rest
    bf16), and the values agree within one bf16 step (fp32 accumulation on
    both sides, rounded once)."""
    r = np.random.default_rng(61)
    ins = []
    for i, s in enumerate(shapes):
        if name == "SoftmaxOutput" and i == 1:
            ins.append(r.integers(0, 10, s).astype(np.float32))
        else:
            ins.append(r.standard_normal(s).astype(np.float32))
    jins = [jnp.asarray(a) if name == "SoftmaxOutput" and i == 1
            else jnp.asarray(a, jnp.bfloat16) for i, a in enumerate(ins)]
    tins = [torch.from_numpy(a) if name == "SoftmaxOutput" and i == 1
            else bf16_from_numpy(np.asarray(j)) for i, (a, j)
            in enumerate(zip(ins, jins))]
    jop, top = jax_get_op(name), get_op(name)
    want = jop.fn(jop.parse_attrs(dict(attrs)), *jins)
    got = top.fn(top.parse_attrs(dict(attrs)), *tins)
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    assert _name(got.dtype) == np.dtype(want.dtype).name
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=BF16_STEP,
                               atol=1e-3 * np.abs(w).max())
