"""The classic Module API of the port (mxnet_tpu_torch) against the
reference's (mxnet_tpu), on the CPU, at small sizes: an MLP and a
two-block conv net, each ending in ``SoftmaxOutput``, both packages fed the
same seeded numpy weights and batches.

- ROADMAP's SoftmaxOutput repro (FC(3) -> SoftmaxOutput, batch 8 x 5,
  ``default_rng(0)``, one SGD step at lr 1.0) moves ``fc_weight`` as the
  reference does, 0.2416 at most, on the fused and on the eager path;
- the six optimizer settings of ``tests/test_fused_step.py`` train the MLP
  for three steps: the port's fused step against its eager path and both
  against the reference Module, parameters within rtol 1e-4, atol 1e-6;
- ``fit`` (2 epochs of an ``NDArrayIter``, acc and ce, with the overlapped
  tail and without), then ``score`` and ``predict``, on the conv net:
  parameters within 1e-4, metrics within 1e-5, predictions within 1e-5;
- ``.params`` and ``.states`` files that one package writes are loaded by
  the other's ``Module.load`` and train on in step (Adam, 2 steps);
- two contexts (``[cpu(0), cpu(1)]`` and ``[cpu(0), cpu(0)]``, the batch
  split between them and the gradients summed by the local kvstore)
  match one context on the MLP;
- ``fixed_param_names``, ``grad_req`` by name and ``get_input_grads``
  against the reference;
- ``fit`` refuses ``MXNET_CKPT_DIR``, whose fault tolerance is not ported.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.weights import from_jax_module

PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
BATCH = 8

OPT_CONFIGS = [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("sgd", {"learning_rate": 0.05}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
]
OPT_IDS = ["sgd_m", "sgd", "nag_m", "adam", "rmsprop", "rmsprop_c"]


def mlp(pkg, hidden=16, classes=4):
    s = pkg.sym
    x = s.FullyConnected(s.var("data"), num_hidden=hidden, name="fc1")
    x = s.Activation(x, act_type="relu", name="relu1")
    x = s.FullyConnected(x, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(x, name="softmax")


def convnet(pkg, classes=4):
    """Two conv blocks (3x3 conv, BatchNorm, relu), pooling, FC."""
    s = pkg.sym
    x = s.var("data")
    for i, c in enumerate((4, 8)):
        x = s.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=c,
                          no_bias=True, name="conv%d" % i)
        x = s.BatchNorm(x, fix_gamma=False, name="bn%d" % i)
        x = s.Activation(x, act_type="relu", name="relu%d" % i)
    x = s.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg",
                  name="pool")
    x = s.FullyConnected(s.Flatten(x, name="flat"), num_hidden=classes,
                         name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def seeded_params(net, data_shape, seed):
    """Numpy weights for every argument and auxiliary state of ``net``
    (the reference's shapes), from ``default_rng(seed)``."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    r = np.random.default_rng(seed)
    arg = {n: (0.3 * r.standard_normal(s)).astype(np.float32)
           for n, s in zip(net.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if "var" in n else np.zeros(s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def batches(data_shape, n, seed, classes=4):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(data_shape).astype(np.float32),
             r.integers(0, classes, data_shape[0]).astype(np.float32))
            for _ in range(n)]


def make_module(pkg, net, data_shape, params, opt, ctx=None, **kw):
    ctx = ctx or ([mx.cpu()] if pkg is mx else [tmx.cpu()])
    mod = pkg.mod.Module(net, context=ctx, **kw)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (data_shape[0],))])
    arg, aux = params
    c = {} if pkg is mx else {"ctx": tmx.cpu()}
    mod.init_params(arg_params={k: pkg.nd.array(v, **c)
                                for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v, **c)
                                for k, v in aux.items()})
    if opt is not None:
        mod.init_optimizer(kvstore="local", optimizer=opt[0],
                           optimizer_params=dict(opt[1]))
    return mod


def batch_of(pkg, x, y):
    c = {} if pkg is mx else {"ctx": tmx.cpu()}
    return pkg.io.DataBatch([pkg.nd.array(x, **c)], [pkg.nd.array(y, **c)])


def train(pkg, mod, data):
    for x, y in data:
        mod.forward_backward(batch_of(pkg, x, y))
        mod.update()
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def assert_params_close(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_softmax_output_module_step_moves_weights(monkeypatch, fused):
    """ROADMAP Queue 3 fault 1: before the fix the port moved
    ``fc_weight`` by 2.3e-10 and the reference by 0.2416."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", fused)
    r = np.random.default_rng(0)
    x = r.standard_normal((8, 5)).astype(np.float32)
    y = r.integers(0, 3, 8).astype(np.float32)
    w = (0.1 * r.standard_normal((3, 5))).astype(np.float32)
    params = ({"fc_weight": w, "fc_bias": np.zeros(3, np.float32)}, {})
    moved = []
    for pkg in (mx, tmx):
        s = pkg.sym
        net = s.SoftmaxOutput(s.FullyConnected(s.var("data"), num_hidden=3,
                                               name="fc"), name="softmax")
        mod = make_module(pkg, net, (8, 5), params,
                          ("sgd", {"learning_rate": 1.0}))
        moved.append(train(pkg, mod, [(x, y)])["fc_weight"] - w)
    assert np.abs(moved[0]).max() == pytest.approx(0.2416, abs=1e-4)
    np.testing.assert_allclose(moved[1], moved[0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", range(len(OPT_CONFIGS)), ids=OPT_IDS)
def test_optimizer_configs_fused_eager_and_reference(monkeypatch, case):
    net_shape = (BATCH, 10)
    params = seeded_params(mlp(mx), net_shape, seed=case)
    data = batches(net_shape, 3, seed=20 + case)
    opt = OPT_CONFIGS[case]
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_FUSED_STEP", flag)
        mod = make_module(tmx, mlp(tmx), net_shape, params, opt)
        out[flag] = train(tmx, mod, data)
        assert mod._fused_step.eligible() == (flag == "1")
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "0")
    want = train(mx, make_module(mx, mlp(mx), net_shape, params, opt), data)
    assert_params_close(out["1"], out["0"])
    assert_params_close(out["1"], want)


@pytest.mark.parametrize("overlap", [2, 0], ids=["overlapped", "serial"])
def test_fit_score_predict_match_reference(monkeypatch, overlap):
    """``fit`` for 2 epochs over 20 rows in batches of 8 (the last padded),
    SGD with momentum, acc and ce, a batch callback; then ``score`` and
    ``predict`` over the same iterator."""
    monkeypatch.delenv("MXNET_CKPT_DIR", raising=False)
    shape = (BATCH, 3, 6, 6)
    params = seeded_params(convnet(mx), shape, seed=5)
    r = np.random.default_rng(6)
    X = r.standard_normal((20, 3, 6, 6)).astype(np.float32)
    Y = r.integers(0, 4, 20).astype(np.float32)
    res = {}
    for pkg in (mx, tmx):
        c = {} if pkg is mx else {"ctx": tmx.cpu()}
        it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH, **c)
        mod = pkg.mod.Module(convnet(pkg),
                             context=[mx.cpu()] if pkg is mx
                             else [tmx.cpu()])
        seen = []
        mod.fit(it, num_epoch=2, eval_metric=["acc", "ce"],
                optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                                   "momentum": 0.9},
                arg_params={k: pkg.nd.array(v, **c)
                            for k, v in params[0].items()},
                aux_params={k: pkg.nd.array(v, **c)
                            for k, v in params[1].items()},
                batch_end_callback=lambda p: seen.append(
                    (p.epoch, p.nbatch, p.eval_metric.get_name_value())),
                overlap_depth=overlap)
        arg, aux = mod.get_params()
        res[pkg] = ({k: v.asnumpy() for k, v in {**arg, **aux}.items()},
                    seen, mod.score(it, ["acc", "ce"]),
                    mod.predict(it).asnumpy())
    (tp, tseen, tscore, tpred), (jp, jseen, jscore, jpred) = \
        res[tmx], res[mx]
    assert_params_close(tp, jp)
    assert [s[:2] for s in tseen] == [s[:2] for s in jseen]
    for (_, _, tnv), (_, _, jnv) in zip(tseen, jseen):
        assert [n for n, _ in tnv] == [n for n, _ in jnv]
        np.testing.assert_allclose([v for _, v in tnv], [v for _, v in jnv],
                                   rtol=1e-5)
    assert [n for n, _ in tscore] == ["accuracy", "cross-entropy"]
    np.testing.assert_allclose([v for _, v in tscore],
                               [v for _, v in jscore], rtol=1e-5)
    assert tpred.shape == (20, 4)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpred.sum(1), 1.0, rtol=1e-6)


def _load_module(pkg, prefix, epoch, shape, opt):
    ctx = [mx.cpu()] if pkg is mx else [tmx.cpu()]
    mod = pkg.mod.Module.load(prefix, epoch, load_optimizer_states=True,
                              context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    mod.init_params()                 # loaded params count as initialised
    mod.init_optimizer(optimizer=opt[0], optimizer_params=dict(opt[1]))
    return mod


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_with_states_carries_across(tmp_path, monkeypatch,
                                               writer):
    """One package trains 2 Adam steps and saves with
    ``save_optimizer_states``; each package's ``Module.load(...,
    load_optimizer_states=True)`` reads the files (the states bit for bit)
    and trains 2 more steps, in step with the other.  (The ``.states``
    file holds no update counts, so in both packages a loaded Adam starts
    its bias correction again, unlike the writer itself.)"""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    shape = (BATCH, 10)
    params = seeded_params(mlp(mx), shape, seed=8)
    data = batches(shape, 4, seed=9)
    opt = ("adam", {"learning_rate": 0.01})
    src = mx if writer == "reference" else tmx
    first = make_module(src, mlp(src), shape, params, opt)
    train(src, first, data[:2])
    prefix = str(tmp_path / "ck")
    first.save_checkpoint(prefix, 3, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0003.states")
    mods = {pkg: _load_module(pkg, prefix, 3, shape, opt)
            for pkg in (mx, tmx)}
    for pkg, mod in mods.items():
        assert sorted(mod._updater.states) == sorted(first._updater.states)
    for k, st in first._updater.states.items():
        for a, b in zip(st, mods[tmx]._updater.states[k]):
            np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    assert_params_close(train(tmx, mods[tmx], data[2:]),
                        train(mx, mods[mx], data[2:]))


@pytest.mark.parametrize("second", [1, 0], ids=["cpu0-cpu1", "cpu0-cpu0"])
def test_two_contexts_match_one(monkeypatch, second):
    """The batch split over ``[cpu(0), cpu(1)]``, or a list that repeats
    one device as the port's meshes do (5 and 3 rows by
    ``work_load_list``), the gradients summed by the local kvstore: the
    same parameters and outputs as one context (rtol 1e-5)."""
    shape = (BATCH, 10)
    params = seeded_params(mlp(mx), shape, seed=12)
    data = batches(shape, 3, seed=13)
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    one = make_module(tmx, mlp(tmx), shape, params, opt)
    two = make_module(tmx, mlp(tmx), shape, params, opt,
                      ctx=[tmx.cpu(0), tmx.cpu(second)],
                      work_load_list=[5, 3])
    assert [e.arg_dict["data"].shape[0] for e in two._exec_group.execs] \
        == [5, 3]
    assert not two._fused_step.eligible()
    assert_params_close(train(tmx, two, data), train(tmx, one, data),
                        rtol=1e-5)
    b = batch_of(tmx, *data[0])
    for m in (one, two):
        m.forward(b, is_train=False)
    np.testing.assert_allclose(two.get_outputs()[0].asnumpy(),
                               one.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-7)
    parts = two.get_outputs(merge_multi_context=False)[0]
    assert [p.shape[0] for p in parts] == [5, 3]


def test_fixed_params_grad_req_and_input_grads(monkeypatch):
    """``fixed_param_names`` stay put, ``grad_req={'fc2_bias': 'null'}``
    too, and ``get_input_grads`` equals the reference's."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    shape = (BATCH, 10)
    params = seeded_params(mlp(mx), shape, seed=14)
    x, y = batches(shape, 1, seed=15)[0]
    got = {}
    for pkg in (mx, tmx):
        mod = pkg.mod.Module(mlp(pkg), fixed_param_names=["fc1_weight"],
                             context=[mx.cpu()] if pkg is mx
                             else [tmx.cpu()])
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (BATCH,))],
                 inputs_need_grad=True, grad_req={"fc2_bias": "null"})
        c = {} if pkg is mx else {"ctx": tmx.cpu()}
        mod.init_params(arg_params={k: pkg.nd.array(v, **c)
                                    for k, v in params[0].items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        mod.forward_backward(batch_of(pkg, x, y))
        mod.update()
        grads = mod.get_input_grads()[0].asnumpy()
        arg, _ = mod.get_params()
        got[pkg] = (grads, {k: v.asnumpy() for k, v in arg.items()})
    (tg, tp), (jg, jp) = got[tmx], got[mx]
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    assert np.abs(tg).max() > 0
    assert_params_close(tp, jp)
    for k in ("fc1_weight", "fc2_bias"):
        np.testing.assert_array_equal(tp[k], params[0][k])
    assert not np.array_equal(tp["fc2_weight"], params[0]["fc2_weight"])


def test_reference_module_weights_and_states_carry_over(monkeypatch):
    """``weights.from_jax_module(..., optimizer_states=True)``: a port
    Module set from a reference Module mid-training (RMSProp) trains on
    in step with it."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "0")
    shape = (BATCH, 10)
    params = seeded_params(mlp(mx), shape, seed=16)
    data = batches(shape, 4, seed=17)
    opt = ("rmsprop", {"learning_rate": 0.01, "centered": True})
    jmod = make_module(mx, mlp(mx), shape, params, opt)
    train(mx, jmod, data[:2])
    tmod = make_module(tmx, mlp(tmx), shape, seeded_params(mlp(mx), shape,
                                                           seed=99), opt)
    from_jax_module(jmod, tmx.cpu(), mod=tmod, optimizer_states=True)
    assert_params_close(train(tmx, tmod, data[2:]),
                        train(mx, jmod, data[2:]))


def test_fit_refuses_ckpt_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_CKPT_DIR", str(tmp_path))
    it = tmx.io.NDArrayIter(np.zeros((8, 10), np.float32),
                            np.zeros(8, np.float32), batch_size=8,
                            ctx=tmx.cpu())
    mod = tmx.mod.Module(mlp(tmx), context=[tmx.cpu()])
    with pytest.raises(MXNetError, match="not ported"):
        mod.fit(it, num_epoch=1)
    with pytest.raises(MXNetError, match="not ported"):
        tmx.kvstore.create("dist_sync")
