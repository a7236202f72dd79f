"""The imperative training loop of the port (``autograd.record``,
``backward``, ``gluon.Trainer.step``) against the reference's, on the
CPU, from the same seeded weights and batches.

- A tiny ResNet v1 (bottleneck, one block a stage, widths 16-256, 10
  classes, batch 4, 64 px, SGD lr 0.01, momentum 0.9) trained 3 steps by
  the port hybridized and not, each against the reference's hybridized
  loop: every step's per-example loss within rtol 1e-4, and after step 1
  every parameter and running statistic within 1e-5 * max(1, |p|).
- The Trainer's fused update arm (``Optimizer.fused_update``) and its
  per-parameter updater, bit for bit, for SGD (with and without momentum
  and weight decay), NAG, Adam and RMSProp.
- ``grad_req="add"``, ``lr_mult=0``, ``ignore_stale_grad`` and two CPU
  contexts (summed through the local kvstore), each against the
  reference within rtol 1e-5, atol 1e-6.
- A reference ``.states`` file loaded into the port's Trainer.
- ``Parameter._load_init`` with a wrong shape: ``MXNetError`` in the
  port, ``AssertionError`` in the reference (a difference, not a fault).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError

from test_torch_gluon import seeded_pair

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6


def _tiny(pkg):
    return pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1],
                        [16, 32, 64, 128, 256], classes=10)


def _batch(n, px, classes, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 3, px, px)).astype(np.float32)
    y = r.integers(0, classes, (n,)).astype(np.float32)
    return x, y


def _params(net):
    return {k: p.list_data()[0].asnumpy()
            for k, p in net.collect_params().items()}


def _loop(pkg, net, batches, ctx=None, opt=None):
    """Losses and the parameters after each step of the Gluon loop."""
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           opt or {"learning_rate": 0.01, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {} if pkg is mx else {"ctx": ctx or cpu()}
    losses, params = [], []
    for x, y in batches:
        x, y = pkg.nd.array(x, **kw), pkg.nd.array(y, **kw)
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(x.shape[0])
        losses.append(loss.asnumpy())
        params.append(_params(net))
    return losses, params


@pytest.fixture(scope="module")
def reference_loop():
    x, _ = _batch(4, 64, 10, 0)
    jnet, _ = seeded_pair(_tiny, x)
    for p in jnet.collect_params().values():
        if not p.name.endswith(("running_mean", "running_var")):
            p.grad_req = "write"
    jnet.hybridize()
    batches = [_batch(4, 64, 10, s) for s in range(3)]
    return batches, _loop(mx, jnet, batches)


@pytest.mark.parametrize("hybridize", [True, False])
def test_tiny_resnet_loop_matches_reference(reference_loop, hybridize):
    batches, (want_l, want_p) = reference_loop
    _, net = seeded_pair(_tiny, batches[0][0])
    if hybridize:
        net.hybridize()
    got_l, got_p = _loop(tmx, net, batches)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)
    assert sorted(got_p[0]) == sorted(want_p[0])
    bad = {k: float(np.abs(got_p[0][k] - w).max()) for k, w in
           want_p[0].items() if not np.all(np.abs(got_p[0][k] - w)
                                           <= PARAM_TOL * np.maximum(
                                               1.0, np.abs(w)))}
    assert not bad, bad
    moved = [k for k, w in want_p[0].items()
             if k.endswith("running_var") and not np.allclose(w, got_p[0][k]
                                                              * 0 + 1)]
    assert moved


def test_not_hybridized_step_goes_op_by_op():
    """Without ``hybridize()`` no CachedOp is built: every layer runs its
    ``hybrid_forward`` on ``nd``, recorded."""
    x, y = _batch(2, 32, 10, 4)
    _, net = seeded_pair(_tiny, x)
    _loop(tmx, net, [(x, y)])
    assert net._cached_op is None and not net._active


def _mlp(pkg, act="relu"):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation=act))
        net.add(pkg.gluon.nn.Dense(4))
    return net


def _mlp_pair(x, seed=0, ctx=None):
    """A reference and a port MLP with the same seeded weights."""
    with mx.name.NameManager():
        jnet = _mlp(mx)
    with tmx.name.NameManager():
        net = _mlp(tmx)
    net.initialize(ctx=ctx or [cpu()])
    net(tmx.nd.array(x, ctx=(ctx or [cpu()])[0]))
    r = np.random.default_rng(seed)
    values = {k: (r.standard_normal(p.shape) * 0.3).astype(np.float32)
              for k, p in net.collect_params().items()}
    jnet.initialize(ctx=[mx.cpu(i) for i in range(len(ctx or [cpu()]))])
    jnet(mx.nd.array(x))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(values[k]))
    for k, p in net.collect_params().items():
        p.set_data(tmx.nd.array(values[k], ctx=cpu()))
    return jnet, net


_OPTS = [("sgd", {"learning_rate": 0.1}),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
         ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
         ("adam", {"learning_rate": 0.01}),
         ("rmsprop", {"learning_rate": 0.01}),
         ("rmsprop", {"learning_rate": 0.01, "centered": True})]


@pytest.mark.parametrize("name,opt", _OPTS,
                         ids=["sgd", "sgd-mom-wd", "nag", "adam", "rmsprop",
                              "rmsprop-centered"])
def test_fused_and_per_parameter_arms_bit_equal(monkeypatch, name, opt):
    x = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 4, 8).astype(np.float32)
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_FUSED_STEP", flag)
        _, net = _mlp_pair(x)
        tr = tmx.gluon.Trainer(net.collect_params(), name, dict(opt))
        fused = []
        tr._fused_update = (lambda f: lambda live: fused.append(1) or
                            f(live))(tr._fused_update)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(x, ctx=cpu())),
                               tmx.nd.array(y, ctx=cpu()))
            loss.backward()
            tr.step(8)
        assert bool(fused) == (flag == "1")
        states = [s for k in sorted(tr._updaters[0].states)
                  for s in np.atleast_1d(np.asarray(
                      [a.asnumpy() for a in _leaves(tr._updaters[0]
                                                    .states[k])],
                      dtype=object))]
        out.append((_params(net), states))
    (p1, s1), (p0, s0) = out
    for k in p0:
        np.testing.assert_array_equal(p1[k], p0[k])
    assert len(s1) == len(s0)
    for a, b in zip(s1, s0):
        np.testing.assert_array_equal(a, b)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _imperative_steps(pkg, net, x, y, steps, trainer, ctxs=None,
                      backwards=1, ignore_stale_grad=False):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        for _ in range(backwards):
            parts = [(x, y)] if ctxs is None else \
                list(zip(np.split(x, len(ctxs)), np.split(y, len(ctxs))))
            for i, (xp, yp) in enumerate(parts):
                kw = {} if pkg is mx else {
                    "ctx": cpu() if ctxs is None else ctxs[i]}
                if pkg is mx and ctxs is not None:
                    kw = {"ctx": mx.cpu(i)}
                with pkg.autograd.record():
                    loss = loss_fn(net(pkg.nd.array(xp, **kw)),
                                   pkg.nd.array(yp, **kw))
                loss.backward()
        trainer.step(x.shape[0], ignore_stale_grad=ignore_stale_grad)
    return _params(net)


def _compare(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _data():
    r = np.random.default_rng(3)
    return (r.standard_normal((8, 6)).astype(np.float32),
            r.integers(0, 4, 8).astype(np.float32))


def test_grad_req_add_matches_reference():
    x, y = _data()
    jnet, net = _mlp_pair(x)
    res = []
    for pkg, n in ((mx, jnet), (tmx, net)):
        n.collect_params().setattr("grad_req", "add")
        tr = pkg.gluon.Trainer(n.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        res.append(_imperative_steps(pkg, n, x, y, 2, tr, backwards=2))
    _compare(res[1], res[0])
    g = next(iter(net.collect_params().values()))
    assert g.grad_req == "add"
    g.zero_grad()
    assert not g.grad().asnumpy().any()


def test_lr_mult_zero_matches_reference():
    x, y = _data()
    jnet, net = _mlp_pair(x)
    before = _params(net)
    res = []
    for pkg, n in ((mx, jnet), (tmx, net)):
        first = list(n.collect_params().values())[0]
        first.lr_mult = 0.0
        tr = pkg.gluon.Trainer(n.collect_params(), "sgd",
                               {"learning_rate": 0.1, "wd": 0.01})
        res.append(_imperative_steps(pkg, n, x, y, 2, tr))
    _compare(res[1], res[0])
    first = list(before)[0]
    np.testing.assert_array_equal(res[1][first], before[first])


def test_ignore_stale_grad_matches_reference():
    """A parameter outside the graph keeps its old (zero) gradient and is
    updated all the same (weight decay), as in the reference."""
    x, y = _data()
    res = []
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            jnet, net = _mlp_pair(x)
        n = jnet if pkg is mx else net
        extra = n.params.get("unused", shape=(3,),
                             init=pkg.init.Constant(0.5))
        extra.initialize(ctx=mx.cpu() if pkg is mx else cpu())
        tr = pkg.gluon.Trainer(n.collect_params(), "sgd",
                               {"learning_rate": 0.1, "wd": 0.1})
        res.append(_imperative_steps(pkg, n, x, y, 2, tr,
                                     ignore_stale_grad=True))
    _compare(res[1], res[0])
    stale = [k for k in res[1] if k.endswith("unused")]
    np.testing.assert_allclose(res[1][stale[0]], 0.5 * (1 - 0.01) ** 2,
                               rtol=1e-6)


def test_two_contexts_match_reference_and_one():
    x, y = _data()
    ctxs = [cpu(0), cpu(1)]
    jnet, net = _mlp_pair(x, ctx=ctxs)
    res = []
    for pkg, n, cs in ((mx, jnet, [mx.cpu(0), mx.cpu(1)]), (tmx, net, ctxs)):
        tr = pkg.gluon.Trainer(n.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        res.append(_imperative_steps(pkg, n, x, y, 2, tr, ctxs=cs))
        assert tr._kvstore is not None
    _compare(res[1], res[0])
    for p in net.collect_params().values():
        a, b = (d.asnumpy() for d in p.list_data())
        np.testing.assert_array_equal(a, b)
        assert [d.context for d in p.list_data()] == ctxs
    _, one = _mlp_pair(x)
    tr = tmx.gluon.Trainer(one.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    _compare(_imperative_steps(tmx, one, x, y, 2, tr), res[1])


def test_reference_states_load_into_port_trainer(tmp_path):
    x, y = _data()
    jnet, net = _mlp_pair(x)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    _imperative_steps(mx, jnet, x, y, 2, jtr)
    jtr.save_states(str(tmp_path / "ref.states"))
    for k, p in net.collect_params().items():
        p.set_data(tmx.nd.array(jnet.collect_params()[k].data().asnumpy(),
                                ctx=cpu()))
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    tr.load_states(str(tmp_path / "ref.states"))
    assert tr._optimizer.num_update == jtr._optimizer.num_update
    want = _imperative_steps(mx, jnet, x, y, 1, jtr)
    got = _imperative_steps(tmx, net, x, y, 1, tr)
    _compare(got, want)
    tr.save_states(str(tmp_path / "port.states"))
    jtr.load_states(str(tmp_path / "port.states"))


def test_trainer_learning_rate_and_update_split():
    x, y = _data()
    _, net = _mlp_pair(x)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    assert tr.learning_rate == 0.1
    tr.set_learning_rate(0.2)
    assert tr.learning_rate == 0.2
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(tmx.nd.array(x, ctx=cpu())),
                       tmx.nd.array(y, ctx=cpu()))
    loss.backward()
    w = list(net.collect_params().values())[0]
    before, g = w.data().asnumpy(), w.grad().asnumpy()
    tr.allreduce_grads()
    tr.update(8)
    np.testing.assert_allclose(w.data().asnumpy(), before - 0.2 * g / 8,
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tmx.gluon.Trainer([1, 2], "sgd")


def test_load_init_shape_check_differs_only_in_exception_type():
    """A wrong shape is refused by both packages: the port's ``shape``
    setter raises ``MXNetError``, the reference's ``_load_init``
    ``AssertionError``."""
    p = tmx.gluon.Parameter("w", shape=(3, 4))
    with pytest.raises(MXNetError, match="incompatible"):
        p._load_init(np.zeros((3, 5), np.float32), [cpu()])
    jp = mx.gluon.Parameter("w", shape=(3, 4))
    with pytest.raises(AssertionError):
        jp._load_init(mx.nd.zeros((3, 5)), mx.cpu())
    p._load_init(np.ones((3, 4), np.float32), [cpu()])
    assert p.grad().shape == (3, 4)


def test_parameter_grad_req_and_reset_ctx():
    p = tmx.gluon.Parameter("w", shape=(2,), init=tmx.init.Constant(1.0))
    p.initialize(ctx=[cpu()])
    assert p.data()._data.requires_grad and p.grad() is not None
    p.grad_req = "null"
    assert p._grad is None and not p.data()._data.requires_grad
    with pytest.raises(MXNetError, match="null"):
        p.grad()
    p.grad_req = "add"
    assert p.list_grad()[0].shape == (2,)
    p.reset_ctx([cpu(0), cpu(1)])
    assert p.list_ctx() == [cpu(0), cpu(1)]
    np.testing.assert_array_equal(p.data(cpu(1)).asnumpy(), [1.0, 1.0])
    p.set_data(tmx.nd.array([3.0, 4.0], ctx=cpu()))
    for d in p.list_data():
        np.testing.assert_array_equal(d.asnumpy(), [3.0, 4.0])


def _loss_inputs():
    r = np.random.default_rng(5)
    pred = r.standard_normal((4, 5)).astype(np.float32)
    dense = r.uniform(0.1, 1.0, (4, 5)).astype(np.float32)
    dense /= dense.sum(axis=1, keepdims=True)
    return {
        "pred": pred, "prob": 1 / (1 + np.exp(-pred)),
        "logprob": pred - np.log(np.exp(pred).sum(1, keepdims=True)),
        "target": r.standard_normal((4, 5)).astype(np.float32),
        "binary": r.integers(0, 2, (4, 5)).astype(np.float32),
        "signed": (2 * r.integers(0, 2, (4, 5)) - 1).astype(np.float32),
        "sparse": r.integers(0, 5, (4,)).astype(np.float32),
        "dense": dense, "counts": r.integers(0, 4, (4, 5)).astype(np.float32),
        "pos": (r.standard_normal((4, 5)) + 0.1).astype(np.float32),
        "neg": r.standard_normal((4, 5)).astype(np.float32),
        "weight": r.uniform(0.5, 1.5, (4, 1)).astype(np.float32)}


# (loss class, constructor keywords, input names; the first input is
# differentiated, ``weight`` is the sample weight)
_LOSSES = [
    ("L2Loss", {}, ("pred", "target", "weight")),
    ("L1Loss", {}, ("pred", "target", "weight")),
    ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "binary", "weight")),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
     ("prob", "binary")),
    ("SoftmaxCrossEntropyLoss", {}, ("pred", "sparse", "weight")),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True},
     ("logprob", "sparse")),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, ("pred", "dense")),
    ("KLDivLoss", {}, ("logprob", "dense", "weight")),
    ("KLDivLoss", {"from_logits": False}, ("pred", "dense")),
    ("HuberLoss", {"rho": 0.7}, ("pred", "target", "weight")),
    ("HingeLoss", {}, ("pred", "signed", "weight")),
    ("SquaredHingeLoss", {"margin": 1.5}, ("pred", "signed")),
    ("LogisticLoss", {}, ("pred", "signed", "weight")),
    ("LogisticLoss", {"label_format": "binary"}, ("pred", "binary")),
    ("TripletLoss", {"margin": 0.5}, ("pred", "pos", "neg")),
    ("PoissonNLLLoss", {}, ("pred", "counts")),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     ("prob", "counts")),
]


@pytest.mark.parametrize("name,kwargs,inputs", _LOSSES,
                         ids=["%s-%d" % (l[0], i)
                              for i, l in enumerate(_LOSSES)])
def test_loss_matches_reference(name, kwargs, inputs):
    """Each Gluon loss, op by op under autograd (and hybridized in the
    port), against the reference: the per-example loss and the gradient
    of its sum within rtol 1e-5, atol 1e-6."""
    vals = _loss_inputs()
    out = []
    for pkg, hybrid in ((mx, False), (tmx, False), (tmx, True)):
        kw = {} if pkg is mx else {"ctx": cpu()}
        arrays = [pkg.nd.array(vals[n], **kw) for n in inputs]
        arrays[0].attach_grad()
        loss = getattr(pkg.gluon.loss, name)(**kwargs)
        if hybrid:
            loss.hybridize()
        with pkg.autograd.record():
            val = loss(*arrays)
        val.backward()
        out.append((val.asnumpy(), arrays[0].grad.asnumpy()))
    for got in out[1:]:
        for g, w in zip(got, out[0]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_block_hooks_and_plain_block():
    """Forward pre-hooks and hooks run around ``__call__`` and detach; a
    plain Block's ``forward`` runs user code over ``nd``, recorded."""
    seen = []

    class Twice(tmx.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = tmx.gluon.nn.Dense(3)

        def forward(self, x):
            return tmx.nd.relu(self.dense(x)) * 2.0

    net = Twice()
    # a fixed weight keeps every ReLU alive, whatever the generator's state
    # after the tests that ran before this one
    net.initialize(tmx.init.Constant(0.25), ctx=cpu())
    pre = net.register_forward_pre_hook(lambda b, a: seen.append(("pre", b)))
    post = net.register_forward_hook(
        lambda b, a, o: seen.append(("post", o.shape)))
    x = tmx.nd.array(np.ones((2, 4), np.float32), ctx=cpu())
    with tmx.autograd.record():
        y = net(x)
    y.backward()
    assert seen == [("pre", net), ("post", (2, 3))]
    assert net.dense.weight.grad().asnumpy().any()
    pre.detach()
    post.detach()
    net(x)
    assert len(seen) == 2
    applied = []
    net.apply(lambda b: applied.append(type(b).__name__))
    assert applied == ["Dense", "Twice"]


def test_set_data_before_a_deferred_initialization():
    """``set_data`` on a parameter whose shape is still unknown takes the
    initializer's place when the shape arrives."""
    p = tmx.gluon.Parameter("w", shape=(0, 3), allow_deferred_init=True)
    p.initialize(ctx=[cpu()])
    p.set_data(tmx.nd.array(np.full((2, 3), 7.0, np.float32), ctx=cpu()))
    p._finish_deferred_init()
    np.testing.assert_array_equal(p.data().asnumpy(), np.full((2, 3), 7.0))
    assert p.grad().shape == (2, 3)
