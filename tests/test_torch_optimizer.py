"""The port's optimizers, schedulers, update ops and updater states
(mxnet_tpu_torch) against the reference's (mxnet_tpu), on the CPU.

- every optimizer of ``mxnet_tpu/optimizer.py`` (some in several
  settings), through an ``Updater`` over three parameters (weight, bias,
  gamma names, so the weight-decay rules apply), five steps of seeded
  gradients: weights and states within rtol 1e-5, atol 1e-6 (the same
  fp32 arithmetic, one op order each) after every step; SGLD's noise is
  the device generator's, so its mean and spread are held instead;
- every scheduler, alone and through an optimizer, at each update count;
- the twelve update ops, ``nd.<name>_update`` against the reference op at
  rtol 1e-6;
- ``__lr_mult__``/``__wd_mult__`` symbol attributes, ``param_dict`` and
  ``begin_num_update``;
- ``Updater.get_states``/``set_states`` across the packages, both ways.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.weights import from_jax_updater

RTOL, ATOL = 1e-5, 1e-6
NAMES = ["fc_weight", "fc_bias", "bn_gamma"]
SHAPES = [(4, 3), (4,), (4,)]
STEPS = 5

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5, "rescale_grad": 0.5}),
    ("signum", {"learning_rate": 0.01, "wd_lh": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 1.0}),
    ("ftml", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.05, "clip_weights": 0.3}),
    ("ftrl", {"learning_rate": 0.1, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 1.0}),
    ("adadelta", {"wd": 0.01}),
    ("adamax", {"wd": 0.01}),
    ("nadam", {"wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"rescale_grad": 0.5}),
]


def _ids(configs):
    return ["%s-%d" % (name, i) for i, (name, _) in enumerate(configs)]


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state.asnumpy()]


def _pair(name, kwargs, lr_scheduler=None):
    """(reference updater, port updater) for the same optimizer."""
    idx2name = dict(enumerate(NAMES))
    jkw, tkw = dict(kwargs), dict(kwargs)
    if lr_scheduler is not None:
        jkw["lr_scheduler"] = lr_scheduler(mx.lr_scheduler)
        tkw["lr_scheduler"] = lr_scheduler(tmx.lr_scheduler)
    jopt = mx.optimizer.create(name, param_idx2name=idx2name, **jkw)
    topt = tmx.optimizer.create(name, param_idx2name=idx2name, **tkw)
    return mx.optimizer.get_updater(jopt), tmx.optimizer.get_updater(topt)


def _steps(jup, tup, seed, steps=STEPS, check=True):
    r = np.random.default_rng(seed)
    ws = [r.standard_normal(s).astype(np.float32) for s in SHAPES]
    jw = [mx.nd.array(w) for w in ws]
    tw = [tmx.nd.array(w, tmx.cpu()) for w in ws]
    for step in range(steps):
        for i, s in enumerate(SHAPES):
            g = r.standard_normal(s).astype(np.float32)
            jup(i, mx.nd.array(g), jw[i])
            tup(i, tmx.nd.array(g, tmx.cpu()), tw[i])
        if check:
            for i in range(len(SHAPES)):
                msg = "step %d, %s" % (step, NAMES[i])
                np.testing.assert_allclose(tw[i].asnumpy(), jw[i].asnumpy(),
                                           rtol=RTOL, atol=ATOL, err_msg=msg)
                js, ts = _leaves(jup.states[i]), _leaves(tup.states[i])
                assert len(ts) == len(js), msg
                for a, b in zip(ts, js):
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                               err_msg=msg)
    return jw, tw


@pytest.mark.parametrize("case", range(len(OPTIMIZERS)),
                         ids=_ids(OPTIMIZERS))
def test_optimizer_matches_reference_step_for_step(case):
    name, kwargs = OPTIMIZERS[case]
    jup, tup = _pair(name, kwargs)
    _steps(jup, tup, seed=100 + case)
    assert tup.optimizer.num_update == jup.optimizer.num_update


def test_sgld_noise():
    """SGLD: ``w - lr/2 (g + wd w) + N(0, lr)``; the noise comes from the
    port's own generator, so over 40,000 entries its mean is within 0.01
    and its std within 1% of sqrt(lr)."""
    lr, wd = 0.04, 0.1
    opt = tmx.optimizer.create("sgld", learning_rate=lr, wd=wd,
                               param_idx2name={0: "w_weight"})
    r = np.random.default_rng(1)
    w = r.standard_normal(40000).astype(np.float32)
    g = r.standard_normal(40000).astype(np.float32)
    tw = tmx.nd.array(w, tmx.cpu())
    tmx.optimizer.get_updater(opt)(0, tmx.nd.array(g, tmx.cpu()), tw)
    noise = tw.asnumpy() - (w - lr / 2 * (g + wd * w))
    assert abs(noise.mean()) < 0.01
    assert abs(noise.std() / np.sqrt(lr) - 1) < 0.01


SCHEDULERS = [
    ("FactorScheduler", lambda m: m.FactorScheduler(step=3, factor=0.5,
                                                    stop_factor_lr=0.01)),
    ("MultiFactorScheduler",
     lambda m: m.MultiFactorScheduler(step=[2, 5, 9], factor=0.3)),
    ("PolyScheduler", lambda m: m.PolyScheduler(max_update=20, base_lr=0.1,
                                                pwr=2)),
    ("CosineScheduler", lambda m: m.CosineScheduler(max_update=20,
                                                    base_lr=0.1,
                                                    final_lr=0.01)),
    ("WarmupScheduler", lambda m: m.WarmupScheduler(
        4, m.FactorScheduler(step=3, factor=0.5))),
]


@pytest.mark.parametrize("case", range(len(SCHEDULERS)),
                         ids=[s[0] for s in SCHEDULERS])
def test_scheduler_matches_reference(case):
    """The rate at each update count 0..30 (exact: the same float64
    arithmetic), then through SGD with momentum over five steps."""
    make = SCHEDULERS[case][1]
    js, ts = make(mx.lr_scheduler), make(tmx.lr_scheduler)
    for n in range(31):
        assert ts(n) == js(n), n
    jup, tup = _pair("sgd", {"learning_rate": 0.2, "momentum": 0.9}, make)
    _steps(jup, tup, seed=7 + case)


UPDATE_OPS = [
    ("sgd_update", 0, {}),
    ("sgd_mom_update", 1, {"momentum": 0.9}),
    ("nag_mom_update", 1, {"momentum": 0.9}),
    ("mp_sgd_update", 1, {}),
    ("mp_sgd_mom_update", 2, {"momentum": 0.9}),
    ("adam_update", 2, {"beta1": 0.9, "beta2": 0.99}),
    ("rmsprop_update", 1, {"gamma1": 0.9, "clip_weights": 0.5}),
    ("rmspropalex_update", 3, {"gamma1": 0.9, "gamma2": 0.8}),
    ("ftrl_update", 2, {"lamda1": 0.01}),
    ("ftml_update", 3, {"t": 3}),
    ("signsgd_update", 0, {}),
    ("signum_update", 1, {"momentum": 0.9, "wd_lh": 0.01}),
]


@pytest.mark.parametrize("case", range(len(UPDATE_OPS)),
                         ids=[o[0] for o in UPDATE_OPS])
def test_update_op_matches_reference(case):
    """``nd.<name>_update(w, g, *states, out=w)`` against the reference op
    on the same inputs: the new weight in ``out`` and each new state
    written back into its input, rtol 1e-6; the mp ops keep an fp32 master
    beside an fp32 weight here."""
    name, nstates, extra = UPDATE_OPS[case]
    r = np.random.default_rng(case)
    arrays = [r.standard_normal((3, 5)).astype(np.float32)
              for _ in range(2 + nstates)]
    if name.startswith("ftrl") or name.startswith("ftml") or \
            name.startswith("rmsprop"):
        arrays[2] = np.abs(arrays[2])           # n / d / v are >= 0
    attrs = dict(extra, lr=0.05, wd=0.01, rescale_grad=0.5,
                 clip_gradient=1.0)
    jop = jax_get_op(name)
    want = jop.fn(jop.parse_attrs({k: str(v) for k, v in attrs.items()}),
                  *[jnp.asarray(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    ins = [tmx.nd.array(a, tmx.cpu()) for a in arrays]
    out = getattr(tmx.nd, name)(*ins, out=ins[0], **attrs)
    assert out is ins[0]
    got = [ins[0]] + ins[2:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_lr_wd_mult_and_param_dict_match_reference():
    """``__lr_mult__``/``__wd_mult__`` on a variable, the bias rule, a
    ``param_dict`` entry and ``begin_num_update``: the same lr and wd for
    every slot, and the same update count."""

    class P:
        lr_mult, wd_mult = 3.0, 0.25

    def build(pkg):
        w = pkg.sym.var("fc_weight", attr={"__lr_mult__": "0.5",
                                           "__wd_mult__": "2"})
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), weight=w,
                                     num_hidden=3, name="fc")
        names = [n for n in net.list_arguments() if n != "data"]
        return pkg.optimizer.create(
            "sgd", sym=net, learning_rate=0.1, wd=0.01, begin_num_update=7,
            param_idx2name=dict(enumerate(names + ["other_weight"])),
            param_dict={"other_weight": P()})

    jo, to = build(mx), build(tmx)
    for i in range(3):
        assert to._get_lr(i) == jo._get_lr(i), i
        assert to._get_wd(i) == jo._get_wd(i), i
    assert to.num_update == jo.num_update == 7


def _states_equal(tup, jup):
    assert sorted(tup.states) == sorted(jup.states)
    for k in jup.states:
        for a, b in zip(_leaves(tup.states[k]), _leaves(jup.states[k])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"learning_rate": 0.01}),
    ("rmsprop", {"centered": True}),
    ("sgd", {"momentum": 0.9}),
    ("dcasgd", {"learning_rate": 0.1}),
], ids=["adam", "rmsprop_c", "sgd_mom", "dcasgd"])
def test_updater_states_carry_across(name, kwargs):
    """A reference ``.states`` pickle loads into the port's updater and the
    port's into the reference's, bit for bit; after the carry
    (``weights.from_jax_updater``, counts included) both train on in step
    for two more steps."""
    jup, tup = _pair(name, kwargs)
    jw, _ = _steps(jup, tup, seed=3, steps=2, check=False)
    blob = jup.get_states(dump_optimizer=True)
    fresh = tmx.optimizer.get_updater(_pair(name, kwargs)[1].optimizer)
    fresh.set_states(blob)
    _states_equal(fresh, jup)
    assert fresh.optimizer.num_update == jup.optimizer.num_update
    back = mx.optimizer.get_updater(_pair(name, kwargs)[0].optimizer)
    back.set_states(fresh.get_states())
    _states_equal(fresh, back)
    assert isinstance(pickle.loads(fresh.get_states()), dict)
    # train on from the carried states
    port = tmx.optimizer.get_updater(_pair(name, kwargs)[1].optimizer)
    from_jax_updater(jup, port)
    r = np.random.default_rng(9)
    tw = [tmx.nd.array(w.asnumpy(), tmx.cpu()) for w in jw]
    for _ in range(2):
        for i, s in enumerate(SHAPES):
            g = r.standard_normal(s).astype(np.float32)
            jup(i, mx.nd.array(g), jw[i])
            port(i, tmx.nd.array(g, tmx.cpu()), tw[i])
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def test_fused_update_matches_eager_update():
    """SGD, NAG, Adam and RMSProp (plain, centered, clip_weights): the
    foreach ``fused_update`` over all slots at once against the eager
    per-slot update, three steps, rtol 1e-5 (another op order)."""
    for name, kwargs in [("sgd", {"momentum": 0.9, "wd": 0.01}),
                         ("nag", {"momentum": 0.9, "wd": 0.01}),
                         ("adam", {"learning_rate": 0.01, "wd": 0.01,
                                   "clip_gradient": 0.5}),
                         ("rmsprop", {"learning_rate": 0.01}),
                         ("rmsprop", {"centered": True,
                                      "clip_weights": 0.8})]:
        _, eager = _pair(name, kwargs)
        _, fused = _pair(name, kwargs)
        r = np.random.default_rng(11)
        ws = [r.standard_normal(s).astype(np.float32) for s in SHAPES]
        ew = [tmx.nd.array(w, tmx.cpu()) for w in ws]
        fw = [tmx.nd.array(w, tmx.cpu()) for w in ws]
        assert all(fused.optimizer.supports_fused(w) for w in fw)
        for _ in range(3):
            gs = [r.standard_normal(s).astype(np.float32) for s in SHAPES]
            for i, g in enumerate(gs):
                eager(i, tmx.nd.array(g, tmx.cpu()), ew[i])
            states = [fused.state(i, w) for i, w in enumerate(fw)]
            tens = [tuple(x._data for x in s) if isinstance(s, tuple)
                    else (None if s is None else s._data) for s in states]
            fused.optimizer.fused_update(
                list(range(3)), [w._data for w in fw],
                [torch.from_numpy(g.copy()) for g in gs], tens)
        for a, b in zip(fw, ew):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        assert fused.optimizer.num_update == eager.optimizer.num_update
