"""The bucketed LSTM LM of ``example/rnn/bucketing/lstm_bucketing.py``
through the port (mxnet_tpu_torch) against the reference (mxnet_tpu), on
the CPU, at a small size; the reference's LSTM recurrence runs its Pallas
kernel in the interpreter (``pallas_rnn.INTERPRET``).

- ``rnn.BucketSentenceIter``, NT and TN, given buckets and the default
  ones: buckets, ``provide_data``/``provide_label`` and every batch (data,
  label, ``bucket_key``, its own descriptors) over two epochs, equal, from
  one numpy and one ``random`` seed;
- the ``transpose`` and ``zeros`` ops, forward and ``jax.vjp`` against
  autograd, within 1e-6;
- ``init.FusedRNN``'s packed layout (each block at its own shape, the
  forget-gate bias), ``LSTMBias``, ``Bilinear``, ``Orthogonal`` from one
  numpy seed and ``Mixed``'s pattern dispatch: exact;
- ``metric.Perplexity``, which picks the label's probabilities where the
  prediction lies, bit for bit the reference's, with and without
  ``ignore_label``, for ``axis`` 0 and -1, labels flat and (B, T);
- the example's model (vocab 64, embed = hidden = 32, 2 layers, batch 8,
  buckets 5 and 10, Adam lr 0.01) through ``mod.BucketingModule``, the
  port's initialised by the example's ``Mixed``/``FusedRNN`` initializer
  and then set to the reference's seeded weights and Adam states by
  ``weights.from_jax_module``, trained
  over 4 batches that switch buckets: every batch's outputs within rtol
  1e-4, the final parameters and Adam states within 1e-5 of their scale,
  as many bound buckets as the reference's, and in the port every
  bucket's executors on the default bucket's parameter, gradient and
  auxiliary NDArrays (one tensor each).
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.ops import pallas_rnn
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.weights import from_jax_module

OP_TOL = 1e-6
OUT_RTOL = 1e-4
STATE_TOL = 1e-5
LM = dict(vocab=64, hidden=32, layers=2, batch=8, buckets=(5, 10))


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_rnn.INTERPRET = True
    yield
    pallas_rnn.INTERPRET = False


def _ctx(pkg):
    return {} if pkg is mx else {"ctx": tmx.cpu()}


def _corpus(n, vocab, lengths, seed):
    """Ragged token-id sentences from ``default_rng(seed)``, ids in [1,
    vocab) (0 pads)."""
    r = np.random.default_rng(seed)
    return [list(r.integers(1, vocab, int(r.choice(lengths))))
            for _ in range(n)]


def _iter(pkg, sentences, seed, **kw):
    np.random.seed(seed)
    random.seed(seed)
    return pkg.rnn.BucketSentenceIter(sentences, LM["batch"], **kw,
                                      **_ctx(pkg))


def _batches(it, epochs=2):
    """The iterator's batches over ``epochs`` epochs (its first epoch is
    the one its construction shuffled)."""
    out = list(it)
    for _ in range(epochs - 1):
        it.reset()
        out.extend(it)
    return out


@pytest.mark.parametrize("layout", ["NT", "TN"])
@pytest.mark.parametrize("buckets", [[5, 10], None], ids=["given", "default"])
def test_bucket_sentence_iter_matches_reference(layout, buckets):
    # lengths 1 (no target), 4, 9 and 12 (past the largest given bucket)
    sents = _corpus(60, LM["vocab"], [1, 4, 4, 9, 9, 12], seed=3)
    ref = _iter(mx, sents, 11, buckets=buckets, invalid_label=0,
                layout=layout)
    want = _batches(ref)
    got = _iter(tmx, sents, 11, buckets=buckets, invalid_label=0,
                layout=layout)
    have = _batches(got)
    assert got.buckets == ref.buckets
    assert got.default_bucket_key == ref.default_bucket_key
    assert got.provide_data == ref.provide_data
    assert got.provide_label == ref.provide_label
    assert len(have) == len(want) > 2
    for b, a in zip(have, want):
        assert b.bucket_key == a.bucket_key and b.pad == a.pad == 0
        assert b.provide_data == a.provide_data
        assert b.provide_label == a.provide_label
        np.testing.assert_array_equal(b.data[0].asnumpy(),
                                      a.data[0].asnumpy())
        np.testing.assert_array_equal(b.label[0].asnumpy(),
                                      a.label[0].asnumpy())


@pytest.mark.parametrize("axes", [(1, 0, 2), (), (2, 0, 1)],
                         ids=["tnc", "reverse", "cyclic"])
def test_transpose_matches_reference(axes):
    r = np.random.default_rng(5)
    x = r.standard_normal((3, 4, 5)).astype(np.float32)
    attrs = {"axes": str(axes)}
    jop, top = jax_get_op("transpose"), get_op("transpose")
    jattrs = jop.parse_attrs(dict(attrs))
    want, vjp = jax.vjp(lambda a: jop.fn(jattrs, a), jnp.asarray(x))
    g = r.standard_normal(want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = top.fn(top.parse_attrs(dict(attrs)), xt)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0,
                               atol=OP_TOL)
    # the Symbol method and the nd function are the same op
    s = tmx.sym.var("x").transpose(axes=axes)
    ex = s.simple_bind(tmx.cpu(), x=x.shape)
    np.testing.assert_array_equal(ex.forward(x=x)[0].asnumpy(),
                                  got.detach().numpy())
    np.testing.assert_array_equal(
        tmx.nd.transpose(tmx.nd.array(x, tmx.cpu()), axes=axes).asnumpy(),
        got.detach().numpy())


@pytest.mark.parametrize("op", ["_zeros", "_ones", "_full"])
def test_init_ops_match_reference(op):
    attrs = {"shape": "(2, 3, 4)", "dtype": "float32", "value": "2.5"}
    if op != "_full":
        del attrs["value"]
    jop, top = jax_get_op(op), get_op(op)
    want = np.asarray(jop.fn(jop.parse_attrs(dict(attrs))))
    got = top.fn(top.parse_attrs(dict(attrs)))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OP_TOL)
    # a node with no inputs: shape inference, and the executor's device
    z = tmx.sym.zeros(shape=(2, 3)) + tmx.sym.var("a")
    assert z.infer_shape(a=(2, 3))[1] == [(2, 3)]
    ex = z.simple_bind(tmx.cpu(), a=(2, 3))
    np.testing.assert_array_equal(ex.forward(a=np.ones((2, 3)))[0]
                                  .asnumpy(), np.ones((2, 3)))


def _fan_init(pkg):
    """An initializer whose draw names the block it fills: every entry is
    rows + cols / 1000."""
    class FanInit(pkg.init.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = np.full(arr.shape, arr.shape[0]
                             + arr.shape[1] / 1000.0, np.float32)
    return FanInit()


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
def test_fused_rnn_and_named_initializers_match_reference(bidirectional):
    from mxnet_tpu.ops.rnn import rnn_param_size
    n = rnn_param_size(2, 8, 5, bidirectional, "lstm")
    arrays = {}
    for pkg in (mx, tmx):
        init = pkg.init.FusedRNN(_fan_init(pkg), 8, 2, "lstm",
                                 bidirectional=bidirectional,
                                 forget_bias=1.5)
        arr = pkg.nd.zeros((n,), **_ctx(pkg))
        init("lstm_parameters", arr)
        np.random.seed(4)
        orth = pkg.nd.zeros((6, 4), **_ctx(pkg))
        pkg.init.Orthogonal(scale=1.1)("w_weight", orth)
        bil = pkg.nd.zeros((2, 1, 4, 4), **_ctx(pkg))
        pkg.init.Bilinear()("up_weight", bil)
        lstm_b = pkg.nd.zeros((32,), **_ctx(pkg))
        pkg.init.LSTMBias(forget_bias=2.0)("cell_bias", lstm_b)
        mixed = pkg.init.Mixed([".*lstm", ".*weight", ".*"],
                               [pkg.init.Constant(1.0),
                                pkg.init.Constant(2.0), pkg.init.Zero()])
        picks = []
        for name in ("l0_lstm_x", "fc_weight", "fc_bias", "embed_gamma"):
            a = pkg.nd.zeros((3,), **_ctx(pkg))
            mixed(name, a)
            picks.append(a.asnumpy())
        arrays[pkg] = [arr.asnumpy(), orth.asnumpy(), bil.asnumpy(),
                       lstm_b.asnumpy()] + picks
    for got, want in zip(arrays[tmx], arrays[mx]):
        np.testing.assert_array_equal(got, want)
    assert tmx.init.create("fusedrnn", init=tmx.init.Xavier().dumps(),
                           num_hidden=8, num_layers=1, mode="lstm") \
        ._init.magnitude == 3.0


@pytest.mark.parametrize("ignore", [None, 0], ids=["all", "ignore0"])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "BT"])
def test_perplexity_matches_reference_bit_for_bit(ignore, axis, flat):
    r = np.random.default_rng(7)
    B, T, V = 4, 6, 11
    logits = r.standard_normal((B * T, V)).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    label = r.integers(0, V, (B, T)).astype(np.float32)
    label[:, -2:] = 0                       # padding
    lab = label.ravel() if flat else label
    vals = {}
    for pkg in (mx, tmx):
        m = pkg.metric.Perplexity(ignore_label=ignore, axis=axis)
        for _ in range(2):
            m.update([pkg.nd.array(lab, **_ctx(pkg))],
                     [pkg.nd.array(pred, **_ctx(pkg))])
        vals[pkg] = (m.sum_metric, m.num_inst, m.get()[1])
    assert vals[tmx] == vals[mx]


def sym_gen_of(pkg, batch=LM["batch"]):
    """The example's ``make_sym_gen`` (lstm_bucketing.py:68-92)."""
    s = pkg.sym
    V, H, L = LM["vocab"], LM["hidden"], LM["layers"]

    def sym_gen(seq_len):
        data = s.var("data")
        label = s.var("softmax_label")
        embed = s.Embedding(data, input_dim=V, output_dim=H, name="embed")
        tnc = s.transpose(embed, axes=(1, 0, 2))
        init = s.zeros(shape=(L, batch, H))
        out = s.RNN(tnc, s.var("lstm_parameters"), init, init, state_size=H,
                    num_layers=L, mode="lstm", name="lstm")
        out = s.transpose(out, axes=(1, 0, 2))
        pred = s.Reshape(out, shape=(-1, H))
        pred = s.FullyConnected(pred, num_hidden=V, name="pred")
        out = s.SoftmaxOutput(pred, s.Reshape(label, shape=(-1,)),
                              name="softmax", normalization="batch")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _initializer(pkg):
    return pkg.init.Mixed(
        [".*lstm_parameters", ".*"],
        [pkg.init.FusedRNN(pkg.init.Xavier(factor_type="in", magnitude=2.34),
                           LM["hidden"], LM["layers"], "lstm"),
         pkg.init.Xavier(factor_type="in", magnitude=2.34)])


def _bucketing_module(pkg, it, arg_params=None):
    """The example's module, bound at the default bucket: the port's
    initialised by the example's ``Mixed`` initializer, the reference's
    from ``arg_params`` (its initializers compile one draw per shape)."""
    bmod = pkg.mod.BucketingModule(
        sym_gen_of(pkg), default_bucket_key=it.default_bucket_key,
        context=[pkg.cpu()])
    bmod.bind(it.provide_data, it.provide_label)
    if arg_params is None:
        bmod.init_params(initializer=_initializer(pkg))
    else:
        bmod.init_params(arg_params={k: pkg.nd.array(v, **_ctx(pkg))
                                     for k, v in arg_params.items()})
    bmod.init_optimizer(kvstore="local", optimizer="adam",
                        optimizer_params={"learning_rate": 0.01})
    return bmod


def _seeded_params(mod, seed):
    """Numpy weights of the port module's shapes from ``default_rng``, at
    the example initializer's scale."""
    r = np.random.default_rng(seed)
    arg, _ = mod.get_params()
    return {k: (r.standard_normal(v.shape) * 0.3).astype(np.float32)
            for k, v in arg.items()}


def _state_arrays(updater):
    """Every updater slot's state arrays, by slot, as numpy."""
    out = {}
    for k, st in updater.states.items():
        leaves = st if isinstance(st, (tuple, list)) else [st]
        out[k] = [a.asnumpy() for a in leaves]
    return out


def _close_to_scale(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, "%s: %g of its scale > %g" % (what, err, tol)


def test_bucketed_lstm_lm_trains_as_reference():
    V = LM["vocab"]
    r = np.random.default_rng(1)
    sents = [list(r.integers(1, V, n)) for n in [4, 9] * 16]
    its = {pkg: _iter(pkg, sents, 2, buckets=list(LM["buckets"]),
                      invalid_label=0) for pkg in (mx, tmx)}
    mods = {tmx: _bucketing_module(tmx, its[tmx])}
    mods[mx] = _bucketing_module(mx, its[mx],
                                 _seeded_params(mods[tmx], seed=6))
    from_jax_module(mods[mx], tmx.cpu(), mod=mods[tmx],
                    optimizer_states=True)
    batches = {pkg: list(its[pkg]) for pkg in (mx, tmx)}
    keys = [b.bucket_key for b in batches[tmx]]
    assert keys == [b.bucket_key for b in batches[mx]]
    assert len(keys) == 4 and len(set(keys)) == 2
    assert any(a != b for a, b in zip(keys, keys[1:]))
    for i, (bt, bj) in enumerate(zip(batches[tmx], batches[mx])):
        outs = {}
        for pkg, b in ((mx, bj), (tmx, bt)):
            mods[pkg].forward(b, is_train=True)
            mods[pkg].backward()
            mods[pkg].update()
            outs[pkg] = mods[pkg].get_outputs()[0].asnumpy()
        np.testing.assert_allclose(outs[tmx], outs[mx], rtol=OUT_RTOL,
                                   atol=OUT_RTOL * 1e-2,
                                   err_msg="batch %d (T %d)" % (i, keys[i]))
    assert sorted(mods[tmx]._buckets) == sorted(mods[mx]._buckets)
    for pkg in (mx, tmx):
        arg, aux = mods[pkg].get_params()
        mods[pkg].final = {k: v.asnumpy() for k, v in {**arg, **aux}.items()}
    assert sorted(mods[tmx].final) == sorted(mods[mx].final)
    for k, want in mods[mx].final.items():
        _close_to_scale(mods[tmx].final[k], want, STATE_TOL, k)
    upd = {pkg: mods[pkg]._curr_module._updater for pkg in (mx, tmx)}
    st_t, st_j = _state_arrays(upd[tmx]), _state_arrays(upd[mx])
    assert sorted(st_t) == sorted(st_j)
    for k in st_j:
        for a, b in zip(st_t[k], st_j[k]):
            _close_to_scale(a, b, STATE_TOL, "Adam state of slot %s" % k)
    assert upd[tmx].optimizer.num_update == upd[mx].optimizer.num_update
    # every bucket of the port on one set of tensors
    base = mods[tmx]._buckets[its[tmx].default_bucket_key]._exec_group
    for m in mods[tmx]._buckets.values():
        assert m._updater is upd[tmx]
        ex, ex0 = m._exec_group.execs[0], base.execs[0]
        for n in m._param_names:
            assert ex.arg_dict[n] is ex0.arg_dict[n]
            assert ex.grad_dict[n] is ex0.grad_dict[n]
            assert ex.arg_dict[n]._data.data_ptr() == \
                ex0.arg_dict[n]._data.data_ptr()
