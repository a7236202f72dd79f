"""The LSTM language-model slice as a whole: bench.py's ``bench_lstm_lm`` net
(Embedding -> 2-layer LSTM -> Dense(flatten=False)) built through deferred
shapes and trained by ``FusedTrainer`` with ``SoftmaxCrossEntropyLoss``, in
the port (mxnet_tpu_torch) against the reference (mxnet_tpu), on the CPU.

At a tiny size (vocab 64, embed = hidden = 16, 2 layers, bptt 5, batch 4),
from the same seeded numpy weights carried across by
``weights.from_jax_block``, with the reference's Pallas LSTM kernels run by
the interpreter (``pallas_rnn.INTERPRET``):

- parameter names and shapes are equal, each side resolving the LSTM's
  input size from the first batch, and ``from_jax_block`` carries the
  reference block's parameters into a fresh port block by name;
- three SGD steps at lr 0.5 on one batch: each loss within rtol 1e-5, and
  every parameter after the third step within 1e-4 absolute.

And in the port only, with ``dropout=0.5``: one seed gives the same loss
twice, another seed a different one, and evaluation (a plain forward)
ignores dropout.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops import pallas_rnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon, nd
from mxnet_tpu_torch.weights import from_jax_block

VOCAB, EMBED, BPTT, BATCH = 64, 16, 5, 4
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_rnn.INTERPRET = True
    yield
    pallas_rnn.INTERPRET = False


def _lm(pkg, dropout=0.0, input_size=0):
    """bench.py:218-224, at the test's size."""
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Embedding(VOCAB, EMBED))
        net.add(pkg.gluon.rnn.LSTM(EMBED, num_layers=2, dropout=dropout,
                                   input_size=input_size))
        net.add(pkg.gluon.nn.Dense(VOCAB, flatten=False))
    return net


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (BPTT, BATCH)) \
        .astype(np.float32)


def _weights(net, seed):
    """Seeded values for every parameter of a port net whose shapes are
    known: embeddings N(0, 0.1), the rest N(0, 1 / fan_in)."""
    r = np.random.default_rng(seed)
    out = {}
    for name, p in net.collect_params().items():
        s = p.shape
        scale = 0.1 if name.endswith("embedding0_weight") else \
            1.0 / np.sqrt(s[-1] if len(s) > 1 else EMBED)
        out[name] = (r.standard_normal(s) * scale).astype(np.float32)
    return out


def _port_lm(toks, dropout=0.0):
    """A port LM with deferred shapes resolved by one batch, as the bench
    resolves them, and seeded weights."""
    with tmx.name.NameManager():
        net = _lm(tmx, dropout)
    net.initialize(ctx=cpu())
    x = nd.array(toks, ctx=cpu())
    assert net(x).shape == (BPTT, BATCH, VOCAB)
    values = _weights(net, seed=0)
    from_jax_block(values, net, cpu())
    net.hybridize()
    return net, values


def _reference_lm(values, input_size=0):
    """The reference LM with the port's seeded weights."""
    with mx.name.NameManager():
        jnet = _lm(mx, input_size=input_size)
    for name, p in jnet.collect_params().items():
        p.grad_req = "null"        # no gradient buffers: never read here
        p._load_init(mx.nd.array(values[name]), mx.cpu())
    return jnet


def test_lm_names_and_shapes_match_reference():
    toks = _tokens(1)
    net, values = _port_lm(toks)
    jnet = _reference_lm(values)
    # the reference resolves the LSTM's input size in an eager call; the
    # interpreter is not needed for that (its scan arm runs)
    pallas_rnn.INTERPRET = False
    jnet(mx.nd.array(toks))
    want = [(k, tuple(p.shape)) for k, p in jnet.collect_params().items()]
    got = [(k, p.data().shape) for k, p in net.collect_params().items()]
    assert got == want and len(got) == 11
    # the reference block's parameters carry over by name
    with tmx.name.NameManager():
        fresh = _lm(tmx)
    from_jax_block(jnet, fresh, cpu())
    for k, p in fresh.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), values[k])


def test_lm_trains_like_reference():
    toks = _tokens(1)
    net, values = _port_lm(toks)
    # names and shapes are held equal above; here the reference is told its
    # input size, which spares an eager forward
    jnet = _reference_lm(values, input_size=EMBED)
    jnet.hybridize()
    jx, jy = mx.nd.array(toks), mx.nd.array(toks)
    opt = {"learning_rate": 0.5}
    jft = mx.FusedTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                          dict(opt))
    ft = tmx.FusedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                          dict(opt))
    tx, ty = nd.array(toks, ctx=cpu()), nd.array(toks, ctx=cpu())
    for _ in range(3):
        want = float(jft.step(jx, jy).asnumpy())
        got = float(ft.step(tx, ty).asnumpy())
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jft.sync_params()
    ft.sync_params()
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), jp[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


def test_lm_dropout_follows_the_seed():
    toks = _tokens(2)
    net, _ = _port_lm(toks, dropout=0.5)
    x, y = nd.array(toks, ctx=cpu()), nd.array(toks, ctx=cpu())

    def first_loss(seed):
        tmx.random.seed(seed)
        ft = tmx.FusedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.5})
        return float(ft.step(x, y).asnumpy())

    a, b, c = first_loss(5), first_loss(5), first_loss(6)
    assert a == b and a != c
    # evaluation runs no dropout: the forward is the same in every call
    out = net(x).asnumpy()
    np.testing.assert_array_equal(net(x).asnumpy(), out)
    no_drop, _ = _port_lm(toks, dropout=0.0)
    np.testing.assert_array_equal(no_drop(x).asnumpy(), out)


def test_loss_block_matches_reference():
    """``SoftmaxCrossEntropyLoss`` on NDArrays, with a weight and batch
    axis 1, against the reference's block, within 1e-6."""
    r = np.random.default_rng(3)
    pred = r.standard_normal((3, 4, 7)).astype(np.float32)
    label = r.integers(0, 7, (3, 4)).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss(weight=0.5, batch_axis=1)(
        mx.nd.array(pred), mx.nd.array(label)).asnumpy()
    got = gluon.loss.SoftmaxCrossEntropyLoss(weight=0.5, batch_axis=1)(
        nd.array(pred, ctx=cpu()), nd.array(label, ctx=cpu())).asnumpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lstm_layer_call_contract():
    """``layer(x)`` gives the output alone; ``layer(x, begin_state(...))``
    gives (output, [hT, cT]) with the same output, the top layer's hT its
    last row."""
    with tmx.name.NameManager():
        layer = gluon.rnn.LSTM(8, num_layers=2)
    layer.initialize(ctx=cpu())
    x = nd.array(np.random.default_rng(4).standard_normal((BPTT, BATCH, 6)),
                 ctx=cpu())
    out = layer(x)
    states = layer.begin_state(BATCH, ctx=cpu())
    assert [s.shape for s in states] == [(2, BATCH, 8)] * 2
    out2, (hT, cT) = layer(x, states)
    np.testing.assert_array_equal(out2.asnumpy(), out.asnumpy())
    assert hT.shape == cT.shape == (2, BATCH, 8)
    np.testing.assert_allclose(hT.asnumpy()[1], out.asnumpy()[-1], rtol=0,
                               atol=1e-7)


def test_fused_trainer_loss_forms_agree():
    """The loss as a name, a Gluon block and a callable on tensors give the
    same first step."""
    import torch
    toks = _tokens(5)
    x, y = nd.array(toks, ctx=cpu()), nd.array(toks, ctx=cpu())

    def callable_loss(logits, labels):
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, VOCAB), labels.reshape(-1).long())

    losses = []
    for loss in ("softmax_cross_entropy", gluon.loss.SoftmaxCrossEntropyLoss(),
                 callable_loss):
        net, _ = _port_lm(toks)
        ft = tmx.FusedTrainer(net, loss, "sgd", {"learning_rate": 0.5})
        losses.append(float(ft.step(x, y).asnumpy()))
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)
