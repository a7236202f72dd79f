"""The 27 ``gluon.nn`` classes beyond ``HybridSequential``, ``Dense``,
``Embedding``, ``BatchNorm``, ``Flatten``, ``Activation``, ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D``, and the 4 ``gluon.contrib.nn``
classes, against the reference on the CPU, forward and backward, each
hybridized and not in the port.

Each case builds a small net around the layer in both packages (in a fresh
``NameManager``, so names agree), gives the reference seeded numpy
parameters, carries them to the port through the reference's own
``save_parameters`` file, and runs one forward under ``autograd.record``
and one backward of ``sum(out * head)`` with a seeded head.  The outputs,
the input's gradient and every trainable parameter's gradient agree within
rtol = atol = 1e-5 (fp32, sums in another order).  The reference runs
hybridized (one compile a case), the port both ways.  ``Dropout`` draws
its mask from each package's own generator, so it is held to the identity
outside training and, in training, to a mask of ``0`` and ``1 / (1 -
rate)`` that the gradient repeats.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu.gluon.contrib.nn  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


def _ctx(pkg):
    return mx.cpu() if pkg is mx else cpu()


def _seq(pkg, *blocks):
    net = pkg.gluon.nn.HybridSequential()
    net.add(*blocks)
    return net


def _plain_seq(pkg, *blocks):
    net = pkg.gluon.nn.Sequential()
    net.add(*blocks)
    return net


def _nn(pkg):
    return pkg.gluon.nn


def _cnn(pkg):
    return pkg.gluon.contrib.nn


# (id, the function that builds the net, input shape); a layer without
# parameters follows a small Dense or Conv so that a parameter gradient is
# compared too (with no bias before a normalization, whose gradient would
# be rounding alone)
CASES = [
    ("Sequential", lambda p: _plain_seq(p, _nn(p).Dense(6),
                                        _nn(p).Activation("tanh"),
                                        _nn(p).Dense(3)), (4, 5)),
    ("Dropout", None, (4, 6)),
    ("InstanceNorm", lambda p: _seq(p, _nn(p).Conv2D(3, 1, use_bias=False),
                                    _nn(p).InstanceNorm(scale=True)),
     (2, 2, 5, 4)),
    ("LayerNorm", lambda p: _seq(p, _nn(p).Dense(6, flatten=False),
                                 _nn(p).LayerNorm()), (3, 2, 5)),
    ("Lambda", lambda p: _plain_seq(p, _nn(p).Dense(4),
                                    _nn(p).Lambda("tanh")), (3, 5)),
    ("HybridLambda", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.sigmoid(x))), (3, 5)),
    ("LeakyReLU", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).LeakyReLU(0.1)),
     (3, 5)),
    ("PReLU", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).PReLU()), (3, 5)),
    ("ELU", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).ELU(0.7)), (3, 5)),
    ("SELU", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).SELU()), (3, 5)),
    ("Swish", lambda p: _seq(p, _nn(p).Dense(4), _nn(p).Swish(1.5)), (3, 5)),
    ("Conv1D", lambda p: _seq(p, _nn(p).Conv1D(4, 3, strides=2, padding=1,
                                               dilation=1, groups=1)),
     (2, 3, 9)),
    ("Conv3D", lambda p: _seq(p, _nn(p).Conv3D(4, (2, 3, 3), padding=(0, 1,
                                                                      1),
                                               activation="relu")),
     (2, 2, 4, 5, 5)),
    ("Conv1DTranspose", lambda p: _seq(p, _nn(p).Conv1DTranspose(
        3, 4, strides=2, padding=1)), (2, 4, 6)),
    ("Conv2DTranspose", lambda p: _seq(p, _nn(p).Conv2DTranspose(
        3, 4, strides=2, padding=1, output_padding=1)), (2, 4, 5, 6)),
    ("Conv3DTranspose", lambda p: _seq(p, _nn(p).Conv3DTranspose(
        2, 3, strides=(1, 2, 2), padding=1, use_bias=False)),
     (1, 3, 3, 4, 4)),
    ("MaxPool1D", lambda p: _seq(p, _nn(p).Conv1D(3, 1),
                                 _nn(p).MaxPool1D(3, 2, 1, ceil_mode=True)),
     (2, 2, 8)),
    ("MaxPool3D", lambda p: _seq(p, _nn(p).Conv3D(3, 1),
                                 _nn(p).MaxPool3D(2)), (1, 2, 4, 4, 6)),
    ("AvgPool1D", lambda p: _seq(p, _nn(p).Conv1D(3, 1),
                                 _nn(p).AvgPool1D(3, 2, 1,
                                                  count_include_pad=False)),
     (2, 2, 9)),
    ("AvgPool2D", lambda p: _seq(p, _nn(p).Conv2D(3, 1),
                                 _nn(p).AvgPool2D(2, ceil_mode=True)),
     (2, 2, 5, 7)),
    ("AvgPool3D", lambda p: _seq(p, _nn(p).Conv3D(3, 1),
                                 _nn(p).AvgPool3D((2, 2, 2), padding=1)),
     (1, 2, 3, 4, 4)),
    ("GlobalMaxPool1D", lambda p: _seq(p, _nn(p).Conv1D(3, 1),
                                       _nn(p).GlobalMaxPool1D()), (2, 2, 7)),
    ("GlobalMaxPool2D", lambda p: _seq(p, _nn(p).Conv2D(3, 1),
                                       _nn(p).GlobalMaxPool2D()),
     (2, 2, 5, 6)),
    ("GlobalMaxPool3D", lambda p: _seq(p, _nn(p).Conv3D(3, 1),
                                       _nn(p).GlobalMaxPool3D()),
     (1, 2, 3, 4, 5)),
    ("GlobalAvgPool1D", lambda p: _seq(p, _nn(p).Conv1D(3, 1),
                                       _nn(p).GlobalAvgPool1D()), (2, 2, 7)),
    ("GlobalAvgPool3D", lambda p: _seq(p, _nn(p).Conv3D(3, 1),
                                       _nn(p).GlobalAvgPool3D()),
     (1, 2, 3, 4, 5)),
    ("ReflectionPad2D", lambda p: _seq(p, _nn(p).Conv2D(3, 1),
                                       _nn(p).ReflectionPad2D(2)),
     (2, 2, 5, 6)),
    ("Concurrent", lambda p: _concurrent(p, _cnn(p).Concurrent), (3, 5)),
    ("HybridConcurrent", lambda p: _concurrent(p, _cnn(p).HybridConcurrent),
     (3, 5)),
    ("Identity", lambda p: _seq(p, _nn(p).Dense(4), _cnn(p).Identity()),
     (3, 5)),
    ("SyncBatchNorm", lambda p: _seq(p, _nn(p).Conv2D(3, 1, use_bias=False),
                                     _cnn(p).SyncBatchNorm(num_devices=1)),
     (4, 2, 3, 3)),
    # ResNet v2's input BatchNorm: no gamma and no beta to train
    ("BatchNorm_no_center_no_scale", lambda p: _seq(
        p, _nn(p).Conv2D(3, 1, use_bias=False),
        _nn(p).BatchNorm(center=False, scale=False)), (4, 2, 3, 3)),
]


def _concurrent(pkg, klass):
    net = klass(axis=1)
    net.add(_nn(pkg).Dense(3), _cnn(pkg).Identity(), _nn(pkg).Dense(2))
    return net


def _build(pkg, make):
    with pkg.name.NameManager():
        return make(pkg)


def _inputs(shape):
    r = np.random.default_rng(5)
    x = r.uniform(-1, 1, shape).astype(np.float32)
    return x


def _run(pkg, net, x, head, hybridize):
    """(output, input gradient, {param: gradient}) of one recorded forward
    and the backward of sum(out * head)."""
    if hybridize:
        net.hybridize()
    ctx = _ctx(pkg)
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    with pkg.autograd.record():
        out = net(xa)
        loss = (out * pkg.nd.array(head, ctx=ctx)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xa.grad.asnumpy(), grads


def _reference(make, x, tmp_path):
    """The reference net with seeded parameters, its file, and its run."""
    net = _build(mx, make)
    net.initialize()
    hybrid = isinstance(net, mx.gluon.HybridBlock)
    if hybrid:
        net.infer_shape(mx.nd.array(x))     # no eager per-op compiles
    else:
        net(mx.nd.array(x))
    r = np.random.default_rng(11)
    for name, p in net.collect_params().items():
        if name.endswith("_var"):
            v = r.uniform(0.5, 1.5, p.shape)
        elif name.endswith("_gamma"):
            v = r.uniform(0.8, 1.2, p.shape)
        else:
            v = r.standard_normal(p.shape) * 0.4
        p.set_data(mx.nd.array(v.astype(np.float32)))
        p._finish_deferred_init()
    path = str(tmp_path / "ref.params")
    net.save_parameters(path)
    if hybrid:
        net.hybridize()
    return net, path


@pytest.mark.parametrize("name,make,shape",
                         [c for c in CASES if c[1] is not None],
                         ids=[c[0] for c in CASES if c[1] is not None])
def test_layer_matches_reference(name, make, shape, tmp_path):
    x = _inputs(shape)
    ref, path = _reference(make, x, tmp_path)
    probe = _build(tmx, make)
    probe.load_parameters(path, ctx=cpu())
    head = np.random.default_rng(9).uniform(
        0.5, 1.5, probe(tmx.nd.array(x, ctx=cpu())).shape).astype(np.float32)
    want = _run(mx, ref, x, head, False)
    for hybridize in (False, True):
        net = _build(tmx, make)
        net.load_parameters(path, ctx=cpu())
        got = _run(tmx, net, x, head, hybridize)
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
        assert sorted(got[2]) == sorted(want[2])
        for k in want[2]:
            np.testing.assert_allclose(got[2][k], want[2][k], rtol=TOL,
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("hybridize", [False, True])
def test_dropout(hybridize):
    rate = 0.4
    x = _inputs((64, 50)) + 2.0
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            net = pkg.gluon.nn.Dropout(rate)
        if hybridize:
            net.hybridize()
        xa = pkg.nd.array(x, ctx=_ctx(pkg))
        np.testing.assert_array_equal(net(xa).asnumpy(), x)
    xa = tmx.nd.array(x, ctx=cpu())
    xa.attach_grad()
    with tmx.autograd.record():
        out = net(xa)
    out.backward()
    out, grad = out.asnumpy(), xa.grad.asnumpy()
    np.testing.assert_allclose(np.unique(grad), [0.0, 1 / (1 - rate)],
                               rtol=1e-6)
    np.testing.assert_allclose(out, x * grad, rtol=1e-6)
    assert abs((grad > 0).mean() - (1 - rate)) < 0.05


def test_sequential_indexing_and_repr():
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            net = _plain_seq(pkg, _nn(pkg).Dense(3), _nn(pkg).Dense(2),
                             _nn(pkg).Dense(1))
        assert len(net) == 3
        part = net[1:]
        assert isinstance(part, pkg.gluon.nn.Sequential) and len(part) == 2
        assert part.prefix == net.prefix
        assert net[0] is list(net._children.values())[0]
    assert repr(_build(tmx, lambda p: _nn(p).Dense(3, in_units=2))) == \
        "Dense(2 -> 3, linear)"


def test_lambda_rejects_unknown_names():
    with pytest.raises(MXNetError, match="not found"):
        tmx.gluon.nn.Lambda("no_such_op")
    with pytest.raises(MXNetError, match="not found"):
        tmx.gluon.nn.HybridLambda("no_such_op")


def test_sparse_embedding_is_not_ported_yet():
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        tmx.gluon.contrib.nn.SparseEmbedding(10, 4)
    with pytest.raises(MXNetError, match="Queue 1 item 5"):
        tmx.gluon.nn.Embedding(10, 4, sparse_grad=True)


def test_conv_layers_declare_upstream_weight_shapes():
    """The port declares what upstream MXNet declares before the first
    forward; the reference declares None for every convolution (ROADMAP.md
    Queue 3)."""
    nn = tmx.gluon.nn
    assert nn.Conv2D(8, 3, in_channels=4).weight.shape == (8, 4, 3, 3)
    assert nn.Conv2D(8, 3, groups=2, in_channels=4).weight.shape == \
        (8, 2, 3, 3)
    assert nn.Conv1D(8, 3).weight.shape == (8, 0, 3)
    assert nn.Conv2DTranspose(8, 3, in_channels=4).weight.shape == \
        (4, 8, 3, 3)
    assert nn.Conv3DTranspose(8, 3, groups=2).weight.shape == (0, 4, 3, 3, 3)
    assert mx.gluon.nn.Conv2D(8, 3, in_channels=4).weight.shape is None
