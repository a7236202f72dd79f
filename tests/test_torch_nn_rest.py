"""The other 20 names of ``mxnet_tpu/ops/nn.py`` and
``Pooling(pool_type='lp')`` in the port (``mxnet_tpu_torch/ops/nn.py``)
against the reference, on the CPU.

Each case runs the op through both packages' imperative dispatch under
their ``autograd.record`` on the same seeded numpy inputs, compares the
outputs (rtol 1e-5, atol 1e-6; 1e-5 for the transposed convolution and
the upsampling, whose values sum many products), then one backward with a
seeded head gradient for every float output and 0.25 for every marked
input, and compares the inputs' gradients within the same tolerance.  The
regression outputs' and ``SoftmaxOutput``'s backward ignores the head
gradient in both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import imperative_invoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.nn import _deconv_pad_adj

RTOL, ATOL, SUM_ATOL = 1e-5, 1e-6, 1e-5


def u(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _run(pkg, name, inputs, kwargs, head=None, train_mode=True):
    """(outputs, input gradients) of one op in one package; ``head`` is the
    first output's head gradient (default: seeded uniform)."""
    ctx = {} if pkg is mx else {"ctx": cpu()}
    invoke = imperative_invoke if pkg is mx else tmx.nd.invoke
    arrays = [pkg.nd.array(x, **ctx) for x in inputs]
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record(train_mode=train_mode):
        outs = invoke(name, *arrays, **kwargs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    rng = np.random.default_rng(7)
    heads = list(outs) + arrays
    head_grads = [pkg.nd.array(rng.uniform(0.5, 1.5, o.shape)
                               .astype(np.float32) if head is None
                               else head, **ctx) for o in outs]
    head_grads += [pkg.nd.array(np.full(a.shape, 0.25, np.float32), **ctx)
                   for a in arrays]
    pkg.autograd.backward(heads, head_grads)
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrays]


def case(name, inputs, kwargs=None, atol=ATOL, id=None):
    return pytest.param(name, inputs, kwargs or {}, atol, id=id or name)


X4 = u((2, 4, 7, 9), 1)
CASES = [
    case("Deconvolution", [u((2, 4, 5, 6), 2), u((4, 3, 3, 3), 3),
                           u((3,), 4)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=3), SUM_ATOL, "Deconvolution-bias-adj"),
    case("Deconvolution", [u((2, 4, 5, 6), 2), u((4, 3, 4, 4), 3)],
         dict(kernel=(4, 4), stride=(2, 2), num_filter=3, no_bias=True),
         SUM_ATOL, "Deconvolution-fcn-4x4-s2"),
    case("Deconvolution", [u((1, 3, 6, 6), 5), u((3, 3, 16, 16), 6)],
         dict(kernel=(16, 16), stride=(8, 8), num_filter=3, no_bias=True),
         SUM_ATOL, "Deconvolution-fcn-16x16-s8"),
    case("Deconvolution", [u((2, 4, 5, 6), 2), u((4, 2, 3, 3), 3),
                           u((2,), 4)],
         dict(kernel=(3, 3), num_filter=2, dilate=(2, 2), pad=(1, 2)),
         SUM_ATOL, "Deconvolution-dilate"),
    case("Deconvolution", [u((2, 3, 7), 2), u((3, 2, 4), 3)],
         dict(kernel=(4,), stride=(3,), num_filter=2, no_bias=True),
         SUM_ATOL, "Deconvolution-1d"),
    case("Crop", [X4, u((2, 4, 3, 5), 5)], dict(offset=(2, 3)),
         id="Crop-like"),
    case("Crop", [X4], dict(h_w=(4, 4), offset=(1, 5)), id="Crop-h_w"),
    case("Crop", [X4], dict(h_w=(3, 6), center_crop=True), id="Crop-center"),
    case("crop_like", [X4, u((2, 4, 5, 4), 5)], dict(center_crop=True),
         id="crop_like-center"),
    case("UpSampling", [X4], dict(scale=2, sample_type="nearest"),
         SUM_ATOL, "UpSampling-nearest-2"),
    case("UpSampling", [X4], dict(scale=3), SUM_ATOL, "UpSampling-nearest-3"),
    case("UpSampling", [X4], dict(scale=2, sample_type="bilinear"),
         SUM_ATOL, "UpSampling-bilinear-2"),
    case("UpSampling", [X4], dict(scale=4, sample_type="bilinear"),
         SUM_ATOL, "UpSampling-bilinear-4"),
    case("UpSampling", [X4, u((2, 4, 7, 9), 6)],
         dict(scale=2, num_args=2), SUM_ATOL, "UpSampling-concat"),
    case("UpSampling", [X4, u((2, 4, 7, 9), 6)],
         dict(scale=2, num_args=2, multi_input_mode="sum"), SUM_ATOL,
         "UpSampling-sum"),
] + [
    case("LeakyReLU", [X4], dict(act_type=a, slope=0.1), id="LeakyReLU-" + a)
    for a in ("leaky", "elu", "selu", "gelu")
] + [
    case("LeakyReLU", [X4, u((4,), 7, 0.0, 0.5)], dict(act_type="prelu"),
         id="LeakyReLU-prelu"),
    case("leakyrelu", [X4, u((1,), 7, 0.0, 0.5)], dict(act_type="prelu"),
         id="leakyrelu-prelu-one"),
    case("InstanceNorm", [X4, u((4,), 8), u((4,), 9)], {}, SUM_ATOL),
    case("instancenorm", [u((3, 2, 11), 10), u((2,), 8), u((2,), 9)],
         dict(eps=1e-5), SUM_ATOL, "instancenorm-1d"),
] + [
    case("L2Normalization", [X4], dict(mode=m), id="L2Normalization-" + m)
    for m in ("instance", "channel", "spatial")
] + [
    case("L2Normalization", [u((5, 6), 11)], {}, id="L2Normalization-2d"),
    case("LRN", [u((2, 7, 5, 6), 12)], dict(nsize=5), id="LRN-5"),
    case("lrn", [u((2, 7, 5, 6), 12)],
         dict(nsize=3, alpha=1e-3, beta=0.5, knorm=1.0), id="lrn-3"),
    case("SoftmaxActivation", [X4], {}, id="SoftmaxActivation-instance"),
    case("SoftmaxActivation", [X4], dict(mode="channel"),
         id="SoftmaxActivation-channel"),
    case("SoftmaxActivation", [u((5, 6), 13)], {}, id="SoftmaxActivation-2d"),
] + [
    case(n, [u((6, 3), 14), u((6, 3), 15, 0.0, 1.0)], dict(grad_scale=0.5),
         id=n)
    for n in ("LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput")
] + [
    case("Pooling", [X4], dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               pool_type="lp", p_value=p),
         id="Pooling-lp-%d" % p)
    for p in (1, 2, 3)
] + [
    case("Pooling", [X4], dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                               pooling_convention="full", p_value=2),
         id="Pooling-lp-full"),
    case("Pooling", [X4], dict(global_pool=True, pool_type="lp"),
         id="Pooling-lp-global"),
    case("Pooling", [u((2, 3, 8), 16)], dict(kernel=(3,), pool_type="lp",
                                             p_value=2), id="Pooling-lp-1d"),
]


@pytest.mark.parametrize("name,inputs,kwargs,atol", CASES)
def test_matches_reference(name, inputs, kwargs, atol):
    want, want_g = _run(mx, name, inputs, kwargs)
    got, got_g = _run(tmx, name, inputs, kwargs)
    assert len(got) == len(want)
    for g, w in zip(got + got_g, want + want_g):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("in_hw,kernel,stride,target", [
    ((5, 6), (3, 3), (2, 2), (10, 12)),
    ((5, 6), (4, 4), (2, 2), (11, 12)),
    ((7, 7), (16, 16), (8, 8), (60, 63)),
])
def test_deconvolution_target_shape(in_hw, kernel, stride, target):
    """``target_shape`` sets the output's size, as upstream MXNet derives
    pad and adj; the reference ignores it, so it gets that pad and adj
    explicitly."""
    x, w = u((2, 3) + in_hw, 20), u((3, 2) + kernel, 21)
    kw = dict(kernel=kernel, stride=stride, num_filter=2, no_bias=True)
    pad, adj = _deconv_pad_adj(dict(kw, dilate=(), pad=(), adj=(),
                                    target_shape=target), in_hw)
    got, got_g = _run(tmx, "Deconvolution", [x, w],
                      dict(kw, target_shape=target))
    want, want_g = _run(mx, "Deconvolution", [x, w],
                        dict(kw, pad=pad, adj=adj))
    assert got[0].shape[2:] == target
    for g, w_ in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(g, w_, rtol=RTOL, atol=SUM_ATOL)


def test_grouped_deconvolution_is_the_groups_side_by_side():
    """A grouped transposed convolution equals each group's own, stacked
    on the channel axis.  The reference raises on ``num_group`` > 1 (its
    IO-layout ``conv_general_dilated`` reads the weight's first axis as
    the group's inputs), so each group goes through it ungrouped."""
    x, w, b = u((2, 4, 5, 6), 2), u((4, 3, 3, 3), 3), u((6,), 4)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    head = u((2, 6, 9, 11), 24)
    got, got_g = _run(tmx, "Deconvolution", [x, w, b],
                      dict(kw, num_filter=6, num_group=2), head)
    parts = [_run(mx, "Deconvolution",
                  [x[:, 2 * g:2 * g + 2], w[2 * g:2 * g + 2],
                   b[3 * g:3 * g + 3]],
                  dict(kw, num_filter=3), head[:, 3 * g:3 * g + 3])
             for g in range(2)]
    np.testing.assert_allclose(
        got[0], np.concatenate([p[0][0] for p in parts], 1), rtol=RTOL,
        atol=SUM_ATOL)
    for i, axis in ((0, 1), (1, 0), (2, 0)):
        np.testing.assert_allclose(
            got_g[i], np.concatenate([p[1][i] for p in parts], axis),
            rtol=RTOL, atol=SUM_ATOL)


def test_rrelu_in_inference_matches_reference():
    """Out of training rrelu's slope is the bounds' mean in both
    packages."""
    kw = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3)
    want, want_g = _run(mx, "LeakyReLU", [X4], kw, train_mode=False)
    got, got_g = _run(tmx, "LeakyReLU", [X4], kw, train_mode=False)
    for g, w in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_lrn_hides_its_scale():
    """LRN has two outputs, the normalized data visible and the divisor
    hidden, as the reference's."""
    x = u((2, 5, 3, 3), 22)
    a = tmx.nd.LRN(tmx.nd.array(x, ctx=cpu()), nsize=3)
    b = mx.nd.LRN(mx.nd.array(x), nsize=3)
    assert not isinstance(a, list) and not isinstance(b, list)
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                               atol=ATOL)


def test_rrelu_draws_its_slopes_in_training():
    """In training rrelu's negative slopes are U[lower, upper) draws from
    the context's generator (one seed, one draw); otherwise their mean."""
    x = -np.abs(u((4000,), 23)) - 0.1
    arr = tmx.nd.array(x, ctx=cpu())
    kw = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3)
    outs = []
    for _ in range(2):
        tmx.random.seed(5)
        with tmx.autograd.record(train_mode=True):
            outs.append(tmx.nd.LeakyReLU(arr, **kw).asnumpy())
    slopes = outs[0] / x
    np.testing.assert_array_equal(outs[0], outs[1])
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() < 0.3 + 1e-6
    assert abs(slopes.mean() - 0.2) < 0.005
    np.testing.assert_allclose(tmx.nd.LeakyReLU(arr, **kw).asnumpy(),
                               0.2 * x, rtol=1e-6)


@pytest.mark.parametrize("act,args", [("prelu", ["data", "r_gamma"]),
                                      ("leaky", ["data"])])
def test_leaky_relu_arguments(act, args):
    """The prelu variant alone gets a gamma variable, as the reference's
    ``_create`` does; its shape comes from the data's channels."""
    for pkg in (mx, tmx):
        s = pkg.sym.LeakyReLU(pkg.sym.var("data"), act_type=act, name="r")
        assert s.list_arguments() == args
    s = tmx.sym.LeakyReLU(tmx.sym.var("data"), act_type=act, name="r")
    arg_shapes, out_shapes, _ = s.infer_shape(data=(2, 5, 3, 3))
    assert out_shapes == [(2, 5, 3, 3)]
    assert arg_shapes[1:] == ([(5,)] if act == "prelu" else [])


@pytest.mark.parametrize("no_bias", [False, True])
def test_deconvolution_symbol_matches_reference(no_bias):
    """``sym.Deconvolution`` makes the reference's arguments, a weight of
    (in, out / group, k...) and a bias unless ``no_bias`` (whose default
    is False in both packages; upstream MXNet's is True), and infers the
    same shapes."""
    shapes = {}
    for pkg in (mx, tmx):
        s = pkg.sym.Deconvolution(pkg.sym.var("data"), kernel=(4, 4),
                                  stride=(2, 2), num_filter=6,
                                  no_bias=no_bias, name="up")
        shapes[pkg] = (s.list_arguments(),) + tuple(
            s.infer_shape(data=(1, 4, 5, 5))[:2])
    assert shapes[mx] == shapes[tmx]
    assert shapes[tmx][1][1] == (4, 6, 4, 4)
    grouped = tmx.sym.Deconvolution(tmx.sym.var("data"), kernel=(4, 4),
                                    stride=(2, 2), num_filter=6, num_group=2,
                                    no_bias=no_bias, name="up")
    arg_shapes, out_shapes, _ = grouped.infer_shape(data=(1, 4, 5, 5))
    assert arg_shapes[1] == (4, 3, 4, 4) and out_shapes == [(1, 6, 12, 12)]


def test_crop_outside_raises():
    with pytest.raises(MXNetError):
        tmx.nd.Crop(tmx.nd.array(X4, ctx=cpu()), h_w=(6, 6), offset=(3, 0))
