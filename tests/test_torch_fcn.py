"""FCN-8s on VGG-16 (Long, Shelhamer and Darrell, CVPR 2015, as upstream
MXNet's ``example/fcn-xs/symbol_fcnxs.py`` writes it) through ``Module`` in
both packages, on the CPU.

The network is built with each package's ``sym`` by :func:`fcn8s_symbol`
(``chip_smoke.py`` trains it at full width on the card).  At full width
the two packages agree on the arguments and every shape at 1 x 3 x 500 x
500 (shape inference only).  At narrow widths (channels divided by 16, fc6
and fc7 of 64, 1 x 3 x 48 x 48, dropout off: the packages' generators
draw other masks) both take three steps of ``Module.fit`` (SGD, momentum
0.9) from the same seeded weights, carried into the port by
``mxnet_tpu_torch/weights.py``; the outputs of ``predict``, ``score``'s
accuracy and every parameter then agree within rtol 1e-4, atol 1e-6.  A
``cuda`` test runs the narrow network's step on the card against the
CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, weights

BLOCKS = (2, 2, 3, 3, 3)
WIDTHS = (64, 128, 256, 512, 512)
NARROW = tuple(c // 16 for c in WIDTHS)
SIZE = 48
RTOL, ATOL = 1e-4, 1e-6


def fcn8s_symbol(sym, widths=WIDTHS, fc=4096, classes=21, dropout=0.5):
    """FCN-8s: VGG-16 with conv1_1 padded by 100, 2x2 max pools, fc6/fc7
    as 7x7 and 1x1 convolutions with Dropout, scores from fc7, pool4 and
    pool3 joined by Deconvolution and Crop at (5, 5), (9, 9), (31, 31),
    and the pixel-wise SoftmaxOutput ignoring label 255."""
    data = sym.var("data")
    x, pools = data, []
    for b, (n, c) in enumerate(zip(BLOCKS, widths), 1):
        for i in range(1, n + 1):
            x = sym.Convolution(x, kernel=(3, 3), num_filter=c,
                                pad=(100, 100) if (b, i) == (1, 1)
                                else (1, 1), name="conv%d_%d" % (b, i))
            x = sym.Activation(x, act_type="relu", name="relu%d_%d" % (b, i))
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool%d" % b)
        pools.append(x)
    for name, k in (("fc6", 7), ("fc7", 1)):
        x = sym.Convolution(x, kernel=(k, k), num_filter=fc, name=name)
        x = sym.Activation(x, act_type="relu", name="relu" + name[2])
        x = sym.Dropout(x, p=dropout, name="drop" + name[2])
    score = sym.Convolution(x, kernel=(1, 1), num_filter=classes,
                            name="score")

    def upsample(s, k, stride, name):
        return sym.Deconvolution(s, kernel=(k, k), stride=(stride, stride),
                                 num_filter=classes, no_bias=True, name=name)

    def skip(pool, like, offset, name):
        s = sym.Convolution(pool, kernel=(1, 1), num_filter=classes,
                            name="score_" + name)
        return sym.Crop(s, like, offset=offset, name="score_%sc" % name)

    score2 = upsample(score, 4, 2, "score2")
    score4 = upsample(score2 + skip(pools[3], score2, (5, 5), "pool4"), 4,
                      2, "score4")
    big = upsample(score4 + skip(pools[2], score4, (9, 9), "pool3"), 16, 8,
                   "bigscore")
    upscore = sym.Crop(big, data, offset=(31, 31), name="upscore")
    return sym.SoftmaxOutput(upscore, sym.var("softmax_label"),
                             multi_output=True, use_ignore=True,
                             ignore_label=255, normalization="valid",
                             name="softmax")


def fcn_images(n, size, seed=0, classes=21, band=4):
    rng = np.random.RandomState(seed)
    colors = rng.uniform(-1.5, 1.5, (classes, 3)).astype(np.float32)
    x = rng.randn(n, 3, size, size).astype(np.float32) * 0.3
    y = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(4):
            c = rng.randint(1, classes)
            h, w = rng.randint(size // 6, size // 2, size=2)
            r, q = rng.randint(0, size - h), rng.randint(0, size - w)
            x[i, :, r:r + h, q:q + w] += colors[c][:, None, None]
            y[i, r:r + h, q:q + w] = c
        b = rng.randint(0, size - band)
        y[i, b:b + band] = 255
    return x, y


def _bilinear_diagonal(shape):
    """The bilinear upsampling kernel from class i to class i."""
    k = shape[3]
    f = np.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.arange(k)
    filt = np.outer(1 - abs(og / f - c), 1 - abs(og / f - c))
    w = np.zeros(shape, np.float32)
    w[range(shape[0]), range(shape[1])] = filt
    return w


def _seeded_params(sym, data_shape, seed=1):
    """He-normal weights, zero biases, diagonal bilinear deconvolutions,
    from ``seed`` (numpy)."""
    names = sym.list_arguments()
    shapes = sym.infer_shape(data=data_shape)[0]
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in zip(names, shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("bias"):
            out[n] = np.zeros(s, np.float32)
        elif n.startswith(("score2", "score4", "bigscore")):
            out[n] = _bilinear_diagonal(s)
        else:
            out[n] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))) \
                .astype(np.float32)
    return out


def test_full_width_shapes_match_reference():
    """At full width and 500 px both packages make the same arguments and
    infer the same shapes: the 21-class output at the input's size, fc6 of
    (4096, 512, 7, 7), the deconvolutions of (21, 21, k, k)."""
    res = {}
    for pkg in (mx, tmx):
        s = fcn8s_symbol(pkg.sym)
        args, outs, _ = s.infer_shape(data=(1, 3, 500, 500))
        res[pkg] = (s.list_arguments(), args, outs)
    assert res[mx] == res[tmx]
    shapes = dict(zip(res[tmx][0], res[tmx][1]))
    assert res[tmx][2] == [(1, 21, 500, 500)]
    assert shapes["fc6_weight"] == (4096, 512, 7, 7)
    assert shapes["bigscore_weight"] == (21, 21, 16, 16)
    assert "bigscore_bias" not in shapes
    internals = tmx.sym.load_json(fcn8s_symbol(tmx.sym).tojson()) \
        .get_internals()
    names = internals.list_outputs()
    sides = dict(zip(names, internals.infer_shape(data=(1, 3, 500, 500))[1]))
    assert sides["conv1_2_output"][2:] == (698, 698)
    assert [sides["pool%d_output" % b][2] for b in range(1, 6)] == \
        [349, 174, 87, 43, 21]
    assert sides["score2_output"][2:] == (32, 32)
    assert sides["bigscore_output"][2:] == (536, 536)


def _bound(pkg, sym, x, y, ctx):
    it = pkg.io.NDArrayIter(x, y, batch_size=1, label_name="softmax_label",
                            **({} if pkg is mx else {"ctx": ctx}))
    mod = pkg.mod.Module(sym, context=[ctx])
    mod.bind(it.provide_data, it.provide_label)
    return mod, it


def _fit(mod, it):
    """Three steps of ``fit``, then ``score``'s accuracy, ``predict``'s
    probabilities and the parameters."""
    mod.fit(it, num_epoch=1, optimizer="sgd", eval_metric="acc",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    acc = mod.score(it, "acc")[0][1]
    probs = mod.predict(it).asnumpy()
    arg, _ = mod.get_params()
    return acc, probs, {k: v.asnumpy() for k, v in arg.items()}


def test_narrow_fit_matches_reference():
    """The reference's Module, initialised from seeded weights, hands them
    to the port's through ``weights.from_jax_module``; both then fit."""
    x, y = fcn_images(3, SIZE)
    syms = {pkg: fcn8s_symbol(pkg.sym, NARROW, 64, dropout=0.0)
            for pkg in (mx, tmx)}
    init = _seeded_params(syms[tmx], (1, 3, SIZE, SIZE))
    ref, ref_it = _bound(mx, syms[mx], x, y, mx.cpu())
    ref.init_params(arg_params={k: mx.nd.array(v) for k, v in init.items()})
    mod, it = _bound(tmx, syms[tmx], x, y, cpu())
    arg, aux = weights.from_jax_module(ref, cpu(), mod)
    assert sorted(arg) == sorted(init) and not aux
    mod.init_params(arg_params=arg, aux_params=aux)
    ref_acc, ref_probs, ref_params = _fit(ref, ref_it)
    acc, probs, params = _fit(mod, it)
    assert abs(acc - ref_acc) < 1e-6
    np.testing.assert_allclose(probs, ref_probs, rtol=RTOL, atol=ATOL)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v, rtol=RTOL, atol=ATOL)
        assert np.abs(v - init[k]).max() > 0, k     # every weight trained


@pytest.mark.cuda
def test_narrow_step_on_card():
    """One Module step of the narrow network on the card against the CPU
    (dropout off): the outputs and every updated parameter within 1e-4 of
    the CPU's, kernels 1 and 2 launched for every 3x3 but conv1_1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.ops import hopper_conv as hc
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = fcn_images(1, SIZE)
    sym = fcn8s_symbol(tmx.sym, NARROW, 64, dropout=0.0)
    init = _seeded_params(sym, (1, 3, SIZE, SIZE))
    res = []
    for ctx in (cpu(), tmx.gpu(0)):
        mod = tmx.mod.Module(sym, context=[ctx])
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params={k: tmx.nd.array(v, ctx=cpu())
                                    for k, v in init.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.01, "momentum": 0.9})
        before = (hc.launches, hc.wgrad_launches)
        mod.forward_backward(tmx.io.DataBatch(
            [tmx.nd.array(x, ctx=ctx)], [tmx.nd.array(y, ctx=ctx)]))
        mod.update()
        out = mod.get_outputs()[0].asnumpy()
        launched = (hc.launches - before[0], hc.wgrad_launches - before[1])
        res.append((out, {k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()},
                    launched))
    (oc, pc, _), (og, pg, launched) = res
    assert launched == (24, 12)
    np.testing.assert_allclose(og, oc, rtol=1e-4, atol=1e-5)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=1e-4, atol=1e-5)
