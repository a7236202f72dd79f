"""The vision model zoo in the port against the reference's, on the CPU.

All 34 names of ``get_model``: the same parameter names, in order, and the
same declared shapes where the reference declares one (its convolutions
declare none before the first forward, ROADMAP.md Queue 3), with no
forward.  Then one forward and backward a family on a narrow variant
(``classes=10``, small sides, ``mobilenet0.25``, ``squeezenet1.1``, a
2-block DenseNet at 56 px, which keeps its final 7x7 pool valid, and
Inception v3's five block types at 17 px): the reference's seeded weights
reach the port through its own ``save_parameters`` file, and the logits,
the input's gradient and every weight's gradient agree within 1e-4 of the
largest |value| (fp32 through up to 30 layers, sums in another order).
Last, one ``Trainer("nag")`` step of the small DenseNet against the
reference's: the loss and every updated weight within 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = 1e-4
NAMES = sorted(jvision._models)


def _build(pkg, make):
    with pkg.name.NameManager():
        return make(jvision if pkg is mx else vision)


def test_get_model_has_the_reference_names():
    assert sorted(vision._models) == NAMES and len(NAMES) == 34
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("resnet19_v1")


@pytest.mark.parametrize("name", NAMES)
def test_names_and_declared_shapes_match_reference(name):
    ref = _build(mx, lambda v: v.get_model(name))
    net = _build(tmx, lambda v: v.get_model(name))
    want = list(ref.collect_params().items())
    got = list(net.collect_params().items())
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, p), (_, q) in zip(got, want):
        if q.shape is not None:
            assert tuple(p.shape) == tuple(q.shape), k


def _inception_blocks(v):
    net = tmx.gluon.nn.HybridSequential() if v is vision \
        else mx.gluon.nn.HybridSequential()
    m = v.inception
    with net.name_scope():
        net.add(m._make_A(8, "A1_"), m._make_B("B_"), m._make_C(16, "C1_"),
                m._make_D("D_"), m._make_E("E1_"))
    return net


FAMILIES = [
    ("resnet_v1", lambda v: v.ResNetV1(v.BasicBlockV1, [1, 1, 1, 1],
                                       [8, 8, 16, 32, 64], classes=10),
     (2, 3, 32, 32)),
    ("resnet_v2", lambda v: v.ResNetV2(v.BottleneckV2, [1, 1, 1, 1],
                                       [8, 16, 32, 64, 128], classes=10),
     (2, 3, 32, 32)),
    ("vgg_bn", lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                               classes=10, batch_norm=True),
     (2, 3, 32, 32)),
    ("alexnet", lambda v: v.alexnet(classes=10), (2, 3, 64, 64)),
    ("densenet", lambda v: v.DenseNet(16, 8, [2, 2], classes=10),
     (2, 3, 56, 56)),
    ("squeezenet1.1", lambda v: v.get_model("squeezenet1.1", classes=10),
     (1, 3, 224, 224)),
    ("inception_blocks", _inception_blocks, (1, 192, 17, 17)),
    ("mobilenet0.25", lambda v: v.get_model("mobilenet0.25", classes=10),
     (2, 3, 32, 32)),
    ("mobilenetv2_0.25", lambda v: v.get_model("mobilenetv2_0.25",
                                               classes=10), (2, 3, 32, 32)),
]


def _seeded_reference(make, x, path):
    """The reference net with seeded weights, its shapes from shape
    inference (no eager forward, whose per-op compiles would dominate),
    written to ``path``, then hybridized."""
    net = _build(mx, make)
    net.initialize()
    net.infer_shape(mx.nd.array(x))
    r = np.random.default_rng(12)
    for name, p in net.collect_params().items():
        if name.endswith("_var"):
            v = r.uniform(0.5, 1.5, p.shape)
        elif name.endswith("_gamma"):
            v = r.uniform(0.8, 1.2, p.shape)
        elif name.endswith("_weight"):
            v = r.standard_normal(p.shape) * np.sqrt(
                2.0 / max(1, int(np.prod(p.shape[1:]))))
        else:
            v = r.standard_normal(p.shape) * 0.05
        p.set_data(mx.nd.array(v.astype(np.float32)))
        p._finish_deferred_init()
    net.save_parameters(path)
    net.hybridize()
    return net


def _step(pkg, net, x, head):
    """Logits, input and weight gradients of ``sum(out * head)`` in
    inference mode (BatchNorm on its seeded moving statistics, Dropout the
    identity): batch statistics over one or two pixels of a narrow net
    would make the comparison one of rounding."""
    ctx = mx.cpu() if pkg is mx else cpu()
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    with pkg.autograd.record(train_mode=False):
        out = net(xa)
        loss = (out * pkg.nd.array(head, ctx=ctx)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if k.endswith("_weight")}
    return out.asnumpy(), xa.grad.asnumpy(), grads


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, "%s: %.3g of max |value|" % (what, err)


@pytest.mark.parametrize("family,make,shape", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_forward_backward_matches_reference(family, make, shape,
                                                   tmp_path):
    x = np.random.default_rng(13).uniform(-1, 1, shape).astype(np.float32)
    path = str(tmp_path / "ref.params")
    ref = _seeded_reference(make, x, path)
    net = _build(tmx, make)
    net.load_parameters(path, ctx=cpu())
    net.hybridize()
    head = np.random.default_rng(14).uniform(
        0.5, 1.5, net(tmx.nd.array(x, ctx=cpu())).shape).astype(np.float32)
    want = _step(mx, ref, x, head)
    got = _step(tmx, net, x, head)
    _close(got[0], want[0], "output")
    _close(got[1], want[1], "input gradient")
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], k)


def test_small_densenet_nag_step_matches_reference(tmp_path):
    make = FAMILIES[4][1]
    shape = FAMILIES[4][2]
    x = np.random.default_rng(15).uniform(-1, 1, shape).astype(np.float32)
    y = np.array([3, 7], np.float32)
    path = str(tmp_path / "ref.params")
    ref = _seeded_reference(make, x, path)
    net = _build(tmx, make)
    net.load_parameters(path, ctx=cpu())
    net.hybridize()
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    results = []
    for pkg, n in ((mx, ref), (tmx, net)):
        ctx = mx.cpu() if pkg is mx else cpu()
        trainer = pkg.gluon.Trainer(n.collect_params(), "nag", dict(opt))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(2):
            with pkg.autograd.record():
                loss = loss_fn(n(pkg.nd.array(x, ctx=ctx)),
                               pkg.nd.array(y, ctx=ctx))
            loss.backward()
            trainer.step(2)
            losses.append(loss.asnumpy())
        results.append((losses, {k: p.data().asnumpy() for k, p in
                                 n.collect_params().items()}))
    (lr_, wr), (lp, wp) = results
    for a, b in zip(lp, lr_):
        np.testing.assert_allclose(a, b, rtol=TOL)
    for k in wr:
        _close(wp[k], wr[k], k)


def test_model_store_takes_no_other_models_file(tmp_path):
    """``vgg16`` does not claim ``vgg16_bn``'s file: a name is matched up
    to the dash before the hash."""
    (tmp_path / "vgg16_bn-0123abcd.params").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="vgg16-<hash>.params"):
        model_store.get_model_file("vgg16", root=str(tmp_path))
    assert model_store.get_model_file("vgg16_bn", root=str(tmp_path)) \
        == str(tmp_path / "vgg16_bn-0123abcd.params")


def test_model_store_reads_local_files_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="resnet18_v1-<hash>.params"):
        model_store.get_model_file("resnet18_v1", root=str(tmp_path))
    x = np.zeros((1, 3, 32, 32), np.float32)
    path = str(tmp_path / "resnet18_v1-0123abcd.params")
    ref = _seeded_reference(lambda v: v.resnet18_v1(classes=10), x, path)
    assert model_store.get_model_file("resnet18_v1", root=str(tmp_path)) \
        == path + ".npz"
    with tmx.name.NameManager():
        net = vision.resnet18_v1(classes=10, pretrained=True, ctx=cpu(),
                                 root=str(tmp_path))
    want = ref._collect_params_with_prefix()
    got = net._collect_params_with_prefix()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].data().asnumpy(),
                                      want[k].data().asnumpy())
