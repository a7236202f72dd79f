"""The port's Gluon layer (mxnet_tpu_torch.gluon) against the reference's
(mxnet_tpu.gluon), on the CPU: parameter names and shapes of the model zoo's
ResNet-50 v1, a forward with the same weights, and the weight carry-over.

Names are compared within one fresh name scope on each side, as the
reference's own counters make them (``resnetv10_...``).  Tolerance of the
forward: 1e-5 absolute on unit-scale logits (fp32 on both sides, sums in
another order).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.weights import from_jax_block

TOL = 1e-5


def _tiny(pkg):
    return pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1],
                        [16, 32, 64, 128, 256], classes=10)


def seeded_pair(make, x, seed=0):
    """The reference block and the port block of ``make(vision)`` with the
    same seeded numpy weights (He-scaled convs and dense, gamma near 1,
    small betas and means, variances in [0.5, 1.5]), shapes from the port's
    shape inference.  The reference's own initializers would compile one
    draw per shape, which takes longer than the test."""
    with tmx.name.NameManager():
        net = make(vision)
    net.initialize(ctx=cpu())
    net.infer_shape(nd.array(x, ctx=cpu()))
    r = np.random.default_rng(seed)
    values = {}
    for name, p in net.collect_params().items():
        s = p.shape
        if name.endswith("_weight"):
            v = r.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif name.endswith("_gamma"):
            v = r.uniform(0.8, 1.2, s)
        elif name.endswith("_running_var"):
            v = r.uniform(0.5, 1.5, s)
        else:
            v = r.standard_normal(s) * 0.05
        values[name] = v.astype(np.float32)
    with mx.name.NameManager():
        jnet = make(jvision)
    for name, p in jnet.collect_params().items():
        p.grad_req = "null"        # no gradient buffers: the tests never read them
        p._load_init(mx.nd.array(values[name]), mx.cpu())
    from_jax_block(values, net, cpu())
    return jnet, net


def test_resnet50_v1_names_and_shapes_match_reference():
    x = np.random.default_rng(0).uniform(size=(1, 3, 32, 32)) \
        .astype(np.float32)
    with mx.name.NameManager():
        jnet = jvision.resnet50_v1()
    jnet.infer_shape(mx.nd.array(x))
    want = [(k, tuple(p.shape)) for k, p in jnet.collect_params().items()]
    with tmx.name.NameManager():
        net = vision.resnet50_v1()
    net.initialize(ctx=cpu())
    assert net(nd.array(x, ctx=cpu())).shape == (1, 1000)
    got = [(k, p.data().shape) for k, p in net.collect_params().items()]
    assert len(got) == 299
    assert got == want


def test_tiny_resnet_forward_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    jnet, net = seeded_pair(_tiny, x)
    jnet.hybridize()
    want = jnet(mx.nd.array(x)).asnumpy()
    net = from_jax_block(jnet, _fresh(_tiny), cpu())
    got = net(nd.array(x, ctx=cpu())).asnumpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _fresh(make):
    with tmx.name.NameManager():
        return make(vision)


def test_from_jax_block_raises_on_a_missing_name():
    _, donor = seeded_pair(_tiny, np.zeros((1, 3, 32, 32), np.float32))
    values = {k: p.data().asnumpy() for k, p in donor.collect_params().items()}
    net = _fresh(_tiny)
    gone = "resnetv10_dense0_bias"
    del values[gone]
    with pytest.raises(MXNetError, match=gone):
        from_jax_block(values, net, cpu())
    values[gone] = np.zeros(3, np.float32)
    with pytest.raises(MXNetError, match="shape"):
        from_jax_block(values, net, cpu())
