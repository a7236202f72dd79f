"""The training slice as a whole: the port's FusedTrainer (mxnet_tpu_torch)
against the reference's (mxnet_tpu), on the CPU, from the same seeded
weights and batches.

- A tiny ResNet v1 (bottleneck, one block a stage, widths 16-256, 10
  classes) at batch 4, 64 px, SGD lr 0.01, momentum 0.9: the loss of each
  of 3 steps within rtol 1e-4, and after step 1 every parameter within
  1e-5 * max(1, |p|) and every running mean and variance likewise.
- Full-depth ResNet-50 v1 at bench.py's CPU shape (batch 8, 64 px), one
  step at bench.py's lr 0.1, momentum 0.9: the loss within rtol 1e-4, and
  the update of each of the 16 3x3 weights within 5% of its own norm
  (Frobenius).  That gradient is ill-conditioned in fp32 at this shape
  (53 layers, BatchNorm over 8 x 2 x 2 values in stage 4): scaling the
  input by 1 + 1e-7 moves the port's own 3x3 updates by 0.34-1.93% of their
  norm, and single elements by up to 5.7% of the largest |update|, while
  the port and the reference differ by 0.85-2.44% of the norm (up to 21%
  of the largest |update| in single elements).  So the 5% norm tolerance
  sits 2.6 times above the rounding floor, and a per-element tolerance
  would test the rounding.  Both probes print from the repository root with
  ``PYTHONPATH=. python tests/test_torch_train.py`` (:func:`reference_gap`,
  :func:`update_spread`).

fp32 on both sides; the sums run in another order, and the reference's 3x3
convolutions are XLA's while the port's run its plain per-tap versions of
the kernels (forward, dgrad, wgrad).
"""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, nd

from test_torch_gluon import seeded_pair

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5
UPDATE_TOL = 0.05


def _batch(n, px, classes, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 3, px, px)).astype(np.float32)
    y = r.integers(0, classes, (n,)).astype(np.float32)
    return x, y


def _pair(make, x, opt):
    """Reference and port nets with the same weights, and their trainers."""
    jnet, net = seeded_pair(make, x)
    jnet.hybridize()
    net.hybridize()
    return (jnet, mx.FusedTrainer(jnet, "softmax_cross_entropy", "sgd",
                                  dict(opt)),
            net, tmx.FusedTrainer(net, "softmax_cross_entropy", "sgd",
                                  dict(opt)))


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _close(got, want):
    err = np.abs(got - want).max()
    return err <= PARAM_TOL * max(1.0, float(np.abs(want).max())), err


def test_tiny_resnet_trains_like_reference():
    make = lambda pkg: pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1],
                                    [16, 32, 64, 128, 256], classes=10)
    x, y = _batch(4, 64, 10, seed=0)
    jnet, jft, net, ft = _pair(make, x, {"learning_rate": 0.01,
                                         "momentum": 0.9})
    jx, jy = mx.nd.array(x), mx.nd.array(y)
    tx, ty = nd.array(x, ctx=cpu()), nd.array(y, ctx=cpu())
    for step in range(3):
        want = float(jft.step(jx, jy).asnumpy())
        got = float(ft.step(tx, ty).asnumpy())
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        if step == 0:
            jft.sync_params()
            ft.sync_params()
            want_p = _params(jnet)
            got_p = _params(net)
            assert sorted(got_p) == sorted(want_p)
            bad = {k: err for k in want_p
                   for ok, err in [_close(got_p[k], want_p[k])] if not ok}
            assert not bad, bad
            assert any(k.endswith("_running_var") and
                       not np.allclose(v, 1.0) for k, v in got_p.items())


def _conv3x3_weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()
            if k.endswith("_weight") and p.shape[2:] == (3, 3)}


def _conv3x3_updates(net, w0):
    params = net.collect_params()
    return {k: params[k].data().asnumpy() - w0[k] for k in w0}


def _shares(got, want):
    """Per 3x3 weight: |got - want| as a share of |want| (Frobenius), and
    its largest element as a share of the largest |want|."""
    return {k: (float(np.linalg.norm(got[k] - want[k])
                      / np.linalg.norm(want[k])),
                float(np.abs(got[k] - want[k]).max()
                      / np.abs(want[k]).max()))
            for k in sorted(want)}


def reference_gap():
    """One full-depth ResNet-50 v1 step (batch 8, 64 px, lr 0.1, momentum
    0.9) in both packages from the same weights: the two losses, and the
    port's 3x3 updates against the reference's (:func:`_shares`)."""
    x, y = _batch(8, 64, 1000, seed=1)
    jnet, jft, net, ft = _pair(lambda pkg: pkg.resnet50_v1(), x,
                               {"learning_rate": 0.1, "momentum": 0.9})
    w0 = _conv3x3_weights(net)
    assert len(w0) == 16
    want = float(jft.step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
    got = float(ft.step(nd.array(x, ctx=cpu()), nd.array(y, ctx=cpu()))
                .asnumpy())
    jft.sync_params()
    ft.sync_params()
    return got, want, _shares(_conv3x3_updates(net, w0),
                              _conv3x3_updates(jnet, w0))


def test_resnet50_v1_step_matches_reference():
    got, want, shares = reference_gap()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for k, (norm_share, _) in shares.items():
        assert norm_share <= UPDATE_TOL, (k, norm_share)


def update_spread(rel=1e-7):
    """The floor under UPDATE_TOL: the port's one-step 3x3 updates of
    full-depth ResNet-50 v1 at the shape of the test above, from the
    input and from the input scaled by ``1 + rel``.  Returns, per 3x3
    weight, the difference of the two updates as a share of the update's
    norm and its largest element as a share of the largest |update|."""
    x, y = _batch(8, 64, 1000, seed=1)
    _, net = seeded_pair(lambda pkg: pkg.resnet50_v1(), x)
    net.hybridize()
    w0 = _conv3x3_weights(net)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    # both trainers copy the same starting values when they are made
    trainers = [tmx.FusedTrainer(net, "softmax_cross_entropy", "sgd",
                                 dict(opt)) for _ in range(2)]
    updates = []
    for ft, xi in zip(trainers, (x, x * np.float32(1 + rel))):
        ft.step(nd.array(xi, ctx=cpu()), nd.array(y, ctx=cpu()))
        ft.sync_params()
        updates.append(_conv3x3_updates(net, w0))
    return _shares(updates[1], updates[0])


def _report(title, shares):
    print(title)
    for k, (norm_share, elem_share) in shares.items():
        print("  %-36s norm %.4f  largest element %.4f"
              % (k, norm_share, elem_share))
    print("  norm share %.4f-%.4f, largest element share %.4f (UPDATE_TOL "
          "%g)" % (min(v[0] for v in shares.values()),
                   max(v[0] for v in shares.values()),
                   max(v[1] for v in shares.values()), UPDATE_TOL))


if __name__ == "__main__":
    got, want, gap = reference_gap()
    _report("port vs reference, one step: loss %.6f vs %.6f (rel %.2g)"
            % (got, want, abs(got - want) / abs(want)), gap)
    _report("port vs itself on the input scaled by 1 + 1e-7",
            update_spread())
