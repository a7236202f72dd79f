"""The port's imperative autograd (``mxnet_tpu_torch.autograd`` with
NDArray arithmetic) against the reference's (``mxnet_tpu.autograd``), on
the CPU: the 13 behaviours of ``tests/test_autograd.py``, each run in both
packages on the same numpy inputs, gradients within rtol 1e-5, atol 1e-6;
dropout by its mode and by its mask's statistics (the two packages draw
from different generators), not bit for bit.  One ``cuda`` test runs
``record``/``backward`` on gpu(0) against the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


def _arr(pkg, x, ctx=None):
    if pkg is mx:
        return mx.nd.array(np.asarray(x, np.float32))
    return tmx.nd.array(np.asarray(x, np.float32), ctx=ctx or tmx.cpu())


def both(fn):
    """``fn(pkg)`` in the reference and in the port, as numpy."""
    def np_(v):
        if isinstance(v, (list, tuple)):
            return [np_(x) for x in v]
        return v.asnumpy() if hasattr(v, "asnumpy") else v
    return np_(fn(mx)), np_(fn(tmx))


def assert_same(fn):
    want, got = both(fn)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_simple_backward():
    def run(pkg):
        x = _arr(pkg, [1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x + 2.0
        y.backward()
        return x.grad
    assert_same(run)


def test_chain():
    def run(pkg):
        x = _arr(pkg, [[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with pkg.autograd.record():
            z = pkg.nd.exp(pkg.nd.log(x) * 2.0).sum()
        z.backward()
        return [x.grad, z]
    assert_same(run)


def test_multiple_inputs():
    def run(pkg):
        a, b = _arr(pkg, [1.0, 2.0]), _arr(pkg, [3.0, 4.0])
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            c = a * b + a
        c.backward()
        return [a.grad, b.grad]
    assert_same(run)


def test_head_grads():
    def run(pkg):
        x = _arr(pkg, [1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = 3.0 * x
        y.backward(_arr(pkg, [10.0, 100.0]))
        return x.grad
    assert_same(run)


def test_grad_req_add():
    def run(pkg):
        x = _arr(pkg, [1.0])
        g = _arr(pkg, [0.0])
        pkg.autograd.mark_variables([x], [g], "add")
        for _ in range(3):
            with pkg.autograd.record():
                y = 2.0 * x
            y.backward()
        return x.grad
    want, got = both(run)
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, [6.0])


def test_not_recording_outside_scope():
    def run(pkg):
        x = _arr(pkg, [1.0])
        x.attach_grad()
        y = x * 2.0
        with pkg.autograd.record():
            rec = pkg.autograd.is_recording()
            z = x * 2.0
        return [y._ag_entry is None, z._ag_entry is not None, rec,
                pkg.autograd.is_recording()]
    want, got = both(run)
    assert got == want == [True, True, True, False]


def test_pause():
    def run(pkg):
        x = _arr(pkg, [1.0])
        x.attach_grad()
        with pkg.autograd.record():
            with pkg.autograd.pause():
                y = x * 2.0
            z = x * 3.0
        z.backward()
        return [x.grad, float(y._ag_entry is None)]
    assert_same(run)


def test_train_mode_flags():
    def run(pkg):
        ag = pkg.autograd
        out = [ag.is_training()]
        with ag.record():
            out.append(ag.is_training())
            with ag.predict_mode():
                out.append(ag.is_training())
        with ag.train_mode():
            out.append(ag.is_training())
        with ag.record(train_mode=False):
            out.append(ag.is_training())
        out.append(ag.set_training(True))
        out.append(ag.set_training(False))
        return out
    want, got = both(run)
    assert got == want == [False, True, False, True, False, False, True]


def test_dropout_respects_mode():
    """Off outside training (exactly the input), on inside ``record`` with
    the same keep rate and scale in both packages: the dropped share near
    p, the kept entries 1 / (1 - p)."""
    def run(pkg):
        x = pkg.nd.ones((100, 100)) if pkg is mx else \
            tmx.nd.ones((100, 100), ctx=tmx.cpu())
        out_eval = pkg.nd.Dropout(x, p=0.5)
        with pkg.autograd.record():
            out_train = pkg.nd.Dropout(x, p=0.3)
        with pkg.autograd.train_mode():
            out_mode = pkg.nd.Dropout(x, p=0.3)
        always = pkg.nd.Dropout(x, p=0.3, mode="always")
        return [out_eval, out_train, out_mode, always]
    want, got = both(run)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], 1.0)
    for g, w in zip(got[1:], want[1:]):
        for a in (g, w):
            assert 0.27 < (a == 0).mean() < 0.33
            np.testing.assert_allclose(np.unique(a), [0.0, 1.0 / 0.7],
                                       rtol=1e-6)


def test_grad_function():
    def run(pkg):
        x = _arr(pkg, [2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
        g = pkg.autograd.grad([y], [x])[0]
        return [g, x.grad]
    want, got = both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], 0.0)


def test_retain_graph():
    def run(pkg):
        x = _arr(pkg, [1.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * 5.0
        y.backward(retain_graph=True)
        first = x.grad.asnumpy().copy()
        y.backward()
        return [first, x.grad]
    assert_same(run)
    x = _arr(tmx, [1.0])
    x.attach_grad()
    with tmx.autograd.record():
        y = x * 5.0
    y.backward()
    with pytest.raises(MXNetError, match="retain_graph"):
        y.backward()


def test_custom_function():
    def run(pkg):
        nd = pkg.nd

        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = _arr(pkg, [0.0, 1.0, -2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = Sigmoid()(x * 2.0)
        y.backward()
        return [y, x.grad]
    assert_same(run)


def test_backward_through_conv():
    rng = np.random.default_rng(0)
    xs = [rng.random((2, 3, 8, 8)), rng.random((4, 3, 3, 3)) - 0.5,
          rng.random((4,))]

    def run(pkg):
        x, w, b = (_arr(pkg, v) for v in xs)
        for v in (x, w, b):
            v.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Convolution(x, w, b, kernel=(3, 3), num_filter=4,
                                   pad=(1, 1))
            loss = (y * y).sum()
        loss.backward()
        return [loss, x.grad, w.grad, b.grad]
    want, got = both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
    assert np.abs(got[2]).sum() > 0


def test_in_place_write_keeps_the_leaf():
    """``x += 1`` and ``x[:] = v`` on a marked array write in place: the
    next recorded graph still reaches its gradient buffer."""
    x = _arr(tmx, [1.0, 2.0])
    x.attach_grad()
    leaf = x._data
    x += 1.0
    x[1:] = 5.0
    assert x._data is leaf and leaf.requires_grad
    with tmx.autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0, 10.0])


@pytest.mark.cuda
def test_record_backward_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((4, 8, 9, 9)), rng.standard_normal((8, 8, 3, 3))
          * 0.2, rng.standard_normal((8,))]
    out = []
    for ctx in (tmx.cpu(), tmx.gpu(0)):
        x, w, b = (_arr(tmx, v, ctx) for v in xs)
        for v in (x, w, b):
            v.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.Convolution(x, w, b, kernel=(3, 3), num_filter=8,
                                   pad=(1, 1))
            loss = (tmx.nd.relu(y) * y).mean()
        loss.backward()
        out.append([a.asnumpy() for a in (loss, x.grad, w.grad, b.grad)])
    for g, w in zip(*out[::-1]):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
