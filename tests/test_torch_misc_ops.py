"""The deterministic names of ``mxnet_tpu/ops/misc_parity.py`` in the port
(``mxnet_tpu_torch/ops/misc_parity.py``) against the reference, on the CPU.

Each case runs the op through both packages' imperative dispatch under
their ``autograd.record`` on the same seeded numpy inputs and compares the
visible outputs (rtol 1e-5, atol 1e-6; integer outputs exactly, dtypes
included), then, for the differentiable ones, one backward with a seeded
head gradient and compares the inputs' gradients within the same
tolerance.  The four ``_sample_*`` tails are held to their distributions
in ``tests/test_torch_random_ops.py``.  ``cast_storage`` to a sparse
storage type raises until ``ndarray/sparse.py`` is ported.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import imperative_invoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


def u(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _run(pkg, name, inputs, kwargs, diff):
    """(visible outputs, gradients of the inputs listed in ``diff``)."""
    ctx = {} if pkg is mx else {"ctx": cpu()}
    invoke = imperative_invoke if pkg is mx else tmx.nd.invoke
    arrays = [pkg.nd.array(x, **ctx) for x in inputs]
    marked = [arrays[i] for i in diff]
    for a in marked:
        a.attach_grad()
    with pkg.autograd.record():
        outs = invoke(name, *arrays, **kwargs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    if marked:
        rng = np.random.default_rng(7)
        heads = [o for o in outs if o.asnumpy().dtype.kind == "f"]
        grads = [pkg.nd.array(rng.uniform(0.5, 1.5, o.shape)
                              .astype(np.float32), **ctx) for o in heads]
        pkg.autograd.backward(heads + marked, grads + [
            pkg.nd.array(np.full(a.shape, 0.25, np.float32), **ctx)
            for a in marked])
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in marked]


def case(name, inputs, kwargs=None, diff=(), id=None):
    return pytest.param(name, inputs, kwargs or {}, diff, id=id or name)


IDX = np.array([[0, 5, 2, 3, 5], [6, 0, 3, 1, 6]], np.float32)
UNIQ = np.array([[0, 5, 2, 3], [6, 0, 3, 1]], np.float32)
CASES = [
    case("_grad_add", [u((3, 4), 1), u((3, 4), 2)], diff=(0, 1)),
    case("_identity_with_attr_like_rhs", [u((3, 4), 1), u((3, 4), 2)],
         diff=(0,)),
    case("_histogram", [u((200,), 3)], dict(bin_cnt=8, range=(-1.5, 1.5)),
         id="_histogram-bin_cnt"),
    case("_histogram", [u((200,), 3),
                        np.array([-2, -1, 0, 0.5, 2], np.float32)],
         id="_histogram-edges"),
    case("_ravel_multi_index", [IDX], dict(shape=(6, 7))),
    case("ravel_multi_index", [IDX[:, :3]], dict(shape=(7, 9)),
         id="ravel_multi_index-alias"),
    case("_unravel_index", [np.array([0, 5, 41, 17, 36], np.float32)],
         dict(shape=(6, 7))),
    case("unravel_index", [np.array([3, 62], np.float32)],
         dict(shape=(7, 9)), id="unravel_index-alias"),
    case("_slice_assign", [u((6, 7), 4), u((2, 3), 5)],
         dict(begin=(1, 2), end=(5, 7), step=(2, 2)), (0, 1),
         "_slice_assign-step"),
    case("_slice_assign", [u((6, 7, 3), 4), u((3, 7, 3), 5)],
         dict(begin=(-1,), end=(0,), step=(-2,)), (0, 1),
         "_slice_assign-negative-step"),
    case("_slice_assign", [u((6, 7), 4), u((1, 3), 5)],
         dict(begin=(2, 1), end=(3, 4)), (0, 1), "_slice_assign-block"),
    case("_slice_assign_scalar", [u((6, 7), 4)],
         dict(scalar=1.5, begin=(1, -3), end=(4, 7)), (0,)),
    case("_scatter_set_nd", [u((6, 7), 6), u((4,), 7), UNIQ],
         dict(shape=(6, 7)), (0, 1)),
    case("_square_sum", [u((4, 5, 3), 8)], dict(axis=(1,)), (0,),
         "_square_sum-axis"),
    case("square_sum", [u((4, 5, 3), 8)], dict(axis=(0, 2), keepdims=True),
         (0,), "square_sum-keepdims"),
    case("_square_sum", [u((4, 5, 3), 8)], dict(axis=(1,), exclude=True),
         (0,), "_square_sum-exclude"),
    case("_sparse_adagrad_update", [u((5, 4), 9), u((5, 4), 10),
                                    u((5, 4), 11, 0.0, 1.0)],
         dict(lr=0.1, rescale_grad=0.5, clip_gradient=0.6)),
    case("IdentityAttachKLSparseReg", [u((6, 8), 12, 0.05, 0.95)],
         dict(sparseness_target=0.2, penalty=0.01, momentum=0.8), (0,)),
    case("IdentityAttachKLSparseReg", [u((4, 5, 3), 12, 0.05, 0.95),
                                       u((5,), 13, 0.1, 0.9)],
         {}, (0,), "IdentityAttachKLSparseReg-avg"),
    case("cast_storage", [u((3, 4), 1)], diff=(0,)),
    case("_cast_storage", [u((3, 4), 1)], dict(stype="default"), (0,),
         "_cast_storage-alias"),
]


@pytest.mark.parametrize("name,inputs,kwargs,diff", CASES)
def test_matches_reference(name, inputs, kwargs, diff):
    want, want_g = _run(mx, name, inputs, kwargs, diff)
    got, got_g = _run(tmx, name, inputs, kwargs, diff)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_sparse_adagrad_writes_its_history():
    """The new history is written back into the history input
    (``aux_writeback``), and rows with a zero gradient keep their
    weights, in both packages."""
    w, g, h = u((5, 4), 9), u((5, 4), 10), u((5, 4), 11, 0.1, 1.0)
    g[2] = 0.0
    res = {}
    for pkg, ctx in ((mx, {}), (tmx, {"ctx": cpu()})):
        arrays = [pkg.nd.array(x, **ctx) for x in (w, g, h)]
        out = pkg.nd._sparse_adagrad_update(*arrays, lr=0.1)
        res[pkg] = (out.asnumpy(), arrays[2].asnumpy())
    np.testing.assert_allclose(res[tmx][0], res[mx][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res[tmx][1], res[mx][1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(res[tmx][0][2], w[2])


@pytest.mark.parametrize("call", [
    lambda a: tmx.nd.cast_storage(a, stype="csr"),
    lambda a: tmx.nd.cast_storage(a, stype="row_sparse"),
    lambda a: tmx.nd._sparse_adagrad_update(a, a, a, lr=0.1, wd=0.1),
], ids=["csr", "row_sparse", "adagrad-wd"])
def test_unported_or_refused_raise(call):
    with pytest.raises(MXNetError):
        call(tmx.nd.array(u((3, 4), 1), ctx=cpu()))


def test_histogram_symbol_and_floats_param():
    """``range`` is a ``floats`` parameter: a string from a Symbol JSON
    parses as the tuple does, and a graph node gives the reference's
    counts and edges."""
    x = u((100,), 14)
    s = tmx.sym._histogram(tmx.sym.var("x"), bin_cnt=5, range="(-1, 1)")
    got = tmx.sym.load_json(s.tojson()).eval(
        cpu(), x=tmx.nd.array(x, ctx=cpu()))
    want = mx.nd._histogram(mx.nd.array(x), bin_cnt=5, range=(-1.0, 1.0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL)
