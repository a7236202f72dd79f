"""The port's ``nd.random``, ``nd.contrib``, ``nd.image``, ``nd.utils``,
``sym.random``, ``sym.contrib`` and ``sym.image`` namespaces and the eight
``Symbol`` methods of slice 18, against the reference, on the CPU.

The contrib and image namespaces are generated from the ``_contrib_`` and
``_image_`` prefixes over each package's own registry, so the port's hold
exactly the names its registry has (the rest come with ROADMAP.md's Queue
1 item 9), and the control-flow operators raise until
``ops/control_flow.py`` is ported.  Values compare within rtol 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OPS

RTOL = 1e-6


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def _generated(prefix):
    return {n[len(prefix):] for n in OPS if n.startswith(prefix)}


@pytest.mark.parametrize("ns", ["random"])
def test_random_namespaces_hold_the_reference_names(ns):
    """Every sampler of the reference's ``nd.random`` and ``sym.random``
    is in the port's; ``sym.random`` has all of ``nd.random``'s."""
    ref_nd = {n for n in _public(mx.nd.random)
              if callable(getattr(mx.nd.random, n))} - {
                  "NDArray", "imperative_invoke", "annotations"}
    assert ref_nd <= _public(tmx.nd.random)
    assert (_public(mx.sym.random) - {"annotations"}) <= \
        _public(tmx.sym.random)
    assert set(tmx.nd.random.__all__) == set(tmx.sym.random.__all__)


@pytest.mark.parametrize("module,prefix", [
    (tmx.nd.contrib, "_contrib_"), (tmx.sym.contrib, "_contrib_"),
    (tmx.nd.image, "_image_"), (tmx.sym.image, "_image_")],
    ids=["nd.contrib", "sym.contrib", "nd.image", "sym.image"])
def test_prefix_namespaces_are_generated(module, prefix):
    names = _generated(prefix)
    assert names <= _public(module)
    for n in names:
        assert getattr(module, n).__name__ == n


@pytest.mark.parametrize("module", [tmx.nd.contrib, tmx.sym.contrib],
                         ids=["nd", "sym"])
@pytest.mark.parametrize("name", ["foreach", "while_loop", "cond"])
def test_control_flow_raises(module, name):
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        getattr(module, name)(lambda *a: a, None, None)


def test_reference_contrib_names_are_ported_or_item_9():
    """A name of the reference's ``nd.contrib`` that the port lacks is one
    whose op the port does not register yet (item 9)."""
    from mxnet_tpu.ops.registry import OPS as REF
    ref = {n for n in _public(mx.nd.contrib)
           if "_contrib_" + n in REF}
    missing = ref - _public(tmx.nd.contrib)
    assert all("_contrib_" + n not in OPS for n in missing)


def test_utils_zeros_like_fn():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = tmx.nd.utils.zeros_like_fn(tmx.nd.array(x, ctx=cpu()))
    want = mx.nd.utils.zeros_like_fn(mx.nd.array(x))
    assert got.shape == want.shape and got.context == cpu()
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert tmx.nd.zeros_like_fn is tmx.nd.utils.zeros_like_fn


def _both(build, **arrays):
    """``build(sym)`` evaluated in both packages on the same arrays, each
    built under a fresh ``NameManager``, so that the names compared do not
    depend on how far earlier tests advanced either package's counters."""
    out = {}
    for pkg, ctx in ((mx, None), (tmx, cpu())):
        with pkg.name.NameManager():
            s = build(pkg.sym)
        kw = {k: pkg.nd.array(v, **({} if pkg is mx else {"ctx": ctx}))
              for k, v in arrays.items()}
        res = s.eval(ctx, **kw) if pkg is tmx else s.eval(**kw)
        out[pkg] = (s, [r.asnumpy() for r in res])
    return out


X = np.random.default_rng(0).uniform(-2, 2, (3, 4, 5)).astype(np.float32)


@pytest.mark.parametrize("build", [
    lambda s: s.var("x").flatten(),
    lambda s: s.var("x").sum(),
    lambda s: s.var("x").sum(axis=1, keepdims=True),
    lambda s: s.var("x").mean(axis=(0, 2)),
    lambda s: s.var("x").mean(),
    lambda s: s.var("x").slice_axis(axis=2, begin=1, end=4),
    lambda s: s.var("x").slice_axis(axis=0, begin=-2, end=None),
    lambda s: s.var("x").astype("int32"),
    lambda s: s.var("x").astype(np.float16),
], ids=["flatten", "sum", "sum-axis", "mean-axes", "mean", "slice_axis",
        "slice_axis-negative", "astype-int32", "astype-float16"])
def test_symbol_methods_match_reference(build):
    res = _both(build, x=X)
    (rs, want), (ts, got) = res[mx], res[tmx]
    assert ts.list_outputs() == rs.list_outputs() == ts.outputs \
        == rs.outputs
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_simple_eval_is_eval():
    s = tmx.sym.var("a") * 2 + tmx.sym.var("b")
    a, b = np.ones((2, 2), np.float32), np.full((2, 2), 3, np.float32)
    kw = dict(a=tmx.nd.array(a, ctx=cpu()), b=tmx.nd.array(b, ctx=cpu()))
    np.testing.assert_array_equal(s.simple_eval(cpu(), **kw)[0].asnumpy(),
                                  s.eval(cpu(), **kw)[0].asnumpy())
    np.testing.assert_array_equal(s.eval(cpu(), **kw)[0].asnumpy(), 5.0)


def test_sym_random_node_shapes_match_reference():
    """``sym.random`` nodes infer the reference's shapes, and one made
    under a name keeps it."""
    for name in ("uniform", "normal", "gamma"):
        r = getattr(mx.sym.random, name)(shape=(3, 2), name="r")
        t = getattr(tmx.sym.random, name)(shape=(3, 2), name="r")
        assert t.infer_shape()[1] == r.infer_shape()[1] == [(3, 2)]
        assert t.name == r.name == "r"
