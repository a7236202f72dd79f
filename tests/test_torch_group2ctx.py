"""Placement of a graph's node groups on devices (``AttrScope(ctx_group=)``
with ``bind``/``simple_bind(group2ctx=)`` and ``Module(group2ctxs=)``) in
the port against the reference, on the CPU: the reference's two-group MLP
with ``dev1`` on cpu(0) and ``dev2`` on cpu(1).  Forward and backward
equal the ungrouped executor's and the reference's within 1e-6; the
output's context is cpu(1).  ``AttrScope`` reaches the nodes of operator
overloads and variables, with the reference's precedence.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-6


def two_group_mlp(pkg):
    sym = pkg.sym if pkg is tmx else pkg.symbol
    data = sym.var("data")
    with pkg.AttrScope(ctx_group="dev1"):
        h = sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = sym.Activation(h, act_type="relu")
    with pkg.AttrScope(ctx_group="dev2"):
        h = sym.FullyConnected(h, num_hidden=8, name="fc2")
        out = sym.SoftmaxOutput(h, name="softmax")
    return out


def _bind(pkg, grouped):
    g2c = {"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)} if grouped else None
    return two_group_mlp(pkg).simple_bind(ctx=pkg.cpu(0), group2ctx=g2c,
                                          data=(4, 12))


def _step(ex, values):
    for n, v in values.items():
        ex.arg_dict[n][:] = v
    outs = ex.forward(is_train=True)
    ex.backward()
    return outs[0], {n: g.asnumpy() for n, g in ex.grad_dict.items()
                     if n not in ("data", "softmax_label")}


def _values(ex):
    rng = np.random.default_rng(0)
    vals = {n: rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
            for n, a in ex.arg_dict.items()}
    vals["data"] = rng.uniform(size=(4, 12)).astype(np.float32)
    vals["softmax_label"] = rng.integers(0, 8, 4).astype(np.float32)
    return vals


@pytest.mark.parametrize("grouped", [True, False])
def test_two_groups_match_ungrouped_and_reference(grouped):
    ex = _bind(tmx, grouped)
    vals = _values(ex)
    out, grads = _step(ex, vals)
    out1, grads1 = _step(_bind(tmx, False), vals)
    jout, jgrads = _step(_bind(mx, grouped), vals)
    assert out.context == (tmx.cpu(1) if grouped else tmx.cpu(0))
    assert set(grads) == {"fc1_weight", "fc1_bias", "fc2_weight",
                          "fc2_bias"}
    for want in (out1.asnumpy(), jout.asnumpy()):
        np.testing.assert_allclose(out.asnumpy(), want, rtol=TOL, atol=TOL)
    for n in grads:
        for want in (grads1[n], jgrads[n]):
            np.testing.assert_allclose(grads[n], want, rtol=TOL, atol=TOL)


def test_plan_places_each_group():
    ex = _bind(tmx, True)
    plan = ex._plan(True)
    placed = {n.name: plan.placed[id(n)] for n in plan.topo if not n.is_var}
    assert placed["fc1"] == tmx.cpu(0) and placed["fc2"] == tmx.cpu(1)
    assert placed["softmax"] == tmx.cpu(1)
    assert ex._plan(False).placed is not None


def test_module_group2ctxs_fits_and_scores(monkeypatch):
    """``Module(group2ctxs=)`` (a dict, and a list of one dict a context)
    trains through ``fit`` on the eager arm (the fused step stands aside,
    as the reference's) and scores; its parameters equal an ungrouped
    Module's after the same epoch."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(32, 12)).astype(np.float32)
    y = rng.integers(0, 8, 32).astype(np.float32)
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    params = []
    for groups in (g2c, [g2c], None):
        tmx.random.seed(3)
        np.random.seed(3)
        mod = tmx.mod.Module(two_group_mlp(tmx), context=[tmx.cpu()],
                             group2ctxs=groups)
        it = tmx.io.NDArrayIter(X, y, batch_size=8, ctx=tmx.cpu())
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
                initializer=tmx.init.Uniform(0.1))
        if groups is not None:
            assert not mod._fused().eligible()
            assert mod._exec_group.execs[0]._group2ctx == g2c
        acc = dict(mod.score(it, "acc"))["accuracy"]
        assert 0.0 <= acc <= 1.0
        params.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for got in params[:2]:
        for k, v in params[2].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="number of contexts"):
        tmx.mod.Module(two_group_mlp(tmx), context=[tmx.cpu()],
                       group2ctxs=[g2c, g2c]).bind([("data", (8, 12))],
                                                   [("softmax_label", (8,))])


def test_bucketing_module_passes_group2ctxs_on():
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}

    def sym_gen(key):
        return two_group_mlp(tmx), ("data",), ("softmax_label",)

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=12,
                                  context=[tmx.cpu()], group2ctxs=g2c)
    mod.bind([("data", (4, 12))], [("softmax_label", (4,))])
    assert mod._curr_module._exec_group.execs[0]._group2ctx == g2c


def test_attr_scope_applies_to_operator_overloads():
    def run(pkg):
        sym = pkg.sym if pkg is tmx else pkg.symbol
        with pkg.AttrScope(ctx_group="g1"):
            a, b = sym.var("a"), sym.var("b")
            c = a * b + a
            d = -(a - 2.0) / b
        return [node.attrs.get("ctx_group") for s in (c, d)
                for node, _ in s._outputs] + [
            node.attrs.get("ctx_group") for node, _ in a._outputs]
    assert run(tmx) == run(mx) == ["g1"] * 3


def test_attr_precedence_and_variable_scope():
    """Op keywords beat the explicit attr dict, which beats the scope;
    variables take the scope's attributes; nested scopes merge."""
    def run(pkg):
        sym = pkg.sym if pkg is tmx else pkg.symbol
        with pkg.AttrScope(ctx_group="g", __lr_mult__="0.0"):
            v = sym.var("w")
            fc = sym.FullyConnected(sym.var("x"), num_hidden=10,
                                    attr={"num_hidden": "20",
                                          "ctx_group": "override"})
            with pkg.AttrScope(ctx_group="inner"):
                w2 = sym.var("w2")
        vn, fn, wn = (s._outputs[0][0] for s in (v, fc, w2))
        return [vn.attrs["__lr_mult__"], vn.attrs["ctx_group"],
                fn.parsed_attrs()["num_hidden"], fn.attrs["ctx_group"],
                wn.attrs["ctx_group"], wn.attrs["__lr_mult__"]]
    assert run(tmx) == run(mx) == ["0.0", "g", 10, "override", "inner",
                                   "0.0"]
