"""Port ops (mxnet_tpu_torch.ops) vs mxnet_tpu's ``get_op(name).fn``.

Each case parses the same attribute dict with both registries, feeds both
functions the same numpy inputs (seeded) on the CPU and compares at
rtol = 1e-5 (fp32; both sides run the same fp32 arithmetic, summed in a
different order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu  # noqa: F401  (registers ops)
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.ops.registry import param as jax_param
from mxnet_tpu_torch.ops import get_op, nn as tnn
from mxnet_tpu_torch.ops.registry import param

RTOL = 1e-5
ATOL = 1e-5


def _bn_inputs(r, shape):
    c = shape[1]
    return [r.standard_normal(shape), r.uniform(0.5, 1.5, c),
            r.standard_normal(c), r.standard_normal(c) * 0.1,
            r.uniform(0.5, 2.0, c)]


# (op name, attrs as a Symbol JSON would carry them, input generator)
CASES = [
    ("BatchNorm", {"fix_gamma": "True"},
     lambda r: _bn_inputs(r, (2, 4, 5, 5))),
    ("BatchNorm", {"fix_gamma": "False"},
     lambda r: _bn_inputs(r, (2, 4, 5, 5))),
    ("Pooling", {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
                 "pool_type": "max"},
     lambda r: [r.standard_normal((2, 3, 9, 8))]),
    ("Pooling", {"global_pool": "True", "kernel": "(7, 7)",
                 "pool_type": "avg"},
     lambda r: [r.standard_normal((2, 3, 7, 7))]),
    ("Pooling", {"kernel": "(3, 3)", "stride": "(2, 2)", "pool_type": "max",
                 "pooling_convention": "full"},
     lambda r: [r.standard_normal((2, 3, 8, 8))]),
    ("Pooling", {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
                 "pool_type": "avg", "pooling_convention": "full"},
     lambda r: [r.standard_normal((2, 3, 8, 7))]),
    ("Pooling", {"kernel": "(2, 2)", "stride": "(2, 2)", "pad": "(1, 1)",
                 "pool_type": "avg", "count_include_pad": "False"},
     lambda r: [r.standard_normal((1, 2, 5, 5))]),
    ("Convolution", {"kernel": "(1, 1)", "stride": "(2, 2)",
                     "num_filter": "8", "no_bias": "True"},
     lambda r: [r.standard_normal((2, 6, 8, 8)),
                r.standard_normal((8, 6, 1, 1))]),
    ("Convolution", {"kernel": "(7, 7)", "stride": "(2, 2)", "pad": "(3, 3)",
                     "num_filter": "8", "no_bias": "True"},
     lambda r: [r.standard_normal((2, 3, 16, 16)),
                r.standard_normal((8, 3, 7, 7)) * 0.1]),
    ("Convolution", {"kernel": "(3, 3)", "pad": "(1, 1)", "num_filter": "6"},
     lambda r: [r.standard_normal((2, 4, 7, 5)),
                r.standard_normal((6, 4, 3, 3)), r.standard_normal(6)]),
    ("Convolution", {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
                     "num_filter": "6", "no_bias": "True"},
     lambda r: [r.standard_normal((2, 4, 8, 6)),
                r.standard_normal((6, 4, 3, 3))]),
    ("FullyConnected", {"num_hidden": "5"},
     lambda r: [r.standard_normal((3, 2, 2, 2)), r.standard_normal((5, 8)),
                r.standard_normal(5)]),
    ("Activation", {"act_type": "relu"},
     lambda r: [r.standard_normal((3, 7))]),
    ("Activation", {"act_type": "sigmoid"},
     lambda r: [r.standard_normal((3, 7))]),
    ("Activation", {"act_type": "tanh"},
     lambda r: [r.standard_normal((3, 7))]),
    ("Activation", {"act_type": "softrelu"},
     lambda r: [r.standard_normal((3, 7))]),
    ("Activation", {"act_type": "softsign"},
     lambda r: [r.standard_normal((3, 7))]),
    ("Activation", {"act_type": "gelu"},
     lambda r: [r.standard_normal((3, 7))]),
    ("softmax", {"axis": "1"}, lambda r: [r.standard_normal((4, 10))]),
    ("SoftmaxOutput", {}, lambda r: [r.standard_normal((4, 10)),
                                     np.arange(4.0)]),
    ("Flatten", {}, lambda r: [r.standard_normal((2, 3, 2, 2))]),
    ("elemwise_add", {}, lambda r: [r.standard_normal((2, 3)),
                                    r.standard_normal((2, 3))]),
    ("_plus_scalar", {"scalar": "1.5"}, lambda r: [r.standard_normal((2, 3))]),
]


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_op_matches_reference(case):
    name, attrs, make = CASES[case]
    inputs = [np.asarray(a, np.float32)
              for a in make(np.random.default_rng(case))]
    jop, top = jax_get_op(name), get_op(name)
    want = _first(jop.fn(jop.parse_attrs(dict(attrs)),
                         *[jnp.asarray(a) for a in inputs]))
    got = _first(top.fn(top.parse_attrs(dict(attrs)),
                        *[torch.from_numpy(a) for a in inputs]))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ptype,value", [
    ("shape", "(3, 3)"), ("shape", "(1,)"), ("shape", 2), (bool, "True"),
    (bool, "False"), (bool, "1"), (int, "64"), (float, "1e-3"),
    (["relu", "tanh"], "relu"), ("dtype", "float32"), ("dtype", "None"),
])
def test_param_coercion_matches_reference(ptype, value):
    assert param(ptype).coerce(value) == jax_param(ptype).coerce(value)


def test_registry_names_and_aliases_match_reference():
    for name in ("Convolution", "BatchNorm", "Pooling", "Activation",
                 "FullyConnected", "softmax", "SoftmaxOutput", "Flatten",
                 "elemwise_add", "broadcast_add", "_plus_scalar"):
        top, jop = get_op(name), jax_get_op(name)
        assert top.name == jop.name
        assert top.arg_names == jop.arg_names
        assert top.aux_inputs == jop.aux_inputs


@pytest.mark.parametrize("attrs,shape,mode", [
    ({"kernel": "(3, 3)", "pad": "(1, 1)"}, (1, 4, 5, 7), "s1"),
    ({"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)"},
     (1, 4, 8, 6), "s2"),
    ({"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)"},
     (1, 4, 7, 6), None),
    ({"kernel": "(1, 1)", "stride": "(2, 2)"}, (1, 4, 8, 8), None),
    ({"kernel": "(7, 7)", "stride": "(2, 2)", "pad": "(3, 3)"},
     (1, 3, 8, 8), None),
    ({"kernel": "(3, 3)", "pad": "(1, 1)", "num_group": "2"},
     (1, 4, 5, 5), None),
    ({"kernel": "(3, 3)", "pad": "(1, 1)", "dilate": "(2, 2)"},
     (1, 4, 5, 5), None),
])
def test_conv_dispatch_classes(attrs, shape, mode):
    """The 3x3 s1 / s2 classes go to the hand-written kernel, every other
    conv to F.conv2d."""
    a = get_op("Convolution").parse_attrs(dict(attrs, num_filter="4"))
    assert tnn.hopper_conv_mode(a, torch.empty(shape, device="meta")) == mode


@pytest.mark.parametrize("fix_gamma", ["True", "False"])
def test_batchnorm_training_matches_reference(fix_gamma):
    """Training BatchNorm: the output over the batch's statistics and the
    new moving mean and variance (outputs 1 and 2) all match."""
    inputs = [np.asarray(a, np.float32)
              for a in _bn_inputs(np.random.default_rng(11), (3, 4, 5, 6))]
    raw = {"fix_gamma": fix_gamma, "eps": "1e-5", "momentum": "0.9"}
    jop, top = jax_get_op("BatchNorm"), get_op("BatchNorm")
    want = jop.fn(jop.parse_attrs(dict(raw, __train__=True)),
                  *[jnp.asarray(a) for a in inputs])
    got = top.fn(dict(top.parse_attrs(dict(raw)), __train__=True),
                 *[torch.from_numpy(a) for a in inputs])
    assert top.train_aware and top.aux_writeback == {1: 3, 2: 4}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_softmax_cross_entropy_matches_reference():
    r = np.random.default_rng(12)
    logits = r.standard_normal((6, 10)).astype(np.float32) * 3
    labels = r.integers(0, 10, 6).astype(np.float32)
    jop, top = (jax_get_op("softmax_cross_entropy"),
                get_op("softmax_cross_entropy"))
    want = jop.fn(jop.parse_attrs({}), jnp.asarray(logits),
                  jnp.asarray(labels))
    got = top.fn(top.parse_attrs({}), torch.from_numpy(logits),
                 torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    per = tnn.streaming_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    lse = np.log(np.exp(logits).sum(1))
    np.testing.assert_allclose(
        per.numpy(), lse - logits[np.arange(6), labels.astype(int)],
        rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# SoftmaxOutput's backward, Embedding out of range, LayerNorm's mean and var:
# each against jax.vjp of the reference op on the same inputs
# --------------------------------------------------------------------------
def _vjp_both(name, attrs, inputs, cots):
    """(reference outputs, reference input cotangents, port outputs, port
    input gradients) of op ``name`` on the same inputs and cotangents."""
    import jax
    jop, top = jax_get_op(name), get_op(name)
    ja = jop.parse_attrs(dict(attrs))
    want, vjp = jax.vjp(lambda *xs: jop.fn(ja, *xs),
                        *[jnp.asarray(a) for a in inputs])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(want, tuple) else jnp.asarray(cots[0]))
    ts = [torch.from_numpy(a).requires_grad_(a.dtype.kind == "f")
          for a in inputs]
    got = top.fn(top.parse_attrs(dict(attrs)), *ts)
    outs = got if isinstance(got, tuple) else (got,)
    torch.autograd.backward(list(outs), [torch.from_numpy(c) for c in cots])
    return (want if isinstance(want, tuple) else (want,), jgrads, outs,
            [t.grad for t in ts])


SOFTMAX_OUTPUT_CASES = [
    ({}, (4, 10), (4,)),
    ({"grad_scale": "0.5", "normalization": "batch"}, (4, 10), (4,)),
    ({"use_ignore": "True", "ignore_label": "2"}, (6, 5), (6,)),
    ({"use_ignore": "True", "ignore_label": "2", "normalization": "valid"},
     (6, 5), (6,)),
    ({"normalization": "valid"}, (6, 5), (6,)),
    ({"multi_output": "True"}, (3, 5, 4), (3, 4)),
    ({"multi_output": "True", "use_ignore": "True", "ignore_label": "-1",
      "normalization": "valid"}, (3, 5, 4), (3, 4)),
    ({"preserve_shape": "True"}, (2, 3, 6), (2, 3)),
    ({"preserve_shape": "True", "use_ignore": "True", "ignore_label": "1"},
     (2, 3, 6), (2, 3)),
    ({"smooth_alpha": "0.1"}, (4, 10), (4,)),
]


@pytest.mark.parametrize("case", range(len(SOFTMAX_OUTPUT_CASES)),
                         ids=["-".join(sorted(c[0])) or "plain"
                              for c in SOFTMAX_OUTPUT_CASES])
def test_softmax_output_backward_matches_reference(case):
    """The logits' gradient is ``(p - onehot(label)) * scale`` whatever the
    head gradient, masked and normalised as the reference's custom VJP
    (``nn.py:777-826``), at rtol = atol = 1e-5; the label's is zero."""
    attrs, dshape, lshape = SOFTMAX_OUTPUT_CASES[case]
    r = np.random.default_rng(40 + case)
    data = r.standard_normal(dshape).astype(np.float32)
    ncls = dshape[1] if attrs.get("multi_output") else dshape[-1]
    label = r.integers(-1 if "ignore_label" in attrs else 0, ncls,
                       lshape).astype(np.float32)
    head = r.standard_normal(dshape).astype(np.float32)
    want, jg, got, tg = _vjp_both("SoftmaxOutput", attrs, [data, label],
                                  [head])
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(np.asarray(jg[0])).max() > 0
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), rtol=RTOL,
                               atol=ATOL)
    assert not np.asarray(jg[1]).any() and not tg[1].numpy().any()


def test_softmax_output_low_precision_logits():
    """bf16 logits: fp32 probabilities and a bf16 gradient, the cast taken
    outside the Function as the reference does (``nn.py:818-826``)."""
    r = np.random.default_rng(3)
    data = torch.from_numpy(r.standard_normal((4, 6)).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_()
    label = torch.tensor([0.0, 5.0, 2.0, 1.0])
    top = get_op("SoftmaxOutput")
    p = top.fn(top.parse_attrs({}), data, label)
    assert p.dtype == torch.float32
    p.sum().backward()
    assert data.grad.dtype == torch.bfloat16
    want = torch.softmax(data.detach().float(), -1) \
        - torch.nn.functional.one_hot(label.long(), 6)
    np.testing.assert_allclose(data.grad.float().numpy(), want.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("ids", [[[0, 7], [-1, 1]], [[-5, -6], [4, 5]]],
                         ids=["roadmap", "edges"])
def test_embedding_out_of_range_matches_reference(ids):
    """``jnp.take``'s default mode: ids in [-5, 0) wrap, ids >= 5 and < -5
    give NaN rows; the gradient reaches only rows of valid ids (exact)."""
    w = np.arange(15, dtype=np.float32).reshape(5, 3)
    data = np.asarray(ids, np.float32)
    cot = np.random.default_rng(5).standard_normal((2, 2, 3)) \
        .astype(np.float32)
    attrs = {"input_dim": "5", "output_dim": "3"}
    want, jg, got, tg = _vjp_both("Embedding", attrs, [data, w], [cot])
    np.testing.assert_array_equal(got[0].detach().numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), rtol=RTOL,
                               atol=ATOL)


def test_layer_norm_mean_var_gradients_match_reference():
    """Cotangents on out, mean and var at (2, 5, 3), ``default_rng(0)``:
    outputs and dx, dgamma, dbeta within rtol = atol = 1e-5."""
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 3)).astype(np.float32)
    gamma = r.standard_normal(3).astype(np.float32)
    beta = r.standard_normal(3).astype(np.float32)
    cots = [r.standard_normal((2, 5, 3)).astype(np.float32),
            r.standard_normal((2, 5)).astype(np.float32),
            r.standard_normal((2, 5)).astype(np.float32)]
    want, jg, got, tg = _vjp_both("LayerNorm", {"output_mean_var": "True"},
                                  [x, gamma, beta], cots)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_layer_norm_var_precision():
    """x = 1e-4 N(0, 1) at (4, 64): var within a relative 1e-6 of float64
    (the reference's is 6.8e-8 off; rebuilding var from 1/std was 8.5e-5
    off)."""
    x = (1e-4 * np.random.default_rng(0).standard_normal((4, 64))) \
        .astype(np.float32)
    top = get_op("LayerNorm")
    _, mean, var = top.fn(top.parse_attrs({"output_mean_var": "True"}),
                          torch.from_numpy(x), torch.ones(64),
                          torch.zeros(64))
    want = x.astype(np.float64).var(axis=-1)
    np.testing.assert_allclose(var.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(mean.numpy(), x.astype(np.float64).mean(-1),
                               rtol=1e-5, atol=1e-12)
