"""Every op name of the port's elementwise, reduction and matrix modules
(``mxnet_tpu_torch/ops/{elemwise,reduce,matrix}.py``) against the
reference's (``mxnet_tpu.nd``), on the CPU.

Each case runs one op through both packages' imperative dispatch under
their ``autograd.record`` on the same seeded numpy inputs: the outputs are
compared (float outputs within rtol 1e-5, atol 1e-6; integer and 0/1
outputs exactly, dtypes included), then one backward under each
package's autograd takes every float output with a seeded head gradient
``w_i`` and every marked input with 0.25 (which keeps an op without a
gradient connected) as heads, and the inputs' gradients are compared
within the same tolerance.  The cases include ties for ``sort``/``topk``/
``maximum``/``clip``, negative operands for ``mod`` and ``.5`` values for
``round``.  ``test_every_name_is_checked_or_exempt`` fails when a name of
the three modules is neither a case nor exempted with a reason.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import imperative_invoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OPS

RTOL, ATOL = 1e-5, 1e-6
MODULES = ("mxnet_tpu_torch.ops.elemwise", "mxnet_tpu_torch.ops.reduce",
           "mxnet_tpu_torch.ops.matrix")
EXEMPT = {
    "_contrib_SparseEmbedding": "needs ndarray/sparse.py (Queue 1 item 9); "
                                "raises, checked by test_sparse_ops_raise",
    "sparse_retain": "needs ndarray/sparse.py (Queue 1 item 9); raises",
    "_sparse_retain": "needs ndarray/sparse.py (Queue 1 item 9); raises",
}
# integer outputs whose dtype the reference takes from JAX's 32-bit
# default (it asks for int64, MXNet's dtype, which the port gives)
INT64_BY_DESIGN = ("shape_array", "size_array")


def _r(seed=0):
    return np.random.default_rng(seed)


def u(shape, lo=-2.0, hi=2.0, seed=0):
    return _r(seed).uniform(lo, hi, shape).astype(np.float32)


def pos(shape, seed=0):
    return u(shape, 0.5, 2.0, seed)


def away(shape, seed=0):
    """Magnitudes in [0.5, 2], either sign."""
    v = pos(shape, seed)
    return np.where(_r(seed + 1).uniform(size=shape) < 0.5, -v, v) \
        .astype(np.float32)


def ints(shape, lo, hi, seed=0):
    return _r(seed).integers(lo, hi, shape).astype(np.float32)


A, B = u((3, 4), seed=1), u((3, 4), seed=2)
B[0] = A[0]                       # ties for maximum / minimum
ROW = u((1, 4), seed=3)
ROW[0, 1] = A[2, 1]
HALVES = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.49, -0.51],
                   [3.5, -3.5, 0.0, 1.2]], np.float32)
TIES = np.array([[1.0, 3.0, 3.0, 2.0, 1.0], [0.0, -1.0, 2.0, 2.0, 2.0]],
                np.float32)
NANS = u((2, 3, 4), seed=4)
NANS[0, 1, 2] = NANS[1, 0, 0] = np.nan
X3 = u((2, 3, 4), seed=5)


def case(name, inputs, kwargs=None, diff=None, id=None):
    """``diff``: the indices of the inputs that get gradients (default:
    every one)."""
    return pytest.param(name, inputs, kwargs or {},
                        list(range(len(inputs))) if diff is None else diff,
                        id=id or name)


CASES = []
_BINARY = {"add": ("elemwise_add", "_plus", "_add"),
           "sub": ("elemwise_sub", "_minus", "_sub"),
           "mul": ("elemwise_mul", "_mul"),
           "div": ("elemwise_div", "_div", "_scatter_elemwise_div"),
           "mod": ("_mod",), "power": ("_power", "_pow"),
           "maximum": ("_maximum",), "minimum": ("_minimum",),
           "hypot": ("_hypot",)}
_OPERANDS = {"div": (A, away((3, 4), 6), away((1, 4), 7)),
             "mod": (u((3, 4), -3, 3, 8), away((3, 4), 9), away((1, 4), 10)),
             "power": (pos((3, 4), 11), u((3, 4), -1.5, 1.5, 12),
                       u((1, 4), -1.5, 1.5, 13))}
for _op, _aliases in _BINARY.items():
    lhs, rhs, row = _OPERANDS.get(_op, (A, B, ROW))
    CASES.append(case("broadcast_" + _op, [lhs, row]))
    CASES.append(case(_aliases[0], [lhs, rhs]))
    # the other aliases on the canonical op's inputs: the reference's
    # compiled primitives are reused, which keeps the sweep short
    CASES += [case(a, [lhs, row]) for a in _aliases[1:]]
_CMP_L, _CMP_R = ints((3, 4), -2, 3, 14), ints((3, 4), -2, 3, 15)
for _op in ("equal", "not_equal", "greater", "greater_equal", "lesser",
            "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    CASES.append(case("broadcast_" + _op, [_CMP_L, _CMP_R[:1]]))
    CASES.append(case("_" + _op, [_CMP_L, _CMP_R[:1]]))
_SCALAR_IN = {"_mod_scalar": (u((3, 4), -3, 3, 16), -1.5),
              "_rmod_scalar": (away((3, 4), 17), 2.5),
              "_rdiv_scalar": (away((3, 4), 18), 1.5),
              "_power_scalar": (pos((3, 4), 19), 1.5),
              "_rpower_scalar": (u((3, 4), seed=20), 2.0)}
for _op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
            "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
            "_power_scalar", "_rpower_scalar", "_maximum_scalar",
            "_minimum_scalar", "_hypot_scalar", "_scatter_plus_scalar",
            "_scatter_minus_scalar"):
    x, s = _SCALAR_IN.get(_op, (A, 0.5))
    if _op in ("_maximum_scalar", "_minimum_scalar"):
        x = A.copy()
        x[0, 0] = s                      # a tie with the scalar
    CASES.append(case(_op, [x], {"scalar": s}))
for _op in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
            "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
            "_logical_and_scalar", "_logical_or_scalar",
            "_logical_xor_scalar"):
    CASES.append(case(_op, [_CMP_L], {"scalar": 1.0}))
_UNARY_IN = {
    "pos": ("sqrt", "rsqrt", "log", "log10", "log2", "gamma", "gammaln",
            "reciprocal", "cbrt", "rcbrt"),
    "unit": ("arcsin", "arccos", "arctanh", "erfinv", "tan"),
    "halves": ("round", "rint", "ceil", "floor", "trunc", "fix", "sign",
               "abs", "relu"),
    "any": ("negative", "square", "exp", "log1p", "expm1", "sin", "cos",
            "arctan", "degrees", "radians", "sinh", "cosh", "tanh",
            "arcsinh", "erf", "sigmoid", "softsign", "softrelu", "_copy",
            "identity", "BlockGrad", "stop_gradient", "make_loss",
            "MakeLoss"),
}
for _kind, _names in _UNARY_IN.items():
    for _op in _names:
        x = {"pos": pos((3, 4), 21), "unit": u((3, 4), -0.9, 0.9, 22),
             "halves": HALVES, "any": u((3, 4), -1.5, 1.5, 23)}[_kind]
        if _op == "log1p":
            x = u((3, 4), -0.5, 2.0, 24)
        CASES.append(case(_op, [x]))
CASES += [
    case("arccosh", [u((3, 4), 1.1, 3.0, 25)]),
    case("logical_not", [_CMP_L]),
    case("hard_sigmoid", [np.array([[-2.5, 2.5, 0.3, -4.0]], np.float32)]),
    case("clip", [np.array([[-1.0, 1.0, 0.3, -4.0, 2.0]], np.float32)],
         {"a_min": -1.0, "a_max": 1.0}),
    case("smooth_l1", [u((3, 4), seed=26)], {"scalar": 1.5}),
]
CASES += [case(n, [A, B, u((3, 4), seed=27)])
          for n in ("add_n", "ElementWiseSum", "_sum")]

# ---- reductions -----------------------------------------------------------
for _op in ("sum", "sum_axis", "mean", "prod", "max", "max_axis", "min",
            "min_axis"):
    x = TIES if _op.startswith(("max", "min")) else X3
    CASES.append(case(_op, [x], id=_op + "-all"))
    CASES.append(case(_op, [x], {"axis": (1,), "keepdims": True},
                      id=_op + "-axis"))
CASES.append(case("sum", [X3], {"axis": (1,), "exclude": True},
                  id="sum-exclude"))
CASES += [case("nansum", [NANS], {"axis": (0, 2)}),
          case("nanprod", [NANS], {"axis": (2,)}),
          case("norm", [X3], id="norm-2"),
          case("norm", [X3], {"ord": 1, "axis": (1,)}, id="norm-1"),
          case("argmax", [TIES], id="argmax-flat"),
          case("argmax", [TIES], {"axis": (1,), "keepdims": True}),
          case("argmin", [TIES], {"axis": (1,)}),
          case("argmax_channel", [TIES]),
          case("broadcast_to", [ROW], {"shape": (3, 4)}),
          case("broadcast_axis", [ROW], {"axis": (0,), "size": (3,)}),
          case("broadcast_axes", [ROW], {"axis": (0,), "size": (3,)}),
          case("broadcast_like", [ROW, A], diff=[0])]
for _rt in ("value", "indices", "mask", "both"):
    CASES.append(case("topk", [TIES], {"k": 3, "ret_typ": _rt},
                      id="topk-" + _rt))
CASES += [case("topk", [TIES], {"k": 2, "ret_typ": "both",
                                "is_ascend": True}, id="topk-ascend"),
          case("sort", [TIES], id="sort-ascend"),
          case("sort", [TIES], {"is_ascend": False}, id="sort-descend"),
          case("argsort", [TIES], id="argsort-ascend"),
          case("argsort", [TIES], {"is_ascend": False},
               id="argsort-descend")]

# ---- matrix -----------------------------------------------------------------
IDS = np.array([[0, 3, 1], [2, 2, 4]], np.float32)
SEQ = u((4, 3, 2), seed=28)
LENS = np.array([2, 4, 1], np.float32)
CASES += [
    case("Reshape", [X3], {"shape": (0, -1)}),
    case("reshape", [X3], {"shape": (-3, 0)}),
    case("Reshape", [X3], {"shape": (-4, 1, 2, -2)}, id="Reshape-split"),
    case("Flatten", [X3]), case("flatten", [X3]),
    case("Concat", [A, B], {"dim": 1}), case("concat", [A, ROW], {"dim": 0}),
    case("SwapAxis", [X3], {"dim1": 0, "dim2": 2}),
    case("swapaxes", [X3], {"dim1": 1, "dim2": 2}),
    case("transpose", [X3]), case("transpose", [X3], {"axes": (2, 0, 1)},
                                  id="transpose-axes"),
    case("expand_dims", [A], {"axis": 1}),
    case("Embedding", [IDS, u((5, 3), seed=29)],
         {"input_dim": 5, "output_dim": 3}, diff=[1]),
    case("embedding", [IDS, u((5, 3), seed=30)],
         {"input_dim": 5, "output_dim": 3}, diff=[1]),
    case("zeros_like", [A]), case("ones_like", [A]),
    case("squeeze", [u((3, 1, 4), seed=31)]),
    case("squeeze", [u((3, 1, 4), seed=31)], {"axis": (1,)},
         id="squeeze-axis"),
    case("slice", [X3], {"begin": (0, 1), "end": (2, 3)}),
    case("crop", [X3], {"begin": (1, 2), "end": (2, 0), "step": (1, -1)}),
    case("slice_axis", [X3], {"axis": 2, "begin": 1, "end": 3}),
    case("slice_like", [X3, u((2, 2, 3), seed=32)], {"axes": (1, 2)},
         diff=[0]),
    case("dot", [A, u((4, 5), seed=33)]),
    case("dot", [u((4, 3), seed=34), u((5, 4), seed=35)],
         {"transpose_a": True, "transpose_b": True}, id="dot-transposed"),
    case("batch_dot", [u((2, 3, 4), seed=36), u((2, 4, 5), seed=37)]),
    case("batch_dot", [u((2, 4, 3), seed=38), u((2, 5, 4), seed=39)],
         {"transpose_a": True, "transpose_b": True},
         id="batch_dot-transposed"),
    case("stack", [A, B, ROW.repeat(3, 0)], {"axis": 1}),
    case("SliceChannel", [X3], {"num_outputs": 2, "axis": 0}),
    case("split", [X3], {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
    case("tile", [A], {"reps": (2, 1)}),
    case("repeat", [A], {"repeats": 2, "axis": (1,)}),
    case("repeat", [A], {"repeats": 2}, id="repeat-flat"),
    case("Pad", [u((1, 2, 3, 4), seed=40)],
         {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1), "constant_value": 0.5}),
    case("pad", [u((1, 2, 3, 4), seed=41)],
         {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    case("Pad", [u((1, 2, 3, 4), seed=42)],
         {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
         id="Pad-reflect"),
    case("reverse", [X3], {"axis": (0, 2)}), case("flip", [X3], {"axis": 1}),
    case("depth_to_space", [u((1, 8, 2, 3), seed=43)], {"block_size": 2}),
    case("space_to_depth", [u((1, 2, 4, 6), seed=44)], {"block_size": 2}),
] + [case(n, [u((1, 2, 4, 6), seed=45)], {"stride": 2})
     for n in ("reorg", "newreorg", "Reorg", "NewReorg")] + [
    case("take", [A, np.array([[0, 5], [-1, 2]], np.float32)], diff=[0]),
    case("take", [A, np.array([0, 5, -1, 2], np.float32)],
         {"axis": 1, "mode": "wrap"}, diff=[0], id="take-wrap"),
    case("batch_take", [A, np.array([3, 0, 2], np.float32)], diff=[0]),
    case("one_hot", [np.array([1, 0, 3, -1], np.float32)],
         {"depth": 4, "on_value": 2.0, "off_value": -1.0}, diff=[]),
    case("pick", [A, np.array([3, 0, 1], np.float32)], diff=[0]),
    case("pick", [X3, ints((2, 4), 0, 3, 46)], {"axis": 1, "keepdims": True},
         diff=[0], id="pick-axis"),
    case("where", [ints((3, 4), 0, 2, 47), A, B], diff=[1, 2]),
    case("gather_nd", [X3, np.array([[0, 1, 1], [2, 0, 2]], np.float32)],
         diff=[0]),
    case("scatter_nd", [u((3,), seed=48),
                        np.array([[0, 1, 0], [2, 1, 2]], np.float32)],
         {"shape": (2, 3)}, diff=[0]),
    case("Cast", [A], {"dtype": "float16"}),
    case("cast", [HALVES], {"dtype": "int32"}, diff=[]),
    case("amp_cast", [A], {"dtype": "float16"}),
    case("shape_array", [X3]), case("size_array", [X3]),
    case("reshape_like", [u((2, 6), seed=49), A], diff=[0]),
    case("diag", [A], {"k": 1}), case("diag", [u((3,), seed=50)],
                                      id="diag-1d"),
] + [case(n, [SEQ, LENS], {"use_sequence_length": True, "value": -1.0},
          diff=[0]) for n in ("SequenceMask", "sequence_mask")] + [
    case("SequenceLast", [SEQ, LENS], {"use_sequence_length": True},
         diff=[0]),
    case("sequence_last", [SEQ]),
    case("SequenceReverse", [SEQ, LENS], {"use_sequence_length": True},
         diff=[0]),
    case("sequence_reverse", [SEQ]),
]


def _run(pkg, invoke, name, inputs, kwargs, diff):
    """(outputs, input gradients) of one op in one package: each float
    output seeded with its ``w_i`` and each marked input with 0.25 as
    heads of one backward under the package's autograd."""
    ctx = {} if pkg is mx else {"ctx": cpu()}
    arrays = [pkg.nd.array(x, **ctx) for x in inputs]
    marked = [arrays[i] for i in diff]
    for a in marked:
        a.attach_grad()
    with pkg.autograd.record():
        outs = invoke(name, *arrays, **kwargs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    rng = np.random.default_rng(7)
    heads, head_grads = [], []
    for o in outs:
        w = rng.uniform(0.5, 1.5, o.shape).astype(np.float32)
        # an output the port leaves out of the graph (an index, a
        # comparison, BlockGrad) gets a zero gradient in the reference
        if o.asnumpy().dtype.kind == "f" and (
                pkg is mx or o._data.requires_grad):
            heads.append(o)
            head_grads.append(pkg.nd.array(w.astype(o.asnumpy().dtype),
                                           **ctx))
    heads += marked
    head_grads += [pkg.nd.array(np.full(a.shape, 0.25, np.float32), **ctx)
                   for a in marked]
    if marked:
        pkg.autograd.backward(heads, head_grads)
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in marked]


@pytest.mark.parametrize("name,inputs,kwargs,diff", CASES)
def test_op_matches_reference(name, inputs, kwargs, diff):
    want, want_g = _run(mx, imperative_invoke, name, inputs, kwargs, diff)
    got, got_g = _run(tmx, tmx.nd.invoke, name, inputs, kwargs, diff)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            if name not in INT64_BY_DESIGN:
                assert g.dtype == w.dtype, (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_comparisons_keep_integer_dtypes():
    """An int32 comparison gives int32 0/1 in both packages."""
    a, b = np.array([1, 2, 3], np.int32), np.array([3, 2, 1], np.int32)
    for name in ("broadcast_greater", "_equal", "broadcast_logical_and"):
        want = imperative_invoke(name, mx.nd.array(a), mx.nd.array(b))
        got = tmx.nd.invoke(name, tmx.nd.array(a, ctx=cpu()),
                            tmx.nd.array(b, ctx=cpu()))
        assert got.asnumpy().dtype == want.asnumpy().dtype == np.int32
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_sparse_ops_raise():
    x = tmx.nd.array(A, ctx=cpu())
    for name in EXEMPT:
        with pytest.raises(MXNetError, match="Queue 1 item 9"):
            tmx.nd.invoke(name, x, x)


def test_every_name_is_checked_or_exempt():
    names = {n for n, op in OPS.items() if op.fn.__module__ in MODULES}
    checked = {p.values[0] for p in CASES}
    missing = sorted(names - checked - set(EXEMPT))
    assert not missing, "names neither checked nor exempt: %s" % missing
    assert not set(EXEMPT) & checked
    assert len(names) >= 180


@pytest.mark.parametrize("value", [np.float32(2.5), np.array(2.5, np.float32),
                                   3.0], ids=["np-scalar", "0-d", "float"])
def test_zero_d_array_keeps_its_shape(value):
    """``nd.array`` of a 0-d value is 0-d, as the reference's (the port
    made it (1,) before, through ``np.ascontiguousarray``)."""
    want = mx.nd.array(value)
    got = tmx.nd.array(value, ctx=cpu())
    assert got.shape == want.shape == ()
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
