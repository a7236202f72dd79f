"""The port's LSTM recurrence and RNN op (mxnet_tpu_torch.ops.hopper_rnn,
ops.rnn) and the ops the LSTM layer's graph uses, against the reference's
(mxnet_tpu), on the CPU.

- ``lstm_fwd_plain`` / ``lstm_bwd_plain`` against the Pallas kernels
  ``_lstm_fwd_impl`` and ``_lstm_vjp_bwd`` themselves, run by the Pallas
  interpreter (``pallas_rnn.INTERPRET``, as ``tests/test_pallas_rnn.py``
  sets it): forward 2e-5 and backward 5e-4 absolute, the tolerances of
  ``tests/test_pallas_rnn.py``.  The reference kernels work in (T, 4, B, H)
  layouts and the port's in (T, B, 4H); the test converts.
- The ``RNN`` op, 2 LSTM layers, one and two directions, ``p = 0``, against
  the reference's ``_rnn`` under the interpreter: outputs within 2e-5, and
  the gradients with respect to data, packed parameters and both states,
  for seeded cotangents on all three outputs, within 5e-4.
- ``Reshape``, ``Concat``, ``mean(exclude)``, ``broadcast_axis``,
  ``Embedding`` and ``streaming_softmax_ce`` against the reference's ops,
  within 1e-6.
- One ``cuda`` test: kernels 8 and 9 against their plain versions at a
  ragged shape; it skips without a card and runs on one.

fp32 throughout; the sums run in another order on each side.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import pallas_rnn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import hopper_rnn as hr
from mxnet_tpu_torch.ops import registry as treg

FWD_TOL = 2e-5
BWD_TOL = 5e-4
OP_TOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_rnn.INTERPRET = True
    yield
    pallas_rnn.INTERPRET = False


def _lstm_case(T, B, H, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(xp=f(T, B, 4 * H), h0=f(B, H, scale=0.3), c0=f(B, H, scale=0.3),
                R=f(4 * H, H, scale=0.2), bR=f(4 * H, scale=0.1),
                dys=f(T, B, H), dhT=f(B, H), dcT=f(B, H))


def _to4(a, T, B, H):
    """(T, B, 4H) -> the reference kernel's (T, 4, B, H)."""
    return jnp.asarray(a).reshape(T, B, 4, H).transpose(0, 2, 1, 3)


def _from4(a, T, B, H):
    return np.asarray(a).transpose(0, 2, 1, 3).reshape(T, B, 4 * H)


@pytest.mark.parametrize("T,B,H", [(5, 8, 16), (3, 5, 12)])
def test_plain_lstm_matches_pallas_kernels(T, B, H):
    c = _lstm_case(T, B, H, seed=T * 100 + H)
    rt4 = jnp.asarray(c["R"]).reshape(4, H, H).transpose(0, 2, 1)
    b4 = jnp.asarray(c["bR"]).reshape(4, 1, H)
    (ys, hT, cT), (gates, cs, _, _, _) = pallas_rnn._lstm_fwd_impl(
        _to4(c["xp"], T, B, H), jnp.asarray(c["h0"]), jnp.asarray(c["c0"]),
        rt4, b4)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    got = hr.lstm_fwd_plain(t["xp"], t["h0"], t["c0"], t["R"], t["bR"])
    want = [ys, hT, cT, _from4(gates, T, B, H), cs]
    for name, g, w in zip(["ys", "hT", "cT", "gates", "cs"], got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_TOL, err_msg=name)

    res = (gates, cs, ys, jnp.asarray(c["h0"]), jnp.asarray(c["c0"]), rt4)
    dxp4, dh0, dc0, _, _ = pallas_rnn._lstm_vjp_bwd(
        res, (jnp.asarray(c["dys"]), jnp.asarray(c["dhT"]),
              jnp.asarray(c["dcT"])))
    got = hr.lstm_bwd_plain(got[3], got[4], t["c0"], t["dys"], t["dhT"],
                            t["dcT"], t["R"])
    want = [_from4(dxp4, T, B, H), dh0, dc0]
    for name, g, w in zip(["dxp", "dh0", "dc0"], got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_matches_reference(bidirectional):
    T, B, F, H, L = 3, 3, 6, 8, 2
    dirs = 2 if bidirectional else 1
    kw = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
              mode="lstm", p=0.0, state_outputs=True)
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    n = rnn_param_size(L, H, F, bidirectional, "lstm")
    r = np.random.default_rng(7 + dirs)
    data = r.standard_normal((T, B, F)).astype(np.float32)
    params = (r.standard_normal(n) * 0.3).astype(np.float32)
    h0 = (r.standard_normal((L * dirs, B, H)) * 0.3).astype(np.float32)
    c0 = (r.standard_normal((L * dirs, B, H)) * 0.3).astype(np.float32)
    cts = [r.standard_normal(s).astype(np.float32)
           for s in ((T, B, dirs * H), (L * dirs, B, H), (L * dirs, B, H))]

    jop = jreg.get_op("RNN")
    jattrs = jop.parse_attrs(dict(kw))
    key = jax.random.PRNGKey(0)

    @jax.jit        # one program: the interpreter runs faster traced
    def reference(args, cotangents):
        outs, vjp = jax.vjp(lambda *a: jop.fn(jattrs, key, *a), *args)
        return outs, vjp(cotangents)

    jouts, jgrads = reference(tuple(map(jnp.asarray, (data, params, h0, c0))),
                              tuple(map(jnp.asarray, cts)))

    top = treg.get_op("RNN")
    ins = [torch.from_numpy(a).requires_grad_() for a in (data, params, h0, c0)]
    touts = top.fn(top.parse_attrs(dict(kw)), None, *ins)
    tgrads = torch.autograd.grad(touts, ins, [torch.from_numpy(c) for c in cts])

    for name, g, w in zip(["out", "hT", "cT"], touts, jouts):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_TOL, err_msg=name)
    for name, g, w in zip(["d data", "d params", "d h0", "d c0"], tgrads,
                          jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_TOL, err_msg=name)


def _ops_cases():
    r = np.random.default_rng(11)
    x = r.standard_normal((2, 3, 4)).astype(np.float32)
    ids = r.integers(0, 10, (3, 2)).astype(np.float32)
    table = r.standard_normal((10, 5)).astype(np.float32)
    logits = r.standard_normal((3, 2, 7)).astype(np.float32)
    labels = r.integers(0, 7, (3, 2)).astype(np.float32)
    return [
        ("Reshape", {"shape": (-1,)}, [x]),
        ("Reshape", {"shape": (0, -3)}, [x]),
        ("Reshape", {"shape": (-4, 1, 2, -2)}, [x]),
        ("Concat", {"dim": 0}, [x.reshape(-1), x[0].reshape(-1)]),
        ("mean", {"axis": (0, 2), "keepdims": True}, [x]),
        ("mean", {"axis": 0, "exclude": True}, [x]),
        ("broadcast_axis", {"axis": (0, 2), "size": (3, 5)}, [x[:1, :, :1]]),
        ("SwapAxis", {"dim1": 0, "dim2": 1}, [x]),
        ("zeros_like", {}, [x]),
        ("Embedding", {"input_dim": 10, "output_dim": 5}, [ids, table]),
        ("streaming_softmax_ce", {"axis": -1, "keepdims": True},
         [logits, labels]),
        ("streaming_softmax_ce", {"axis": 1}, [logits.transpose(0, 2, 1),
                                               labels]),
    ]


@pytest.mark.parametrize("name,kw,inputs", _ops_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_layer_ops_match_reference(name, kw, inputs):
    jop, top = jreg.get_op(name), treg.get_op(name)
    want = jop.fn(jop.parse_attrs(dict(kw)), *map(jnp.asarray, inputs))
    got = top.fn(top.parse_attrs(dict(kw)), *map(torch.from_numpy, inputs))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_TOL)


@pytest.mark.cuda
def test_lstm_kernels_match_plain_on_the_card():
    """Kernels 8 and 9 against their plain versions at ragged shapes (B and
    H off every tile width), 1e-5 forward, 1e-4 of the largest |value|
    backward, as chip_smoke.py holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same check "
                    "on the H100")
    for T, B, H in [(7, 3, 100), (5, 33, 257)]:
        c = {k: torch.from_numpy(v).cuda()
             for k, v in _lstm_case(T, B, H, seed=1).items()}
        got = hr.lstm_fwd(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
        want = hr.lstm_fwd_plain(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-5
        args = (want[3], want[4], c["c0"], c["dys"], c["dhT"], c["dcT"],
                c["R"])
        for g, w in zip(hr.lstm_bwd(*args), hr.lstm_bwd_plain(*args)):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
