"""Flash attention and the transformer's ops: the port (mxnet_tpu_torch)
against the reference (mxnet_tpu), on the CPU.

- The plain versions of kernels 3 and 5 (``flash_fwd_plain``) and of kernels
  6 and 7 (``flash_bwd_plain``) against the reference's Pallas kernels
  ``_flash_fwd``, ``_flash_fwd_lse`` and ``flash_attention_bwd``, run by the
  interpreter (``pallas_attention.INTERPRET``) with blocks of 32 rows at
  T = 64, so that the reference loops over several K and Q blocks: causal
  and not, D = 16 and 32.  Forward within 2e-5, backward within 1e-4 of
  the largest |value|.
- The ``MultiHeadAttention`` op (whose reference takes its Pallas path at
  T = 128 under the interpreter) and ``LayerNorm``, outputs and gradients,
  against the reference ops.
- ``expand_dims``, ``broadcast_like``, ``_arange`` and ``make_loss`` against
  the reference, within 1e-6.
- ``flash_attention`` takes kernel 5's Function only when an input needs a
  gradient, and kernel 3's path otherwise.
- The forward's host plan (``flash_fwd_plan``, kernels 3, 4 and 5): its
  tile and shared memory per head dim, its grid order (heaviest query tiles
  first under the causal mask, a permutation of (head, query tile)), and
  that each query tile, and each warp's rows in it, walk exactly the key
  tiles their rows can see, each once, at chip_smoke.py's ``ATTN_SHAPES``
  and ``RING_STATS_SHAPES`` and at T off the tiles; and that the CUDA arm
  hands the plan's tile to the entry point and counts the launch by mode
  (library, stream and counters faked).
- The fused backward's host plan (``flash_bwd_plan``): its tile per head
  dim and shared memory, its grid order (heaviest key tiles first), and its
  dQ workspace, whose rows are checked in pure Python to hold every visible
  (query row, key tile) pair exactly once, in the order the dq sum reads
  them, at chip_smoke.py's attention shapes and the ring's 4096 x 4096
  calls, under a stated byte cap.
- One ``cuda`` test: kernels 3 and 5 and the fused backward against their
  plain versions at every head dim, causal and not, Tq > Tk and Tq < Tk,
  all three bit-equal on a rerun; it skips without a card and runs on
  one.

fp32 throughout; the sums run in another order on each side.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import hopper_attention as ha
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.hopper_block import SMEM_LIMIT

FWD_TOL = 2e-5
BWD_TOL = 1e-4      # of the largest |value|
OP_TOL = 1e-6
BLOCK = 32


@pytest.fixture(autouse=True)
def _interpret_mode():
    pa.INTERPRET = True
    yield
    pa.INTERPRET = False


def _qkv(B, H, Tq, Tk, D, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    return f(B, H, Tq, D), f(B, H, Tk, D), f(B, H, Tk, D), f(B, H, Tq, D)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 32])
def test_plain_forward_matches_pallas_kernels(causal, D):
    q, k, v, _ = _qkv(2, 2, 64, 64, D, seed=D + causal)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want3 = pa._flash_fwd(jq, jk, jv, causal, scale, BLOCK, BLOCK)
    want5, want_lse = pa._flash_fwd_lse(jq, jk, jv, causal, scale, BLOCK,
                                        BLOCK)
    out, lse = ha.flash_fwd_plain(*_t(q, k, v), causal, scale)
    for g, w, name in ((out, want3, "kernel 3 out"), (out, want5,
                       "kernel 5 out"), (lse, want_lse, "lse")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_TOL, err_msg=name)


def _check_plain_backward(Tq, Tk, D, causal, seed):
    q, k, v, do = _qkv(2, 2, Tq, Tk, D, seed=seed)
    scale = 1.0 / math.sqrt(D)
    out, lse = ha.flash_fwd_plain(*_t(q, k, v), causal, scale)
    delta = (torch.from_numpy(do) * out).sum(-1)
    want = pa.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)),
                                  jnp.asarray(lse.numpy()),
                                  jnp.asarray(delta.numpy()), causal, scale,
                                  BLOCK, BLOCK)
    got = ha.flash_bwd_plain(*_t(q, k, v, do), lse, delta, causal, scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 32])
def test_plain_backward_matches_pallas_kernels(causal, D):
    _check_plain_backward(64, 64, D, causal, seed=10 + D + causal)


# ragged: T off the 32-row block (the reference's picker halves it to 16
# or 8), Tq > Tk and Tq < Tk
@pytest.mark.parametrize("Tq,Tk,D,causal", [(48, 48, 16, True),
                                            (40, 72, 32, True),
                                            (64, 32, 32, True),
                                            (32, 96, 16, False)])
def test_plain_backward_matches_pallas_kernels_ragged(Tq, Tk, D, causal):
    _check_plain_backward(Tq, Tk, D, causal, seed=Tq + Tk + D)


# (B, H, Tq, Tk, D, causal): chip_smoke.py's ATTN_SHAPES and the ring's
# per-shard calls at T 32,768 over sp 8, full and diagonal
PLAN_SHAPES = [(16, 12, 1024, 1024, 64, True), (2, 4, 128, 128, 16, True),
               (1, 3, 1000, 1000, 64, True), (2, 2, 77, 77, 32, False),
               (1, 2, 128, 384, 128, False), (1, 1, 256, 128, 64, True),
               (1, 12, 4096, 4096, 64, False), (1, 12, 4096, 4096, 64, True)]
#: the dQ workspace's cap: at most one partial a (query row, key tile), and
#: at most 512 MB at these shapes (403 MB at the ring's full call)
WS_CAP_BYTES = 512 * 2 ** 20


@pytest.mark.parametrize("D,tile", [(16, (128, 64)), (32, (128, 64)),
                                    (64, (128, 64)), (128, (64, 32))])
def test_bwd_plan_tile_per_head_dim(D, tile):
    plan = ha.flash_bwd_plan(1000, 700, D, True)
    assert (plan.bk, plan.bq) == tile
    # 16 x 16 threads: 4 keys in each of bk / 64 sub-tiles, bq / 16 queries
    # and dQ rows a thread; a key tile is whole q tiles
    assert plan.bk in (64, 128) and plan.bq % 16 == 0
    assert plan.bk % plan.bq == 0
    assert (plan.n_kt, plan.n_qt) == (-(-700 // plan.bk), -(-1000 // plan.bq))
    # K and V, a 2-stage Q/dO ring with lse and delta, P and dS; padded rows
    want = 4 * (2 * plan.bk * (D + 4) + 2 * (2 * plan.bq * (D + 4)
                                            + 2 * plan.bq)
                + 2 * plan.bq * (plan.bk + 4))
    assert plan.smem == want <= SMEM_LIMIT


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_bwd_plan_deals_heaviest_key_tiles_first(shape):
    B, H, Tq, Tk, D, causal = shape
    BH = B * H
    plan = ha.flash_bwd_plan(Tq, Tk, D, causal)
    blocks = [plan.block(b, BH) for b in range(BH * plan.n_kt)]
    assert sorted(blocks) == [(h, t) for h in range(BH)
                              for t in range(plan.n_kt)]
    work = [plan.n_qt - min(plan.first_qt[t], plan.n_qt) for _, t in blocks]
    assert all(a >= b for a, b in zip(work, work[1:]))
    if causal and Tq == Tk and plan.n_kt > 1:
        assert work[0] > work[-1]


#: the forward plan's shapes: the above (chip_smoke.py's ATTN_SHAPES and
#: RING_STATS_SHAPES are among them), then T off the tiles, Tq > Tk and
#: Tq < Tk, one row
FWD_PLAN_SHAPES = PLAN_SHAPES + [(1, 1, 129, 65, 64, True),
                                 (1, 2, 300, 77, 16, True),
                                 (1, 1, 77, 300, 128, True),
                                 (2, 1, 65, 33, 128, False),
                                 (1, 3, 1000, 1000, 32, False),
                                 (1, 1, 1, 1, 32, True)]


@pytest.mark.parametrize("D,tile", [(16, (64, 64)), (32, (64, 64)),
                                    (64, (64, 64)), (128, (64, 32))])
def test_fwd_plan_tile_per_head_dim(D, tile):
    plan = ha.flash_fwd_plan(1000, 700, D, True)
    assert (plan.bq, plan.bk) == tile
    # 4 warps of 4 x 8 lanes: 4 rows a lane and a key tile of 8 lanes' keys
    assert plan.warps == 4 and plan.bq % (plan.warps * 4) == 0
    assert plan.bk % 8 == 0
    assert (plan.n_qt, plan.n_kt) == (-(-1000 // plan.bq), -(-700 // plan.bk))
    # the Q tile, a 2-slot K/V ring and P; rows padded by 4 floats, P's by 8
    want = 4 * (plan.bq * (D + 4) + 2 * plan.bk * (D + 4)
                + plan.bq * (plan.bk + 8))
    assert plan.smem == want <= SMEM_LIMIT
    # CTAs an SM's 228 KB hold (1 KB reserved a CTA): three at D 64, the
    # main path's head dim
    per_sm = (228 * 1024) // (plan.smem + 1024)
    assert per_sm >= (2 if D == 128 else 3)


@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES, ids=str)
def test_fwd_plan_deals_heaviest_query_tiles_first(shape):
    B, H, Tq, Tk, D, causal = shape
    BH = B * H
    plan = ha.flash_fwd_plan(Tq, Tk, D, causal)
    blocks = [plan.block(b, BH) for b in range(BH * plan.n_qt)]
    assert sorted(blocks) == [(h, t) for h in range(BH)
                              for t in range(plan.n_qt)]
    work = [plan.key_tiles(t * plan.bq, plan.bq) for _, t in blocks]
    assert all(a >= b for a, b in zip(work, work[1:]))
    if causal and Tq == Tk and plan.n_qt > 1 and plan.n_kt > 1:
        assert work[0] > work[-1]


def _visible_key_tiles(vis, rows, bk):
    """Key tiles (of ``bk`` keys) holding a key that one of ``rows`` sees,
    from the dense mask ``vis`` (Tq, Tk)."""
    seen = vis[rows].any(axis=0) if len(rows) else np.zeros(vis.shape[1],
                                                            bool)
    return sorted({int(j) // bk for j in np.flatnonzero(seen)})


@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES, ids=str)
def test_fwd_plan_walks_each_visible_key_tile_once(shape):
    B, H, Tq, Tk, D, causal = shape
    plan = ha.flash_fwd_plan(Tq, Tk, D, causal)
    vis = np.ones((Tq, Tk), bool)
    if causal:
        vis = np.arange(Tq)[:, None] >= np.arange(Tk)[None, :]
    wr = plan.bq // plan.warps
    for qt in range(plan.n_qt):
        q0 = qt * plan.bq
        walk = list(range(plan.key_tiles(q0, plan.bq)))
        rows = np.arange(q0, min(q0 + plan.bq, Tq))
        assert walk == _visible_key_tiles(vis, rows, plan.bk), qt
        # each warp stops at its own rows' last tile, within the CTA's walk
        for w in range(plan.warps):
            r0 = q0 + w * wr
            own = list(range(plan.key_tiles(r0, wr)))
            assert own == _visible_key_tiles(vis, rows[(rows >= r0)
                                                       & (rows < r0 + wr)],
                                             plan.bk), (qt, w)
            assert len(own) <= len(walk)


class _FakeFwd:
    """``mxtt_flash_attn_fwd`` recording its arguments and reporting one
    launch (or the error ``rc``)."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, *args):
        self.calls.append(args[:-1])
        args[-1]._obj.value = int(self.rc == 0)
        return self.rc


@pytest.fixture
def fake_fwd(monkeypatch):
    fake = _FakeFwd()
    monkeypatch.setattr(ha, "_fns", {"mxtt_flash_attn_fwd": fake})
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    for attr in ("flash_fwd_launches", "flash_fwd_lse_launches",
                 "flash_stats_launches"):
        monkeypatch.setattr(ha, attr, 0)
    return fake


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_fwd_cuda_arm_passes_the_plan(fake_fwd, D):
    q, k, v, _ = _t(*_qkv(2, 3, 200, 77, D, seed=D))
    plan = ha.flash_fwd_plan(200, 77, D, True)
    for mode, counter, n_out in ((0, "flash_fwd_launches", 1),
                                 (1, "flash_fwd_lse_launches", 2),
                                 (2, "flash_stats_launches", 3)):
        outs = ha._fwd_cuda(q, k, v, True, 0.125, mode)
        assert len(outs) == n_out and outs[0].shape == q.shape
        args = fake_fwd.calls[-1]
        # pointers (3 in, 3 out; null where the mode writes none), BH, Tq,
        # Tk, D, scale, causal, mode, bq, bk, device, stream
        assert args[3:6].count(None) == 3 - n_out
        assert args[6:] == (6, 200, 77, D, 0.125, 1, mode, plan.bq, plan.bk,
                            None, 0)
        assert getattr(ha, counter) == 1
    fake_fwd.rc = 1
    with pytest.raises(MXNetError, match="CUDA error 1"):
        ha._fwd_cuda(q, k, v, True, 0.125, 0)
    assert ha.flash_fwd_launches == 1


def _ws_off_closed(kt, Tq, bk, causal):
    """ws_off in csrc/flash_attn_bwd.cu: sum over t < kt of rows(t)."""
    if not causal:
        return kt * Tq
    m = min(kt, -(-Tq // bk))
    return m * Tq - bk * m * (m - 1) // 2


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_bwd_plan_workspace_holds_each_visible_pair_once(shape):
    B, H, Tq, Tk, D, causal = shape
    plan = ha.flash_bwd_plan(Tq, Tk, D, causal)
    bk, bq = plan.bk, plan.bq
    assert plan.ws_off == tuple(_ws_off_closed(t, Tq, bk, causal)
                                for t in range(plan.n_kt + 1))
    # the rows each key tile writes: its q tiles' rows below Tq
    slot = np.full((Tq, plan.n_kt), -1, np.int64)
    for kt in range(plan.n_kt):
        start = plan.first_qt[kt] * bq
        rows = range(plan.ws_off[kt], plan.ws_off[kt + 1])
        assert len(rows) == max(0, Tq - start)
        slot[start:, kt] = np.arange(plan.ws_off[kt], plan.ws_off[kt + 1])
    held = slot >= 0
    assert sorted(slot[held].tolist()) == list(range(plan.ws_rows))
    # a pair is visible when some key of the tile may be seen by the row
    first_key = np.arange(plan.n_kt) * bk
    qs = np.arange(Tq)[:, None]
    visible = first_key[None, :] < Tk
    if causal:
        visible = visible & (first_key[None, :] <= qs)
    assert not (visible & ~held).any()
    # rows held without a visible key are only those of a causal key tile's
    # first q tile that lie above its keys (written as zeros)
    extra = held & ~visible
    assert (np.where(extra)[0] // bq
            == np.array(plan.first_qt)[np.where(extra)[1]]).all()
    # the dq sum's walk (dq_sum_kernel): key tiles 0..last in order, its
    # offset recurrence over rows(kt) = Tq - lo(kt)
    for q in range(0, Tq, max(1, Tq // 97)):
        last = min(plan.n_kt - 1, q // bk) if causal else plan.n_kt - 1
        off, read = 0, []
        for kt in range(last + 1):
            lo = kt * bk if causal else 0
            read.append(off + q - lo)
            off += Tq - lo
        assert read == slot[q, :last + 1].tolist()
        assert (slot[q, last + 1:] < 0).all() or not causal


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_bwd_workspace_bytes_under_cap(shape):
    B, H, Tq, Tk, D, causal = shape
    plan = ha.flash_bwd_plan(Tq, Tk, D, causal)
    dq_bytes = 4 * B * H * Tq * D
    ws_bytes = 4 * B * H * plan.ws_rows * D     # the wrapper's torch.empty
    assert ws_bytes <= plan.n_kt * dq_bytes
    assert ws_bytes <= WS_CAP_BYTES
    if causal and Tq == Tk and plan.n_kt > 1:
        # the causal mask skips the rows above each key tile
        assert ws_bytes < 0.6 * plan.n_kt * dq_bytes


def test_flash_attention_takes_kernel_5_only_for_gradients():
    q, k, v, do = _t(*_qkv(1, 2, 16, 16, 16, seed=3))
    assert ha.flash_attention(q, k, v, True).grad_fn is None
    qg = q.clone().requires_grad_()
    out = ha.flash_attention(qg, k, v, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    with torch.no_grad():
        assert ha.flash_attention(qg, k, v, True).grad_fn is None
    # the Function's gradient is the dense softmax's
    (dq,) = torch.autograd.grad(out, qg, do)
    ref = qg.detach().clone().requires_grad_()
    s = (ref @ k.transpose(-1, -2)) / 4.0
    s = s.masked_fill(torch.ones(16, 16).triu(1).bool(), -math.inf)
    (want,) = torch.autograd.grad(torch.softmax(s, -1) @ v, ref, do)
    np.testing.assert_allclose(dq.numpy(), want.numpy(), rtol=0,
                               atol=BWD_TOL * want.abs().max().item())


def _reference_vjp(name, kw, inputs, cotangent):
    jop = jreg.get_op(name)
    attrs = jop.parse_attrs(dict(kw))

    @jax.jit
    def run(args, ct):
        out, vjp = jax.vjp(lambda *a: jop.fn(attrs, *a), *args)
        return out, vjp(ct)

    return run(tuple(map(jnp.asarray, inputs)), cotangent)


def _port_vjp(name, kw, inputs, cotangent):
    top = treg.get_op(name)
    ins = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = top.fn(top.parse_attrs(dict(kw)), *ins)
    grads = torch.autograd.grad(out, ins, cotangent)
    return out, grads


def test_multi_head_attention_matches_reference():
    B, T, Dm, H = 2, 128, 32, 2
    assert pa.flash_attention_available(B, H, T, T, Dm // H, jnp.float32)
    r = np.random.default_rng(5)
    data = r.standard_normal((B, T, Dm)).astype(np.float32)
    ws = [(r.standard_normal((Dm, Dm)) * Dm ** -0.5).astype(np.float32)
          for _ in range(4)]
    ct = r.standard_normal((B, T, Dm)).astype(np.float32)
    kw = {"num_heads": H, "causal": True}
    jout, jgrads = _reference_vjp("MultiHeadAttention", kw, [data] + ws,
                                  jnp.asarray(ct))
    tout, tgrads = _port_vjp("MultiHeadAttention", kw, [data] + ws,
                             torch.from_numpy(ct))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=FWD_TOL)
    for g, w, name in zip(tgrads, jgrads, ("data", "query", "key", "value",
                                           "out_proj")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_reference(axis):
    r = np.random.default_rng(6)
    x = (r.standard_normal((2, 5, 8)) * 3 + 1).astype(np.float32)
    c = x.shape[axis]
    gamma = r.standard_normal(c).astype(np.float32)
    beta = r.standard_normal(c).astype(np.float32)
    kw = {"axis": axis, "output_mean_var": True}
    cts = tuple(r.standard_normal(s).astype(np.float32) for s in
                (x.shape, x.shape[:axis % 3] + x.shape[axis % 3 + 1:]))
    jop, top = jreg.get_op("LayerNorm"), treg.get_op("LayerNorm")
    jouts = jop.fn(jop.parse_attrs(dict(kw)), *map(jnp.asarray,
                                                   (x, gamma, beta)))
    touts = top.fn(top.parse_attrs(dict(kw)), *_t(x, gamma, beta))
    for g, w, name in zip(touts, jouts, ("out", "mean", "var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5, err_msg=name)
    # gradients of the visible output
    _, jgrads = _reference_vjp("LayerNorm", {"axis": axis}, [x, gamma, beta],
                               (jnp.asarray(cts[0]), jnp.zeros(cts[1].shape),
                                jnp.zeros(cts[1].shape)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    out = top.fn(top.parse_attrs({"axis": axis}), *ins)[0]
    tgrads = torch.autograd.grad(out, ins, torch.from_numpy(cts[0]))
    for g, w, name in zip(tgrads, jgrads, ("data", "gamma", "beta")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


def _small_ops_cases():
    r = np.random.default_rng(12)
    x = r.standard_normal((3, 4)).astype(np.float32)
    like = np.zeros((2, 3, 4), np.float32)
    return [
        ("expand_dims", {"axis": 0}, [x]),
        ("expand_dims", {"axis": -1}, [x]),
        ("broadcast_like", {}, [x[None, :1], like]),
        ("make_loss", {}, [x]),
        ("_arange", {"start": 0, "stop": 16}, []),
        ("_arange", {"start": 5}, []),
        ("_arange", {"start": 1.5, "stop": 4.0, "step": 0.5, "repeat": 2}, []),
    ]


@pytest.mark.parametrize("name,kw,inputs", _small_ops_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_small_ops_match_reference(name, kw, inputs):
    jop, top = jreg.get_op(name), treg.get_op(name)
    want = jop.fn(jop.parse_attrs(dict(kw)), *map(jnp.asarray, inputs))
    got = top.fn(top.parse_attrs(dict(kw)), *_t(*inputs))
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OP_TOL)


@pytest.mark.cuda
def test_attention_kernels_match_plain_on_the_card():
    """Kernels 3 and 5 and the fused backward against their plain versions
    at every head dim, causal and not, Tq > Tk and Tq < Tk, T off the tiles:
    1e-5 forward, 1e-4 of the largest |value| backward, as chip_smoke.py
    holds them; all three bit-equal on a rerun (no atomics; the backward's
    dq is summed in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same check "
                    "on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    for D in ha.SUPPORTED_D:
        for causal in (False, True):
            for Tq, Tk in ((200, 77), (77, 300)):
                q, k, v, _ = (torch.from_numpy(a).cuda() for a in
                              _qkv(2, 3, Tq, Tk, D, seed=Tq + D))
                do = torch.from_numpy(_qkv(2, 3, Tq, Tq, D, seed=D)[3]).cuda()
                sc = 1.0 / math.sqrt(D)
                want, lse = ha.flash_fwd_plain(q, k, v, causal, sc)
                got5, got_lse = ha.flash_fwd_lse(q, k, v, causal, sc)
                got3 = ha.flash_fwd(q, k, v, causal, sc)
                for g in (got3, got5):
                    assert (g - want).abs().max().item() <= 1e-5
                assert (got_lse - lse).abs().max().item() <= 1e-5
                again5 = ha.flash_fwd_lse(q, k, v, causal, sc)
                assert torch.equal(ha.flash_fwd(q, k, v, causal, sc), got3)
                assert torch.equal(again5[0], got5), (D, causal, Tq, Tk)
                assert torch.equal(again5[1], got_lse), (D, causal, Tq, Tk)
                delta = (do * want).sum(-1)
                args = (q, k, v, do, lse, delta, causal, sc)
                got = ha.flash_bwd(*args)
                again = ha.flash_bwd(*args)
                for g, w, g2 in zip(got, ha.flash_bwd_plain(*args), again):
                    assert (g - w).abs().max().item() \
                        <= 1e-4 * w.abs().max().item(), (D, causal, Tq, Tk)
                    assert torch.equal(g, g2), (D, causal, Tq, Tk)
