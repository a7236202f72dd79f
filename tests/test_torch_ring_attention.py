"""Ring and blockwise attention and kernel 4: the port
(``mxnet_tpu_torch.parallel.ring_attention``, ``ops.hopper_attention``)
against the reference (``mxnet_tpu``), on the CPU, on meshes whose entries
repeat the CPU device (the reference runs on 8 virtual CPU devices).

- Kernel 4's plain version (``flash_stats_plain``) against the reference's
  ``flash_attention_stats`` run by the Pallas interpreter, with 32-row
  blocks so that it loops, causal and not, Tq other than Tk: m within 1e-5,
  acc and l within 1e-5 of their largest |value| (they are unnormalised
  sums that grow with Tk: at l = 46 one fp32 ulp is 3.8e-6).
- ``blockwise_attention``: the scan arm and the flash arm (the port's
  ``flash_attention``, which CUDA tensors take) against the reference's, at
  ``tests/test_parallel.py``'s cases (rtol 1e-4, atol 1e-5).
- ``ring_attention`` forward at B 1, H 2, T 512, D 16, sp 4 (T/sp = 128 is
  the smallest shard the reference's gate lets onto its flash ring under
  the interpreter; at T 256 it would take its scan arm): the flash arm
  (kernel 4's plain version per step) against the reference's interpreted
  flash ring within 2e-5, both arms against a dense softmax (rtol 1e-4,
  atol 1e-5).
- Ring gradients of ``sum(out²)``, both arms, against ``jax.grad`` of the
  reference's scan ring at sp 4 and 8 (rtol = atol = 1e-5, as
  ``tests/test_pallas_attention.py``'s ring gradient test); at sp 8 a dk/dv
  accumulator that came home rotated would be off by a whole shard.
- The flash arm's calls of kernels 4, 6 and 7: n(n+1)/2 each causal, n²
  not, and never kernel 5.
- One ``cuda`` test: kernel 4 against its plain version and the flash ring
  against one un-sharded flash attention on the card; it skips without one.

The reference runs under ``jax.jit``, several cases in one program where
they share a mesh: eagerly, its ``shard_map`` programs take ten times as
long on a CPU.  Ulysses and long-context attention are in
``test_torch_compositions.py``.
"""
import math
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel import ring_attention as rra
from mxnet_tpu_torch.models import long_context_attention
from mxnet_tpu_torch.ops import hopper_attention as ha
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel import ring_attention as tra
from mxnet_tpu_torch.parallel.mesh import shard, unshard

STATS_TOL = 1e-5
FWD_TOL = 2e-5
GRAD_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture
def interpret():
    pa.INTERPRET = True
    yield
    pa.INTERPRET = False


def _arrays(shape, seed, n=3, scale=0.5):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _dense(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        mask = np.arange(s.shape[-2])[:, None] >= np.arange(s.shape[-1])
        s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def _meshes(sp):
    return (make_mesh({"sp": sp}, devices=[CPU] * sp),
            ref_make_mesh({"sp": sp}, devices=jax.devices()[:sp]))


def _flash_ring(q, k, v, mesh, causal):
    """The flash arm on the CPU: what CUDA shards take, with kernel 4's and
    kernels 6/7's plain versions."""
    qs, ks, vs = (shard(t, mesh, "sp", 2) for t in (q, k, v))
    return unshard(tra._ring_flash(qs, ks, vs, causal,
                                   1.0 / math.sqrt(q.shape[-1])), 2)


@pytest.mark.parametrize("causal,Tq,Tk", [(False, 32, 128), (True, 128, 64)])
def test_flash_stats_plain_matches_pallas_kernel(interpret, causal, Tq, Tk):
    q, = _arrays((1, 2, Tq, 16), seed=Tq + causal, n=1)
    k, v = _arrays((1, 2, Tk, 16), seed=Tk, n=2)
    sc = 0.25
    want = jax.jit(partial(pa.flash_attention_stats, causal=causal,
                           scale=sc, block_q=32, block_k=32))(q, k, v)
    got = ha.flash_attention_stats(*map(torch.from_numpy, (q, k, v)),
                                   causal, sc)
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        scale = 1.0 if name == "m" else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=STATS_TOL * scale, err_msg=name)
    # lse_of: +inf where a row saw nothing, log-sum-exp elsewhere
    lse = ha.lse_of(torch.tensor([0.5, -math.inf]), torch.tensor([2.0, 0.0]))
    assert lse[0].item() == pytest.approx(0.5 + math.log(2.0))
    assert lse[1].item() == math.inf


BLOCKWISE_CASES = [(False, 8), (True, 8), (False, 5)]   # 32 % 5 != 0


@lru_cache(maxsize=None)
def _ref_blockwise():
    """The reference's outputs for every case, from one compiled program."""
    q, k, v = _arrays((2, 4, 32, 8), seed=0, scale=1.0)
    outs = jax.jit(lambda q, k, v: [
        rra.blockwise_attention(q, k, v, block_size=block, causal=causal)
        for causal, block in BLOCKWISE_CASES])(q, k, v)
    return dict(zip(BLOCKWISE_CASES, map(np.asarray, outs)))


@pytest.mark.parametrize("arm", ["scan", "flash"])
@pytest.mark.parametrize("causal,block", BLOCKWISE_CASES)
def test_blockwise_attention_matches_reference(arm, causal, block):
    q, k, v = _arrays((2, 4, 32, 8), seed=0, scale=1.0)
    want = _ref_blockwise()[(causal, block)]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    if arm == "scan":
        got = tra.blockwise_attention(tq, tk, tv, block_size=block,
                                      causal=causal, use_pallas=False)
        # CPU tensors take the scan arm with use_pallas too
        default = tra.blockwise_attention(tq, tk, tv, block_size=block,
                                          causal=causal)
        assert torch.equal(default, got)
    else:
        got = ha.flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v, causal),
                               rtol=1e-4, atol=1e-5)


@lru_cache(maxsize=None)
def _ref_flash_ring():
    """The reference's interpreted flash ring, not causal and causal, from
    one compiled program; and whether it traced its stats kernel."""
    q, k, v = _arrays((1, 2, 512, 16), seed=0)
    ref_mesh = ref_make_mesh({"sp": 4}, devices=jax.devices()[:4])
    traced = []
    stats = pa.flash_attention_stats
    pa.flash_attention_stats = \
        lambda *a, **kw: traced.append(1) or stats(*a, **kw)
    pa.INTERPRET = True
    try:
        outs = jax.jit(lambda q, k, v: [
            rra.ring_attention(q, k, v, ref_mesh, axis="sp", causal=causal,
                               block_size=128)
            for causal in (False, True)])(q, k, v)
    finally:
        pa.flash_attention_stats = stats
        pa.INTERPRET = False
    return [np.asarray(o) for o in outs], bool(traced)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_forward_matches_interpreted_flash_ring(causal):
    q, k, v = _arrays((1, 2, 512, 16), seed=0)
    mesh, _ = _meshes(4)
    outs, traced = _ref_flash_ring()
    assert traced, "the reference took its scan arm, not its flash ring"
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    flash = _flash_ring(tq, tk, tv, mesh, causal)
    scan = tra.ring_attention(tq, tk, tv, mesh, causal=causal,
                              block_size=128)
    np.testing.assert_allclose(flash.numpy(), outs[causal], rtol=0,
                               atol=FWD_TOL)
    dense = _dense(q, k, v, causal)
    for got in (flash, scan):
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sp,causal", [(4, False), (8, True)])
def test_ring_gradients_match_reference_scan_ring(sp, causal):
    q, k, v = _arrays((1, 1, 512, 8), seed=1)
    mesh, ref_mesh = _meshes(sp)

    def ref_loss(q, k, v):
        return jnp.sum(rra.ring_attention(
            q, k, v, ref_mesh, axis="sp", causal=causal, block_size=128,
            use_pallas=False) ** 2)

    want = jax.jit(jax.grad(ref_loss, (0, 1, 2)))(q, k, v)
    for arm in ("flash", "scan"):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        out = (_flash_ring(tq, tk, tv, mesh, causal) if arm == "flash" else
               tra.ring_attention(tq, tk, tv, mesh, causal=causal,
                                  use_pallas=False))
        got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg="%s arm, d%s" % (arm, name))


@pytest.mark.parametrize("sp,causal", [(4, True), (4, False), (8, True)])
def test_flash_ring_kernel_calls(monkeypatch, sp, causal):
    """Kernel 4 forward and kernels 6/7 backward once a visible (step,
    shard) pair; the skipped pairs and kernel 5 never."""
    calls = {"stats": 0, "bwd": 0, "fwd_lse": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for name, attr in (("stats", "flash_attention_stats"),
                       ("bwd", "flash_bwd"), ("fwd_lse", "flash_fwd_lse")):
        monkeypatch.setattr(ha, attr, counted(name, getattr(ha, attr)))
    mesh, _ = _meshes(sp)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays((1, 2, 16 * sp, 16), seed=2))
    _flash_ring(q, k, v, mesh, causal).sum().backward()
    want = sp * (sp + 1) // 2 if causal else sp * sp
    assert calls == {"stats": want, "bwd": want, "fwd_lse": 0}


@pytest.mark.cuda
def test_kernel4_and_flash_ring_on_the_card():
    """Kernel 4 against its plain version at ragged shapes (acc and l within
    1e-5 of their largest |value|, m within 1e-5), and the causal flash ring
    at sp 4 against one un-sharded flash attention, forward and gradients,
    with n(n+1)/2 launches of kernel 4, as chip_smoke.py holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same check "
                    "on the H100")
    dev = torch.device("cuda", 0)
    for (Tq, Tk, D, causal) in [(77, 77, 32, True), (128, 384, 64, False),
                                (256, 128, 128, True)]:
        q, = (torch.from_numpy(a).to(dev)
              for a in _arrays((1, 2, Tq, D), seed=Tq, n=1))
        k, v = (torch.from_numpy(a).to(dev)
                for a in _arrays((1, 2, Tk, D), seed=Tk, n=2))
        got = ha.flash_attention_stats(q, k, v, causal, 0.125)
        want = ha.flash_stats_plain(q, k, v, causal, 0.125)
        for g, w, rel in zip(got, want, (True, False, True)):
            scale = w.abs().max().item() if rel else 1.0
            assert (g - w).abs().max().item() <= STATS_TOL * scale
    mesh = make_mesh({"sp": 4}, devices=[dev] * 4)
    q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
               for a in _arrays((1, 2, 1024, 64), seed=5))
    before = ha.flash_stats_launches
    out = long_context_attention(q, k, v, mesh)
    assert ha.flash_stats_launches - before == 10
    ref = ha.flash_attention(q, k, v, True)
    assert (out - ref).abs().max().item() <= FWD_TOL
    g = torch.autograd.grad(out.sum(), (q, k, v))
    w = torch.autograd.grad(ref.sum(), (q, k, v))
    for a, b in zip(g, w):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
