"""The port's parallel layer (``mxnet_tpu_torch.parallel``) against the
reference's (``mxnet_tpu.parallel``), on the CPU.  The port's meshes repeat
the CPU device; the reference's use the 8 virtual CPU devices.

- ``make_mesh``: the -1 remainder rule, the "does not fit" error, the
  devices along an axis, and no default mesh without a card.
- ``ShardingRules`` / ``megatron_rules`` on the transformer's parameter
  names (first match wins, ``_fits`` divisibility) give the reference's
  specs.
- The collectives (``shard``, ``unshard``, ``ppermute``, ``all_to_all``,
  ``psum``) and their gradients; ``all_to_all`` against the reference's
  ``jax.lax.all_to_all(tiled=True)``.
- ``platform_dependent`` on CPU and ``meta`` tensors, kernel 10's plain
  version.
- The tensor-parallel helpers against the reference's at
  ``tests/test_parallel.py``'s cases and tolerances.
- ``moe_ffn`` / ``moe_transformer_ffn`` with and without an ``ep`` mesh
  against the reference's, at the reference test's capacity factor (8.0,
  nothing dropped) and at 1.25, where tokens drop and the per-shard
  capacity makes the mesh and no-mesh results differ (rtol 1e-4, atol
  1e-5).

The reference runs under ``jax.jit``.  fp32 throughout.
"""
import math
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP
from mxnet_tpu.models import transformer as rtfm
from mxnet_tpu.parallel import _compat as rcompat
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel import mesh as rmesh
from mxnet_tpu.parallel import moe as rmoe
from mxnet_tpu.parallel import tensor_parallel as rtp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import get_config, moe_transformer_ffn
from mxnet_tpu_torch.parallel import _compat, make_mesh, moe
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import tensor_parallel as tp

CPU = torch.device("cpu")
META = torch.device("meta")


def _meshes(axis, n):
    return (make_mesh({axis: n}, devices=[CPU] * n),
            ref_make_mesh({axis: n}, devices=jax.devices()[:n]))


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_make_mesh_rules_and_errors(monkeypatch):
    mesh = make_mesh({"dp": -1, "tp": 2}, devices=[CPU] * 8)
    assert dict(mesh.shape) == dict(ref_make_mesh({"dp": -1, "tp": 2}).shape)
    assert mesh.devices.size == 8 and mesh.axis_names == ("dp", "tp")
    for m in (make_mesh, ref_make_mesh):
        with pytest.raises(ValueError, match="does not fit 8 devices"):
            m({"dp": 3}, devices=([CPU] * 8 if m is make_mesh
                                  else jax.devices()))
    grid = make_mesh({"a": 2, "b": 2}, devices=[CPU, META, CPU, META])
    assert grid.axis_devices("a") == [CPU, CPU]
    assert grid.axis_devices("b") == [CPU, META]
    assert make_mesh({"x": 2}, devices=[mx.cpu(), "cpu"]).axis_devices(
        "x") == [CPU, CPU]
    assert tmesh.host_shard_hint(mesh) == (0, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        make_mesh({"sp": 1})


def test_sharding_rules_match_reference():
    mesh = make_mesh({"dp": -1, "tp": 2}, devices=[CPU] * 8)
    ref_mesh = ref_make_mesh({"dp": -1, "tp": 2})
    cfg = get_config("tiny", seq_len=16)
    d, f = cfg.d_model, cfg.d_ff
    cases = [("tfm_l0_attn_query_weight", (d, d)),
             ("tfm_l0_attn_out_proj_weight", (d, d)),
             ("tfm_l0_ffn_fc1_weight", (f, d)),
             ("tfm_l0_ffn_down_weight", (d, f)),
             ("tfm_tok_embedding_weight", (cfg.vocab_size, d)),
             ("tfm_l0_ln1_gamma", (d,)), ("conv0_weight", (64, 3, 7, 7)),
             ("conv1_weight", (3, 3, 7, 7)),          # 3 % 2: the default
             ("fc2_weight", (7, 5))]                  # odd: the default
    rules, ref_rules = tmesh.megatron_rules(mesh), rmesh.megatron_rules(
        ref_mesh)
    for name, shape in cases:
        got = rules.spec_for(name, shape)
        assert tuple(got) == tuple(ref_rules.spec_for(name, shape)), name
    assert rules.spec_for("tfm_l0_attn_out_proj_weight", (d, d)) \
        == tmesh.P(None, "tp")
    # first match wins, and a rule over several axes divides by their product
    custom = tmesh.ShardingRules(mesh, rules=[
        (r"w$", tmesh.P(("dp", "tp"))), (r"w$", tmesh.P("tp"))])
    ref_custom = rmesh.ShardingRules(ref_mesh, rules=[
        (r"w$", JP(("dp", "tp"))), (r"w$", JP("tp"))])
    for shape in ((16,), (6,), (3,)):
        assert tuple(custom.spec_for("w", shape)) == tuple(
            ref_custom.spec_for("w", shape))
    assert custom.sharding_for("w", (6,)).spec == tmesh.P("tp")
    assert tmesh.data_parallel_sharding(mesh).spec == tmesh.P("dp")
    assert tmesh.replicated_sharding(mesh).spec == tmesh.P()


def test_collectives_and_their_gradients():
    mesh, ref_mesh = _meshes("sp", 4)
    x = torch.randn(2, 8, 4, requires_grad=True)
    parts = tmesh.shard(x, mesh, "sp", 1)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 4)] * 4
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(tmesh.unshard(parts, 1), x)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard(x, mesh, "sp", 0)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    shifted = tmesh.ppermute(parts, ring)
    assert all(torch.equal(shifted[(i + 1) % 4], parts[i]) for i in range(4))
    one = tmesh.ppermute(parts, [(0, 2)])
    assert torch.equal(one[2], parts[0])
    assert not any(p.any() for i, p in enumerate(one) if i != 2)
    summed = tmesh.psum(parts)
    assert all(torch.equal(s, parts[0] + parts[1] + parts[2] + parts[3])
               for s in summed)
    a2a = tmesh.all_to_all(parts, 2, 0)
    assert [tuple(t.shape) for t in a2a] == [(8, 2, 1)] * 4
    # all_to_all against the reference's tiled all_to_all
    y = np.random.default_rng(0).standard_normal((4, 8, 8)).astype(
        np.float32)
    ref = jax.jit(rcompat.shard_map(
        lambda t: jax.lax.all_to_all(t, "sp", split_axis=2, concat_axis=0,
                                     tiled=True),
        mesh=ref_mesh, in_specs=(JP(None, "sp"),), out_specs=JP(None, "sp")))
    got = tmesh.unshard(tmesh.all_to_all(
        tmesh.shard(torch.from_numpy(y), mesh, "sp", 1), 2, 0), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(y)))
    # gradients: the cotangents travel back the way the values came
    for outs, back in (
            (shifted, lambda w: tmesh.ppermute(w, [(d, s) for s, d in ring])),
            (summed, lambda w: tmesh.psum(w)),
            (a2a, lambda w: tmesh.all_to_all(w, 0, 2))):
        w = [torch.randn(t.shape) for t in outs]
        g, = torch.autograd.grad(sum((t * c).sum() for t, c in
                                     zip(outs, w)), x, retain_graph=True)
        assert torch.allclose(g, tmesh.unshard(back(w), 1), atol=1e-6)


def test_platform_dependent_and_kernel10_plain():
    calls = []

    def branch(name):
        return lambda *a: calls.append(name) or name

    t = torch.zeros(2)
    pd = _compat.platform_dependent
    assert pd(t, cpu=branch("cpu"), gpu=branch("gpu")) == "cpu"
    assert pd([t.to(META)], gpu=branch("gpu"),
              default=branch("default")) == "default"
    assert pd(t.to(META), cpu=branch("cpu"), gpu=branch("gpu")) == "cpu"
    assert "gpu" not in calls
    with pytest.raises(ValueError, match="no branch for backend 'cpu' and "
                                         "no default"):
        pd(t, gpu=branch("gpu"))
    before = _compat.zero_fill_launches
    buf = torch.full((8, 128), math.nan)
    assert _compat.zero_fill(buf) is buf and not buf.any()
    assert _compat.zero_fill_launches == before    # the plain version
    assert _compat.zero_fill(torch.empty(3, device=META)).device == META


def test_tensor_parallel_matches_reference():
    rng = np.random.RandomState(0)
    mesh, ref_mesh = _meshes("tp", 4)
    x, w1, w2 = (rng.randn(*s).astype(np.float32)
                 for s in ((8, 16), (16, 32), (32, 16)))
    tx, tw1, tw2 = map(torch.from_numpy, (x, w1, w2))
    col = tp.column_parallel_dense(tx, tw1, mesh)
    _close(col, jax.jit(partial(rtp.column_parallel_dense, mesh=ref_mesh))(
        x, w1), 1e-4, 1e-4)
    row = tp.row_parallel_dense(col, tw2, mesh)
    _close(row, x @ w1 @ w2, 1e-3, 1e-3)
    _close(row, jax.jit(partial(rtp.row_parallel_dense, mesh=ref_mesh))(
        np.asarray(col.detach()), w2), 1e-4, 1e-4)
    rng = np.random.RandomState(1)
    x, w1, w2 = (rng.randn(*s).astype(np.float32)
                 for s in ((4, 8), (8, 16), (16, 8)))
    out = tp.mlp_block(*map(torch.from_numpy, (x, w1, w2)), mesh)
    _close(out, np.maximum(x @ w1, 0) @ w2, 1e-3, 1e-3)
    _close(out, jax.jit(partial(rtp.mlp_block, mesh=ref_mesh))(x, w1, w2),
           1e-4, 1e-4)


def _moe_case():
    rng = np.random.RandomState(6)
    params = rmoe.init_moe_params(rng, d_model=16, d_hidden=32,
                                  num_experts=8)
    x = rng.randn(2, 16, 16).astype(np.float32)
    return params, x


@pytest.mark.parametrize("ep,cf", [(None, 8.0), (4, 8.0), (None, 1.25),
                                   (4, 1.25)])
def test_moe_transformer_ffn_matches_reference(ep, cf):
    ref_params, x = _moe_case()
    params = weights.from_jax_moe_params(ref_params, mx.cpu())
    mesh, ref_mesh = _meshes("ep", ep) if ep else (None, None)
    want = jax.jit(partial(rtfm.moe_transformer_ffn, moe_params=ref_params,
                           mesh=ref_mesh, axis="ep", k=2,
                           capacity_factor=cf))(x)
    got = moe_transformer_ffn(torch.from_numpy(x), params, mesh=mesh,
                              axis="ep", k=2, capacity_factor=cf)
    assert got.shape == x.shape
    _close(got, want)


def test_moe_ffn_drops_tokens_per_shard_as_the_reference():
    """At capacity factor 1.25 each of the 4 shards gates its 8 tokens into
    3 slots an expert, where the un-sharded layer has 10: tokens drop, and
    the two results differ in the port as in the reference."""
    ref_params, x = _moe_case()
    x = x.reshape(-1, 16)
    params = weights.from_jax_moe_params(ref_params, mx.cpu())
    mesh, ref_mesh = _meshes("ep", 4)
    tx = torch.from_numpy(x)
    got = {m is not None: moe.moe_ffn(tx, params, mesh=m, capacity_factor=1.25)
           for m in (None, mesh)}
    for sharded, m in ((False, None), (True, ref_mesh)):
        _close(got[sharded], jax.jit(partial(
            rmoe.moe_ffn, params=ref_params, mesh=m,
            capacity_factor=1.25))(x))
    assert (got[True] - got[False]).abs().max() > 1e-3
    logits = tx[:8] @ params.wg
    weights_, ids = moe.top_k_gating(logits, 2)
    dispatch, _ = moe._dispatch_mask(ids, weights_, 8, 3)
    assert dispatch.sum() < 8 * 2           # this shard drops tokens
    ref_w, ref_ids = rmoe.top_k_gating(jnp.asarray(logits.numpy()), 2)
    _close(weights_, ref_w, 1e-6, 1e-6)
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    _close(moe.load_balancing_loss(logits, ids, 8),
           rmoe.load_balancing_loss(jnp.asarray(logits.numpy()), ref_ids, 8),
           1e-6, 1e-6)


@pytest.mark.cuda
def test_probe_and_compositions_on_the_card():
    """Kernel 10 leaves zeros over NaN; ``platform_dependent`` runs it at
    most once a process on the card before its first ``gpu`` branch; the
    TP block on a mesh of one card's entries matches the un-sharded one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same checks "
                    "on the H100")
    dev = torch.device("cuda", 0)
    buf = torch.full((8, 128), math.nan, device=dev)
    before = _compat.zero_fill_launches
    _compat.zero_fill(buf)
    assert _compat.zero_fill_launches == before + 1 and not buf.any()
    t = torch.zeros(2, device=dev)
    for _ in range(2):
        assert _compat.platform_dependent(t, gpu=lambda a: "gpu",
                                          default=lambda a: "cpu") == "gpu"
    assert _compat.zero_fill_launches - before <= 2
    mesh = make_mesh({"tp": 4}, devices=[dev] * 4)
    x, w1, w2 = (torch.randn(*s, device=dev)
                 for s in ((64, 32), (32, 128), (128, 32)))
    want = torch.relu(x @ w1) @ w2
    got = tp.mlp_block(x, w1, w2, mesh)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
