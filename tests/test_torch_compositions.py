"""The transformer's parallel compositions in the port
(``mxnet_tpu_torch.models``: ``long_context_attention``,
``pipeline_transformer``; ``parallel.ring_attention.ulysses_attention``,
``parallel.pipeline``) against the reference's, on the CPU, on meshes whose
entries repeat the CPU device (the reference's use the 8 virtual CPU
devices).

- ``ulysses_attention`` forward and gradients (rtol 1e-4, atol 1e-5), and
  its error when the heads do not split.
- ``long_context_attention`` at sp 8 against the reference's
  (``tests/test_transformer.py``'s case, 2e-5).
- ``pipeline_apply`` / ``pipeline_transformer`` against the reference's and
  against the same blocks applied in sequence, at the ``tiny`` width
  (rtol 1e-4, atol 1e-5); the bubble's ticks run no stage.

The reference runs under ``jax.jit``.  fp32 throughout.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.models import get_config as ref_get_config
from mxnet_tpu.models import transformer as rtfm
from mxnet_tpu.parallel import make_mesh as ref_make_mesh
from mxnet_tpu.parallel import pipeline as rpipe
from mxnet_tpu.parallel import ring_attention as rra
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import (block_apply, get_config,
                                    long_context_attention,
                                    pipeline_transformer)
from mxnet_tpu_torch.parallel import make_mesh, pipeline
from mxnet_tpu_torch.parallel import ring_attention as tra

CPU = torch.device("cpu")


def _meshes(axis, n):
    return (make_mesh({axis: n}, devices=[CPU] * n),
            ref_make_mesh({axis: n}, devices=jax.devices()[:n]))


def _arrays(shape, seed, n=3, scale=0.5):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_ulysses_attention_matches_reference():
    q, k, v = _arrays((2, 4, 32, 8), seed=3, scale=1.0)
    mesh, ref_mesh = _meshes("sp", 4)

    def ref_fn(q, k, v):
        return rra.ulysses_attention(q, k, v, ref_mesh, axis="sp",
                                     causal=True)

    def ref_out_and_grads(q, k, v):
        out, vjp = jax.vjp(ref_fn, q, k, v)
        return out, vjp(2 * out)          # the gradients of sum(out ** 2)

    want, want_g = jax.jit(ref_out_and_grads)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tra.ulysses_attention(tq, tk, tv, mesh, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    got_g = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for g, w, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="heads do not split"):
        tra.ulysses_attention(tq[:, :3], tk[:, :3], tv[:, :3], mesh)


def test_long_context_attention_matches_reference_8_way():
    q, k, v = _arrays((1, 2, 1024, 16), seed=4)
    mesh, ref_mesh = _meshes("sp", 8)
    want = jax.jit(partial(rtfm.long_context_attention, mesh=ref_mesh,
                           axis="sp", causal=True, block_size=128))(q, k, v)
    got = long_context_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                                 axis="sp", causal=True, block_size=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_pipeline_apply_matches_reference():
    rng = np.random.RandomState(2)
    stage_w = rng.randn(4, 6, 6).astype(np.float32) * 0.5
    x = rng.randn(8, 6).astype(np.float32)
    mesh, ref_mesh = _meshes("pp", 4)
    calls = []

    def stage_fn(params, xb):
        calls.append(1)
        return torch.tanh(xb @ params["w"])

    got = pipeline.pipeline_apply(mesh, "pp", stage_fn,
                                  {"w": torch.from_numpy(stage_w)},
                                  torch.from_numpy(x), n_micro=4)
    want = jax.jit(lambda p, x: rpipe.pipeline_apply(
        ref_mesh, "pp", lambda q, xb: jnp.tanh(xb @ q["w"]), p, x,
        n_micro=4))({"w": stage_w}, x)
    _close(got, want)
    assert len(calls) == 4 * 4          # the bubble's ticks compute nothing
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(mesh, "pp", stage_fn,
                                {"w": torch.from_numpy(stage_w)},
                                torch.from_numpy(x), n_micro=3)


def test_pipeline_transformer_matches_reference_and_sequential():
    cfg = get_config("tiny", seq_len=16)
    rng = np.random.RandomState(8)
    per_stage = [rtfm.init_block_params(ref_get_config("tiny", seq_len=16),
                                        rng) for _ in range(4)]
    stacked = {k: np.stack([np.asarray(p[k]) for p in per_stage])
               for k in per_stage[0]}
    x = (rng.randn(8, cfg.seq_len, cfg.d_model) * 0.5).astype(np.float32)
    mesh, ref_mesh = _meshes("pp", 4)
    params = weights.from_jax_stage_params(stacked, mx.cpu())
    got = pipeline_transformer(mesh, "pp", cfg, params, torch.from_numpy(x),
                               n_micro=4)
    want = jax.jit(lambda p, x: rtfm.pipeline_transformer(
        ref_mesh, "pp", ref_get_config("tiny", seq_len=16), p, x,
        n_micro=4))(stacked, x)
    _close(got, want)
    seq = torch.from_numpy(x)
    for s in range(4):
        seq = block_apply(cfg, {k: v[s] for k, v in params.items()}, seq)
    _close(got, seq.numpy())
