"""Ring, Ulysses and blockwise attention: exact attention with the sequence
sharded over a mesh axis (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

- :func:`blockwise_attention`: one device's attention.  For CUDA tensors
  with ``use_pallas`` it is the port's ``flash_attention`` (kernels 3 and 5
  forward, 6 and 7 backward); otherwise the reference's scan over K/V
  blocks with the online-softmax update (:func:`_attn_block`), as a loop.
- :func:`ring_attention`: q, k and v ``[B, H, T, D]`` are split along T over
  ``mesh[axis]``; each shard keeps its Q block while the K/V blocks go round
  the ring by ``ppermute``, and the output comes back whole on q's device,
  as the reference returns a global array.  At step ``s`` shard ``idx``
  holds the K/V of shard ``src = (idx - s) % n``.  Two arms:

  * the scan arm (``use_pallas=False``, or tensors not on the card): the
    reference's ``per_shard_scan``, :func:`_attn_block` per (step, shard)
    with a causal bias from the global positions, differentiated by
    autograd.  Like the reference's, it has no guard against a row that has
    seen no key yet, and relies on step 0 being the diagonal;
  * the flash arm (CUDA tensors, ``use_pallas``): :class:`_RingFlash`, the
    reference's ``_ring_flash`` custom VJP.  Its forward runs kernel 4
    (``flash_attention_stats``) per (step, shard): unmasked where ``src <
    idx``, locally causal where ``src == idx``, and, where ``src > idx``
    under a causal mask, not at all (the reference's ``kernel_skip``
    returns ``m = -inf, l = 0``, for which the merge is the identity).  The
    exact merge of ``(m, l, acc)`` runs in PyTorch between steps with the
    reference's ``m_safe`` and ``isfinite`` guards.  Its backward runs
    the fused kernels 6 and 7 (``flash_bwd``, one launch and its dq sum)
    per (step, shard) in the same modes
    against the forward's combined full-sequence ``lse`` and ``delta =
    rowsum(g out)``; dq accumulates on its shard, and the dk/dv
    accumulators travel with their K/V block, ``n`` shifts in all, so that
    each arrives home after visiting every Q shard.

  A causal ring of ``n`` shards launches kernel 4 ``n(n+1)/2`` times a
  forward and the fused backward (with its dq sum) as often a backward; a
  non-causal one ``n²``.
- :func:`ulysses_attention`: ``all_to_all`` from sequence shards to head
  shards, :func:`blockwise_attention` over the whole sequence for ``H/n``
  heads on each device, and ``all_to_all`` back.

The arm is picked by ``_compat.platform_dependent`` on the shards' device,
whose first ``gpu`` pick runs kernel 10.  None of the reference's TPU gates
(``flash_attention_available``: ``Tk >= 2048``, ``Tk % 128``, the 5 MB K/V
envelope, ``MXNET_TPU_PALLAS_ATTN``) applies; the kernels take fp32 and the
head dims of ``hopper_attention.SUPPORTED_D``, and raise otherwise.
"""
from __future__ import annotations

import math
from functools import partial
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..ops import hopper_attention as ha
from ._compat import platform_dependent
from .mesh import Mesh, all_to_all, ppermute, shard, unshard

__all__ = ["blockwise_attention", "ring_attention", "ulysses_attention"]


def _attn_block(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One (Q block x K block) update of the running max ``m``, sum ``l``
    and output accumulator ``o``, in fp32 whatever q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new.unsqueeze(-1))
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha.unsqueeze(-1) + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _running_stats(q):
    """Initial (m, l, o): -inf, 0, 0 in fp32 on q's device."""
    rows = q.shape[:-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full(rows, -math.inf, **f32), torch.zeros(rows, **f32),
            torch.zeros(q.shape, **f32))


def _blockwise_scan(q, k, v, block_size, causal, scale):
    B, H, T, D = q.shape
    Tk = k.shape[2]
    bs = min(block_size, Tk)
    nblocks = (Tk + bs - 1) // bs
    pad = nblocks * bs - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q_pos = torch.arange(T, device=q.device)
    m, l, o = _running_stats(q)
    for i in range(nblocks):
        k_pos = i * bs + torch.arange(bs, device=q.device)
        bias = torch.where(k_pos < Tk, 0.0, -math.inf)[None, None, None, :]
        if causal:
            bias = bias + torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                                      -math.inf)[None, None, :, :]
        m, l, o = _attn_block(q, k[:, :, i * bs:(i + 1) * bs],
                              v[:, :, i * bs:(i + 1) * bs], bias, m, l, o,
                              scale)
    return (o / l.clamp_min(1e-37).unsqueeze(-1)).to(q.dtype)


def blockwise_attention(q, k, v, block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None,
                        use_pallas: bool = True):
    """Attention of ``[B, H, T, D]`` tensors, ``scale`` 1/sqrt(D) by
    default: the flash kernels for CUDA tensors with ``use_pallas``, else
    the scan over K/V blocks of ``block_size`` rows."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scan = partial(_blockwise_scan, block_size=block_size, causal=causal,
                   scale=sc)
    if not use_pallas:
        return scan(q, k, v)
    return platform_dependent(
        q, k, v, default=scan,
        gpu=partial(ha.flash_attention, causal=causal, scale=sc))


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------
def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_scan(qs, ks, vs, causal, scale) -> List[torch.Tensor]:
    """The reference's ``per_shard_scan`` on every shard: n steps of
    :func:`_attn_block` against the K/V block held, then a shift."""
    n = len(qs)
    T_loc = qs[0].shape[2]
    stats = [_running_stats(q) for q in qs]
    kcur, vcur = list(ks), list(vs)
    for step in range(n):
        for idx in range(n):
            bias = None
            if causal:
                dev = qs[idx].device
                src = (idx - step) % n
                q_pos = idx * T_loc + torch.arange(T_loc, device=dev)
                k_pos = src * T_loc + torch.arange(T_loc, device=dev)
                bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                                   -math.inf)[None, None]
            stats[idx] = _attn_block(qs[idx], kcur[idx], vcur[idx], bias,
                                     *stats[idx], scale)
        if step < n - 1:        # the reference's last shift is never read
            kcur = ppermute(kcur, _ring_perm(n))
            vcur = ppermute(vcur, _ring_perm(n))
    return [(o / l.clamp_min(1e-37).unsqueeze(-1)).to(q.dtype)
            for q, (_, l, o) in zip(qs, stats)]


def _step_mode(causal, idx, src):
    """'full', 'diag' or 'skip' for shard ``idx`` against K/V of ``src``."""
    if not causal or src < idx:
        return "full"
    return "diag" if src == idx else "skip"


def _merge(m, l, acc, mi, li, acci):
    """The exact online-softmax merge of two partial results, with the
    reference's guards (``ring_attention.py:218-225``)."""
    m_new = torch.maximum(m, mi)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    b = torch.where(torch.isfinite(mi), torch.exp(mi - m_safe), 0.0)
    return (m_new, l * a + li * b,
            acc * a.unsqueeze(-1) + acci * b.unsqueeze(-1))


class _RingFlash(torch.autograd.Function):
    """(q, k, v shards) -> output shards: kernel 4 forward, kernels 6 and 7
    backward, the counterpart of the reference's ``_ring_flash``."""

    @staticmethod
    def forward(ctx, causal, scale, *shards):
        n = len(shards) // 3
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        stats = [_running_stats(q) for q in qs]
        kcur, vcur = list(ks), list(vs)
        for step in range(n):
            for idx in range(n):
                mode = _step_mode(causal, idx, (idx - step) % n)
                if mode == "skip":
                    continue
                acci, mi, li = ha.flash_attention_stats(
                    qs[idx], kcur[idx], vcur[idx], mode == "diag", scale)
                m, l, acc = stats[idx]
                stats[idx] = _merge(m, l, acc, mi, li, acci)
            if step < n - 1:
                kcur = ppermute(kcur, _ring_perm(n))
                vcur = ppermute(vcur, _ring_perm(n))
        outs = [(acc / l.clamp_min(1e-37).unsqueeze(-1)).to(q.dtype)
                for q, (_, l, acc) in zip(qs, stats)]
        lses = [ha.lse_of(m, l) for m, l, _ in stats]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        gs = [g.contiguous() for g in gs]
        deltas = [(g.float() * o.float()).sum(dim=-1)
                  for g, o in zip(gs, outs)]
        f32 = dict(dtype=torch.float32)
        dqs = [torch.zeros(q.shape, device=q.device, **f32) for q in qs]
        dka = [torch.zeros(k.shape, device=k.device, **f32) for k in ks]
        dva = [torch.zeros(v.shape, device=v.device, **f32) for v in vs]
        kcur, vcur = list(ks), list(vs)
        for step in range(n):
            for idx in range(n):
                mode = _step_mode(ctx.causal, idx, (idx - step) % n)
                if mode == "skip":
                    continue
                dqi, dki, dvi = ha.flash_bwd(
                    qs[idx], kcur[idx], vcur[idx], gs[idx], lses[idx],
                    deltas[idx], mode == "diag", ctx.scale)
                dqs[idx] += dqi
                dka[idx] += dki
                dva[idx] += dvi
            # the accumulators make all n shifts, back to their own shard
            dka = ppermute(dka, _ring_perm(n))
            dva = ppermute(dva, _ring_perm(n))
            if step < n - 1:
                kcur = ppermute(kcur, _ring_perm(n))
                vcur = ppermute(vcur, _ring_perm(n))
        return (None, None,
                *[dq.to(q.dtype) for dq, q in zip(dqs, qs)],
                *[dk.to(k.dtype) for dk, k in zip(dka, ks)],
                *[dv.to(v.dtype) for dv, v in zip(dva, vs)])


def _ring_flash(qs, ks, vs, causal, scale):
    return list(_RingFlash.apply(causal, scale, *qs, *ks, *vs))


def ring_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                   causal: bool = False, block_size: int = 512,
                   scale: Optional[float] = None, use_pallas: bool = True):
    """Exact attention of ``[B, H, T, D]`` tensors with T split over
    ``mesh[axis]`` (``T % n == 0``); returns ``[B, H, T, D]`` on q's device,
    differentiable.  The flash arm (kernels 4, 6, 7) for shards on the card
    with ``use_pallas``, the scan arm otherwise.  ``block_size`` is kept for
    the reference's signature and read by neither arm: the flash arm's tile
    is the kernel's own, and the scan arm takes each K/V shard whole, as
    the reference's ``per_shard_scan`` does."""
    del block_size
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (shard(t, mesh, axis, 2) for t in (q, k, v))
    scan = partial(_ring_scan, causal=causal, scale=sc)
    if use_pallas:
        outs = platform_dependent(
            qs, ks, vs, default=scan,
            gpu=partial(_ring_flash, causal=causal, scale=sc))
    else:
        outs = scan(qs, ks, vs)
    return unshard(outs, 2, q.device)


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                      causal: bool = False, scale: Optional[float] = None):
    """Ulysses (DeepSpeed) sequence parallelism: ``all_to_all`` so that each
    device holds the whole sequence for ``H/n`` heads, attention there, and
    ``all_to_all`` back.  ``H`` and ``T`` must split ``n`` ways."""
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError("ulysses_attention: %d heads do not split over "
                         "%s=%d" % (q.shape[1], axis, n))
    heads = [all_to_all(shard(t, mesh, axis, 2), 1, 2) for t in (q, k, v)]
    outs = [blockwise_attention(qh, kh, vh, causal=causal, scale=scale)
            for qh, kh, vh in zip(*heads)]
    return unshard(all_to_all(outs, 2, 1), 2, q.device)
