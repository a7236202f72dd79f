"""Flash attention, forward and backward, on hand-written Hopper kernels
(counterpart of ``mxnet_tpu/ops/pallas_attention.py``).

:func:`flash_attention` is ``softmax(q kᵀ · scale [causal]) · v`` over
``[B, H, T, D]`` tensors, differentiable, as the reference's ``custom_vjp``
of the same name (``pallas_attention.py:419-443``):

- with grad mode on and an input that requires grad, it applies
  :class:`_FlashAttention`, whose forward is :func:`flash_fwd_lse` (kernel 5,
  the function of ``_flash_fwd_lse``), saving ``(q, k, v, out, lse)``; its
  backward takes ``delta = rowsum(dO · out)`` in one PyTorch expression, as
  the reference takes it in XLA outside its kernels, then calls
  :func:`flash_bwd`: one fused kernel in place of kernels 6 (``_dq_kernel``,
  dq) and 7 (``_dkv_kernel``, dk and dv), then a fixed-order sum of its dq
  partials, in fp32, cast to the inputs' dtype;
- otherwise it calls :func:`flash_fwd` (kernel 3, ``_flash_fwd``), which
  writes no ``lse``.

:func:`flash_attention_stats` (kernel 4, ``flash_attention_stats``,
``pallas_attention.py:184-220``) is ring attention's per-shard pass: the
same loop, returning the unnormalised accumulator ``acc`` and the running
max ``m`` and sum ``l`` of every row, which ``parallel/ring_attention.py``
merges across shards; :func:`lse_of` turns ``(m, l)`` into the ``lse`` of
the backward.

The choice is made before ``apply``: inside ``Function.forward`` grad mode
is off.  The kernels live in ``csrc/flash_attn_fwd.cu`` (3, 4 and 5, one
template with three epilogues; its launch comes from :func:`flash_fwd_plan`)
and ``csrc/flash_attn_bwd.cu`` (6 and 7, fused; its launch comes from
:func:`flash_bwd_plan`).  For CUDA tensors the
wrappers launch them and raise if they cannot (fp32 only, ``D`` in
:data:`SUPPORTED_D`); for tensors on the CPU, or ``meta`` tensors during
shape inference, they run :func:`flash_fwd_plain`, :func:`flash_stats_plain`
and :func:`flash_bwd_plain`, dense fp32 PyTorch with the same mask and the
same ``lse`` rule.  There is no fallback from one to the other, and none of the
reference's TPU gates (``Tk >= 2048``, the 5 MB K/V envelope, ``Tk % 128``,
``MXNET_TPU_FLASH_ATTENTION``/``MXNET_TPU_PALLAS_ATTN``) applies: any
``Tq, Tk >= 1`` is taken.  ``lse`` is a plain ``(B, H, Tq)`` fp32 array; the
reference's ``(..., 128)`` lane packing was a Mosaic layout detail, and so
are ``m`` and ``l``, ``(B, H, Tq)`` here where the reference replicates them
over 128 lanes.

``flash_fwd_launches``, ``flash_stats_launches``, ``flash_fwd_lse_launches``,
``flash_bwd_launches`` and ``flash_dq_sum_launches`` count kernel launches
(kernels 3, 4, 5, the fused 6 and 7, and its dq sum), as the CUDA entry
points report them.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Tuple

import torch

from ..base import MXNetError
from .hopper_conv import _stream

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_lse", "flash_bwd",
           "flash_attention_stats", "lse_of", "flash_fwd_plain",
           "flash_stats_plain", "flash_bwd_plain", "flash_fwd_launches",
           "flash_stats_launches", "flash_fwd_lse_launches",
           "flash_bwd_launches", "flash_dq_sum_launches", "flash_fwd_plan",
           "FlashFwdPlan", "flash_bwd_plan", "FlashBwdPlan", "SUPPORTED_D"]

#: kernel 3 launches so far (CUDA arm of :func:`flash_fwd` only)
flash_fwd_launches = 0
#: kernel 4 launches so far (CUDA arm of :func:`flash_attention_stats` only)
flash_stats_launches = 0
#: kernel 5 launches so far (CUDA arm of :func:`flash_fwd_lse` only)
flash_fwd_lse_launches = 0
#: launches of the fused backward (kernels 6 and 7 as one; CUDA arm of
#: :func:`flash_bwd` only)
flash_bwd_launches = 0
#: launches of its fixed-order dq sum (CUDA arm of :func:`flash_bwd` only)
flash_dq_sum_launches = 0
_count_lock = threading.Lock()

#: head dims the kernels are built for
SUPPORTED_D = (16, 32, 64, 128)

# the forward kernel's epilogues (MODE_* in csrc/flash_attn_fwd.cu)
_OUT, _OUT_LSE, _STATS = 0, 1, 2

#: the forward's tile of each head dim: (query rows of a CTA, keys of a
#: tile), the instantiations of csrc/flash_attn_fwd.cu (Tile<D>)
_FWD_TILE = {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 32)}
#: its warps a CTA and its K/V ring's slots (WARPS and NS there)
_FWD_WARPS, _FWD_SLOTS = 4, 2

#: the fused backward's tile of each head dim: (keys of a CTA, queries of a
#: ring stage), the instantiations of csrc/flash_attn_bwd.cu
_BWD_TILE = {16: (128, 64), 32: (128, 64), 64: (128, 64), 128: (64, 32)}
#: its Q/dO ring depth (STAGES there)
_BWD_STAGES = 2

_fns = {}


def _mask(Tq, Tk, device):
    """True where query i may see key j: j <= i, aligned at the top left."""
    return (torch.arange(Tq, device=device)[:, None]
            >= torch.arange(Tk, device=device)[None, :])


def lse_of(m, l):
    """logsumexp from the online-softmax stats, ``+inf`` for a row that sees
    no key, so that the backward's ``p = exp(s - lse)`` is 0 there
    (``pallas_attention.py:223``)."""
    return torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)),
                       torch.full_like(l, math.inf))


def flash_stats_plain(q, k, v, causal, scale):
    """Dense reference of kernel 4: q (B, H, Tq, D), k/v (B, H, Tk, D) ->
    (acc (B, H, Tq, D), m, l (B, H, Tq)), all fp32: ``m`` the row max of the
    masked scaled scores, ``p = exp(s - m)`` (``m`` taken as 0 where it is
    -inf, the reference's ``m_safe``), ``l`` the row sum of ``p`` and ``acc
    = p v``, not normalised.  A row that sees no key gives -inf, 0, 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_mask(s.shape[-2], s.shape[-1], s.device),
                          -math.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe.unsqueeze(-1))
    return torch.matmul(p, v.float()), m, p.sum(dim=-1)


def flash_fwd_plain(q, k, v, causal, scale):
    """Dense reference of kernels 3 and 5: q (B, H, Tq, D), k/v (B, H, Tk, D)
    -> (out in q's dtype, lse (B, H, Tq) fp32), the softmax in fp32, ``lse``
    +inf for a row that sees no key (:func:`lse_of`)."""
    acc, m, l = flash_stats_plain(q, k, v, causal, scale)
    out = acc / l.clamp_min(1e-37).unsqueeze(-1)
    return out.to(q.dtype), lse_of(m, l)


def flash_bwd_plain(q, k, v, do, lse, delta, causal, scale):
    """Dense reference of kernels 6 and 7 (fused on the card): ``p = exp(s
    - lse)`` (0 where masked), ``ds = p (dO vᵀ - delta) scale`` -> (dq, dk,
    dv), all fp32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    if causal:
        p = p.masked_fill(~_mask(s.shape[-2], s.shape[-1], s.device), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
            torch.matmul(p.transpose(-1, -2), dof))


class FlashFwdPlan(NamedTuple):
    """The forward's launch at one shape (``csrc/flash_attn_fwd.cu``, kernels
    3, 4 and 5).

    One CTA of ``warps`` warps per (head, query tile of ``bq`` rows); each
    warp owns ``bq // warps`` consecutive rows.  Block ``b`` of ``BH * n_qt``
    takes query tile ``n_qt - 1 - b // BH`` of head ``b % BH``
    (:meth:`block`), so under the causal mask, where the last query tiles see
    the most keys, the heaviest CTAs come first.  Query rows ``[r0, r0 +
    rows)`` walk key tiles ``0 .. key_tiles(r0, rows) - 1`` once each, in
    order (:meth:`key_tiles`): a CTA as far as its last warp, a warp as far
    as its own last row."""
    bq: int                     # query rows of a CTA
    bk: int                     # keys of a K/V tile
    warps: int
    n_qt: int
    n_kt: int
    Tq: int
    causal: bool
    smem: int                   # dynamic shared memory of a CTA, bytes

    def block(self, b: int, BH: int) -> Tuple[int, int]:
        """(head, query tile) of block ``b``."""
        return b % BH, self.n_qt - 1 - b // BH

    def key_tiles(self, r0: int, rows: int) -> int:
        """Key tiles that query rows ``[r0, r0 + rows)`` walk (the kernel's
        ``key_tiles``): all, or under the causal mask those up to the last
        row's diagonal; 0 for rows wholly past ``Tq``."""
        if r0 >= self.Tq:
            return 0
        if not self.causal:
            return self.n_kt
        return min(self.n_kt, (min(r0 + rows, self.Tq) - 1) // self.bk + 1)


@functools.lru_cache(maxsize=256)
def flash_fwd_plan(Tq: int, Tk: int, D: int, causal: bool) -> FlashFwdPlan:
    """The forward's tile, shared memory and grid order at one shape (pure
    Python; the kernel recomputes the same order and the entry point refuses
    another tile).  Shared memory: the Q tile, the K/V ring's slots and P,
    rows padded by 4 floats (P's by 8)."""
    bq, bk = _FWD_TILE[D]
    smem = 4 * ((bq + _FWD_SLOTS * bk) * (D + 4) + bq * (bk + 8))
    return FlashFwdPlan(bq, bk, _FWD_WARPS, -(-Tq // bq), -(-Tk // bk), Tq,
                        bool(causal), smem)


class FlashBwdPlan(NamedTuple):
    """The fused backward's launch at one shape (``csrc/flash_attn_bwd.cu``).

    One CTA per (head, key tile): block ``b`` of ``BH * n_kt`` takes key tile
    ``b // BH`` of head ``b % BH`` (:meth:`block`), so under the causal mask,
    where the first key tiles see the most queries, the heaviest CTAs come
    first.  Key tile ``kt`` visits q tiles ``first_qt[kt]`` to ``n_qt - 1``
    and writes its dQ partial for rows ``first_qt[kt] * bq`` to ``Tq - 1``
    into rows ``ws_off[kt]`` on of its head's workspace (``ws_off[-1]`` rows a
    head); the dq sum adds, for each query row, the partials of the key tiles
    that hold it in key-tile order."""
    bk: int                     # keys of a CTA
    bq: int                     # queries of a ring stage
    n_kt: int
    n_qt: int
    first_qt: Tuple[int, ...]   # per key tile
    ws_off: Tuple[int, ...]     # per key tile, and the head's rows last
    smem: int                   # dynamic shared memory of a CTA, bytes

    @property
    def ws_rows(self) -> int:
        return self.ws_off[-1]

    def block(self, b: int, BH: int) -> Tuple[int, int]:
        """(head, key tile) of block ``b``."""
        return b % BH, b // BH


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(Tq: int, Tk: int, D: int, causal: bool) -> FlashBwdPlan:
    """The fused backward's tile, grid order and dQ workspace at one shape
    (pure Python; the kernel recomputes the same offsets and the entry point
    refuses another workspace size)."""
    bk, bq = _BWD_TILE[D]
    n_kt, n_qt = -(-Tk // bk), -(-Tq // bq)
    first = tuple(kt * bk // bq if causal else 0 for kt in range(n_kt))
    off = [0]
    for f in first:
        off.append(off[-1] + max(0, Tq - f * bq))
    smem = 4 * (2 * bk * (D + 4) + _BWD_STAGES * (2 * bq * (D + 4) + 2 * bq)
                + 2 * bq * (bk + 4))
    return FlashBwdPlan(bk, bq, n_kt, n_qt, first, tuple(off), smem)


# --------------------------------------------------------------------------
# the CUDA arms
# --------------------------------------------------------------------------
def _fwd_fn():
    fn = _fns.get("mxtt_flash_attn_fwd")
    if fn is None:
        from .. import _build
        fn = _build.load("flash_attn_fwd").mxtt_flash_attn_fwd
        # pointers, BH, Tq, Tk, D, scale, causal, mode, bq, bk, device,
        # stream, launched
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fns["mxtt_flash_attn_fwd"] = fn
    return fn


def _check_cuda(name, q, k, tensors):
    """Shapes, dtype, device, contiguity and alignment the kernels take;
    returns (B, H, Tq, Tk, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise MXNetError("%s: q, k and v must be [B, H, T, D], got %s and %s"
                         % (name, tuple(q.shape), tuple(k.shape)))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in SUPPORTED_D:
        raise MXNetError("%s: the CUDA kernels take head dims %s, got D=%d"
                         % (name, SUPPORTED_D, D))
    if Tq < 1 or Tk < 1 or B * H < 1:
        raise MXNetError("%s: empty attention (B=%d H=%d Tq=%d Tk=%d)"
                         % (name, B, H, Tq, Tk))
    for t in tensors:
        if t.dtype != torch.float32:
            raise MXNetError("%s: the CUDA kernels take float32, got %s"
                             % (name, t.dtype))
        if t.device != q.device:
            raise MXNetError("%s: all tensors must be on %s" % (name, q.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise MXNetError("%s: tensors must be contiguous and 16-byte "
                             "aligned" % name)
    return B, H, Tq, Tk, D


def _call(fn, ptrs, B, H, Tq, Tk, D, scale, flags, dev):
    launched = ctypes.c_int(0)
    err = fn(*[t.data_ptr() if t is not None else None for t in ptrs],
             B * H, Tq, Tk, D, float(scale), *flags, dev.index,
             _stream(dev), ctypes.byref(launched))
    return err, launched.value


def _fwd_cuda(q, k, v, causal, scale, mode):
    """Kernel 3, 5 or 4 by ``mode``: (out,), (out, lse) or (acc, m, l)."""
    global flash_fwd_launches, flash_stats_launches, flash_fwd_lse_launches
    name = ("flash_fwd", "flash_fwd_lse", "flash_attention_stats")[mode]
    B, H, Tq, Tk, D = _check_cuda(name, q, k, (q, k, v))
    if tuple(v.shape) != tuple(k.shape) or tuple(k.shape[:2]) != (B, H) \
            or k.shape[3] != D:
        raise MXNetError("%s: shapes q %s k %s v %s do not form an attention"
                         % (name, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    rows = dict(dtype=torch.float32, device=q.device)
    outs = (torch.empty_like(q),)
    if mode == _OUT_LSE:
        outs += (torch.empty((B, H, Tq), **rows),)
    elif mode == _STATS:
        outs += (torch.empty((B, H, Tq), **rows),
                 torch.empty((B, H, Tq), **rows))
    ptrs = outs + (None,) * (3 - len(outs))
    plan = flash_fwd_plan(Tq, Tk, D, bool(causal))
    err, n = _call(_fwd_fn(), (q, k, v) + ptrs, B, H, Tq, Tk, D, scale,
                   (int(bool(causal)), mode, plan.bq, plan.bk), q.device)
    with _count_lock:
        if mode == _OUT:
            flash_fwd_launches += n
        elif mode == _OUT_LSE:
            flash_fwd_lse_launches += n
        else:
            flash_stats_launches += n
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (name, err))
    return outs


def _bind_bwd(lib):
    """``mxtt_flash_attn_bwd`` of a library built from
    ``csrc/flash_attn_bwd.cu``, typed."""
    fn = lib.mxtt_flash_attn_bwd
    # pointers, BH, Tq, Tk, D, scale, causal, bk, ws_rows, device, stream,
    # launched[2]
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _fns.get("mxtt_flash_attn_bwd")
    if fn is None:
        from .. import _build
        fn = _fns["mxtt_flash_attn_bwd"] = _bind_bwd(
            _build.load("flash_attn_bwd"))
    return fn


def _bwd_cuda(q, k, v, do, lse, delta, causal, scale):
    """The fused backward and its dq sum: two launches, dq bit-equal on
    reruns."""
    global flash_bwd_launches, flash_dq_sum_launches
    B, H, Tq, Tk, D = _check_cuda("flash_bwd", q, k, (q, k, v, do, lse, delta))
    if tuple(do.shape) != tuple(q.shape) or tuple(lse.shape) != (B, H, Tq) \
            or tuple(delta.shape) != (B, H, Tq) \
            or tuple(v.shape) != tuple(k.shape):
        raise MXNetError("flash_bwd: shapes q %s k %s v %s dO %s lse %s delta "
                         "%s do not match" % tuple(tuple(t.shape) for t in
                                                   (q, k, v, do, lse, delta)))
    plan = flash_bwd_plan(Tq, Tk, D, bool(causal))
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, H, Tq, D), **f32)
    dk = torch.empty((B, H, Tk, D), **f32)
    dv = torch.empty((B, H, Tk, D), **f32)
    ws = torch.empty((B * H, plan.ws_rows, D), **f32)
    launched = (ctypes.c_int * 2)()
    dev = q.device
    err = _bwd_fn()(*[t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk,
                                             dv, ws)],
                    B * H, Tq, Tk, D, float(scale), int(bool(causal)),
                    plan.bk, plan.ws_rows, dev.index, _stream(dev), launched)
    with _count_lock:
        flash_bwd_launches += launched[0]
        flash_dq_sum_launches += launched[1]
    if err != 0:
        raise MXNetError("flash_bwd launch failed: CUDA error %d" % err)
    return dq, dk, dv


# --------------------------------------------------------------------------
# dispatch: the kernel for a CUDA tensor, the plain version on the CPU
# --------------------------------------------------------------------------
def _plain_device(t, name):
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise MXNetError("%s: no arm for device %s" % (name, t.device))


def flash_fwd(q, k, v, causal, scale):
    """The attention output alone (kernel 3 for tensors on the card, the
    plain version on the CPU or ``meta``)."""
    if _plain_device(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, causal, scale)[0]
    return _fwd_cuda(q, k, v, causal, scale, _OUT)[0]


def flash_fwd_lse(q, k, v, causal, scale):
    """(out, lse) for the backward (kernel 5 for tensors on the card, the
    plain version on the CPU or ``meta``)."""
    if _plain_device(q, "flash_fwd_lse"):
        return flash_fwd_plain(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale, _OUT_LSE)


def flash_attention_stats(q, k, v, causal, scale, block_q=512, block_k=512):
    """(acc, m, l), all fp32, for ring attention's exact merge: ``acc``
    ``[B, H, Tq, D]`` not normalised, ``m`` and ``l`` ``[B, H, Tq]`` (kernel
    4 for tensors on the card, the plain version on the CPU or ``meta``).
    ``block_q`` and ``block_k`` are the reference's Pallas tiles, taken and
    ignored: the kernel's tile is its own."""
    del block_q, block_k
    if _plain_device(q, "flash_attention_stats"):
        return flash_stats_plain(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale, _STATS)


def flash_bwd(q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) in fp32 (the fused kernel 6 and 7 and its dq sum for
    tensors on the card, the plain version on the CPU or ``meta``)."""
    if _plain_device(q, "flash_bwd"):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    return _bwd_cuda(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> out with the saved ``lse``; backward on the fused
    kernels 6 and 7."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd_lse(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g.float() * out.float()).sum(dim=-1)
        dq, dk, dv = flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               g.contiguous(), lse, delta, ctx.causal,
                               ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """[B, H, T, D] attention, ``scale`` 1/sqrt(D) by default;
    differentiable, both directions on the kernels for tensors on the
    card."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), float(sc))
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal), float(sc))
