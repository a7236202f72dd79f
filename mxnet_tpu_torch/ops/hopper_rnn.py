"""Fused LSTM recurrence, forward and backward, on hand-written Hopper
kernels (counterpart of ``mxnet_tpu/ops/pallas_rnn.py``).

:func:`lstm_recurrence` is the LSTM time loop of the ``RNN`` op: given the
input projections ``xp = x @ Wᵀ + bW`` of all T steps, (T, B, 4H) in
``[i f g o]`` order, the initial states ``h0``, ``c0`` (B, H), the recurrent
weight ``R`` (4H, H) and bias ``bR`` (4H,), it returns ``ys`` (T, B, H),
``hT`` and ``cT``.  It is a ``torch.autograd.Function``, as the reference's
is a ``custom_vjp``:

- the forward is :func:`lstm_fwd`, the function of the TPU kernel
  ``_fwd_kernel``: the whole recurrence, which also writes the reserve the
  backward reads (post-activation gates (T, B, 4H), fp32 cell states
  (T, B, H));
- the backward is :func:`lstm_bwd`, the function of ``_bwd_kernel``: the
  reverse-time recurrence giving ``dxp`` (T, B, 4H), ``dh0`` and ``dc0``;
  then ``dR = dxpᵀ · h_prev`` and ``dbR = Σ dxp`` are two large products
  outside the kernel, as the reference computes them outside its kernel
  (``pallas_rnn.py:260-275``).

:func:`lstm_fwd` and :func:`lstm_bwd` launch the CUDA kernels in
``mxnet_tpu_torch/csrc/lstm_fwd.cu`` and ``lstm_bwd.cu`` for tensors on the
card, and raise if they cannot; for tensors on the CPU (or ``meta``, during
shape inference) they run :func:`lstm_fwd_plain` and :func:`lstm_bwd_plain`,
step loops of fp32 PyTorch with the same contracts.  There is no fallback
from one to the other.  The kernels take fp32 and the reference's whole
envelope, H ≤ 2048 and B ≤ 1024 (``pallas_rnn.py:67``); outside it
:func:`lstm_recurrence` raises on the card.  ``lstm_fwd_launches`` and
``lstm_bwd_launches`` count kernel launches, as the CUDA entry points report
them.

Layouts are the port's own (row-major, the gates packed along the last
axis as the input projection produces them); the reference kernel's
(T, 4, B, H) layout was chosen for the TPU's lanes.  The tests convert at
the boundary when they compare with it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from .hopper_conv import _stream

__all__ = ["lstm_recurrence", "lstm_fwd", "lstm_bwd", "lstm_fwd_plain",
           "lstm_bwd_plain", "lstm_fwd_launches", "lstm_bwd_launches",
           "geometry", "MAX_HIDDEN", "MAX_BATCH"]

#: kernel 8 launches so far (CUDA arm of :func:`lstm_fwd` only)
lstm_fwd_launches = 0
#: kernel 9 launches so far (CUDA arm of :func:`lstm_bwd` only)
lstm_bwd_launches = 0
_count_lock = threading.Lock()

#: the kernels' envelope, the reference's (``pallas_rnn.py:67``)
MAX_HIDDEN = 2048
MAX_BATCH = 1024

_fns = {}


def lstm_fwd_plain(xp, h0, c0, R, bR):
    """Reference forward: xp (T, B, 4H), h0/c0 (B, H), R (4H, H), bR (4H,)
    -> (ys (T, B, H), hT, cT, gates (T, B, 4H) after the activations,
    cs (T, B, H)), all fp32, one step at a time (what ``_fwd_kernel``
    computes)."""
    T, B, H4 = xp.shape
    H = H4 // 4
    h, c = h0.float(), c0.float()
    Rt, b = R.float().t(), bR.float()
    ys, gates, cs = [], [], []
    for t in range(T):
        pre = xp[t].float() + h @ Rt + b
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gates.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return (torch.stack(ys), h, c, torch.stack(gates), torch.stack(cs))


def lstm_bwd_plain(gates, cs, c0, dys, dhT, dcT, R):
    """Reference backward from the forward's reserve: gates (T, B, 4H), cs
    (T, B, H), c0 (B, H), dys (T, B, H), dhT/dcT (B, H), R (4H, H) ->
    (dxp (T, B, 4H), dh0, dc0), all fp32 (what ``_bwd_kernel`` computes)."""
    T, B, H4 = gates.shape
    H = H4 // 4
    R32 = R.float()
    dh, dc = dhT.float(), dcT.float()
    dxp = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = (gates[t, :, k * H:(k + 1) * H].float()
                      for k in range(4))
        tc = torch.tanh(cs[t])
        cp = cs[t - 1] if t > 0 else c0.float()
        dh = dh + dys[t].float()
        dct = dh * o * (1.0 - tc * tc) + dc
        dpre = torch.cat([(dct * g) * i * (1.0 - i),
                          (dct * cp) * f * (1.0 - f),
                          (dct * i) * (1.0 - g * g),
                          (dh * tc) * o * (1.0 - o)], dim=1)
        dxp[t] = dpre
        dc = dct * f
        dh = dpre @ R32
    return torch.stack(dxp), dh, dc


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from .. import _build
        fn = getattr(_build.load(name), "mxtt_" + name)
        # 11 tensor pointers, T, B, H, device, stream, launched
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def geometry(name, B, H, device=0):
    """The launch geometry kernel ``name`` ("lstm_fwd" or "lstm_bwd") uses
    at (B, H) on a card: blocks, threads, units and batch rows per block,
    batch rows per tile, dynamic shared memory bytes and whether R stays
    resident."""
    from .. import _build
    fn = getattr(_build.load(name), "mxtt_%s_geometry" % name)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    err = fn(B, H, device, out)
    if err != 0:
        raise MXNetError("%s geometry: CUDA error %d" % (name, err))
    return dict(zip(("blocks", "threads", "units_per_block", "rows_per_block",
                     "batch_tile", "smem_bytes", "r_resident"), list(out)))


def _check_cuda(name, tensors, B, H):
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise MXNetError("%s: the CUDA kernel takes float32, got %s"
                             % (name, t.dtype))
        if t.device != dev:
            raise MXNetError("%s: all tensors must be on %s" % (name, dev))
        if not t.is_contiguous():
            raise MXNetError("%s: tensors must be contiguous" % name)
    if not (1 <= H <= MAX_HIDDEN and 1 <= B <= MAX_BATCH):
        raise MXNetError("%s: the kernel covers H <= %d and B <= %d, got H=%d "
                         "B=%d" % (name, MAX_HIDDEN, MAX_BATCH, H, B))
    return dev


def _launch(name, args, dev, T, B, H):
    launched = ctypes.c_int(0)
    err = _kernel(name)(*[a.data_ptr() for a in args], T, B, H, dev.index,
                        _stream(dev), ctypes.byref(launched))
    return err, launched.value


def _lstm_fwd_cuda(xp, h0, c0, R, bR):
    global lstm_fwd_launches
    T, B, H4 = xp.shape
    H = H4 // 4
    dev = _check_cuda("lstm_fwd", (xp, h0, c0, R, bR), B, H)
    if tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H) \
            or tuple(R.shape) != (H4, H) or tuple(bR.shape) != (H4,):
        raise MXNetError("lstm_fwd: shapes xp %s h0 %s c0 %s R %s bR %s do not "
                         "form an LSTM" % tuple(tuple(t.shape) for t in
                                                (xp, h0, c0, R, bR)))
    f32 = dict(dtype=torch.float32, device=dev)
    ys = torch.empty((T, B, H), **f32)
    gates = torch.empty((T, B, H4), **f32)
    cs = torch.empty((T, B, H), **f32)
    hT = torch.empty((B, H), **f32)
    cT = torch.empty((B, H), **f32)
    hbuf = torch.empty((2, H, (B + 3) // 4 * 4), **f32)
    err, n = _launch("lstm_fwd", (xp, h0, c0, R, bR, ys, gates, cs, hT, cT,
                                  hbuf), dev, T, B, H)
    with _count_lock:
        lstm_fwd_launches += n
    if err != 0:
        raise MXNetError("lstm_fwd launch failed: CUDA error %d" % err)
    return ys, hT, cT, gates, cs


def _lstm_bwd_cuda(gates, cs, c0, dys, dhT, dcT, R):
    global lstm_bwd_launches
    T, B, H4 = gates.shape
    H = H4 // 4
    dev = _check_cuda("lstm_bwd", (gates, cs, c0, dys, dhT, dcT, R), B, H)
    f32 = dict(dtype=torch.float32, device=dev)
    dxp = torch.empty((T, B, H4), **f32)
    dh0 = torch.empty((B, H), **f32)
    dc0 = torch.empty((B, H), **f32)
    dpre_t = torch.empty((2, H4, (B + 3) // 4 * 4), **f32)
    err, n = _launch("lstm_bwd", (gates, cs, c0, dys, dhT, dcT, R, dxp, dh0,
                                  dc0, dpre_t), dev, T, B, H)
    with _count_lock:
        lstm_bwd_launches += n
    if err != 0:
        raise MXNetError("lstm_bwd launch failed: CUDA error %d" % err)
    return dxp, dh0, dc0


def lstm_fwd(xp, h0, c0, R, bR):
    """The forward recurrence with its reserve, as :func:`lstm_fwd_plain`:
    kernel 8 for tensors on the card, the plain version on the CPU or
    ``meta``."""
    if xp.device.type == "cuda":
        return _lstm_fwd_cuda(xp, h0, c0, R, bR)
    if xp.device.type in ("cpu", "meta"):
        return lstm_fwd_plain(xp, h0, c0, R, bR)
    raise MXNetError("lstm_fwd: no arm for device %s" % xp.device)


def lstm_bwd(gates, cs, c0, dys, dhT, dcT, R):
    """The reverse-time recurrence, as :func:`lstm_bwd_plain`: kernel 9 for
    tensors on the card, the plain version on the CPU or ``meta``."""
    if gates.device.type == "cuda":
        return _lstm_bwd_cuda(gates, cs, c0, dys, dhT, dcT, R)
    if gates.device.type in ("cpu", "meta"):
        return lstm_bwd_plain(gates, cs, c0, dys, dhT, dcT, R)
    raise MXNetError("lstm_bwd: no arm for device %s" % gates.device)


class _LSTMRecurrence(torch.autograd.Function):
    """(xp, h0, c0, R, bR) -> (ys, hT, cT), both directions on the kernels
    (``pallas_rnn._lstm_pallas`` and its VJP)."""

    @staticmethod
    def forward(ctx, xp, h0, c0, R, bR):
        ys, hT, cT, gates, cs = lstm_fwd(xp.contiguous(), h0.contiguous(),
                                         c0.contiguous(), R.contiguous(),
                                         bR.contiguous())
        ctx.save_for_backward(ys, gates, cs, h0, c0, R)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, gates, cs, h0, c0, R = ctx.saved_tensors
        T, B, H = ys.shape
        zero = lambda: torch.zeros((B, H), dtype=ys.dtype, device=ys.device)  # noqa: E731
        dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
        dhT = zero() if dhT is None else dhT.contiguous()
        dcT = zero() if dcT is None else dcT.contiguous()
        dxp, dh0, dc0 = lstm_bwd(gates, cs, c0.contiguous(), dys, dhT, dcT, R)
        dxp2 = dxp.reshape(T * B, 4 * H)
        hprev = torch.cat([h0.reshape(1, B, H).to(ys.dtype), ys[:-1]])
        dR = dxp2.t() @ hprev.reshape(T * B, H)
        dbR = dxp2.sum(0)
        return dxp, dh0, dc0, dR, dbR


def lstm_recurrence(xp, h0, c0, R, bR):
    """LSTM over T steps: xp (T, B, 4H) input projections, h0/c0 (B, H),
    R (4H, H), bR (4H,) -> (ys (T, B, H), hT, cT); differentiable, both
    directions on the kernels for tensors on the card."""
    return _LSTMRecurrence.apply(xp, h0, c0, R, bR)
