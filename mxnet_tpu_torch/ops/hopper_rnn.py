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
them.  Each launch follows :func:`lstm_plan` (pure Python, cached): the
blocks, threads, units and batch rows a block, the product's tile and
stages, and the shared memory, which the entry points check before they
launch.

Layouts are the port's own (row-major, the gates packed along the last
axis as the input projection produces them); the reference kernel's
(T, 4, B, H) layout was chosen for the TPU's lanes.  The tests convert at
the boundary when they compare with it.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ..base import MXNetError
from .hopper_conv import _sm_count, _stream

__all__ = ["lstm_recurrence", "lstm_fwd", "lstm_bwd", "lstm_fwd_plain",
           "lstm_bwd_plain", "lstm_fwd_launches", "lstm_bwd_launches",
           "LstmPlan", "lstm_plan", "geometry", "MAX_HIDDEN", "MAX_BATCH"]

#: kernel 8 launches so far (CUDA arm of :func:`lstm_fwd` only)
lstm_fwd_launches = 0
#: kernel 9 launches so far (CUDA arm of :func:`lstm_bwd` only)
lstm_bwd_launches = 0
_count_lock = threading.Lock()

#: the kernels' envelope, the reference's (``pallas_rnn.py:67``)
MAX_HIDDEN = 2048
MAX_BATCH = 1024

_fns = {}

# --------------------------------------------------------------------------
# the launch plan (csrc/lstm_common.cuh checks the same arithmetic)
# --------------------------------------------------------------------------
#: shared memory a block may use on an H100 (opt-in), bytes
SMEM_OPTIN = 232448
_STAGES = 3            # LSTM_NS: stages of the exchanged state
_RING = 16             # LSTM_RING_FLOATS: the stage ring's mbarriers
#: threads a block at most (lstm_max_threads)
_MAX_THREADS = {"fwd": 512, "bwd": 640}
_MAX_KG = 8            # LSTM_MAX_KG: thread groups splitting a stage
_MAXPP = 2             # LSTM_MAXPP: (unit, row) pairs a thread


class LstmPlan(NamedTuple):
    """One launch of kernel 8 (``kind`` "fwd") or 9 ("bwd"); the fields in
    the order of ``csrc/lstm_common.cuh``'s ``LstmPlan``.

    The grid is ``halves * groups * parts`` blocks.  A group owns ``units``
    hidden units of one batch half's ``rows`` rows: the forward's block
    (``parts`` 1) multiplies h_{t-1} by the block's 4 x ``units`` gate rows
    of R; the backward's four blocks of a group (``parts`` 4) each take one
    gate's quarter of the reduction, and between two products run the
    elementwise phase for a quarter of the group's units, ``chunk`` rows at
    a time.  A product tile has ``tile`` batch rows, and a thread keeps a
    4 x 8 (forward) or 8 x 4 (backward) register tile of it; ``kg`` thread
    groups take ``sc`` columns each of every stage (``kg * sc`` columns a
    stage, three stages in shared memory); ``resident``: the block's slice
    of R stays in shared memory for the whole sequence, else it is staged
    beside the state; ``smem``: dynamic shared memory, bytes."""
    halves: int
    groups: int
    parts: int
    units: int
    rows: int
    tile: int
    kg: int
    sc: int
    chunk: int
    threads: int
    resident: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.halves * self.groups * self.parts


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _tile(kind):
    """A thread's register tile, rows x columns."""
    return (4, 8) if kind == "fwd" else (8, 4)


def _dims(kind, units, tile, kg, sc, H):
    """(NCP, items, nst) of a plan: the output columns padded to NCP, the
    thread tiles of a group, the stages of a step."""
    TR, TC = _tile(kind)
    NC = 4 * units if kind == "fwd" else units
    NCP = -(-NC // TC) * TC
    items = NCP // TC * (tile // TR)
    return NCP, items, -(-H // (kg * sc))


def _smem_bytes(kind, units, tile, kg, sc, chunk, resident, H) -> int:
    """``lstm_smem_floats`` of ``csrc/lstm_common.cuh``, in bytes."""
    NCP, _, nst = _dims(kind, units, tile, kg, sc, H)
    KC = kg * sc
    res = nst * KC * NCP if resident else 0
    region = max(_STAGES * KC * tile + (0 if resident else _STAGES * KC * NCP),
                 kg * NCP * (tile + 4))
    if kind == "fwd":
        return 4 * (res + _r4(4 * units) + region + _r4(NCP * (tile + 1))
                    + _r4(6 * tile * (units | 1)) + _RING)
    uq = -(-units // 4)
    region = max(region, _r4(4 * chunk * (uq | 1)) + _r4(4 * uq * (chunk + 1)))
    return 4 * (res + region + _r4(7 * uq * (chunk + 1)) + _RING)


@functools.lru_cache(maxsize=256)
def lstm_plan(kind: str, B: int, H: int, sms: int,
              smem_optin: int = SMEM_OPTIN, kg: Optional[int] = None,
              sc: Optional[int] = None) -> LstmPlan:
    """Kernel 8's (``kind`` "fwd") or 9's ("bwd") launch at batch B, hidden
    size H on a card with ``sms`` SMs and ``smem_optin`` bytes of shared
    memory a block (pure Python, cached; raises where no plan fits).

    The batch splits in two halves from 64 rows up.  The forward gives each
    block ceil(2H / sms) units (10 at H 650 on 132 SMs: 130 blocks); the
    backward puts 16 groups of four blocks in a half on 132 SMs (41 units a
    group at H 650: 128 blocks).  Then the plan takes the product's split
    (``kg``, ``sc``) of least cost in SM clocks a step: FMA issue of the
    busiest sub-partition (warps over four, stages, columns, the register
    tile's FMAs and loads), the partial sums' shared-memory traffic, the
    ring's waits and copies a stage and the first stage's copy; with R
    resident whenever some split fits.  FMA issue is taken at full rate
    from 4 warps a sub-partition up and at 0.1 less for each warp fewer.
    The forward runs at most 512 threads (128 registers each), the backward
    640.  ``kg`` / ``sc`` force the split (for measurements)."""
    if kind not in ("fwd", "bwd"):
        raise MXNetError("lstm_plan: kind is 'fwd' or 'bwd', got %r" % (kind,))
    if not (1 <= H <= MAX_HIDDEN and 1 <= B <= MAX_BATCH):
        raise MXNetError("lstm_plan: the kernels cover H <= %d and B <= %d, "
                         "got H=%d B=%d" % (MAX_HIDDEN, MAX_BATCH, H, B))
    fwd = kind == "fwd"
    force_kg, force_sc = kg, sc
    halves = 2 if B >= 64 else 1
    rows = _r4(-(-B // halves))
    if fwd:
        parts = 1
        units = -(-H * halves // sms)
    else:
        parts = 4
        per_half = sms // (4 * halves)
        if per_half < 1:
            raise MXNetError("lstm_plan: %d SMs hold no group of four "
                             "blocks a half" % sms)
        units = -(-H // per_half)
    groups = -(-H // units)
    TR, TC = _tile(kind)
    uq = -(-units // 4)
    best = None
    tile = min(-(-rows // TR) * TR, 64)
    for tile in range(tile, 0, -TR):
        ntiles = -(-rows // tile)
        for kg in (range(1, _MAX_KG + 1) if force_kg is None else (force_kg,)):
            NCP, items, _ = _dims(kind, units, tile, kg, 1, H)
            threads = -(-kg * items // 32) * 32
            need = units * tile if fwd else uq * 4     # pairs in registers
            threads = max(threads, -(-need // (_MAXPP * 32)) * 32)
            if threads > _MAX_THREADS[kind]:
                break
            chunk = tile if fwd else min(rows, _MAXPP * threads // uq // 4 * 4)
            sub = -(-threads // 128)      # warps of the busiest sub-partition
            for sc in (range(1, 65) if force_sc is None else (force_sc,)):
                nst = -(-H // (kg * sc))
                if force_sc is None and sc > 1 and (nst - 1) * kg * sc >= H:
                    continue
                # FMA issue, at 4 warps a sub-partition and more to hide
                # latency; the partial sums; a stage's waits; the first stage
                fma = (sub * nst * sc * (TR * TC + TR // 4 + TC // 4 + 2)
                       / min(1.0, 0.6 + 0.1 * sub))
                cost = ntiles * (fma + kg * NCP * tile // 16 + 150 * nst
                                 + kg * sc * tile // 16)
                for resident in (1, 0):
                    smem = _smem_bytes(kind, units, tile, kg, sc, chunk,
                                       resident, H)
                    if smem > smem_optin:
                        continue
                    key = (-resident, cost, smem)
                    if best is None or key < best[0]:
                        best = (key, LstmPlan(halves, groups, parts, units,
                                              rows, tile, kg, sc, chunk,
                                              threads, resident, smem))
    if best is None:
        raise MXNetError("lstm_plan: no %s plan fits B=%d H=%d in %d bytes of "
                         "shared memory" % (kind, B, H, smem_optin))
    return best[1]


@functools.lru_cache(maxsize=64)
def _plan_ints(plan: LstmPlan):
    return (ctypes.c_int * len(plan))(*plan)


_OPTIN = {}


def _card_plan(kind, B, H, dev) -> LstmPlan:
    optin = _OPTIN.get(dev.index)
    if optin is None:
        optin = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        _OPTIN[dev.index] = optin
    return lstm_plan(kind, B, H, _sm_count(dev), optin)


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
        # the tensors and the counters, T, B, H, plan, device, stream, launched
        fn.argtypes = ([ctypes.c_void_p] * (12 if name == "lstm_fwd" else 13)
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def geometry(name, B, H, device=0):
    """What kernel ``name`` ("lstm_fwd" or "lstm_bwd") launches at (B, H) on
    a card: the plan's fields, its blocks, and the blocks an SM can hold of
    that kernel as the card reports them (``blocks_per_sm``)."""
    from .. import _build
    dev = torch.device("cuda", device)
    plan = _card_plan(name[5:], B, H, dev)
    fn = getattr(_build.load(name), "mxtt_%s_occupancy" % name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    err = fn(ctypes.addressof(_plan_ints(plan)), device, ctypes.byref(per_sm))
    if err != 0:
        raise MXNetError("%s occupancy: CUDA error %d" % (name, err))
    return dict(plan._asdict(), blocks=plan.blocks, blocks_per_sm=per_sm.value)


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


def _launch(name, args, dev, T, B, H, plan):
    launched = ctypes.c_int(0)
    err = _kernel(name)(*args, T, B, H, ctypes.addressof(_plan_ints(plan)),
                        dev.index, _stream(dev), ctypes.byref(launched))
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
    plan = _card_plan("fwd", B, H, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ys = torch.empty((T, B, H), **f32)
    gates = torch.empty((T, B, H4), **f32)
    cs = torch.empty((T, B, H), **f32)
    hT = torch.empty((B, H), **f32)
    cT = torch.empty((B, H), **f32)
    # the (2, H, Bp) ping-pong buffer of h, then a counter a half
    nh = 2 * H * _r4(B)
    scratch = torch.empty(nh + plan.halves, **f32)
    ptrs = [t.data_ptr() for t in (xp, h0, c0, R, bR, ys, gates, cs, hT, cT,
                                   scratch)]
    err, n = _launch("lstm_fwd", ptrs + [scratch.data_ptr() + 4 * nh], dev,
                     T, B, H, plan)
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
    plan = _card_plan("bwd", B, H, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dxp = torch.empty((T, B, H4), **f32)
    dh0 = torch.empty((B, H), **f32)
    dc0 = torch.empty((B, H), **f32)
    # the (2, 4H, Bp) exchange of d_pre^T, the groups' partial dh_next, then
    # the counters
    nd = 2 * H4 * _r4(B)
    npart = plan.blocks * plan.units * plan.rows
    scratch = torch.empty(nd + npart + plan.halves * (1 + plan.groups), **f32)
    ptrs = [t.data_ptr() for t in (gates, cs, c0, dys, dhT, dcT, R, dxp, dh0,
                                   dc0, scratch)]
    base = scratch.data_ptr()
    err, n = _launch("lstm_bwd",
                     ptrs + [base + 4 * nd, base + 4 * (nd + npart)], dev,
                     T, B, H, plan)
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
