"""Port conv (mxnet_tpu_torch.ops.hopper_conv) vs the Pallas conv kernels of
mxnet_tpu.ops.pallas_conv, on the CPU, forward and backward.

Same inputs, made with numpy from a seed, go through both; fp32, rtol =
atol = 1e-4.  On the CPU the port runs its plain version (a per-tap loop of
fp32 matmuls), so these tests hold the layout work around the CUDA kernel
(NHWC views, the tap rewrite, the space-to-depth rewrite and its pads) to
the reference.  The kernel itself is held to the plain version by the
``cuda`` test below, which skips without a card, and by chip_smoke.py.

The installed jax no longer has ``pl.unblocked``, so ``pallas_call`` of
``_conv_s1`` fails even in interpret mode (tests/test_pallas_conv.py fails
the same way).  The reference side therefore runs the kernel the way
interpret mode would: the reference's own frame plan and row-frame
flattening, then its kernel body ``_taps_kernel`` once per grid step on the
element-indexed input slab, with the output blocks stitched as
``_conv_s1`` does.  The wgrad kernel ``_wgrad_kernel`` does run in
interpret mode when its input slab is given as ``pl.Element`` (which this
jax has) instead of ``pl.unblocked``, so the reference side of the wgrad
test is a ``pallas_call`` built here around the reference's own kernel
body, frame plan, row-frame flattening and cotangent framing.  Tolerance
of the wgrad: 1e-4 of the largest |dw|.

bf16 (the mixed-precision training step): kernel 2's bf16 arm against the
same Pallas wgrad run on bf16 inputs, and kernel 12, the 1x1 weight
gradient of ``tools/probe_conv_fixes.py:173``, whose body the probe defines
inside ``main()`` and which is therefore rebuilt here as written and run as
a ``pallas_call`` in interpret mode on the probe's strided rows.  bf16
products are exact in fp32, so these agree within 1e-5 of the largest
|dw| (fp32 sums in another order).  ``conv1x1``'s forward and both
gradients against ``jax.vjp`` of XLA's convolution in bf16: both round one
fp32 sum to bf16, so within one bf16 step of each value (2^-7 relative)
plus 1e-3 of the largest |value|.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import mxnet_tpu  # noqa: F401  (registers ops)
from mxnet_tpu.ops import pallas_conv as pc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import bf16_from_numpy
from mxnet_tpu_torch.ops import hopper_conv as hc
from mxnet_tpu_torch.ops import nn as tnn

RTOL = ATOL = 1e-4
BF16_WGRAD_TOL = 1e-5      # of the largest |dw|: exact products, fp32 sums
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3


class _Ref:
    """A Pallas ref over an array: ``pl.ds`` windows read, ``[:]`` writes."""

    def __init__(self, value=None, dtype=None):
        self.value = value
        self.dtype = value.dtype if dtype is None else dtype

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return self.value[tuple(slice(i.start, i.start + i.size)
                                if isinstance(i, type(pl.ds(0, 1))) else i
                                for i in idx)]

    def __setitem__(self, idx, v):
        self.value = v


def _pallas_conv_s1(x, w_taps, pads, KH, KW):
    """``pc._conv_s1`` with its grid run step by step (see module doc)."""
    N, H, W, C = x.shape
    O = w_taps.shape[-1]
    p = pc._plan(N, H, W, C, O, KH, KW, pads, 4)
    xf = pc._flatten_frames(x, pads, p, total=p.total)
    blocks = []
    for g in range(p.G):
        out = _Ref(dtype=x.dtype)
        pc._taps_kernel(_Ref(xf[g * p.TILE:g * p.TILE + p.SLAB]),
                        _Ref(w_taps), out, TILE=p.TILE, WP=p.WP, KH=KH, KW=KW)
        blocks.append(out.value)
    out = jnp.concatenate(blocks)
    return (out.reshape(N, p.L, O)[:, :p.F_out]
            .reshape(N, p.Ho, p.WP, O)[:, :, :p.Wo])


def _pallas_conv3x3_same(x, w):
    """``pc.conv3x3_same``'s forward over the emulated grid."""
    O, C = w.shape[:2]
    taps = w.transpose(2, 3, 1, 0).reshape(9, C, O)
    return pc._nchw(_pallas_conv_s1(pc._nhwc(x), taps, pc._S1_PADS, 3, 3))


def _pallas_conv3x3_s2(x, w):
    """``pc.conv3x3_s2``'s forward over the emulated grid."""
    w4 = pc._s2d_weight(w)
    O, C4 = w4.shape[:2]
    taps = w4.transpose(2, 3, 1, 0).reshape(4, C4, O)
    return pc._nchw(_pallas_conv_s1(pc._nhwc(pc._s2d_data(x)), taps,
                                    pc._S2_PADS, 2, 2))


def _case(N, C, H, W, O, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N, C, H, W)).astype(np.float32)
    w = (r.standard_normal((O, C, 3, 3)) * 0.1).astype(np.float32)
    return x, w


# tests/test_pallas_conv.py's shapes: odd spatial dims, several images
@pytest.mark.parametrize("N,C,H,W,O", [
    (2, 8, 6, 6, 16),
    (4, 16, 5, 7, 8),
    (3, 8, 7, 9, 8),
])
def test_conv3x3_same_matches_pallas(N, C, H, W, O):
    x, w = _case(N, C, H, W, O)
    want = np.asarray(_pallas_conv3x3_same(jnp.asarray(x), jnp.asarray(w)))
    got = hc.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,C,H,W,O", [
    (2, 8, 8, 8, 16),
    (1, 4, 6, 10, 8),
])
def test_conv3x3_s2_matches_pallas(N, C, H, W, O):
    x, w = _case(N, C, H, W, O, seed=1)
    want = np.asarray(_pallas_conv3x3_s2(jnp.asarray(x), jnp.asarray(w)))
    got = hc.conv3x3_s2(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# the served net's stride-2 3x3 shapes at batch 1 and narrow widths, and a
# ragged one: (N, C, H, W, O)
@pytest.mark.parametrize("N,C,H,W,O", [
    (1, 8, 56, 56, 8),
    (1, 16, 28, 28, 16),
    (1, 32, 14, 14, 32),
    (3, 5, 10, 6, 7),
])
def test_native_s2_plain_matches_reference_s2d_form(N, C, H, W, O):
    """The port's stride-2 arm (a 3x3 at stride 2 straight from the input:
    ``taps_conv_plain`` with ``stride=2``, as the kernels run it) against the
    reference's ``conv3x3_s2`` (space-to-depth, then a 2x2 conv over 4C
    channels, its Pallas kernel body run per grid step) on the same seeded
    inputs: fp32 sums in another order, rtol = atol = 1e-4."""
    x, w = _case(N, C, H, W, O, seed=2)
    want = np.asarray(_pallas_conv3x3_s2(jnp.asarray(x), jnp.asarray(w)))
    xt = torch.from_numpy(x).permute(0, 2, 3, 1)
    taps = torch.from_numpy(w).permute(2, 3, 1, 0).reshape(9, C, O)
    got = hc.taps_conv_plain(xt, taps, hc.S1_PADS, 3, 3, 2).permute(0, 3, 1, 2)
    assert got.shape == want.shape == (N, O, H // 2, W // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_conv3x3_s2_rejects_odd_spatial():
    x, w = _case(1, 4, 7, 8, 4)
    with pytest.raises(MXNetError):
        hc.conv3x3_s2(torch.from_numpy(x), torch.from_numpy(w))


def test_plain_is_the_cpu_arm_and_counts_no_launch():
    x, w = _case(1, 4, 5, 5, 4)
    before = hc.launches
    got = hc.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w))
    ref = hc.conv3x3_same_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, ref)
    assert hc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["s1", "s2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(kind, dtype, tol):
    """The CUDA kernel vs its plain version on the same card tensors, odd
    and even spatial dims, a ragged channel count and a ragged tile edge
    (fp32 FMA vs fp32 matmul: 1e-4; bf16 output rounding: 2e-2); bf16 takes
    the tensor-core kernel (``launches_bf16``), also for data at storage
    offset 1 (its element path), there at 28x28 with 128 channels and batch
    128 too, where the plan takes the 128-column tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, plain = ((hc.conv3x3_same, hc.conv3x3_same_plain) if kind == "s1"
                 else (hc.conv3x3_s2, hc.conv3x3_s2_plain))
    shapes = ([(3, 20, 7, 9, 70), (2, 64, 14, 14, 64), (1, 3, 1, 1, 5),
               (5, 33, 11, 13, 129), (3, 24, 7, 9, 40), (2, 3, 5, 5, 8)]
              if kind == "s1"
              else [(3, 20, 8, 6, 70), (2, 64, 14, 14, 64), (1, 3, 2, 2, 5),
                    (5, 33, 12, 10, 129), (2, 8, 10, 10, 16)])
    bf16 = dtype == torch.bfloat16
    if bf16 and kind == "s1":
        shapes.append((128, 128, 28, 28, 128))
    for N, C, H, W, O in shapes:
        x, w = _case(N, C, H, W, O, seed=3)
        xt = torch.from_numpy(x).cuda().to(dtype)
        wt = torch.from_numpy(w).cuda().to(dtype)
        # bf16 also as a channels-last view of NHWC memory at storage offset
        # 1, which reaches the stride-1 kernel without a copy
        datas = [xt] + ([_at_offset_1(xt.permute(0, 2, 3, 1))
                         .permute(0, 3, 1, 2)] if bf16 else [])
        for data in datas:
            before = (hc.launches, hc.launches_bf16)
            got = fn(data, wt).float()
            want = plain(data, wt).float()
            torch.cuda.synchronize()
            assert (hc.launches, hc.launches_bf16) == \
                (before[0] + 1, before[1] + bf16)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_fp32_kernel_each_tile_and_split_on_card(stride):
    """Kernel 1 fp32 at each tile of ``_CONV_FP32_TILES`` and at 1, 2 and
    the plan's own splits, on aligned x (16-byte copies) and on x at
    storage offset 1 (4 bytes off: the 4-byte copy path), at a ragged
    shape and at a 14-px one whose plan splits: within 1e-4 of the plain
    version, bit-equal on a rerun, one convolution launch a call and one
    split-sum launch a call when split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N, H, W, C, O in [(3, 9, 11, 36, 72), (8, 14, 14, 256, 256)]:
        r = np.random.default_rng(5)
        x = torch.from_numpy(
            r.standard_normal((N, H, W, C)).astype(np.float32)).cuda()
        taps = torch.from_numpy(
            (r.standard_normal((9, C, O)) * 0.1).astype(np.float32)).cuda()
        Ho, Wo = hc._out_hw(H, W, 3, 3, hc.S1_PADS, stride)
        M, ks = N * Ho * Wo, _conv_fp32_stages(C)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        own = hc.conv_fp32_plan(M, C, O, 3, 3, sms).splits
        want = hc.taps_conv_plain(x, taps, hc.S1_PADS, 3, 3, stride)
        for data in (x, _at_offset_1(x)):
            ptrs = (data.data_ptr(), taps.data_ptr(), 0)
            for bm, bn, _, _ in hc._CONV_FP32_TILES:
                for splits in sorted({1, 2, own}):
                    if -(-ks // -(-ks // splits)) != splits:
                        continue
                    plan = hc.conv_fp32_plan(M, C, O, 3, 3, sms, ptrs,
                                             tile=(bm, bn), splits=splits)
                    assert plan.vec == (data is x)
                    before = (hc.launches, hc.conv_reduce_launches)
                    got = hc._taps_conv_cuda(data, taps, hc.S1_PADS, 3, 3,
                                             stride, plan=plan)
                    again = hc._taps_conv_cuda(data, taps, hc.S1_PADS, 3, 3,
                                               stride, plan=plan)
                    torch.cuda.synchronize()
                    assert (hc.launches - before[0],
                            hc.conv_reduce_launches - before[1]) == \
                        (2, 2 * (splits > 1))
                    torch.testing.assert_close(got, want, rtol=RTOL,
                                               atol=ATOL)
                    assert torch.equal(got, again)


def _at_offset_1(t):
    """``t``'s values in a contiguous tensor at storage offset 1 (2 bytes
    off a 16-byte boundary in bf16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _pallas_wgrad_s1(x, g, pads, KH, KW):
    """``pc._wgrad_s1`` in interpret mode with the slab as ``pl.Element``;
    returns ((KH*KW, C, O), grid size)."""
    N, H, W, C = x.shape
    O = g.shape[-1]
    p = pc._plan(N, H, W, C, O, KH, KW, pads, 4)
    xf = pc._flatten_frames(x, pads, p, total=p.total)
    gp = jnp.pad(g, ((0, 0), (0, 0), (0, p.WP - p.Wo), (0, 0)))
    gf = jnp.pad(gp.reshape(N, p.F_out, O),
                 ((0, 0), (0, p.L - p.F_out), (0, 0))).reshape(N * p.L, O)
    kern = functools.partial(pc._wgrad_kernel, TILE=p.TILE, WP=p.WP,
                             KH=KH, KW=KW)
    out = pl.pallas_call(
        kern, grid=(p.G,),
        in_specs=[pl.BlockSpec((pl.Element(p.SLAB), C),
                               lambda i, _p=p: (i * _p.TILE, 0)),
                  pl.BlockSpec((p.TILE, O), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((KH * KW, C, O), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((KH * KW, C, O), jnp.float32),
        interpret=True)(xf, gf)
    return np.asarray(out), p.G


@pytest.mark.parametrize("N,H,W,C,O,taps,pads,G", [
    (3, 5, 7, 8, 16, 3, hc.S1_PADS, 3),     # several grid steps, C != O
    (2, 4, 6, 12, 8, 2, hc.S2_PADS, 1),     # space-to-depth form: 2x2 taps
])
def test_wgrad_matches_pallas_kernel(N, H, W, C, O, taps, pads, G):
    r = np.random.default_rng(4)
    x = r.standard_normal((N, H, W, C)).astype(np.float32)
    Ho, Wo = hc._out_hw(H, W, taps, taps, pads)
    g = r.standard_normal((N, Ho, Wo, O)).astype(np.float32)
    want, grid = _pallas_wgrad_s1(jnp.asarray(x), jnp.asarray(g), pads,
                                  taps, taps)
    assert grid == G
    got = hc.taps_wgrad(torch.from_numpy(x), torch.from_numpy(g), pads,
                        taps, taps).numpy()
    assert got.shape == want.shape == (taps * taps, C, O)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                               atol=ATOL)


def _lax_conv(stride):
    def conv(x, w):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ("NCHW", "OIHW", "NCHW"))
        return jax.lax.conv_general_dilated(x, w, (stride, stride),
                                            [(1, 1), (1, 1)],
                                            dimension_numbers=dn)
    return conv


@pytest.mark.parametrize("kind,N,C,H,W,O", [
    ("s1", 2, 8, 6, 7, 16),
    ("s2", 2, 8, 8, 6, 12),
])
def test_conv_backward_matches_jax_vjp(kind, N, C, H, W, O):
    """dx and dw of the autograd Functions against ``jax.vjp`` of XLA's
    convolution (rtol = atol = 1e-4 of the largest element)."""
    x, w = _case(N, C, H, W, O, seed=5)
    fn = hc.conv3x3_same if kind == "s1" else hc.conv3x3_s2
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt)
    gy = np.random.default_rng(6).standard_normal(tuple(y.shape)) \
        .astype(np.float32)
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(gy))
    want_y, vjp = jax.vjp(_lax_conv(1 if kind == "s1" else 2),
                          jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=RTOL, atol=ATOL)
    for got, want in ((dx.numpy(), want_dx), (dw.numpy(), want_dw)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                                   atol=ATOL)


def test_dgrad_matches_pallas_taps_kernel_on_flipped_taps():
    """The stride-1 data gradient is the forward kernel on the cotangent
    with flipped, io-swapped taps (``_c3s_bwd``): the reference kernel body
    on the reference's taps gives the port's dx."""
    N, C, H, W, O = 2, 8, 5, 7, 16
    x, w = _case(N, C, H, W, O, seed=7)
    gy = np.random.default_rng(8).standard_normal((N, O, H, W)) \
        .astype(np.float32)
    taps_d = (jnp.flip(jnp.asarray(w), (2, 3)).transpose(2, 3, 0, 1)
              .reshape(9, O, C))
    want = np.asarray(pc._nchw(_pallas_conv_s1(pc._nhwc(jnp.asarray(gy)),
                                               taps_d, pc._S1_PADS, 3, 3)))
    np.testing.assert_array_equal(hc.dgrad_taps(torch.from_numpy(w)).numpy(),
                                  np.asarray(taps_d))
    xt = torch.from_numpy(x).requires_grad_()
    y = hc.conv3x3_same(xt, torch.from_numpy(w))
    dx, = torch.autograd.grad(y, [xt], torch.from_numpy(gy))
    np.testing.assert_allclose(dx.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wgrad_kernel_matches_plain_on_card():
    """The wgrad kernels vs their plain version on the same card tensors:
    ragged channel counts, odd spatial dims, rows off the 16- and 32-row
    stages, one split and many, both fp32 tiles, data at storage offset 1
    (the element paths; fp32 sums in another order: 1e-4 of the largest
    |dw|); each call launches the partial pass once and the reduction pass
    once if it splits the rows, in bf16 on the tensor-core kernel, and a
    rerun gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for N, C, H, W, O in [(3, 20, 7, 9, 70), (1, 3, 1, 1, 5),
                              (5, 33, 11, 13, 129), (32, 64, 14, 14, 64),
                              (32, 512, 7, 7, 512), (3, 24, 7, 9, 40),
                              (5, 24, 33, 31, 40), (4, 136, 9, 11, 72)]:
            r = np.random.default_rng(9)
            x = torch.from_numpy(r.standard_normal((N, H, W, C))
                                 .astype(np.float32)).cuda().to(dtype)
            g = torch.from_numpy(r.standard_normal((N, H, W, O))
                                 .astype(np.float32)).cuda().to(dtype)
            if C == 24:
                x = _at_offset_1(x)
            before = (hc.wgrad_launches, hc.wgrad_reduce_launches,
                      hc.wgrad_launches_bf16, hc.wgrad_reduce_launches_bf16)
            got = hc.taps_wgrad(x, g, hc.S1_PADS, 3, 3)
            want = hc.taps_wgrad_plain(x, g, hc.S1_PADS, 3, 3)
            torch.cuda.synchronize()
            split = (hc.wgrad_bf16_plan(N * H * W, C, O, 3, 3, sms)
                     if bf16 else hc.wgrad_fp32_plan(N * H * W, C, O, 3, 3,
                                                     sms)).splits > 1
            assert (hc.wgrad_launches, hc.wgrad_reduce_launches,
                    hc.wgrad_launches_bf16, hc.wgrad_reduce_launches_bf16) \
                == (before[0] + 1, before[1] + split, before[2] + bf16,
                    before[3] + (bf16 and split))
            err = (got - want).abs().max().item() / want.abs().max().item()
            assert err <= 1e-4, (dtype, N, C, H, W, O, err)
            assert torch.equal(got, hc.taps_wgrad(x, g, hc.S1_PADS, 3, 3))


# --------------------------------------------------------------------------
# bf16: kernel 2's bf16 arm and kernel 12 (the 1x1 weight gradient)
# --------------------------------------------------------------------------
def _bf16(a):
    """(jax bf16 array, the same bits as a torch bf16 tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, bf16_from_numpy(np.asarray(j))


def test_wgrad_bf16_matches_pallas_kernel():
    """Kernel 2's plain arm on bf16 x and dy (widened to fp32, fp32 out)
    against the reference's Pallas wgrad on the same bf16 inputs."""
    N, H, W, C, O = 3, 5, 7, 8, 16
    r = np.random.default_rng(14)
    xj, xt = _bf16(r.standard_normal((N, H, W, C)))
    gj, gt = _bf16(r.standard_normal((N, H, W, O)))
    want, _ = _pallas_wgrad_s1(xj, gj, hc.S1_PADS, 3, 3)
    got = hc.taps_wgrad(xt, gt, hc.S1_PADS, 3, 3)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=BF16_WGRAD_TOL)


def _probe_wgrad_kernel(x_ref, g_ref, o_ref):
    """The kernel body of ``tools/probe_conv_fixes.py:164-169``, as
    written there."""
    @pl.when(pl.program_id(0) == 0)
    def _():
        o_ref[:] = jnp.zeros_like(o_ref)
    o_ref[:] += jax.lax.dot_general(
        x_ref[:], g_ref[:], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _probe_wgrad(x_rows, g_rows, TR):
    """The probe's ``pallas_call`` (``probe_conv_fixes.py:171-180``) over
    (R, C) and (R, O) bf16 rows in TR-row tiles, in interpret mode; its
    fp32 output, before the probe's cast to bf16."""
    R, Cs = x_rows.shape
    Cl = g_rows.shape[1]
    return np.asarray(pl.pallas_call(
        _probe_wgrad_kernel, grid=(R // TR,),
        in_specs=[pl.BlockSpec((TR, Cs), lambda i: (i, 0)),
                  pl.BlockSpec((TR, Cl), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((Cs, Cl), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((Cs, Cl), jnp.float32),
        interpret=True)(x_rows, g_rows))


@pytest.mark.parametrize("stride,N,H,W,C,O,TR", [
    (1, 2, 8, 8, 16, 24, 32),      # 4 grid steps
    (2, 2, 8, 6, 16, 24, 8),       # the probe's x[:, ::2, ::2] rows
])
def test_conv1x1_wgrad_plain_matches_probe_kernel(stride, N, H, W, C, O,
                                                  TR):
    r = np.random.default_rng(15)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xj, xt = _bf16(r.standard_normal((N, H, W, C)) * 0.1)
    gj, gt = _bf16(r.standard_normal((N, Ho, Wo, O)) * 0.1)
    want = _probe_wgrad(xj[:, ::stride, ::stride, :].reshape(-1, C),
                        gj.reshape(-1, O), TR)
    before = hc.conv1x1_wgrad_launches
    got = hc.conv1x1_wgrad(xt, gt, stride)
    assert hc.conv1x1_wgrad_launches == before
    assert got.dtype == torch.float32 and got.shape == (C, O)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=BF16_WGRAD_TOL)


def _lax_conv1x1(stride):
    def conv(x, w):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ("NCHW", "OIHW", "NCHW"))
        return jax.lax.conv_general_dilated(x, w, (stride, stride),
                                            [(0, 0), (0, 0)],
                                            dimension_numbers=dn)
    return conv


def _assert_bf16_close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    atol = BF16_ATOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("stride,N,C,H,W,O", [
    (1, 2, 8, 6, 7, 16),
    (2, 2, 8, 8, 6, 12),
])
def test_conv1x1_matches_jax_vjp_in_bf16(stride, N, C, H, W, O):
    """``conv1x1`` (cuDNN forward and dgrad, kernel 12's plain arm for the
    weight gradient) against ``jax.vjp`` of XLA's bf16 convolution."""
    r = np.random.default_rng(16)
    xj, xt = _bf16(r.standard_normal((N, C, H, W)))
    wj, wt = _bf16(r.standard_normal((O, C, 1, 1)) * 0.3)
    want_y, vjp = jax.vjp(_lax_conv1x1(stride), xj, wj)
    gj, gt = _bf16(r.standard_normal(want_y.shape))
    want_dx, want_dw = vjp(gj)
    xt.requires_grad_()
    wt.requires_grad_()
    y = hc.conv1x1(xt, wt, stride)
    dx, dw = torch.autograd.grad(y, [xt, wt], gt)
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    for got, want, what in ((y.detach(), want_y, "y"), (dx, want_dx, "dx"),
                            (dw, want_dw, "dw")):
        assert tuple(got.shape) == tuple(want.shape)
        _assert_bf16_close(got, want, what)


def _conv_attrs(kernel, stride):
    from mxnet_tpu_torch.ops import get_op
    return get_op("Convolution").parse_attrs({
        "kernel": str(kernel), "stride": str(stride), "num_filter": "8",
        "pad": "(1, 1)" if kernel == (3, 3) else "(0, 0)", "no_bias": "True"})


@pytest.mark.parametrize("dtype,kernel,stride,hw,mode", [
    (torch.bfloat16, (1, 1), (1, 1), 6, "1x1"),
    (torch.bfloat16, (1, 1), (2, 2), 6, "1x1"),
    (torch.bfloat16, (1, 1), (2, 2), 7, None),     # odd H, W at stride 2
    (torch.float32, (1, 1), (1, 1), 6, None),      # fp32 1x1s stay on cuDNN
    (torch.bfloat16, (3, 3), (1, 1), 6, "s1"),
])
def test_conv_dispatch_takes_kernel_12_for_bf16_1x1(dtype, kernel, stride,
                                                    hw, mode):
    attrs = _conv_attrs(kernel, stride)
    data = torch.zeros((1, 8, hw, hw), dtype=dtype)
    assert tnn.hopper_conv_mode(attrs, data) == mode


def test_conv1x1_wgrad_cuda_arm_raises_on_limits():
    """The CUDA arm's checks run before any launch: a dtype or channel
    count outside the kernel's envelope raises, naming the limit."""
    x = torch.zeros((1, 4, 4, 12), dtype=torch.bfloat16)
    g = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="multiples of 8"):
        hc._conv1x1_wgrad_cuda(x, g, 1)
    with pytest.raises(MXNetError, match="bfloat16"):
        hc._conv1x1_wgrad_cuda(x.float(), g.float(), 1)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        hc._taps_wgrad_cuda(x.half(), g.half(), hc.S1_PADS, 3, 3)


@pytest.mark.cuda
def test_conv1x1_wgrad_kernel_matches_plain_on_card():
    """Kernel 12 vs its plain version on the same card tensors: rows off
    the tile, C = 8, odd spatial dims at stride 2, one split and many, each
    of its four tiles, x at storage offset 1 (the element path; 1e-4 of the
    largest |dw|); each call launches the partial pass once and the
    reduction pass once when its plan leaves more than one partial (a
    cluster of 2 splits sums its tiles on chip into one), and a rerun gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r = np.random.default_rng(17)
    for N, H, W, C, O, s in [(3, 7, 9, 24, 40, 1), (5, 10, 10, 8, 16, 1),
                             (3, 7, 9, 24, 40, 2), (16, 14, 14, 256, 1024, 1),
                             (8, 14, 14, 512, 256, 2), (4, 11, 13, 64, 256, 2),
                             (6, 12, 12, 256, 64, 1)]:
        Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
        x = torch.from_numpy(r.standard_normal((N, H, W, C))
                             .astype(np.float32)).cuda().bfloat16()
        g = torch.from_numpy(r.standard_normal((N, Ho, Wo, O))
                             .astype(np.float32)).cuda().bfloat16()
        for xin in (x, _at_offset_1(x)):
            before = (hc.conv1x1_wgrad_launches,
                      hc.conv1x1_wgrad_reduce_launches)
            got = hc.conv1x1_wgrad(xin, g, s)
            want = hc.conv1x1_wgrad_plain(xin, g, s)
            torch.cuda.synchronize()
            split = hc.conv1x1_wgrad_plan(
                N * Ho * Wo, C, O, sms).workspace is not None
            assert (hc.conv1x1_wgrad_launches,
                    hc.conv1x1_wgrad_reduce_launches) == \
                (before[0] + 1, before[1] + split)
            err = (got - want).abs().max().item() / want.abs().max().item()
            assert err <= 1e-4, (N, H, W, C, O, s, err)
            assert torch.equal(got, hc.conv1x1_wgrad(xin, g, s))


# --------------------------------------------------------------------------
# the bf16 tensor-core kernels (taps_conv_bf16.cu, taps_wgrad_bf16.cu): the
# host plans, a plain walk of the wgrad plan against the reference's Pallas
# wgrad, and the dtype routing of the CUDA arms
# --------------------------------------------------------------------------
H100_SMS = 132
# the 4 Gluon ResNet-50 v1 3x3 shapes at batch 128: (C = O, H = W), and each
# one's (conv tile BN, wgrad splits, rows a split) on 132 SMs
GLUON_BF16_PLANS = [((64, 56), (64, 131, 3072)), ((128, 28), (128, 33, 3072)),
                    ((256, 14), (128, 8, 3136)), ((512, 7), (64, 2, 3136))]
# ragged: (N, H, W, C, O)
RAGGED_BF16 = [(3, 7, 9, 24, 40), (2, 5, 5, 3, 8), (5, 33, 31, 24, 40),
               (1, 1, 1, 3, 5), (5, 11, 13, 33, 129)]


@pytest.mark.parametrize("shape,want", GLUON_BF16_PLANS)
def test_bf16_plans_at_the_gluon_shapes(shape, want):
    """Tile and split at the main path's shapes on 132 SMs (3 blocks an SM
    of the 128 x 64 tile and of the wgrad block, 2 of the 128 x 128 tile):
    the 128 x 64 tile where O = 64 and where the larger one leaves most of
    its one wave empty (7x7), the wgrad's splits filling one wave, each at
    least 8 stages of 32 rows."""
    C, H = shape
    M = 128 * H * H
    conv = hc.conv_bf16_plan(M, C, C, H100_SMS)
    assert conv.bn == want[0] and conv.vec
    assert conv.grid == (M // 128, C // conv.bn)
    plan = hc.wgrad_bf16_plan(M, C, C, 3, 3, H100_SMS)
    assert (plan.splits, plan.rows) == want[1:]
    assert plan.grid == ((C // 64) ** 2, 3, plan.splits)
    assert plan.grid[0] * plan.grid[1] * plan.splits <= 3 * H100_SMS
    assert plan.workspace == (plan.splits, 9, C, C)


@pytest.mark.parametrize("N,H,W,C,O", RAGGED_BF16)
@pytest.mark.parametrize("KH,KW", [(3, 3), (2, 2), (1, 5)])
def test_bf16_wgrad_plan_deals_every_row_once(N, H, W, C, O, KH, KW):
    """Every row in exactly one split, every split with rows, rows dealt in
    whole 32-row stages, every tap in exactly one block row of the grid,
    and a workspace only when the rows are split."""
    M = N * H * W
    plan = hc.wgrad_bf16_plan(M, C, O, KH, KW, H100_SMS)
    assert plan.rows % 32 == 0 and plan.splits >= 1
    owner = np.zeros(M, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.rows, min((s + 1) * plan.rows, M)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert plan.grid[0] == -(-C // 64) * -(-O // 64)
    taps = [dh * KW + dw0 + t for dh in range(KH) for dw0 in range(0, KW, 3)
            for t in range(min(3, KW - dw0))]
    assert plan.grid[1] == KH * -(-KW // 3)
    assert sorted(taps) == list(range(KH * KW))
    assert plan.workspace == ((plan.splits, KH * KW, C, O)
                              if plan.splits > 1 else None)
    conv = hc.conv_bf16_plan(M, C, O, H100_SMS)
    assert conv.bn in (64, 128)
    assert conv.grid == (-(-M // 128), -(-O // conv.bn))
    assert conv.vec == (C % 8 == 0 and O % 8 == 0)


def test_bf16_load_path_follows_alignment():
    """16-byte copies only for C and O multiples of 8 on 16-byte aligned
    operands; anything else takes the element path of the same kernel,
    at the tile the plan picks for the shape (the 128-column one at 28x28
    with 128 channels and batch 128)."""
    assert hc.bf16_vec_path(64, 64, 0, 256, 4096)
    assert not hc.bf16_vec_path(64, 64, 2, 256)
    assert not hc.bf16_vec_path(24, 44, 0, 0)
    assert not hc.bf16_vec_path(3, 8)
    assert not hc.conv_bf16_plan(100, 64, 64, H100_SMS, (0, 2, 16)).vec
    M = 128 * 28 * 28
    aligned = hc.conv_bf16_plan(M, 128, 128, H100_SMS, (0, 256, 4096))
    offset = hc.conv_bf16_plan(M, 128, 128, H100_SMS, (2, 256, 4096))
    assert (aligned.bn, aligned.vec, offset.bn, offset.vec) == \
        (128, True, 128, False)


def _split_sum(parts):
    """The fixed order of ``csrc/split_sum.cuh`` over (splits, ...)
    partials: up to 8 contiguous groups of splits, each summed in split
    order from zero, then the group sums in group order."""
    splits = parts.shape[0]
    groups = min(splits, 8)
    per = -(-splits // groups)
    sums = []
    for grp in range(groups):
        acc = torch.zeros_like(parts[0])
        for k in range(grp * per, min(splits, (grp + 1) * per)):
            acc = acc + parts[k]
        sums.append(acc)
    out = sums[0]
    for acc in sums[1:]:
        out = out + acc
    return out


def _walk_wgrad_bf16_plan(x, dy, pads, KH, KW, plan):
    """The bf16 wgrad kernel's arithmetic in plain PyTorch: for each split
    of the plan, each tap's input rows gathered by the kernel's own index
    math (pixel of row m, shifted by the tap, zero off the image), the fp32
    partial x_tapᵀ @ dy over the split's rows, then the partials summed in
    the split sum's order."""
    N, H, W, C = x.shape
    O = dy.shape[-1]
    Ho, Wo = hc._out_hw(H, W, KH, KW, pads)
    M = N * Ho * Wo
    (pt, _), (pl, _) = pads
    xf, g = x.float(), dy.reshape(M, O).float()
    parts = torch.zeros((plan.splits, KH * KW, C, O))
    for s in range(plan.splits):
        m = torch.arange(s * plan.rows, min((s + 1) * plan.rows, M))
        n, rem = m // (Ho * Wo), m % (Ho * Wo)
        for tap in range(KH * KW):
            hi = rem // Wo + tap // KW - pt
            wi = rem % Wo + tap % KW - pl
            ok = (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)
            rows = xf[n, hi.clamp(0, H - 1), wi.clamp(0, W - 1)]
            rows = rows * ok[:, None]
            parts[s, tap] = rows.t() @ g[m]
    return _split_sum(parts)


@pytest.mark.parametrize("N,H,W,C,O,taps,pads", [
    (3, 14, 14, 8, 16, 3, hc.S1_PADS),      # 588 rows: 3 splits, ragged last
    (2, 6, 8, 12, 8, 2, hc.S2_PADS),        # space-to-depth form: 2x2 taps
])
def test_wgrad_bf16_plan_walk_matches_pallas_kernel(N, H, W, C, O, taps,
                                                    pads):
    """The plain walk of the bf16 wgrad plan (row ranges, halo, split order)
    against the reference's Pallas wgrad on the same bf16 inputs, within
    1e-5 of the largest |dw|, as test_wgrad_bf16_matches_pallas_kernel."""
    r = np.random.default_rng(19)
    Ho, Wo = hc._out_hw(H, W, taps, taps, pads)
    xj, xt = _bf16(r.standard_normal((N, H, W, C)))
    gj, gt = _bf16(r.standard_normal((N, Ho, Wo, O)))
    plan = hc.wgrad_bf16_plan(N * Ho * Wo, C, O, taps, taps, H100_SMS)
    assert plan.splits == (3 if taps == 3 else 1)
    want, _ = _pallas_wgrad_s1(xj, gj, pads, taps, taps)
    got = _walk_wgrad_bf16_plan(xt, gt, pads, taps, taps, plan)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=BF16_WGRAD_TOL)


# --------------------------------------------------------------------------
# the redesigned fp32 wgrad (taps_wgrad.cu) and kernel 12 (conv1x1_wgrad.cu):
# their host plans, and plain walks of them against the reference kernels
# --------------------------------------------------------------------------
# the 4 Gluon ResNet-50 v1 3x3 shapes, (C = O, H = W)
GLUON_3X3 = [(64, 56), (128, 28), (256, 14), (512, 7)]
# ResNet-50 v1's 15 1x1 shapes of a training step, (C, O, output H = W,
# stride)
RESNET50_1X1 = [(64, 64, 56, 1), (64, 256, 56, 1), (256, 64, 56, 1),
                (256, 128, 28, 2), (256, 512, 28, 2), (128, 512, 28, 1),
                (512, 128, 28, 1), (512, 256, 14, 2), (512, 1024, 14, 2),
                (256, 1024, 14, 1), (1024, 256, 14, 1), (1024, 512, 7, 2),
                (1024, 2048, 7, 2), (512, 2048, 7, 1), (2048, 512, 7, 1)]


def _assert_deals_every_row_once(M, splits, rows, stage, cluster=1):
    """Every row in exactly one split, rows in whole stages, every split
    with rows but a cluster's last, which may pad the splits to a whole
    number of clusters."""
    assert rows % stage == 0 and splits >= 1 and splits % cluster == 0
    owner = np.zeros(M, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min((s + 1) * rows, M)
        assert lo < hi or (cluster > 1 and s == splits - 1)
        owner[lo:hi] += 1
    assert (owner == 1).all()


@pytest.mark.parametrize("batch", [32, 128])
@pytest.mark.parametrize("C,H", GLUON_3X3)
def test_fp32_wgrad_plan_deals_every_row_once(C, H, batch):
    """At the main path's shapes: every row in exactly one split, every
    split with rows and at least 8 whole 16-row stages, the 64-channel tile
    with 3 taps a block only where the channels are 64, at least a block
    for every SM, and a workspace only when the rows are split."""
    M = batch * H * H
    plan = hc.wgrad_fp32_plan(M, C, C, 3, 3, H100_SMS, (0, 256))
    _assert_deals_every_row_once(M, plan.splits, plan.rows, 16)
    assert plan.splits == 1 or plan.rows >= 8 * 16
    assert plan.tile == (64 if C == 64 else 128) and plan.vec
    taps = 3 if plan.tile == 64 else 1
    assert plan.grid == ((C // plan.tile) ** 2, 3 * (3 // taps), plan.splits)
    assert plan.workspace == ((plan.splits, 9, C, C) if plan.splits > 1
                              else None)
    # not under one wave at 2 blocks an SM, where the rows allow it
    assert plan.grid[0] * plan.grid[1] * plan.splits >= H100_SMS


@pytest.mark.parametrize("N,H,W,C,O", RAGGED_BF16 + [(2, 5, 7, 72, 130)])
@pytest.mark.parametrize("KH,KW", [(3, 3), (2, 2), (1, 5)])
def test_fp32_wgrad_plan_deals_every_tap_and_row_once(N, H, W, C, O, KH, KW):
    """Ragged shapes: every row in exactly one split, every (tap, channel
    tile) in exactly one block of the grid, 16-byte copies only for C and
    O multiples of 4 on aligned operands."""
    M = N * H * W
    plan = hc.wgrad_fp32_plan(M, C, O, KH, KW, H100_SMS)
    _assert_deals_every_row_once(M, plan.splits, plan.rows, 16)
    taps = 3 if plan.tile == 64 else 1
    assert plan.tile == (64 if min(C, O) <= 64 else 128)
    seen = np.zeros((KH * KW, -(-C // plan.tile), -(-O // plan.tile)), int)
    ctiles = -(-C // plan.tile)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            dh, dw0 = by // -(-KW // taps), (by % -(-KW // taps)) * taps
            for t in range(min(taps, KW - dw0)):
                seen[dh * KW + dw0 + t, bx % ctiles, bx // ctiles] += 1
    assert (seen == 1).all()
    assert plan.vec == (C % 4 == 0 and O % 4 == 0)
    assert not hc.wgrad_fp32_plan(M, C, O, KH, KW, H100_SMS, (4, 0)).vec


@pytest.mark.parametrize("C,O,H,stride", RESNET50_1X1)
def test_conv1x1_wgrad_plan_deals_every_row_once(C, O, H, stride):
    """At the 15 1x1 shapes of a batch-128 step: every row in exactly one
    split, every split at least 4 whole 64-row stages, one wave of one
    block an SM, split rows in clusters of 2 (half as many partials), the
    64 x 256 / 256 x 64 tiles at the 64 <-> 256 layers (x and g read once)
    and 256 x 128 / 128 x 256, the 256 along the wider side, where both
    sides are wider."""
    M = 128 * H * H
    plan = hc.conv1x1_wgrad_plan(M, C, O, H100_SMS, (0, 256))
    assert plan.cluster == (2 if plan.splits > 1 else 1)
    _assert_deals_every_row_once(M, plan.splits, plan.rows, 64, plan.cluster)
    assert plan.splits == 1 or plan.rows >= 4 * 64
    want = {(64, 64): (64, 64), (64, 256): (64, 256), (256, 64): (256, 64)}
    assert plan.tile == want.get((C, O), (256, 128) if C >= O
                                 else (128, 256)) and plan.vec
    tiles = (C // plan.tile[0]) * (O // plan.tile[1])
    assert plan.grid == (tiles, plan.splits)
    # one wave of one block an SM, less what whole stages round away
    assert H100_SMS // 2 < tiles * plan.splits <= H100_SMS \
        or plan.splits == 1
    assert plan.workspace == ((plan.splits // 2, C, O) if plan.splits > 2
                              else None)


def test_conv1x1_wgrad_plan_at_ragged_and_misaligned_inputs():
    """Rows off the stage and few rows: still every row once; a misaligned
    operand takes the element path."""
    for M in (1, 31, 65, 765, 5000):
        for C, O in ((8, 8), (24, 40), (136, 72), (64, 512), (512, 136)):
            plan = hc.conv1x1_wgrad_plan(M, C, O, H100_SMS)
            _assert_deals_every_row_once(M, plan.splits, plan.rows, 64,
                                         plan.cluster)
    assert not hc.conv1x1_wgrad_plan(100, 64, 64, H100_SMS, (2, 16)).vec


def _walk_wgrad_fp32_plan(x, dy, pads, KH, KW, plan):
    """The fp32 wgrad kernel's arithmetic in plain PyTorch, block by block
    of the plan's grid: for each split, channel tile and group of taps, the
    tap's input rows gathered by the kernel's index math (pixel of row m,
    shifted by the tap, zero off the image), the partial x_tapᵀ @ dy over the
    split's rows and the tile's channels; every output element written by
    exactly one block of each split; then the split sum."""
    N, H, W, C = x.shape
    O = dy.shape[-1]
    Ho, Wo = hc._out_hw(H, W, KH, KW, pads)
    M = N * Ho * Wo
    (pt, _), (pl, _) = pads
    T = plan.tile
    taps = 3 if T == 64 else 1
    groups, ctiles = -(-KW // taps), -(-C // T)
    parts = torch.full((plan.splits, KH * KW, C, O), float("nan"))
    for s in range(plan.grid[2]):
        m = torch.arange(s * plan.rows, min((s + 1) * plan.rows, M))
        n, rem = m // (Ho * Wo), m % (Ho * Wo)
        g = dy.reshape(M, O)[m]
        for bx in range(plan.grid[0]):
            c0, o0 = (bx % ctiles) * T, (bx // ctiles) * T
            for by in range(plan.grid[1]):
                dh, dw0 = by // groups, (by % groups) * taps
                for tap in range(dh * KW + dw0, dh * KW + min(KW, dw0 + taps)):
                    hi = rem // Wo + tap // KW - pt
                    wi = rem % Wo + tap % KW - pl
                    ok = (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)
                    rows = x[n, hi.clamp(0, H - 1), wi.clamp(0, W - 1),
                             c0:c0 + T] * ok[:, None]
                    assert parts[s, tap, c0:c0 + T, o0:o0 + T].isnan().all()
                    parts[s, tap, c0:c0 + T, o0:o0 + T] = \
                        rows.t() @ g[:, o0:o0 + T]
    assert not parts.isnan().any()
    return _split_sum(parts)


@pytest.mark.parametrize("N,H,W,C,O,taps,pads,splits", [
    (3, 14, 14, 8, 16, 3, hc.S1_PADS, 5),   # 588 rows, ragged last split
    (2, 6, 8, 12, 8, 2, hc.S2_PADS, 1),     # space-to-depth form: 2x2 taps
    (2, 5, 7, 72, 130, 3, hc.S1_PADS, 1),   # 128-channel tiles, 2 of O
])
def test_wgrad_fp32_plan_walk_matches_pallas_kernel(N, H, W, C, O, taps,
                                                    pads, splits):
    """The plain walk of the fp32 wgrad plan (grid, row ranges, halo, split
    sum) against the reference's Pallas wgrad (``_wgrad_kernel`` per grid
    step in interpret mode) on the same fp32 inputs, within 1e-4 of the
    largest |dw|."""
    r = np.random.default_rng(20)
    Ho, Wo = hc._out_hw(H, W, taps, taps, pads)
    x = r.standard_normal((N, H, W, C)).astype(np.float32)
    g = r.standard_normal((N, Ho, Wo, O)).astype(np.float32)
    plan = hc.wgrad_fp32_plan(N * Ho * Wo, C, O, taps, taps, H100_SMS)
    assert plan.splits == splits
    want, _ = _pallas_wgrad_s1(jnp.asarray(x), jnp.asarray(g), pads, taps,
                               taps)
    got = _walk_wgrad_fp32_plan(torch.from_numpy(x), torch.from_numpy(g),
                                pads, taps, taps, plan)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=RTOL,
                               atol=ATOL)


def _walk_conv1x1_wgrad_plan(x, g, stride, plan):
    """Kernel 12's arithmetic in plain PyTorch, block by block of the
    plan's grid: for each split and channel tile, the x rows of the split's
    output pixels (n, i, j) at (n, s*i, s*j), the fp32 partial x_rowsᵀ @
    g_rows over the tile's channels, each output element written once per
    split (zeros for a cluster's empty last split); each cluster's partials
    summed in rank order; then the split sum."""
    N, H, W, C = x.shape
    _, Ho, Wo, O = g.shape
    M = N * Ho * Wo
    bc, bo = plan.tile
    ctiles = -(-C // bc)
    parts = torch.full((plan.splits, C, O), float("nan"))
    for s in range(plan.grid[1]):
        m = torch.arange(min(s * plan.rows, M), min((s + 1) * plan.rows, M))
        n, i, j = m // (Ho * Wo), m % (Ho * Wo) // Wo, m % Wo
        xr = x[n, stride * i, stride * j].float()
        gr = g.reshape(M, O)[m].float()
        for bx in range(plan.grid[0]):
            c0, o0 = (bx % ctiles) * bc, (bx // ctiles) * bo
            assert parts[s, c0:c0 + bc, o0:o0 + bo].isnan().all()
            parts[s, c0:c0 + bc, o0:o0 + bo] = \
                xr[:, c0:c0 + bc].t() @ gr[:, o0:o0 + bo]
    assert not parts.isnan().any()
    cl = plan.cluster
    clustered = torch.zeros((plan.splits // cl, C, O))
    for r in range(cl):
        clustered = clustered + parts[r::cl]
    return _split_sum(clustered)


@pytest.mark.parametrize("stride,N,H,W,C,O,TR,splits", [
    (1, 4, 11, 35, 16, 24, 220, 6),    # 1,540 rows: 5 splits, the last
                                       # ragged, and an empty 6th closing
                                       # the last cluster
    (2, 3, 29, 33, 16, 24, 85, 2),     # the probe's x[:, ::2, ::2] rows
    (1, 2, 8, 8, 136, 72, 32, 1),      # 128 x 128 tiles, 2 of C
    (1, 3, 8, 8, 520, 136, 64, 1),     # 256 x 128 tiles, 3 x 2 of them
])
def test_conv1x1_wgrad_plan_walk_matches_probe_kernel(stride, N, H, W, C, O,
                                                      TR, splits):
    """The plain walk of kernel 12's plan (grid, strided rows, split sum)
    against the probe's Pallas ``wgrad_kernel`` in interpret mode on the
    same bf16 inputs, within 1e-5 of the largest |dw|, as
    test_conv1x1_wgrad_plain_matches_probe_kernel."""
    r = np.random.default_rng(21)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xj, xt = _bf16(r.standard_normal((N, H, W, C)) * 0.1)
    gj, gt = _bf16(r.standard_normal((N, Ho, Wo, O)) * 0.1)
    plan = hc.conv1x1_wgrad_plan(N * Ho * Wo, C, O, H100_SMS)
    assert plan.splits == splits
    want = _probe_wgrad(xj[:, ::stride, ::stride, :].reshape(-1, C),
                        gj.reshape(-1, O), TR)
    got = _walk_conv1x1_wgrad_plan(xt, gt, stride, plan)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=BF16_WGRAD_TOL)


class _FakeKernel:
    """Stands in for a ctypes function: records its arguments, reports the
    launches a real entry point would and returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    #: the positions of ``splits`` and of the splits summed on chip (none:
    #: one) in each wgrad entry point's arguments
    SPLITS_ARG = {"mxtt_taps_conv": (18, None),
                  "mxtt_taps_wgrad": (16, None),
                  "mxtt_taps_wgrad_bf16": (15, None),
                  "mxtt_conv1x1_wgrad": (14, 16)}

    def __call__(self, *args):
        # the wrapper's ctypes signature must take what it passes
        assert len(args) == len(getattr(self, "argtypes", args)), self.name
        self.calls.append((self.name, args))
        if self.name in self.SPLITS_ARG:
            at, cluster_at = self.SPLITS_ARG[self.name]
            cluster = 1 if cluster_at is None else args[cluster_at]
            launched = args[-1]
            launched[0] = 1
            launched[1] = int(args[at] // cluster > 1)
        return 0


class _FakeLib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        fn = _FakeKernel(name, self.calls)
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_kernels(monkeypatch):
    """The conv wrappers' CUDA arms on CPU tensors with the libraries,
    stream and SM count faked: each call records (library, entry, args)."""
    from mxnet_tpu_torch import _build
    calls, loaded = [], []

    def load(name):
        loaded.append(name)
        return _FakeLib(calls)

    monkeypatch.setattr(_build, "load", load)
    for attr in ("_fn", "_wgrad_fn", "_conv_bf16_fn", "_wgrad_bf16_fn",
                 "_w1x1_fn"):
        monkeypatch.setattr(hc, attr, None)
    monkeypatch.setattr(hc, "_stream", lambda device: 0)
    monkeypatch.setattr(hc, "_sm_count", lambda device: H100_SMS)
    for attr in ("launches", "launches_bf16", "conv_reduce_launches",
                 "wgrad_launches",
                 "wgrad_reduce_launches", "wgrad_launches_bf16",
                 "wgrad_reduce_launches_bf16", "conv1x1_wgrad_launches",
                 "conv1x1_wgrad_reduce_launches"):
        monkeypatch.setattr(hc, attr, 0)
    return calls, loaded


def test_cuda_arms_pick_the_library_by_dtype(fake_kernels):
    """bf16 goes to taps_conv_bf16 / taps_wgrad_bf16 with the host plan's
    tile, split and load path; fp32 to implicit_gemm_conv / taps_wgrad with
    their plans' tile, split, rows and load path (the convolution's split
    sum counted apart); the bf16 counters count only the bf16 launches."""
    calls, loaded = fake_kernels
    N, H, C, O = 128, 14, 256, 256
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((N, H, H, C), dtype=dtype)
        taps = torch.zeros((9, C, O), dtype=dtype)
        dy = torch.zeros((N, H, H, O), dtype=dtype)
        assert hc._taps_conv_cuda(x, taps, hc.S1_PADS, 3, 3).dtype == dtype
        assert hc._taps_wgrad_cuda(x, dy, hc.S1_PADS, 3, 3).dtype == \
            torch.float32
    assert loaded == ["taps_conv_bf16", "taps_wgrad_bf16",
                      "implicit_gemm_conv", "taps_wgrad"]
    names = [c[0] for c in calls]
    assert names == ["mxtt_taps_conv_bf16", "mxtt_taps_wgrad_bf16",
                     "mxtt_taps_conv", "mxtt_taps_wgrad"]
    conv16, wgrad16, conv32, wgrad32 = (c[1] for c in calls)
    plan = hc.conv_bf16_plan(N * H * H, C, O, H100_SMS)
    assert conv16[3:17] == (N, H, H, C, O, 3, 3, 1, 1, H, H, plan.bn, 1, 1)
    wplan = hc.wgrad_bf16_plan(N * H * H, C, O, 3, 3, H100_SMS)
    assert wgrad16[4:18] == (N, H, H, C, O, 3, 3, 1, 1, H, H, wplan.splits,
                             wplan.rows, 1)
    assert wgrad16[3] is not None      # the workspace of the 8 splits
    cplan = hc.conv_fp32_plan(N * H * H, C, O, 3, 3, H100_SMS)
    assert conv32[4:21] == (N, H, H, C, O, 3, 3, 1, 1, 1, H, H) \
        + cplan.tile + (cplan.splits, cplan.kper, 1)
    assert (conv32[3] is not None) == (cplan.splits > 1)
    fplan = hc.wgrad_fp32_plan(N * H * H, C, O, 3, 3, H100_SMS)
    assert wgrad32[4:19] == (N, H, H, C, O, 3, 3, 1, 1, H, H, 128,
                             fplan.splits, fplan.rows, 1)
    assert fplan.splits > 1 and wgrad32[3] is not None
    assert (hc.launches, hc.launches_bf16, hc.conv_reduce_launches) == \
        (2, 1, int(cplan.splits > 1))
    assert (hc.wgrad_launches, hc.wgrad_launches_bf16) == (2, 1)
    assert (hc.wgrad_reduce_launches, hc.wgrad_reduce_launches_bf16) == (2, 1)


def test_bf16_cuda_arm_takes_a_tile_in_place_of_the_plans(fake_kernels):
    """``bn`` reaches the bf16 kernel in place of the plan's tile, with the
    plan's load path, and counts as a launch; fp32 or another tile
    raises."""
    calls, _ = fake_kernels
    x = torch.zeros((2, 7, 7, 64), dtype=torch.bfloat16)
    taps = torch.zeros((9, 64, 64), dtype=torch.bfloat16)
    for bn in (64, 128):
        hc._taps_conv_cuda(x, taps, hc.S1_PADS, 3, 3, bn=bn)
    assert [c[1][14:16] for c in calls] == [(64, 1), (128, 1)]
    assert hc.launches_bf16 == 2
    for xt, tt, bn in ((x, taps, 32), (x.float(), taps.float(), 64)):
        with pytest.raises(MXNetError):
            hc._taps_conv_cuda(xt, tt, hc.S1_PADS, 3, 3, bn=bn)
    assert len(calls) == 2 and hc.launches == 2


def test_bf16_cuda_arm_takes_the_element_path_when_misaligned(fake_kernels):
    """A contiguous bf16 view at storage offset 1 (2-byte aligned) and a
    channel count off 8 reach the bf16 kernels with vec = 0, never the
    fp32 library or the plain version."""
    calls, loaded = fake_kernels
    buf = torch.zeros(3 * 7 * 9 * 24 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(3, 7, 9, 24)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    taps = torch.zeros((9, 24, 40), dtype=torch.bfloat16)
    dy = torch.zeros((3, 7, 9, 40), dtype=torch.bfloat16)
    hc._taps_conv_cuda(x, taps, hc.S1_PADS, 3, 3)
    hc._taps_wgrad_cuda(x, dy, hc.S1_PADS, 3, 3)
    x3 = torch.zeros((2, 5, 5, 3), dtype=torch.bfloat16)
    hc._taps_conv_cuda(x3, torch.zeros((9, 3, 8), dtype=torch.bfloat16),
                       hc.S1_PADS, 3, 3)
    assert loaded == ["taps_conv_bf16", "taps_wgrad_bf16"]
    conv, wgrad, conv3 = (c[1] for c in calls)
    assert conv[15] == 0 and wgrad[17] == 0 and conv3[15] == 0
    assert hc.launches_bf16 == 2 and hc.wgrad_launches_bf16 == 1


def test_fp32_wgrad_cuda_arm_takes_the_4_byte_path_when_misaligned(
        fake_kernels):
    """An fp32 view at storage offset 1 (4 bytes off a 16-byte boundary)
    and a channel count off 4 reach taps_wgrad with vec = 0 and the plan's
    tile, never the plain version."""
    calls, loaded = fake_kernels
    buf = torch.zeros(3 * 7 * 9 * 24 + 1)
    x = buf[1:].view(3, 7, 9, 24)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    hc._taps_wgrad_cuda(x, torch.zeros((3, 7, 9, 40)), hc.S1_PADS, 3, 3)
    hc._taps_wgrad_cuda(torch.zeros((2, 5, 5, 70)),
                        torch.zeros((2, 5, 5, 130)), hc.S1_PADS, 3, 3)
    assert loaded == ["taps_wgrad"]
    (_, small), (_, wide) = calls
    assert (small[15], small[18]) == (64, 0)
    assert (wide[15], wide[18]) == (128, 0)
    assert hc.wgrad_launches == 2 and hc.wgrad_launches_bf16 == 0


def test_conv1x1_wgrad_cuda_arm_follows_the_plan(fake_kernels):
    """Kernel 12's CUDA arm passes the plan's tile, splits, rows and
    cluster, the workspace when it splits, and the element path (vec = 0)
    for an operand off a 16-byte boundary, which no longer raises."""
    calls, loaded = fake_kernels
    N, H, C, O = 128, 56, 64, 256
    x = torch.zeros((N, H, H, C), dtype=torch.bfloat16)
    g = torch.zeros((N, H, H, O), dtype=torch.bfloat16)
    assert hc._conv1x1_wgrad_cuda(x, g, 1).shape == (C, O)
    buf = torch.zeros(2 * 7 * 9 * 16 + 1, dtype=torch.bfloat16)
    xm = buf[1:].view(2, 7, 9, 16)
    hc._conv1x1_wgrad_cuda(xm, torch.zeros((2, 4, 5, 24),
                                           dtype=torch.bfloat16), 2)
    assert loaded == ["conv1x1_wgrad"]
    (_, big), (_, small) = calls
    plan = hc.conv1x1_wgrad_plan(N * H * H, C, O, H100_SMS)
    assert big[4:18] == (N, H, H, C, O, H, H, 1, 64, 256, plan.splits,
                         plan.rows, 2, 1)
    assert big[3] is not None and plan.splits > 2
    assert small[4:12] == (2, 7, 9, 16, 24, 4, 5, 2) and small[17] == 0
    assert (hc.conv1x1_wgrad_launches,
            hc.conv1x1_wgrad_reduce_launches) == (2, 1)


# --------------------------------------------------------------------------
# kernel 1 in fp32 (implicit_gemm_conv.cu): its host plan, a plain walk of
# the plan (tiles, reduction splits, the stride) against the plain version,
# and the stride-2 arm's launch
# --------------------------------------------------------------------------
# the 3x3 forwards of a served ResNet-50 at batch 32 (class, C = O, input
# H = W) and the Gluon step's 3x3 shapes (forward and dgrad, stride 1)
SERVED_3X3 = [("s1", 64, 56), ("s1", 128, 28), ("s1", 256, 14),
              ("s1", 512, 7), ("s2", 128, 56), ("s2", 256, 28),
              ("s2", 512, 14)]


# each one's (tile, splits) at batch 32 on an H100: the fastest of the
# kernel's tiles and splits that chip_smoke.py's phase 2 timed at the shape
SERVED_3X3_PLANS = {("s1", 64, 56): ((128, 64), 1),
                    ("s1", 128, 28): ((128, 64), 1),
                    ("s1", 256, 14): ((128, 64), 2),
                    ("s1", 512, 7): ((128, 64), 5),
                    ("s2", 128, 56): ((128, 64), 1),
                    ("s2", 256, 28): ((128, 64), 2),
                    ("s2", 512, 14): ((128, 64), 5)}


def _conv_fp32_stages(C, KH=3, KW=3):
    return KH * KW * -(-C // 16)


@pytest.mark.parametrize("kind,C,H", SERVED_3X3 + [
    ("s1", C, H) for C, H in GLUON_3X3])
@pytest.mark.parametrize("batch", [32, 128])
def test_fp32_conv_plan_at_the_main_path_shapes(kind, C, H, batch):
    """At the served and Gluon 3x3 shapes: a tile of the kernel's (at batch
    32 the one the card ran fastest), every split of the reduction
    non-empty and at least 8 stages (or one split), the grid and the
    workspace (only when split) that follow, at least a block for every SM,
    and no tile or split that the cost model prices lower."""
    Ho = H if kind == "s1" else H // 2
    M, ks = batch * Ho * Ho, _conv_fp32_stages(C)
    plan = hc.conv_fp32_plan(M, C, C, 3, 3, H100_SMS, (0, 16, 32))
    if batch == 32:
        assert (plan.tile, plan.splits) == SERVED_3X3_PLANS[(kind, C, H)]
    assert plan.tile in [t[:2] for t in hc._CONV_FP32_TILES] and plan.vec
    assert plan.splits * plan.kper >= ks > (plan.splits - 1) * plan.kper
    assert plan.splits == 1 or plan.kper >= hc._CONV_FP32_MIN_STAGES
    assert plan.grid == (-(-M // plan.tile[0]), -(-C // plan.tile[1]),
                         plan.splits)
    assert plan.workspace == ((plan.splits, M, C) if plan.splits > 1
                              else None)
    assert plan.grid[0] * plan.grid[1] * plan.splits >= H100_SMS
    tile = next(t for t in hc._CONV_FP32_TILES if t[:2] == plan.tile)
    cost = hc._conv_fp32_cost(M, C, ks, tile, plan.splits, H100_SMS)[0]
    for other in hc._CONV_FP32_TILES:
        for splits in range(1, hc._CONV_FP32_MAX_SPLITS + 1):
            c, kper = hc._conv_fp32_cost(M, C, ks, other, splits, H100_SMS)
            if -(-ks // kper) == splits and (splits == 1 or kper >= 8):
                assert cost <= c


@pytest.mark.parametrize("N,H,W,C,O", [(3, 7, 9, 20, 70), (1, 1, 1, 3, 5),
                                       (5, 11, 13, 33, 129),
                                       (2, 10, 6, 36, 130)])
def test_fp32_conv_plan_at_ragged_shapes_and_forced_launches(N, H, W, C, O):
    """Ragged shapes: every output tile in the grid, 16-byte copies only
    for C and O multiples of 4 on aligned operands; a tile and a split set
    in place of the plan's are taken, and a split that would be empty or a
    tile the kernel lacks raises."""
    M, ks = N * H * W, _conv_fp32_stages(C)
    plan = hc.conv_fp32_plan(M, C, O, 3, 3, H100_SMS)
    assert plan.grid[0] * plan.tile[0] >= M > (plan.grid[0] - 1) * plan.tile[0]
    assert plan.grid[1] * plan.tile[1] >= O > (plan.grid[1] - 1) * plan.tile[1]
    assert plan.vec == (C % 4 == 0 and O % 4 == 0)
    assert not hc.conv_fp32_plan(M, C, O, 3, 3, H100_SMS, (4, 0, 0)).vec
    forced = hc.conv_fp32_plan(M, C, O, 3, 3, H100_SMS, tile=(64, 64),
                               splits=min(3, ks))
    assert forced.tile == (64, 64) and forced.splits == min(3, ks)
    assert forced.splits * forced.kper >= ks
    with pytest.raises(MXNetError):
        hc.conv_fp32_plan(M, C, O, 3, 3, H100_SMS, tile=(32, 32))
    with pytest.raises(MXNetError):
        hc.conv_fp32_plan(M, C, O, 3, 3, H100_SMS, splits=ks + 1)


def _walk_conv_fp32_plan(x, taps, pads, KH, KW, stride, plan):
    """Kernel 1 fp32's arithmetic in plain PyTorch, block by block of the
    plan's grid: each block's output rows gather their input pixels at the
    stride, its split walks its range of (tap, 16-channel block) stages in
    the kernel's order, each output element is written once per split, and
    the splits are summed in split_sum.cuh's order."""
    N, H, W, C = x.shape
    O = taps.shape[2]
    Ho, Wo = hc._out_hw(H, W, KH, KW, pads, stride)
    M = N * Ho * Wo
    bm, bn = plan.tile
    cblocks = -(-C // 16)
    xp = torch.nn.functional.pad(x, (0, 0, pads[1][0], KW, pads[0][0], KH))
    parts = torch.full((plan.splits, M, O), float("nan"))
    for bx in range(plan.grid[0]):
        m = torch.arange(bx * bm, min((bx + 1) * bm, M))
        n, ho, wo = m // (Ho * Wo), m % (Ho * Wo) // Wo, m % Wo
        for by in range(plan.grid[1]):
            o0, o1 = by * bn, min((by + 1) * bn, O)
            for z in range(plan.splits):
                acc = torch.zeros((len(m), o1 - o0))
                for k in range(z * plan.kper,
                               min((z + 1) * plan.kper, KH * KW * cblocks)):
                    tap, cb = divmod(k, cblocks)
                    dh, dw = divmod(tap, KW)
                    c0, c1 = cb * 16, min(cb * 16 + 16, C)
                    rows = xp[n, stride * ho + dh, stride * wo + dw, c0:c1]
                    acc += rows @ taps[tap, c0:c1, o0:o1]
                assert parts[z, m[0]:m[-1] + 1, o0:o1].isnan().all()
                parts[z, m[0]:m[-1] + 1, o0:o1] = acc
    assert not parts.isnan().any()
    return _split_sum(parts).reshape(N, Ho, Wo, O)


@pytest.mark.parametrize("N,H,W,C,O,stride,tile,splits", [
    (2, 7, 9, 20, 70, 1, (64, 64), 3),      # ragged tiles, a ragged split
    (3, 10, 6, 36, 130, 2, (128, 64), 2),   # stride 2, O off the tile
    (2, 14, 14, 32, 16, 2, (64, 64), 1),    # stride 2, one split
])
def test_fp32_conv_plan_walk_matches_plain(N, H, W, C, O, stride, tile,
                                           splits):
    """The plain walk of the fp32 kernel's launch (tiles, stages, stride,
    splits, split sum) against ``taps_conv_plain`` on the same fp32 inputs,
    rtol = atol = 1e-4."""
    r = np.random.default_rng(21)
    x = torch.from_numpy(r.standard_normal((N, H, W, C)).astype(np.float32))
    taps = torch.from_numpy(
        (r.standard_normal((9, C, O)) * 0.1).astype(np.float32))
    Ho, Wo = hc._out_hw(H, W, 3, 3, hc.S1_PADS, stride)
    plan = hc.conv_fp32_plan(N * Ho * Wo, C, O, 3, 3, H100_SMS, tile=tile,
                             splits=splits)
    want = hc.taps_conv_plain(x, taps, hc.S1_PADS, 3, 3, stride)
    got = _walk_conv_fp32_plan(x, taps, hc.S1_PADS, 3, 3, stride, plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_fp32_stride_2_takes_one_kernel_launch_on_the_input(fake_kernels,
                                                            monkeypatch):
    """``conv3x3_s2`` on fp32 reaches implicit_gemm_conv once, at stride 2
    on the input's own C channels and 3x3 taps (no space-to-depth copy),
    with the plan's tile and splits; the split sum is counted apart; a
    stride the kernels lack raises."""
    calls, loaded = fake_kernels
    monkeypatch.setattr(hc, "taps_conv", hc._taps_conv_cuda)
    N, C, H, O = 32, 256, 28, 256
    data = torch.zeros((N, C, H, H))
    y = hc.conv3x3_s2(data, torch.zeros((O, C, 3, 3)))
    assert y.shape == (N, O, H // 2, H // 2)
    assert loaded == ["implicit_gemm_conv"] and len(calls) == 1
    args = calls[0][1]
    plan = hc.conv_fp32_plan(N * 14 * 14, C, O, 3, 3, H100_SMS)
    assert args[4:21] == (N, H, H, C, O, 3, 3, 2, 1, 1, 14, 14) + plan.tile \
        + (plan.splits, plan.kper, 1)
    assert (hc.launches, hc.conv_reduce_launches) == \
        (1, int(plan.splits > 1))
    with pytest.raises(MXNetError):
        hc._taps_conv_cuda(torch.zeros((1, 4, 4, 8)), torch.zeros((9, 8, 8)),
                           hc.S1_PADS, 3, 3, 3)
