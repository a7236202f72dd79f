"""Neural-network ops (counterpart of ``mxnet_tpu/ops/nn.py``, every name
of it): Convolution, Deconvolution, FullyConnected, Pooling, Activation,
LeakyReLU, BatchNorm (inference and training statistics), InstanceNorm,
L2Normalization, LRN, softmax, SoftmaxActivation, SoftmaxOutput and the
three regression outputs with the reference's backward, :func:`streaming_ce`
and the ``streaming_softmax_ce`` and ``softmax_cross_entropy`` ops, Dropout,
UpSampling, Crop, and the transformer's LayerNorm and MultiHeadAttention.

Convolution dispatch mirrors ``_pallas_conv_mode`` (``nn.py:239-268``)
without its environment flag and lane gate, which were TPU verdicts: the
3x3 / stride-1 / pad-1 class and the 3x3 / stride-2 / pad-1 class with even
H and W go to the hand-written kernels (``hopper_conv``, whose autograd
Functions carry the backward), in fp32 and in bf16.  A bf16 1x1 / pad-0
convolution at stride 1, or at stride 2 on even H and W, takes
``hopper_conv.conv1x1``: cuDNN forward and data gradient, the weight
gradient on kernel 12 (the bf16 kernel of ``tools/probe_conv_fixes.py``),
with no fallback on the card.  Every other convolution (ResNet's 7x7 stem,
the fp32 1x1 projections) goes to ``torch.nn.functional.conv{1,2,3}d``,
the counterpart of the ``lax`` arm the reference package leaves to XLA.
BatchNorm's training statistics of a bf16 input are the reference's
one-pass ``E[x^2] - E[x]^2`` in fp32 (:class:`_LowPrecisionStats`), which
keeps no fp32 copy of the input for the backward.
MultiHeadAttention's attention always runs on the flash kernels
(``hopper_attention``), whatever ``T``: the reference's TPU gates, which
send ``T < 2048`` to its XLA arm, do not carry over.  Every op is
differentiable by PyTorch's autograd, which the training step uses.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import hopper_attention, hopper_conv
from .init_random import _generator
from .registry import param, register

__all__ = []


# --------------------------------------------------------------------------
# shape hints: fill parameter shapes from the data shape (the reference's
# FInferShape, mxnet_tpu/ops/shape_hints.py)
# --------------------------------------------------------------------------
def _conv_hint(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    nf, g = attrs["num_filter"], attrs["num_group"]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nf, data[1] // g) + tuple(attrs["kernel"])
    if len(out) > 2 and out[2] is None and not attrs["no_bias"]:
        out[2] = (nf,)
    return out


def _fc_hint(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    nh = attrs["num_hidden"]
    in_dim = int(np.prod(data[1:])) if attrs["flatten"] else data[-1]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nh, in_dim)
    if len(out) > 2 and out[2] is None and not attrs["no_bias"]:
        out[2] = (nh,)
    return out


def _bn_hint(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    c = data[attrs["axis"] % len(data)]
    return [shapes[0]] + [s if s is not None else (c,) for s in shapes[1:]]


def _channel_hint(axis_default):
    """Every unknown parameter shape is (C,), C the data's size along
    ``attrs["axis"]`` (LayerNorm's gamma and beta)."""
    def hint(attrs, shapes):
        data = shapes[0]
        if data is None:
            return shapes
        c = data[attrs.get("axis", axis_default) % len(data)]
        return [shapes[0]] + [s if s is not None else (c,) for s in shapes[1:]]
    return hint


def _mha_hint(attrs, shapes):
    """MultiHeadAttention: all four projection weights are (model_dim,
    model_dim), in FullyConnected's (out, in) orientation."""
    data = shapes[0]
    if data is None:
        return shapes
    return [shapes[0]] + [s if s is not None else (data[-1], data[-1])
                          for s in shapes[1:]]


def _softmax_label_hint(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = ((data[0],) + tuple(data[2:]) if attrs["multi_output"]
                  else (data[0],))
    return out


# --------------------------------------------------------------------------
# convolution
# --------------------------------------------------------------------------
_CONV_PARAMS = {
    "kernel": param("shape", (), required=True),
    "stride": param("shape", ()),
    "dilate": param("shape", ()),
    "pad": param("shape", ()),
    "num_filter": param(int, 0, required=True),
    "num_group": param(int, 1),
    "no_bias": param(bool, False),
    "workspace": param(int, 1024),      # accepted, ignored
    "cudnn_tune": param(str, None),     # accepted, ignored
    "cudnn_off": param(bool, False),
    "layout": param(str, None),
}


def hopper_conv_mode(attrs, data):
    """"s1" / "s2" / "1x1" when a hand-written kernel covers this conv, else
    None: "s1" is the reference's ``_is_3x3_same_unit`` class, "s2" the 3x3
    / stride-2 / pad-1 class on even spatial dims, "1x1" a bf16 1x1 / pad-0
    conv at stride 1, or 2 on even spatial dims (its weight gradient on
    kernel 12; fp32 1x1s stay on cuDNN)."""
    if len(attrs["kernel"]) != 2 or data.dim() != 4 \
            or attrs["num_group"] != 1 \
            or tuple(attrs["dilate"] or (1, 1)) != (1, 1):
        return None
    kernel = tuple(attrs["kernel"])
    pad = tuple(attrs["pad"] or (0, 0))
    stride = tuple(attrs["stride"] or (1, 1))
    even = data.shape[2] % 2 == 0 and data.shape[3] % 2 == 0
    if kernel == (1, 1):
        if data.dtype == torch.bfloat16 and pad == (0, 0) and (
                stride == (1, 1) or (stride == (2, 2) and even)):
            return "1x1"
        return None
    if kernel != (3, 3) or pad != (1, 1):
        return None
    if stride == (1, 1):
        return "s1"
    if stride == (2, 2) and even:
        return "s2"
    return None


@register("Convolution", aliases=("convolution", "Convolution_v1"),
          params=dict(_CONV_PARAMS), arg_names=("data", "weight", "bias"),
          shape_hint=_conv_hint)
def _convolution(attrs, data, weight, *maybe_bias):
    """N-D convolution, NCHW data and OIHW weight."""
    nd = len(attrs["kernel"])
    mode = hopper_conv_mode(attrs, data)
    if mode == "s1":
        out = hopper_conv.conv3x3_same(data, weight)
    elif mode == "s2":
        out = hopper_conv.conv3x3_s2(data, weight)
    elif mode == "1x1":
        out = hopper_conv.conv1x1(data, weight, (attrs["stride"] or (1,))[0])
    else:
        if nd not in (1, 2, 3):
            raise MXNetError("Convolution: %d-D kernels are not supported"
                             % nd)
        conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        out = conv(data, weight.to(data.dtype), None,
                   stride=attrs["stride"] or (1,) * nd,
                   padding=attrs["pad"] or (0,) * nd,
                   dilation=attrs["dilate"] or (1,) * nd,
                   groups=attrs["num_group"])
    if not attrs["no_bias"] and maybe_bias:
        out = out + maybe_bias[0].reshape((1, -1) + (1,) * nd)
    return out


@register("FullyConnected", aliases=("fullyconnected", "FullyConnected_v1"),
          params={"num_hidden": param(int, 0, required=True),
                  "no_bias": param(bool, False),
                  "flatten": param(bool, True)},
          arg_names=("data", "weight", "bias"), shape_hint=_fc_hint)
def _fully_connected(attrs, data, weight, *maybe_bias):
    """y = x Wᵀ + b."""
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    bias = maybe_bias[0] if maybe_bias and not attrs["no_bias"] else None
    return F.linear(x, weight, bias)      # the bias added in the product


# --------------------------------------------------------------------------
# pooling
# --------------------------------------------------------------------------
_POOL_PARAMS = {
    "kernel": param("shape", ()),
    "pool_type": param(["max", "avg", "sum", "lp"], "max"),
    "global_pool": param(bool, False),
    "kernel_layout": param(str, None),
    "cudnn_off": param(bool, False),
    "pooling_convention": param(["valid", "full", "same"], "valid"),
    "stride": param("shape", ()),
    "pad": param("shape", ()),
    "p_value": param(int, 2),
    "count_include_pad": param(bool, True),
}


def _window_sum(x, k, stride):
    """Sum over each window of an already padded tensor."""
    nd = len(k)
    avg = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1]
    return avg(x, k, stride) * float(math.prod(k))


@register("Pooling", aliases=("pooling", "Pooling_v1"),
          params=dict(_POOL_PARAMS))
def _pooling(attrs, data):
    """Max/avg/sum/lp pooling with the reference's padding conventions:
    max pads with -inf, "full" adds the extra right pad of a ceil-mode
    output, avg divides by the window size unless ``count_include_pad``
    is off, lp is ``(sum |x|^p_value)^(1/p_value)`` over each window
    padded with zeros (a global lp pool is the mean, as the reference's
    falls through to it)."""
    nd = data.dim() - 2
    pt = attrs["pool_type"]
    if attrs["global_pool"]:
        axes = tuple(range(2, data.dim()))
        if pt == "max":
            return data.amax(dim=axes, keepdim=True)
        if pt == "sum":
            return data.sum(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if nd not in (1, 2, 3):
        raise MXNetError("Pooling: %d-D windows are not supported" % nd)
    k = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"] or (1,) * nd)
    pad = tuple(attrs["pad"] or (0,) * nd)
    lo_hi = [(p, p) for p in pad]
    if attrs["pooling_convention"] == "full":
        for i in range(nd):
            rem = (data.shape[2 + i] + 2 * pad[i] - k[i]) % stride[i]
            extra = (stride[i] - rem) % stride[i] if rem else 0
            lo_hi[i] = (pad[i], pad[i] + extra)
    # F.pad lists the last dim first
    fpad = [v for lh in reversed(lo_hi) for v in lh]
    if pt == "max":
        fill = (-math.inf if data.is_floating_point()
                else torch.iinfo(data.dtype).min)
        xp = F.pad(data, fpad, value=fill)
        maxp = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        return maxp(xp, k, stride)
    if pt == "lp":
        p = attrs["p_value"]
        sp = _window_sum(F.pad(data.abs() ** p, fpad), k, stride)
        return (sp ** (1.0 / p)).to(data.dtype)
    ssum = _window_sum(F.pad(data, fpad), k, stride)
    if pt == "sum":
        return ssum.to(data.dtype)
    if attrs["count_include_pad"]:
        return (ssum / float(math.prod(k))).to(data.dtype)
    counts = _window_sum(F.pad(torch.ones_like(data), fpad), k, stride)
    return (ssum / counts).to(data.dtype)


# --------------------------------------------------------------------------
# activation / normalization / softmax
# --------------------------------------------------------------------------
@register("Activation", aliases=("activation",),
          params={"act_type": param(["relu", "sigmoid", "tanh", "softrelu",
                                     "softsign", "gelu"], "relu",
                                    required=True)})
def _activation(attrs, x):
    act = attrs["act_type"]
    if act == "relu":
        return torch.relu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    if act == "softrelu":
        return torch.logaddexp(x, torch.zeros_like(x))
    if act == "gelu":
        return F.gelu(x, approximate="none")
    return F.softsign(x)


_BN_PARAMS = {
    "eps": param(float, 1e-3),
    "momentum": param(float, 0.9),
    "fix_gamma": param(bool, True),
    "use_global_stats": param(bool, False),
    "output_mean_var": param(bool, False),
    "axis": param(int, 1),
    "cudnn_off": param(bool, False),
}


class _LowPrecisionStats(torch.autograd.Function):
    """Per-channel mean and biased variance of a bf16/fp16 tensor as the
    reference computes them (``nn.py:530-540``): one pass, fp32 sums,
    ``var = max(E[x^2] - E[x]^2, 0)``.  The fp32 widening of the input is a
    temporary of the forward; the Function saves the low-precision input
    itself (which the normalization saves anyway) and differentiates
    analytically: ``dx = (g_mean - 2 mean g_var + 2 x g_var) / n``, with
    ``g_var`` zero where the clamp bit."""

    @staticmethod
    def forward(ctx, data, red):
        mean = torch.mean(data, dim=red, dtype=torch.float32)
        m2 = torch.mean(data.float().square_(), dim=red)
        raw = m2 - mean.square()
        keep = raw >= 0
        ctx.red = red
        ctx.save_for_backward(data, mean, keep)
        return mean, raw.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        data, mean, keep = ctx.saved_tensors
        n = data.numel() // mean.numel()
        shape = [1] * data.dim()
        ax = next(i for i in range(data.dim()) if i not in ctx.red)
        shape[ax] = mean.numel()
        gv = g_var * keep
        a = ((g_mean - 2.0 * mean * gv) / n).reshape(shape)
        b = (2.0 * gv / n).reshape(shape)
        return (data.float() * b + a).to(data.dtype), None


@register("BatchNorm", aliases=("batchnorm", "BatchNorm_v1"),
          params=dict(_BN_PARAMS), nout=3,
          visible=lambda a: 3 if a["output_mean_var"] else 1,
          arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
          aux_inputs=(3, 4), shape_hint=_bn_hint, train_aware=True,
          aux_writeback={1: 3, 2: 4})
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """BatchNorm with MXNet's defaults (``eps=1e-3``, ``fix_gamma=True``:
    gamma is taken as ones), outputs (out, new_moving_mean, new_moving_var)
    as the reference does (``nn.py:516-561``).

    In training (``attrs["__train__"]`` and not ``use_global_stats``) it
    normalizes by the batch's fp32 mean and biased variance (two-pass for
    fp32 input; for bf16/fp16 the reference's one-pass fp32 statistics,
    :class:`_LowPrecisionStats`), and outputs 1 and 2 are ``moving *
    momentum + batch_stat * (1 - momentum)``, detached from the graph; the
    training plan writes them back into the auxiliary states.  Otherwise it
    normalizes by the moving statistics, which pass through unchanged."""
    ax = attrs["axis"] % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    low_precision = data.dtype in (torch.bfloat16, torch.float16)
    if attrs.get("__train__") and not attrs["use_global_stats"]:
        red = tuple(i for i in range(data.dim()) if i != ax)
        if low_precision:
            mean, var = _LowPrecisionStats.apply(data, red)
        else:
            var, mean = torch.var_mean(data.float(), dim=red, correction=0)
        m = attrs["momentum"]
        with torch.no_grad():
            new_mm = moving_mean * m + mean.detach() * (1 - m)
            new_mv = moving_var * m + var.detach() * (1 - m)
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    g = torch.ones_like(gamma) if attrs["fix_gamma"] else gamma
    inv = torch.rsqrt(var + attrs["eps"]) * g
    if low_precision:
        # normalize in the input dtype with scale/shift folded into two
        # per-channel values, as the reference's low-precision path does
        shift = beta - mean * inv
        out = data * inv.to(data.dtype).reshape(shape) \
            + shift.to(data.dtype).reshape(shape)
    else:
        out = ((data - mean.reshape(shape)) * inv.reshape(shape)
               + beta.reshape(shape)).to(data.dtype)
    return out, new_mm, new_mv


@register("LayerNorm", aliases=("layernorm",),
          params={"axis": param(int, -1), "eps": param(float, 1e-5),
                  "output_mean_var": param(bool, False)}, nout=3,
          visible=lambda a: 3 if a["output_mean_var"] else 1,
          arg_names=("data", "gamma", "beta"), shape_hint=_channel_hint(-1))
def _layer_norm(attrs, data, gamma, beta):
    """``(x - mean) / sqrt(var + eps) * gamma + beta`` over ``axis`` with
    fp32 statistics, outputs (out in the data's dtype, mean, var) as the
    reference's (``nn.py:564-577``).  With ``output_mean_var`` the mean and
    var come from ``torch.var_mean`` over the axis, as the reference's
    ``jnp.mean``/``jnp.var``, and carry their gradients; otherwise only
    ``out`` is visible and it is one ``native_layer_norm`` call (PyTorch's
    fused kernel) over ``axis`` moved last, as the reference leaves
    LayerNorm to XLA."""
    ax = attrs["axis"] % data.dim()
    eps = attrs["eps"]
    x32 = data.float()
    if attrs["output_mean_var"]:
        var, mean = torch.var_mean(x32, dim=ax, keepdim=True, correction=0)
        shape = [1] * data.dim()
        shape[ax] = data.shape[ax]
        out = (x32 - mean) * torch.rsqrt(var + eps) \
            * gamma.float().reshape(shape) + beta.float().reshape(shape)
        return out.to(data.dtype), mean.squeeze(ax), var.squeeze(ax)
    x32 = x32.movedim(ax, -1)
    out, mean, rstd = torch.native_layer_norm(
        x32, (x32.shape[-1],), gamma.float(), beta.float(), eps)
    return (out.movedim(-1, ax).to(data.dtype), mean.squeeze(-1),
            rstd.squeeze(-1).pow(-2) - eps)


@register("MultiHeadAttention", aliases=("multiheadattention",),
          params={"num_heads": param(int, 0, required=True),
                  "causal": param(bool, True)},
          arg_names=("data", "query_weight", "key_weight", "value_weight",
                     "out_proj_weight"), shape_hint=_mha_hint)
def _multi_head_attention(attrs, data, query_weight, key_weight,
                          value_weight, out_proj_weight):
    """Decoder attention (``nn.py:603-672``): Q/K/V projections ``x Wᵀ``
    with (out, in) weights, ``[B, H, T, d]`` heads, ``scale = 1/sqrt(d)``,
    :func:`hopper_attention.flash_attention` (kernels 3, or 5 with 6 and 7
    in training, on the card), and the output projection.  The products
    around the attention are ``F.linear`` (cuBLAS), as the reference
    leaves them to XLA."""
    if data.dim() != 3:
        raise MXNetError("MultiHeadAttention: data must be (batch, time, "
                         "model_dim), got %s" % (tuple(data.shape),))
    B, T, D = data.shape
    H = attrs["num_heads"]
    if H <= 0 or D % H:
        raise MXNetError("MultiHeadAttention: num_heads=%d must divide "
                         "model_dim=%d" % (H, D))
    d = D // H

    def proj(w):
        return F.linear(data, w).reshape(B, T, H, d).transpose(1, 2) \
            .contiguous()

    out = hopper_attention.flash_attention(
        proj(query_weight), proj(key_weight), proj(value_weight),
        attrs["causal"], 1.0 / math.sqrt(d))
    return F.linear(out.transpose(1, 2).reshape(B, T, D), out_proj_weight)


@register("softmax", params={"axis": param(int, -1),
                             "temperature": param(float, None),
                             "dtype": param("dtype", None)})
def _softmax(attrs, x):
    t = attrs["temperature"]
    if t is not None and t != 1.0:
        x = x / t
    out = torch.softmax(x, dim=attrs["axis"])
    if attrs["dtype"]:
        from ..ndarray.ndarray import torch_dtype
        out = out.to(torch_dtype(attrs["dtype"]))
    return out


_SOFTMAX_OUT_PARAMS = {
    "grad_scale": param(float, 1.0),
    "ignore_label": param(float, -1.0),
    "multi_output": param(bool, False),
    "use_ignore": param(bool, False),
    "preserve_shape": param(bool, False),
    "normalization": param(["null", "batch", "valid"], "null"),
    "out_grad": param(bool, False),
    "smooth_alpha": param(float, 0.0),
}


def _softmax_output_prob(attrs, data):
    if attrs["multi_output"]:
        return torch.softmax(data, dim=1)
    if attrs["preserve_shape"]:
        return torch.softmax(data, dim=-1)
    prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1)
    return prob.reshape(data.shape)


def _one_hot(lab, n, axis, dtype):
    """``jax.nn.one_hot(lab, n, axis=axis)``: a label outside ``[0, n)``
    (an ignored ``-1``) gives a row of zeros."""
    classes = torch.arange(n, device=lab.device)
    if axis == 1:
        lab = lab.unsqueeze(1)
        classes = classes.reshape((1, n) + (1,) * (lab.dim() - 2))
    else:
        lab = lab.unsqueeze(-1)
    return (lab == classes).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax whose backward is the reference's custom VJP
    (``nn.py:777-816``): the head gradient is ignored and the logits get
    ``(p - onehot(label)) * grad_scale``, masked where the label is
    ``ignore_label`` (``use_ignore``) and divided by the batch or by the
    count of valid labels (``normalization``); the label gets zeros."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        p = _softmax_output_prob(attrs, data)
        ctx.attrs = attrs
        ctx.save_for_backward(p, label)
        return p

    @staticmethod
    def backward(ctx, g):
        p, l = ctx.saved_tensors
        a = ctx.attrs
        if a["multi_output"]:
            oh = _one_hot(l.long(), p.shape[1], 1, p.dtype)
        else:
            flat = l.reshape(l.shape[0], -1) if l.dim() > 1 else l
            oh = _one_hot(flat.long().reshape(p.shape[:-1]), p.shape[-1],
                          -1, p.dtype)
        grad = p - oh
        valid = l != a["ignore_label"]
        if a["use_ignore"]:
            grad = grad * valid.to(p.dtype).unsqueeze(
                1 if a["multi_output"] else -1)
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / p.shape[0]
        elif a["normalization"] == "valid" and a["use_ignore"]:
            scale = scale / valid.sum().clamp_min(1).to(p.dtype)
        dl = torch.zeros_like(l) if ctx.needs_input_grad[1] else None
        return grad * scale, dl, None


@register("SoftmaxOutput", aliases=("softmaxoutput", "Softmax"),
          params=dict(_SOFTMAX_OUT_PARAMS), arg_names=("data", "label"),
          shape_hint=_softmax_label_hint)
def _softmax_output(attrs, data, label):
    """SoftmaxOutput (``nn.py:777-826``): the softmax of the logits, whose
    gradient is ``(p - onehot(label)) * grad_scale`` whatever the head
    gradient (:class:`_SoftmaxOutputFn`), so ``Executor.backward`` and the
    Module steps, which seed the head with ones, train through it.
    ``smooth_alpha`` is accepted and unused, as in the reference.
    Low-precision logits are cast to fp32 outside the Function, as the
    reference casts them outside its custom VJP, so the probabilities stay
    fp32 and the cast's backward returns the gradient in the logits'
    dtype."""
    if data.dtype in (torch.bfloat16, torch.float16):
        data = data.float()
    return _SoftmaxOutputFn.apply(data, label, attrs)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
class _StreamingCE(torch.autograd.Function):
    """``logsumexp(logits) - logits[label]`` whose backward is the
    reference's custom VJP (``nn.py:858-871``): ``g * (softmax - onehot)``
    written once, in place, instead of the separate logsumexp and gather
    gradients autograd would add together over the (N, V) logits."""

    @staticmethod
    def forward(ctx, logits, labels):
        lg = logits.float()
        lab = labels.long().unsqueeze(-1)
        lse = torch.logsumexp(lg, dim=-1)
        ctx.save_for_backward(logits, lab, lse)
        return lse - lg.gather(-1, lab).squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        grad = logits.float().sub(lse.unsqueeze(-1)).exp_()
        grad.scatter_add_(-1, lab, torch.full(lab.shape, -1.0, dtype=grad.dtype,
                                              device=grad.device))
        grad.mul_(g.unsqueeze(-1))
        return grad.to(logits.dtype), None


def streaming_ce(logits, labels):
    """Per-example softmax cross-entropy over the last axis,
    ``logsumexp(logits) - logits[label]`` in fp32 (``nn.py:829-878``).
    Labels may arrive as floats (``nd.array`` of class ids) and are cast to
    int64 for the gather; differentiable in the logits, with the gradient
    ``softmax - onehot`` as the reference's custom VJP emits it."""
    return _StreamingCE.apply(logits, labels)


@register("streaming_softmax_ce", arg_names=("data", "label"),
          params={"axis": param(int, -1), "keepdims": param(bool, False)})
def _streaming_softmax_ce(attrs, data, label):
    """Per-example :func:`streaming_ce` over ``axis`` (``nn.py:881-889``),
    the sparse-label loss of ``gluon.loss.SoftmaxCrossEntropyLoss``."""
    axis = attrs["axis"] % data.dim()
    out = streaming_ce(data.movedim(axis, -1), label)
    return out.unsqueeze(axis) if attrs["keepdims"] else out


@register("softmax_cross_entropy", arg_names=("data", "label"))
def _softmax_cross_entropy(attrs, data, label):
    """Total cross-entropy over the batch (``nn.py:892-896``)."""
    return torch.sum(streaming_ce(data, label)).to(data.dtype)


@register("log_softmax", params={"axis": param(int, -1),
                                 "temperature": param(float, None)})
def _log_softmax(attrs, x):
    """``log(softmax(x / temperature))`` over ``axis`` (``nn.py:736``): the
    dense-label and ``from_logits`` arms of the Gluon losses."""
    t = attrs["temperature"]
    if t is not None and t != 1.0:
        x = x / t
    return torch.log_softmax(x, dim=attrs["axis"])


@register("Dropout", aliases=("dropout",), needs_rng=True, train_aware=True,
          nout=2, visible=1,
          params={"p": param(float, 0.5),
                  "mode": param(["training", "always"], "training"),
                  "axes": param("shape", ()),
                  "cudnn_off": param(bool, False),
                  "__train__": param(bool, False)})
def _dropout(attrs, generator, data):
    """Inverted dropout (``nn.py:959-979``): in training (or with ``mode=
    "always"``) each element, or each slice along ``axes``, is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, the mask drawn
    from ``generator``; otherwise the identity.  Returns (out, mask)."""
    p = attrs["p"]
    active = attrs.get("__train__") or attrs["mode"] == "always"
    if not active or p == 0.0 or data.device.type == "meta":
        return data, torch.ones_like(data)
    shape = tuple(1 if i in attrs["axes"] else s
                  for i, s in enumerate(data.shape))
    keep = 1.0 - p
    mask = (torch.rand(shape, generator=generator, device=data.device)
            < keep).to(data.dtype) / keep
    return data * mask, mask.expand(data.shape)


# --------------------------------------------------------------------------
# the rest of ``nn.py``: transposed convolution, crop and upsampling, the
# other activations and normalizations, the regression outputs.  None is a
# Pallas kernel in the reference (each goes to XLA), so each is PyTorch's
# own op here (cuDNN's transposed convolution on the card).
# --------------------------------------------------------------------------
def _deconv_hint(attrs, shapes):
    """Deconvolution's weight is (in, out / group, k...)."""
    data = shapes[0]
    if data is None:
        return shapes
    nf, g = attrs["num_filter"], attrs["num_group"]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (data[1], nf // g) + tuple(attrs["kernel"])
    if len(out) > 2 and out[2] is None and not attrs["no_bias"]:
        out[2] = (nf,)
    return out


def _deconv_pad_adj(attrs, in_sizes):
    """(pad, adj) of a transposed convolution: the given ones, or with
    ``target_shape`` those that make the output that size, as upstream
    MXNet derives them (``deconvolution-inl.h`` ``InferPad``): the total
    padding ``stride * (in - 1) + dilate * (k - 1) + 1 - target`` split
    evenly, an odd one taking its extra element from ``adj``."""
    k = attrs["kernel"]
    nd = len(k)
    stride = attrs["stride"] or (1,) * nd
    dilate = attrs["dilate"] or (1,) * nd
    target = attrs["target_shape"]
    if not target or not any(target):
        return (tuple(attrs["pad"] or (0,) * nd),
                tuple(attrs["adj"] or (0,) * nd))
    if len(target) != nd:
        raise MXNetError("Deconvolution: target_shape %s for a %d-D kernel"
                         % (target, nd))
    pad, adj = [], []
    for i in range(nd):
        total = stride[i] * (in_sizes[i] - 1) + dilate[i] * (k[i] - 1) + 1 \
            - target[i]
        if total < 0:
            raise MXNetError("Deconvolution: target_shape %s is larger "
                             "than the kernel can reach" % (target,))
        adj.append(total % 2)
        pad.append((total + adj[-1]) // 2)
    return tuple(pad), tuple(adj)


@register("Deconvolution", aliases=("deconvolution",),
          params={**_CONV_PARAMS, "adj": param("shape", ()),
                  "target_shape": param("shape", ())},
          arg_names=("data", "weight", "bias"), shape_hint=_deconv_hint)
def _deconvolution(attrs, data, weight, *maybe_bias):
    """Transposed convolution (``nn.py:324-354``), NCHW data, a weight of
    (in, out / group, k...): the output is ``stride * (in - 1) + dilate *
    (k - 1) + 1 - 2 * pad + adj`` a dimension, or ``target_shape``.  The
    bias is added unless ``no_bias``; its default is False, as the
    reference's (upstream MXNet's is True)."""
    nd = len(attrs["kernel"])
    if nd not in (1, 2, 3):
        raise MXNetError("Deconvolution: %d-D kernels are not supported"
                         % nd)
    pad, adj = _deconv_pad_adj(attrs, data.shape[2:])
    deconv = (F.conv_transpose1d, F.conv_transpose2d,
              F.conv_transpose3d)[nd - 1]
    out = deconv(data, weight.to(data.dtype), None,
                 stride=attrs["stride"] or (1,) * nd, padding=pad,
                 output_padding=adj, groups=attrs["num_group"],
                 dilation=attrs["dilate"] or (1,) * nd)
    if not attrs["no_bias"] and maybe_bias:
        out = out + maybe_bias[0].reshape((1, -1) + (1,) * nd)
    return out


@register("Crop", aliases=("crop_like",),
          params={"offset": param("shape", (0, 0)),
                  "h_w": param("shape", (0, 0)),
                  "num_args": param(int, 1),
                  "center_crop": param(bool, False)})
def _crop(attrs, data, *maybe_like):
    """The (h, w) window of ``data``'s last two axes, h and w from a second
    input's shape (``num_args`` 2) or ``h_w``, at ``offset`` or centred
    (``nn.py:1009-1024``)."""
    if maybe_like:
        th, tw = maybe_like[0].shape[2:4]
    else:
        th, tw = attrs["h_w"]
    h, w = data.shape[2:4]
    if attrs["center_crop"]:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = attrs["offset"]
    if oy < 0 or ox < 0 or oy + th > h or ox + tw > w:
        raise MXNetError("Crop: a %dx%d window at (%d, %d) does not fit in "
                         "%dx%d" % (th, tw, oy, ox, h, w))
    return data[:, :, oy:oy + th, ox:ox + tw]


@register("UpSampling", aliases=("upsampling",),
          params={"scale": param(int, 1, required=True),
                  "num_filter": param(int, 0),
                  "sample_type": param(["nearest", "bilinear"], "nearest"),
                  "multi_input_mode": param(["concat", "sum"], "concat"),
                  "num_args": param(int, 1),
                  "workspace": param(int, 512)})
def _upsampling(attrs, *inputs):
    """Each input's last two axes enlarged ``scale`` times (``nn.py:
    982-1006``): ``nearest`` repeats each pixel; ``bilinear`` interpolates
    at half-pixel centres with the edge pixels held, which is what the
    reference's ``jax.image.resize`` does when it enlarges (PyTorch's
    ``align_corners=False``, not ``True``).  Several inputs are
    concatenated on the channel axis, or summed."""
    s = attrs["scale"]
    outs = []
    for x in inputs:
        if attrs["sample_type"] == "nearest":
            outs.append(x.repeat_interleave(s, dim=2)
                        .repeat_interleave(s, dim=3))
        else:
            outs.append(F.interpolate(x, scale_factor=s, mode="bilinear",
                                      align_corners=False))
    if len(outs) == 1:
        return outs[0]
    if attrs["multi_input_mode"] == "sum":
        out = outs[0]
        for y in outs[1:]:
            out = out + y
        return out
    return torch.cat(outs, dim=1)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", aliases=("leakyrelu",), needs_rng=True,
          train_aware=True, arg_names=("data", "gamma"),
          shape_hint=_channel_hint(1),
          params={"act_type": param(["elu", "leaky", "prelu", "rrelu", "selu",
                                     "gelu"], "leaky"),
                  "slope": param(float, 0.25),
                  "lower_bound": param(float, 0.125),
                  "upper_bound": param(float, 0.334),
                  "__train__": param(bool, False)})
def _leaky_relu(attrs, generator, x, *maybe_gamma):
    """The leaky family (``nn.py:462-495``): ``leaky`` (``slope * x`` below
    0), ``elu`` (``slope * expm1(x)``), ``selu``, exact ``gelu``, ``prelu``
    (a learned ``gamma`` a channel, or one for all) and ``rrelu``: a slope
    drawn from U[lower_bound, upper_bound) an element in training, their
    mean otherwise."""
    act = attrs["act_type"]
    if act == "leaky":
        return torch.where(x > 0, x, attrs["slope"] * x)
    if act == "elu":
        return torch.where(x > 0, x, attrs["slope"] * torch.expm1(x))
    if act == "selu":
        return _SELU_SCALE * torch.where(x > 0, x,
                                         _SELU_ALPHA * torch.expm1(x))
    if act == "gelu":
        return F.gelu(x, approximate="none")
    if act == "prelu":
        gamma = maybe_gamma[0]
        shape = [1] * x.dim()
        if gamma.dim() == 1 and x.dim() > 1 and gamma.shape[0] > 1:
            shape[1] = gamma.shape[0]
        return torch.where(x > 0, x, gamma.reshape(shape) * x)
    lo, hi = attrs["lower_bound"], attrs["upper_bound"]
    if attrs.get("__train__") and x.device.type != "meta":
        u = torch.rand(x.shape, generator=_generator(generator, x.device),
                       device=x.device, dtype=x.dtype)
        slope = lo + (hi - lo) * u
    else:
        slope = (lo + hi) / 2.0
    return torch.where(x > 0, x, slope * x)


@register("InstanceNorm", aliases=("instancenorm",),
          params={"eps": param(float, 1e-3)},
          arg_names=("data", "gamma", "beta"), shape_hint=_channel_hint(1))
def _instance_norm(attrs, data, gamma, beta):
    """Each (sample, channel) normalized over its spatial axes by its
    biased variance, then ``* gamma + beta`` a channel (``nn.py:675-683``)."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + attrs["eps"])
            * gamma.reshape(shape) + beta.reshape(shape))


@register("L2Normalization",
          params={"eps": param(float, 1e-10),
                  "mode": param(["instance", "channel", "spatial"],
                                "instance")})
def _l2_normalization(attrs, data):
    """``data / sqrt(sum(data²) + eps)`` over every axis but the first
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``) (``nn.py:686-699``)."""
    mode = attrs["mode"]
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True)
                             + attrs["eps"])


@register("LRN", aliases=("lrn",), nout=2, visible=1,
          params={"alpha": param(float, 1e-4), "beta": param(float, 0.75),
                  "knorm": param(float, 2.0),
                  "nsize": param(int, 0, required=True)})
def _lrn(attrs, data):
    """Local response normalization across channels (``nn.py:702-720``):
    ``data / (knorm + alpha / nsize * sum of the squares of the nsize
    channels around)^beta``, and that divisor as a hidden second
    output."""
    n = attrs["nsize"]
    half = n // 2
    pad = [0, 0] * (data.dim() - 2) + [half, half]
    ssum = F.pad(data.square(), pad).unfold(1, n, 1).sum(-1)
    scale = (attrs["knorm"] + attrs["alpha"] * ssum / n) ** attrs["beta"]
    return data / scale, scale


@register("SoftmaxActivation",
          params={"mode": param(["instance", "channel"], "instance")})
def _softmax_activation(attrs, x):
    """Softmax over each sample's flattened values (``instance``) or over
    the channel axis (``channel``) (``nn.py:745-751``)."""
    if attrs["mode"] == "channel":
        return torch.softmax(x, dim=1)
    if x.dim() > 2:
        return torch.softmax(x.reshape(x.shape[0], -1), dim=-1) \
            .reshape(x.shape)
    return torch.softmax(x, dim=-1)


def _label_like_hint(attrs, shapes):
    """A regression output's label has the data's shape."""
    data = shapes[0]
    if data is None:
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = data
    return out


class _RegressionOutputFn(torch.autograd.Function):
    """``link(data)`` whose backward is the reference's custom VJP
    (``nn.py:899-956``): the head gradient is ignored, the data gets
    ``grad(out, label) * grad_scale`` and the label zeros."""

    @staticmethod
    def forward(ctx, data, label, link, grad, grad_scale):
        out = link(data)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        dd = ctx.grad(out, label.reshape(out.shape)) * ctx.grad_scale
        dl = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return dd, dl, None, None, None


def _regression_output(name, link, grad, doc):
    def fn(attrs, data, label):
        return _RegressionOutputFn.apply(data, label, link, grad,
                                         attrs["grad_scale"])
    fn.__doc__ = doc
    register(name, aliases=(name.lower(),), arg_names=("data", "label"),
             params={"grad_scale": param(float, 1.0)},
             shape_hint=_label_like_hint)(fn)


_regression_output(
    "LinearRegressionOutput", lambda d: d.clone(), lambda o, l: o - l,
    "The identity; its gradient is ``(data - label) * grad_scale``.")
_regression_output(
    "LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l,
    "``sigmoid(data)``; its gradient is ``(sigmoid(data) - label) * "
    "grad_scale``.")
_regression_output(
    "MAERegressionOutput", lambda d: d.clone(),
    lambda o, l: torch.sign(o - l),
    "The identity; its gradient is ``sign(data - label) * grad_scale``.")
