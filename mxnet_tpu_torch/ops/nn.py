"""Neural-network ops of the serving and training paths (counterpart of
``mxnet_tpu/ops/nn.py``): Convolution, FullyConnected, Pooling, Activation,
BatchNorm (inference and training statistics), softmax, the SoftmaxOutput
forward, :func:`streaming_ce` and the ``streaming_softmax_ce`` and
``softmax_cross_entropy`` ops.

Convolution dispatch mirrors ``_pallas_conv_mode`` (``nn.py:239-268``)
without its environment flag and lane gate, which were TPU verdicts: the
3x3 / stride-1 / pad-1 class and the 3x3 / stride-2 / pad-1 class with even
H and W go to the hand-written kernels (``hopper_conv``, whose autograd
Functions carry the backward); every other convolution (ResNet's 7x7 stem,
the 1x1 projections) goes to ``torch.nn.functional.conv{1,2,3}d``, the
counterpart of the ``lax`` arm the reference package leaves to XLA.  Every
op is differentiable by PyTorch's autograd, which the training step uses.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import hopper_conv
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
    """"s1" / "s2" when the hand-written kernel covers this conv, else None:
    "s1" is the reference's ``_is_3x3_same_unit`` class, "s2" the 3x3 /
    stride-2 / pad-1 class on even spatial dims."""
    if len(attrs["kernel"]) != 2 or data.dim() != 4 \
            or attrs["num_group"] != 1 or tuple(attrs["kernel"]) != (3, 3) \
            or tuple(attrs["dilate"] or (1, 1)) != (1, 1) \
            or tuple(attrs["pad"] or (0, 0)) != (1, 1):
        return None
    stride = tuple(attrs["stride"] or (1, 1))
    if stride == (1, 1):
        return "s1"
    if stride == (2, 2) and data.shape[2] % 2 == 0 and data.shape[3] % 2 == 0:
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
    "pool_type": param(["max", "avg", "sum", "lp"], "max"),   # lp: not ported
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
    """Max/avg/sum pooling with the reference's padding conventions:
    max pads with -inf, "full" adds the extra right pad of a ceil-mode
    output, avg divides by the window size unless ``count_include_pad``
    is off."""
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
        raise MXNetError("Pooling: pool_type='lp' is not ported yet")
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
    normalizes by the batch's fp32 mean and biased variance, and outputs 1
    and 2 are ``moving * momentum + batch_stat * (1 - momentum)``, detached
    from the graph; the training plan writes them back into the auxiliary
    states.  Otherwise it normalizes by the moving statistics, which pass
    through unchanged."""
    ax = attrs["axis"] % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    low_precision = data.dtype in (torch.bfloat16, torch.float16)
    if attrs.get("__train__") and not attrs["use_global_stats"]:
        red = tuple(i for i in range(data.dim()) if i != ax)
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


@register("SoftmaxOutput", aliases=("softmaxoutput", "Softmax"),
          params=dict(_SOFTMAX_OUT_PARAMS), arg_names=("data", "label"),
          shape_hint=_softmax_label_hint)
def _softmax_output(attrs, data, label):
    """Forward of SoftmaxOutput: softmax of the logits (the label only
    shapes the gradient, which serving never takes).  Low-precision
    logits are reduced in fp32 and the probabilities stay fp32."""
    if data.dtype in (torch.bfloat16, torch.float16):
        data = data.float()
    if attrs["multi_output"]:
        return torch.softmax(data, dim=1)
    if attrs["preserve_shape"]:
        return torch.softmax(data, dim=-1)
    prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1)
    return prob.reshape(data.shape)


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
