"""Parameters from the reference package (``mxnet_tpu``) into the port.

The reference keeps parameters as ``{name: array}`` dicts, with or without
the checkpoint's ``arg:``/``aux:`` prefixes, and writes them with
``mxnet_tpu.nd.save`` into an npz ``.params`` file.  ``from_jax_params``
takes either form and places every array on a context, so both packages
can be fed the same weights.  ``from_jax_block`` carries a reference Gluon
block's parameters and auxiliary states into a port block of the same
structure, by name, and ``from_jax_module`` a reference Module's (or
``BucketingModule``'s) into a port Module's, with its optimizer's states
(``from_jax_updater``).  ``from_jax_moe_params`` carries a reference
``MoEParams`` into the port's, and ``from_jax_stage_params`` a dict of
stage-stacked ``(S, ...)`` block parameters (``pipeline_transformer``'s),
so that both packages' parallel compositions compute with the same
weights.  ``fold_bottleneck`` folds a
ResNet v1 identity bottleneck's three convolutions and BatchNorms into the
layout of kernel 13 (``ops/hopper_block.py``), and ``from_probe_block``
carries the arrays of ``tools/probe_fused_block.py`` into that layout.

The reference's bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which the
port does not import: they are told by the dtype's name and carried across
bit for bit through an ``int16`` view (``ndarray.bf16_from_numpy``), so a
bf16 weight stays bf16.  A multi-precision updater's states, ``(inner,
master)`` per slot, carry across in the reference's pickle like any other.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["from_jax_params", "from_jax_block", "from_jax_module",
           "from_jax_updater", "from_jax_moe_params", "from_jax_stage_params",
           "fold_bottleneck", "from_probe_block"]


def from_jax_params(params, ctx: Optional[Context] = None
                    ) -> Dict[str, nd.NDArray]:
    """``{name: NDArray}`` on ``ctx`` (default ``gpu(0)``) from a
    ``{name: array}`` dict (numpy arrays or anything with ``asnumpy()``)
    or a path to a ``.params`` file.  Names, prefixes included, are kept."""
    ctx = ctx or current_context()
    if isinstance(params, str):
        return nd.load(params, ctx)
    return {k: nd.array(v.asnumpy() if hasattr(v, "asnumpy") else v, ctx)
            for k, v in dict(params).items()}


def from_jax_block(jax_net_or_params, net, ctx: Optional[Context] = None):
    """Set every Parameter of the port block ``net`` (auxiliary states
    included) on ``ctx`` (default ``gpu(0)``) from a reference Gluon block
    (its ``collect_params()``) or a ``{name: array}`` dict, by name.
    Raises when a name is missing on either side or a shape differs from
    the port's known dims.  Returns ``net``."""
    ctx = ctx or current_context()
    src = jax_net_or_params
    if hasattr(src, "collect_params"):
        src = {k: p.data() for k, p in src.collect_params().items()}
    values = {k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
              for k, v in dict(src).items()}
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(values))
    extra = sorted(set(values) - set(params.keys()))
    if missing or extra:
        raise MXNetError("from_jax_block: names differ; missing in the "
                         "source: %s, not in the block: %s"
                         % (missing[:5], extra[:5]))
    for name, p in params.items():
        v = values[name]
        if p.shape is not None and (len(p.shape) != v.ndim or any(
                s > 0 and s != d for s, d in zip(p.shape, v.shape))):
            raise MXNetError("from_jax_block: %s has shape %s, the block "
                             "wants %s" % (name, v.shape, p.shape))
        p._load_init(v, [ctx])
    return net


def from_jax_module(jax_mod, ctx: Optional[Context] = None, mod=None,
                    optimizer_states=False):
    """``(arg_params, aux_params)``, dicts of NDArrays on ``ctx`` (default
    ``gpu(0)``), from a reference Module's ``get_params()``.

    The names are checked against the parameters and auxiliary states of
    ``mod``, a bound port Module, when it is given (and its parameters are
    then set from them), else against the reference Module's own symbol;
    a missing or extra name, or a shape that differs, raises.  With
    ``optimizer_states`` (and ``mod``'s optimizer initialised) the
    reference Module's updater states and update counts carry over too
    (:func:`from_jax_updater`), masters of a multi-precision updater
    included.  bf16 values stay bf16, bit for bit.

    Either Module may be a ``BucketingModule``: its current bucket's
    parameters are carried (every bucket of the port's shares them) and
    its shared updater's states."""
    ctx = ctx or current_context()
    arg, aux = jax_mod.get_params()
    jax_mod = getattr(jax_mod, "_curr_module", None) or jax_mod
    port_mod = mod
    if mod is not None:
        mod = getattr(mod, "_curr_module", None) or mod
    out = []
    for kind, src in (("parameter", arg), ("auxiliary state", aux)):
        out.append({k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                  else v) for k, v in src.items()})
    if mod is not None:
        ex = mod._exec_group.execs[0]
        want = ({n: ex.arg_dict[n].shape for n in mod._param_names},
                {n: ex.aux_dict[n].shape for n in mod._aux_names})
    else:
        sym = jax_mod.symbol
        inputs = set(jax_mod.data_names) | set(jax_mod.label_names)
        want = ({n: None for n in sym.list_arguments() if n not in inputs},
                {n: None for n in sym.list_auxiliary_states()})
    for (kind, values), names in zip((("parameter", out[0]),
                                      ("auxiliary state", out[1])), want):
        missing = sorted(set(names) - set(values))
        extra = sorted(set(values) - set(names))
        if missing or extra:
            raise MXNetError("from_jax_module: %s names differ; missing in "
                             "the source: %s, not in the module: %s"
                             % (kind, missing[:5], extra[:5]))
        for n, shape in names.items():
            if shape is not None and tuple(values[n].shape) != tuple(shape):
                raise MXNetError("from_jax_module: %s has shape %s, the "
                                 "module wants %s"
                                 % (n, values[n].shape, shape))
    arg_params = {k: nd.array(v, ctx) for k, v in out[0].items()}
    aux_params = {k: nd.array(v, ctx) for k, v in out[1].items()}
    if mod is not None:
        port_mod.set_params(arg_params, aux_params)
        if optimizer_states:
            from_jax_updater(jax_mod._updater, mod._updater)
    return arg_params, aux_params


def from_jax_updater(jax_updater, updater):
    """Set a port ``Updater``'s states from a reference ``Updater``'s,
    through the reference's pickle of numpy states (the ``.states`` file's
    format), with the optimizer's per-slot update counts and
    ``num_update``, which the pickle leaves out, so that Adam's bias
    correction and a scheduler's rate go on from the same step.  Returns
    ``updater``."""
    updater.set_states(jax_updater.get_states(dump_optimizer=True))
    src, dst = jax_updater.optimizer, updater.optimizer
    dst._index_update_count = dict(src._index_update_count)
    dst.num_update = src.num_update
    if hasattr(src, "m_schedule"):          # Nadam's running product
        dst.m_schedule = src.m_schedule
    return updater


def _tensor(value, ctx: Context):
    arr = np.asarray(value.asnumpy() if hasattr(value, "asnumpy") else value)
    if nd.is_numpy_bf16(arr):
        return nd.bf16_from_numpy(arr).to(ctx.torch_device)
    return torch.as_tensor(np.array(arr), device=ctx.torch_device)


def from_jax_moe_params(params, ctx: Optional[Context] = None):
    """The port's ``parallel.moe.MoEParams`` on ``ctx`` (default ``gpu(0)``)
    from a reference ``MoEParams`` (``wg``, ``w1``, ``w2``)."""
    from .parallel.moe import MoEParams
    ctx = ctx or current_context()
    return MoEParams(*(_tensor(getattr(params, n), ctx)
                       for n in ("wg", "w1", "w2")))


def from_jax_stage_params(params, ctx: Optional[Context] = None
                          ) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``ctx`` (default ``gpu(0)``) from a dict of
    stage-stacked arrays, every one with the same leading stage count."""
    ctx = ctx or current_context()
    out = {k: _tensor(v, ctx) for k, v in dict(params).items()}
    stages = {t.shape[0] for t in out.values() if t.dim() > 0}
    if len(stages) != 1 or any(t.dim() == 0 for t in out.values()):
        raise MXNetError("from_jax_stage_params: every array needs the same "
                         "leading stage dim, got shapes %s"
                         % {k: tuple(t.shape) for k, t in out.items()})
    return out


def _bn_scale_shift(conv_bias, gamma, beta, mean, var, eps, fix_gamma):
    """Per-channel (s, t) with BatchNorm(conv + bias) = conv * s + t at
    inference: ``s = gamma / sqrt(var + eps)`` (gamma taken as 1 under
    ``fix_gamma``), ``t = beta + (bias - mean) * s``, in fp32."""
    f32 = torch.float32
    s = torch.rsqrt(var.to(f32) + eps)
    if not fix_gamma:
        s = s * gamma.to(f32)
    shift = -mean.to(f32) if conv_bias is None \
        else conv_bias.to(f32) - mean.to(f32)
    return s, beta.to(f32) + shift * s


def fold_bottleneck(conv1_weight, conv1_bias, bn1, conv2_weight, conv2_bias,
                    bn2, conv3_weight, conv3_bias, bn3, dtype=torch.bfloat16):
    """Fold an identity bottleneck at inference into kernel 13's operands.

    The convolutions' OIHW weights (1x1 ``(Cm, Cin)``, 3x3 ``(Cm, Cm)``, 1x1
    ``(Cin, Cm)``) and biases (``None`` where a convolution has none), and
    each BatchNorm as ``(gamma, beta, moving_mean, moving_var, eps,
    fix_gamma)``.  Each folded weight is ``W * s`` per output channel and
    each bias ``t`` (:func:`_bn_scale_shift`), computed in fp32; the weights
    are rounded to ``dtype`` once.  Returns ``(w1 (Cm, Cin), w2 (9, Cm, Cm),
    w3 (Cin, Cm), b (3, Cin) fp32)``, every weight ``(out, in)`` as the
    convolutions' own, tap ``3 * dy + dx`` of w2, rows 0 and 1 of b holding
    the first two biases in their first Cm entries."""
    f32 = torch.float32
    folded = []
    for w, bias, bn in ((conv1_weight, conv1_bias, bn1),
                        (conv2_weight, conv2_bias, bn2),
                        (conv3_weight, conv3_bias, bn3)):
        s, t = _bn_scale_shift(bias, *bn)
        folded.append((w.to(f32) * s.reshape(-1, 1, 1, 1), t))
    (w1, t1), (w2, t2), (w3, t3) = folded
    Cm, Cin = w1.shape[:2]
    b = torch.zeros((3, Cin), dtype=f32, device=w1.device)
    b[0, :Cm] = t1
    b[1, :Cm] = t2
    b[2] = t3
    return (w1[:, :, 0, 0].to(dtype).contiguous(),
            w2.permute(2, 3, 0, 1).reshape(9, Cm, Cm).to(dtype).contiguous(),
            w3[:, :, 0, 0].to(dtype).contiguous(), b)


def from_probe_block(w1, w2, w3, b, ctx: Optional[Context] = None):
    """``tools/probe_fused_block.py``'s block operands (numpy, bf16 as
    ``ml_dtypes.bfloat16`` or float32; w1 (Cin, Cm), w2 (9, Cm, Cm) as (in,
    out) per tap, w3 (Cm, Cin), b (3, Cin)) as tensors on ``ctx`` (default
    ``gpu(0)``) in kernel 13's layout, the weights transposed to (out, in)
    and b fp32.  bf16 stays bf16, bit for bit."""
    ctx = ctx or current_context()
    w1, w2, w3, b = (_tensor(v, ctx) for v in (w1, w2, w3, b))
    Cin, Cm = w1.shape
    if tuple(w2.shape) != (9, Cm, Cm) or tuple(w3.shape) != (Cm, Cin) \
            or tuple(b.shape) != (3, Cin):
        raise MXNetError("from_probe_block: w1 %s, w2 %s, w3 %s and b %s do "
                         "not form a block" % tuple(tuple(t.shape)
                                                    for t in (w1, w2, w3, b)))
    return (w1.t().contiguous(), w2.transpose(1, 2).contiguous(),
            w3.t().contiguous(), b.float())
