"""Generate ``nd.<op>`` functions from the op registry (counterpart of
``mxnet_tpu/ndarray/register.py``) and run them: :func:`invoke` is the
imperative dispatch (``mxnet_tpu/ndarray/ndarray.py:489-580``).

A generated function takes its inputs as positional NDArrays (or lists of
them, or numpy arrays) or as keywords named after the op's arguments, its
attrs as keywords, and positional scalars for the op's parameters in
order.  Under ``autograd.record`` the op runs with grad mode on, so its
outputs carry the graph that ``backward`` differentiates; otherwise under
``no_grad``.  A train-aware op (``BatchNorm``, ``Dropout``) is told
``autograd.is_training()``; an op that draws random numbers gets its
device's generator (:func:`mxnet_tpu_torch.random.generator`).  Each
output that ``aux_writeback`` maps onto an input is written into that
input's NDArray (BatchNorm's moving statistics, an update op's new
states), and the visible outputs are returned, or written into ``out``
(``nd.sgd_mom_update(w, g, mom, out=w, lr=0.1, momentum=0.9)`` updates
``w`` and ``mom``); a marked leaf is written in place, so it stays the
leaf its recorded graphs and gradient buffer are bound to.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from ..ops.registry import OPS
from .ndarray import NDArray, array

__all__ = ["invoke", "populate"]


def _inputs(op, args, kwargs):
    """(input NDArrays, attr keywords) from a generated function's
    arguments."""
    inputs, scalars = [], []
    for a in args:
        if isinstance(a, NDArray):
            inputs.append(a)
        elif isinstance(a, (list, tuple)) and a and \
                isinstance(a[0], NDArray):
            inputs.extend(a)
        elif isinstance(a, np.ndarray):
            inputs.append(array(a, inputs[0].context if inputs else None))
        else:
            scalars.append(a)
    by_name = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
    attrs = {k: v for k, v in kwargs.items() if k not in by_name}
    if by_name:
        slots = {n: i for i, n in enumerate(op.arg_names or ())}
        ins = list(inputs)
        for k, v in by_name.items():
            i = slots.get(k)
            if i is None:
                ins.append(v)
                continue
            while len(ins) <= i:
                ins.append(None)
            if ins[i] is not None:
                raise MXNetError("op %s: input %r given both positionally "
                                 "and by keyword" % (op.name, k))
            ins[i] = v
        if any(v is None for v in ins):
            raise MXNetError("op %s: missing input(s) %s" % (
                op.name, [op.arg_names[i] for i, v in enumerate(ins)
                          if v is None]))
        inputs = ins
    for k in op.params:
        if not scalars:
            break
        if k not in attrs and not k.startswith("__"):
            attrs[k] = scalars.pop(0)
    return inputs, attrs


def invoke(op_name, *args, out=None, **kwargs):
    """Run op ``op_name`` imperatively (see the module docstring)."""
    op = OPS[op_name]
    kwargs.pop("name", None)
    ctx = kwargs.pop("ctx", None)
    inputs, kwargs = _inputs(op, args, {k: v for k, v in kwargs.items()
                                        if v is not None})
    if not all(isinstance(a, NDArray) for a in inputs):
        raise MXNetError("op %s: inputs must be NDArrays, got %s"
                         % (op_name, [type(a).__name__ for a in args]))
    attrs = op.parse_attrs(kwargs)
    if "num_args" in op.params:
        attrs["num_args"] = len(inputs)
    if op.train_aware:
        attrs["__train__"] = autograd.is_training()
    recording = autograd.is_recording()
    if recording:
        autograd.lift(inputs)
    tensors = [a._data for a in inputs]
    if not tensors:
        attrs["__device__"] = (ctx or current_context()).torch_device
    if op.needs_rng:
        tensors.insert(0, _random.generator(
            inputs[0].context if inputs else (ctx or current_context())))
    with torch.set_grad_enabled(recording):
        res = op.fn(attrs, *tensors)
    outs = list(res) if isinstance(res, tuple) else [res]
    for oi, ii in op.aux_writeback.items():
        if ii < len(inputs):
            inputs[ii]._assign(outs[oi].detach())
    visible = outs[:op.num_visible_outputs(attrs)]
    if out is None:
        out_ctx = inputs[0]._ctx if inputs else ctx
        arrays = [NDArray(t, out_ctx) for t in visible]
        return arrays[0] if len(arrays) == 1 else arrays
    targets = out if isinstance(out, (list, tuple)) else [out]
    for dst, t in zip(targets, visible):
        dst._assign(t.to(dst._data.dtype))
    return out


def _make_fn(op_name):
    def fn(*args, **kwargs):
        return invoke(op_name, *args, **kwargs)

    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = OPS[op_name].doc
    return fn


def populate(module_dict):
    for name in list(OPS):
        if name not in module_dict:
            module_dict[name] = _make_fn(name)
