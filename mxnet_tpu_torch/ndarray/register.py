"""Generate ``nd.<op>`` functions from the op registry (counterpart of
``mxnet_tpu/ndarray/register.py``).  A generated function takes its inputs
as positional NDArrays and its attrs as keywords, runs the op once without
autograd, writes each output that ``aux_writeback`` maps onto an input
back into that input's NDArray (an update op's new states), and returns the
visible outputs — in ``out`` when it is given, as ``nd.sgd_mom_update(w,
g, mom, out=w, lr=0.1, momentum=0.9)`` updates ``w`` and ``mom``."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.registry import OPS
from .ndarray import NDArray

__all__ = ["invoke", "populate"]


def invoke(op_name, *args, out=None, **kwargs):
    """Run op ``op_name`` on NDArray inputs (see the module docstring)."""
    op = OPS[op_name]
    if not all(isinstance(a, NDArray) for a in args):
        raise MXNetError("op %s: inputs must be NDArrays, got %s"
                         % (op_name, [type(a).__name__ for a in args]))
    attrs = op.parse_attrs(dict(kwargs))
    with torch.no_grad():
        res = op.fn(attrs, *[a._data for a in args])
    outs = list(res) if isinstance(res, tuple) else [res]
    for oi, ii in op.aux_writeback.items():
        if ii < len(args):
            args[ii]._data = outs[oi]
    visible = outs[:op.num_visible_outputs(attrs)]
    if out is None:
        arrays = [NDArray(t) for t in visible]
        return arrays[0] if len(arrays) == 1 else arrays
    targets = out if isinstance(out, (list, tuple)) else [out]
    for dst, t in zip(targets, visible):
        dst._data = t
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
