"""Shape and indexing ops (counterpart of ``mxnet_tpu/ops/matrix.py``): what
the ResNet graphs and the LSTM layer's graph use."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import param, register

__all__ = ["infer_reshape"]


def infer_reshape(src_shape, target, reverse=False):
    """MXNet's reshape target codes (``matrix.py:20-58``): 0 keeps a dim,
    -1 infers one, -2 copies the rest, -3 merges two, -4 splits one into
    the next two entries."""
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        target = tuple(target)[::-1]
    out = []
    i = 0
    t = list(target)
    j = 0
    while j < len(t):
        d = t[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = t[j + 1], t[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            if i < len(src):
                i += 1
        j += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(src_shape)) if src_shape else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = out[::-1]
    return tuple(int(d) for d in out)


@register("Reshape", aliases=("reshape",),
          params={"shape": param("shape", ()), "reverse": param(bool, False),
                  "target_shape": param("shape", ()),
                  "keep_highest": param(bool, False)})
def _reshape(attrs, x):
    tgt = attrs["shape"] or attrs["target_shape"]
    return x.reshape(infer_reshape(tuple(x.shape), tgt, attrs["reverse"]))


@register("Flatten", aliases=("flatten",))
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


@register("Concat", aliases=("concat",),
          params={"dim": param(int, 1), "num_args": param(int, 0)})
def _concat(attrs, *xs):
    dim = attrs["dim"] % xs[0].dim()
    if xs[0].device.type == "meta":
        # shape inference: torch.cat's meta kernel imports torch._dynamo at
        # first use, which takes seconds
        shape = list(xs[0].shape)
        shape[dim] = sum(x.shape[dim] for x in xs)
        return xs[0].new_empty(shape)
    return torch.cat(xs, dim=dim)


@register("SwapAxis", aliases=("swapaxes",),
          params={"dim1": param(int, 0), "dim2": param(int, 0)})
def _swapaxes(attrs, x):
    return x.transpose(attrs["dim1"], attrs["dim2"])


@register("Embedding", aliases=("embedding",), arg_names=("data", "weight"),
          params={"input_dim": param(int, 0, required=True),
                  "output_dim": param(int, 0, required=True),
                  "dtype": param("dtype", "float32"),
                  "sparse_grad": param(bool, False)})
def _embedding(attrs, data, weight):
    """Rows of ``weight`` for the ids in ``data`` (float ids are cast to
    int64), a gather; its gradient is autograd's."""
    return F.embedding(data.long(), weight)


@register("zeros_like")
def _zeros_like(attrs, x):
    return torch.zeros_like(x)
