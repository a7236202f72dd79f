"""Random arrays on a context (counterpart of ``mxnet_tpu.nd.random``),
drawn from that device's generator (:mod:`mxnet_tpu_torch.random`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..context import Context, current_context
from .. import random as _random
from .ndarray import NDArray, torch_dtype

__all__ = ["uniform", "normal"]


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=(1,), ctx: Optional[Context] = None,
            dtype="float32") -> NDArray:
    """Samples from U[low, high)."""
    ctx = ctx or current_context()
    t = torch.rand(_shape(shape), generator=_random.generator(ctx),
                   device=ctx.torch_device, dtype=torch_dtype(dtype))
    return NDArray(t * (high - low) + low)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx: Optional[Context] = None,
           dtype="float32") -> NDArray:
    """Samples from N(loc, scale²)."""
    ctx = ctx or current_context()
    t = torch.randn(_shape(shape), generator=_random.generator(ctx),
                    device=ctx.torch_device, dtype=torch_dtype(dtype))
    return NDArray(t * scale + loc)
