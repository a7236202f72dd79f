"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Zero``, ``One``, ``Uniform`` (the Gluon default, scale 0.07) and
``Xavier``, with the reference's name rules: a name
ending in ``weight`` takes the initializer's draw, ``bias`` and ``beta``
zero, ``gamma`` one, running/moving means zero and variances one.

Random draws come from the array's device generator
(:mod:`mxnet_tpu_torch.random`) and do not match the reference's threefry
draws; tests carry weights across by name instead."""
from __future__ import annotations

import math
from typing import Dict

from .base import MXNetError
from .ndarray import random as _ndrandom

__all__ = ["Initializer", "Zero", "One", "Uniform", "Xavier", "create",
           "register"]

_REGISTRY: Dict[str, type] = {}


def register(klass, aliases=()):
    """Register an initializer class under its lower-case name."""
    for name in (klass.__name__,) + tuple(aliases):
        _REGISTRY[name.lower()] = klass
    return klass


class Initializer:
    """Base initializer, called as ``init(name, arr)`` on an NDArray."""

    def __call__(self, name, arr):
        name = str(name)
        if name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif "moving_mean" in name or "running_mean" in name:
            arr[:] = 0.0
        elif ("moving_var" in name or "running_var" in name
              or "moving_inv_var" in name):
            arr[:] = 1.0
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


register(Zero, aliases=("zeros",))
register(One, aliases=("ones",))


@register
class Uniform(Initializer):
    """U[-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        arr._data = _ndrandom.uniform(-self.scale, self.scale, arr.shape,
                                      ctx=arr.context)._data.to(arr._data.dtype)


@register
class Xavier(Initializer):
    """Glorot: scale sqrt(magnitude / fan), fan from ``factor_type``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / factor)
        draw = _ndrandom.uniform(-scale, scale, shape, ctx=arr.context) \
            if self.rnd_type == "uniform" \
            else _ndrandom.normal(0.0, scale, shape, ctx=arr.context)
        arr._data = draw._data.to(arr._data.dtype)


def create(name, **kwargs) -> Initializer:
    """An initializer from its registered name (or itself)."""
    if isinstance(name, Initializer):
        return name
    klass = _REGISTRY.get(str(name).lower())
    if klass is None:
        raise MXNetError("unknown initializer %r (have %s)"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)
