"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Zero``, ``One``, ``Constant``, ``Uniform`` (the Gluon default, scale
0.07), ``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``FusedRNN`` (the packed parameter vector of
the ``RNN`` op), ``Mixed`` (by name pattern) and ``Load``, with the
reference's name rules: a name ending in ``weight`` takes the
initializer's draw, ``bias`` and ``beta`` zero, ``gamma`` one,
running/moving means zero and variances one, any other name the draw.

Random draws come from the array's device generator
(:mod:`mxnet_tpu_torch.random`; ``Module.init_params`` fills host copies,
so the CPU generator) and do not match the reference's threefry draws;
tests carry weights across by name instead.  ``Orthogonal`` draws from
numpy's global generator, as the reference does, so one numpy seed gives
both packages the same matrix."""
from __future__ import annotations

import json
import math
import re
from typing import Dict

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import ndarray as nd
from .ndarray import random as _ndrandom

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "FusedRNN", "Mixed", "Load", "create", "register"]

_REGISTRY: Dict[str, type] = {}


def register(klass, aliases=()):
    """Register an initializer class under its lower-case name."""
    for name in (klass.__name__,) + tuple(aliases):
        _REGISTRY[name.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name with its symbol attributes (``initializer.py:26``),
    as ``Module.init_params`` passes it: an ``__init__`` attribute there
    overrides the initializer called."""

    def __new__(cls, name, attrs=None, global_init=None):
        s = super().__new__(cls, name)
        s.attrs = attrs or {}
        s.global_init = global_init
        return s


class Initializer:
    """Base initializer, called as ``init(desc, arr)`` on an NDArray, where
    ``desc`` is a name or an :class:`InitDesc`."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        """``'["name", {kwargs}]'``, which :func:`create` and ``FusedRNN``
        read back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr):
        init_attr = getattr(name, "attrs", {}).get("__init__", "")
        if init_attr:
            # the variable's own initializer, by its dumps() or name, draws
            # the values whatever the name says (initializer.py:54-61)
            klass, kwargs = json.loads(init_attr) \
                if init_attr.startswith("[") else (init_attr, {})
            create(klass, **kwargs)._init_weight(str(name), arr)
            return
        name = str(name)
        if name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("beta"):
            arr[:] = 0.0
        elif "moving_mean" in name or "running_mean" in name:
            arr[:] = 0.0
        elif ("moving_var" in name or "running_var" in name
              or "moving_inv_var" in name):
            arr[:] = 1.0
        else:
            self._init_default(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


def _set(arr, draw):
    """Bind a drawn NDArray's values in ``arr``'s dtype."""
    arr._data = draw._data.to(arr._data.dtype)


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
class Constant(Initializer):
    """``value`` everywhere."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U[-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _set(arr, _ndrandom.uniform(-self.scale, self.scale, arr.shape,
                                    ctx=arr.context))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _set(arr, _ndrandom.normal(0.0, self.sigma, arr.shape,
                                   ctx=arr.context))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthogonal factor of a (rows, rest) matrix drawn
    from numpy's global generator, uniform in [-1, 1) or standard
    normal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1, 1, (nout, nin))
        else:
            tmp = np.random.normal(0, 1, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape).astype(np.float32)


@register
class Xavier(Initializer):
    """Glorot: scale sqrt(magnitude / fan), fan from ``factor_type``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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
        _set(arr, _ndrandom.uniform(-scale, scale, shape, ctx=arr.context)
             if self.rnd_type == "uniform"
             else _ndrandom.normal(0.0, scale, shape, ctx=arr.context))


@register
class MSRAPrelu(Xavier):
    """He's initialisation for PReLU of slope ``slope``: Gaussian Xavier of
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for ``Deconvolution``)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)


@register
class LSTMBias(Initializer):
    """An LSTM bias: ``forget_bias`` on the forget gate (the second
    quarter, gates ``[i f g o]``), zero elsewhere."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The ``RNN`` op's packed parameter vector (``initializer.py:241``):
    each (layer, direction)'s input and recurrent matrices, at their own
    shapes ``(gates * H, in)`` and ``(gates * H, H)``, drawn by ``init``,
    in the order of ``ops/rnn.py``'s ``_unpack``, then the biases, zero
    but for an LSTM's forget gate, ``forget_bias`` in both halves of each
    (layer, direction).  ``init`` may be an initializer, its ``dumps()``
    or a registered name."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            if init.startswith("["):
                klass, kwargs = json.loads(init)
                init = create(klass, **kwargs)
            else:
                init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        from .ops.rnn import _NGATES
        ng = _NGATES[self._mode]
        h, L = self._num_hidden, self._num_layers
        dirs = 2 if self._bidirectional else 1
        total = int(np.prod(arr.shape))
        n_bias = L * dirs * 2 * ng * h
        n_weight = total - n_bias
        # layer 0's input size from the packed length
        deeper = (L - 1) * dirs * ng * h * (h * dirs + h)
        in0 = (n_weight - deeper) // (dirs * ng * h) - h
        flat = np.zeros(total, np.float32)
        if self._init is not None:
            ctx = arr.context if arr.context.device_type == "cpu" else cpu()
            off = 0
            for layer in range(L):
                in_sz = in0 if layer == 0 else h * dirs
                for _ in range(dirs):
                    for shape in ((ng * h, in_sz), (ng * h, h)):
                        blk = nd.zeros(shape, ctx=ctx)
                        self._init._init_weight(name, blk)
                        size = int(np.prod(shape))
                        flat[off:off + size] = blk.asnumpy().ravel()
                        off += size
            if off != n_weight:
                raise MXNetError("FusedRNN: %d weights for a packed vector "
                                 "of %d (%d biases)" % (off, total, n_bias))
        if self._mode == "lstm":
            per = 2 * ng * h
            for blk in range(L * dirs):
                for half in range(2):
                    start = n_weight + blk * per + half * ng * h
                    flat[start + h:start + 2 * h] = self._forget_bias
        arr[:] = flat.reshape(arr.shape)

    _init_default = _init_weight


class Load:
    """Values by name from ``param`` (``arg:``/``aux:`` prefixes dropped),
    ``default_init`` for the rest, or raise."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            arr[:] = self.param[name]
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError("cannot init %r: not found and no default"
                             % name)


@register
class Mixed:
    """The initializer of the first pattern (``re.match``) that matches
    the name; raises when none does."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), i) for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("no initializer pattern matches %r" % name)


def create(name, **kwargs) -> Initializer:
    """An initializer from its registered name (or itself)."""
    if isinstance(name, Initializer):
        return name
    klass = _REGISTRY.get(str(name).lower())
    if klass is None:
        raise MXNetError("unknown initializer %r (have %s)"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)
