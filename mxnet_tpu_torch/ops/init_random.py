"""Initialization and sampling ops (counterpart of
``mxnet_tpu/ops/init_random.py``): ``_zeros``, ``_ones`` and ``_full``
(``init_random.py:30-36``; the bucketed LSTM LM's initial states are a
``zeros`` node), ``_arange``, which the transformer LM's position ids start
from, ``_linspace``, ``_eye``, the ``_random_*`` samplers of scalar
parameters, ``_sample_multinomial``, ``_shuffle`` and the ``_sample_*``
samplers of per-element parameter arrays.

An op with no inputs has no tensor to take its device from, so the graph
plan hands it the executor's device as ``attrs["__device__"]`` (``meta``
during shape inference); its dtype is its own ``dtype`` attribute."""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..context import context_of
from ..ndarray.ndarray import torch_dtype
from .registry import param, register

__all__ = []

_INIT_PARAMS = {"shape": param("shape", ()),
                "dtype": param("dtype", "float32"),
                "ctx": param(str, None)}


def _filled(attrs, value):
    return torch.full(attrs["shape"], value,
                      dtype=torch_dtype(attrs["dtype"] or "float32"),
                      device=attrs.get("__device__", "cpu"))


@register("_zeros", aliases=("zeros",), params=dict(_INIT_PARAMS))
def _zeros(attrs):
    """Zeros of ``shape`` and ``dtype``."""
    return _filled(attrs, 0.0)


@register("_ones", aliases=("ones",), params=dict(_INIT_PARAMS))
def _ones(attrs):
    """Ones of ``shape`` and ``dtype``."""
    return _filled(attrs, 1.0)


@register("_full", aliases=("full",),
          params={**_INIT_PARAMS, "value": param(float, 0.0)})
def _full(attrs):
    """``value`` everywhere in ``shape``, as ``dtype``."""
    return _filled(attrs, attrs["value"])


@register("_arange", aliases=("arange",),
          params={**_INIT_PARAMS,
                  "start": param(float, 0.0), "stop": param(float, None),
                  "step": param(float, 1.0), "repeat": param(int, 1),
                  "infer_range": param(bool, False)})
def _arange(attrs):
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` when
    ``stop`` is unset), each repeated ``repeat`` times
    (``init_random.py:39-49``)."""
    start, stop = attrs["start"], attrs["stop"]
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, attrs["step"],
                       dtype=torch_dtype(attrs["dtype"] or "float32"),
                       device=attrs.get("__device__", "cpu"))
    if attrs["repeat"] > 1:
        out = out.repeat_interleave(attrs["repeat"])
    return out


@register("_linspace", aliases=("linspace",),
          params={**_INIT_PARAMS, "start": param(float, 0.0),
                  "stop": param(float, 1.0), "num": param(int, 50),
                  "endpoint": param(bool, True)})
def _linspace(attrs):
    """``num`` evenly spaced values from ``start`` to ``stop``, ``stop``
    included with ``endpoint`` (``init_random.py:52-58``)."""
    start, stop, num = attrs["start"], attrs["stop"], attrs["num"]
    dev = attrs.get("__device__", "cpu")
    dtype = torch_dtype(attrs["dtype"] or "float32")
    if attrs["endpoint"]:
        return torch.linspace(start, stop, num, dtype=torch.float64,
                              device=dev).to(dtype)
    step = (stop - start) / num if num else 0.0
    return (start + torch.arange(num, dtype=torch.float64, device=dev)
            * step).to(dtype)


@register("_eye", aliases=("eye",),
          params={**_INIT_PARAMS, "N": param(int, 0), "M": param(int, 0),
                  "k": param(int, 0)})
def _eye(attrs):
    """An ``N x M`` (``N x N`` when ``M`` is 0) matrix of ones on the
    ``k``-th diagonal (``init_random.py:61-66``)."""
    n, m = attrs["N"], attrs["M"] or attrs["N"]
    dev = attrs.get("__device__", "cpu")
    rows = torch.arange(n, device=dev).unsqueeze(1)
    cols = torch.arange(m, device=dev).unsqueeze(0)
    return (cols - rows == attrs["k"]).to(
        torch_dtype(attrs["dtype"] or "float32"))


# --------------------------------------------------------------------------
# samplers (``init_random.py:69-199``).  A sampler draws from the
# ``torch.Generator`` it is handed (``needs_rng``): the context's, seeded by
# ``mx.random.seed``, under ``nd.invoke``, and a per-step one in a training
# graph; an inference graph hands none, and the draw then comes from the
# device's own generator.  The reference's threefry streams and PyTorch's
# Philox never give the same bits, so one seed gives other draws there.
# --------------------------------------------------------------------------
_SAMPLE_COMMON = {"shape": param("shape", ()), "dtype": param("dtype", None),
                  "ctx": param(str, None)}


def _generator(generator, device):
    """``generator``, else the seeded generator of ``device``'s context."""
    if generator is not None or torch.device(device).type == "meta":
        return generator
    return _random.generator(context_of(torch.device(device)))


def _out_dtype(attrs, default="float32"):
    return torch_dtype(attrs.get("dtype") or default)


def _sampler(draw, default_dtype="float32"):
    """An op with no inputs from ``draw(attrs, generator, shape, device)``,
    which returns float32 (or the op's integer) samples; cast to ``dtype``.
    On ``meta`` (shape inference) nothing is drawn."""
    def fn(attrs, generator):
        dev = torch.device(attrs.get("__device__", "cpu"))
        shape = tuple(attrs["shape"] or ())
        dtype = _out_dtype(attrs, default_dtype)
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        return draw(attrs, _generator(generator, dev), shape, dev).to(dtype)
    fn.__doc__ = draw.__doc__
    return fn


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws of the shape of the tensor ``alpha``
    (Marsaglia-Tsang in ``torch._standard_gamma``)."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


def _poisson(lam, generator):
    return torch.poisson(lam.contiguous(), generator=generator)


def _full(shape, value, device):
    return torch.full(shape, float(value), dtype=torch.float32, device=device)


def _uniform(attrs, generator, shape, device):
    """U[low, high)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * (attrs["high"] - attrs["low"]) + attrs["low"]


def _normal(attrs, generator, shape, device):
    """N(loc, scale²)."""
    return torch.randn(shape, generator=generator, device=device) \
        * attrs["scale"] + attrs["loc"]


def _gamma_op(attrs, generator, shape, device):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return _gamma(_full(shape, attrs["alpha"], device), generator) \
        * attrs["beta"]


def _exponential(attrs, generator, shape, device):
    """Exponential with rate ``lam``."""
    return torch.empty(shape, device=device).exponential_(
        attrs["lam"], generator=generator)


def _poisson_op(attrs, generator, shape, device):
    """Poisson with rate ``lam``."""
    return _poisson(_full(shape, attrs["lam"], device), generator)


def _negative_binomial(attrs, generator, shape, device):
    """Failures before the ``k``-th success at success rate ``p``: a
    Poisson of a Gamma(k, (1 - p) / p) rate, as the reference composes
    it."""
    p = attrs["p"]
    lam = _gamma(_full(shape, attrs["k"], device), generator) * (1 - p) / p
    return _poisson(lam, generator)


def _generalized_negative_binomial(attrs, generator, shape, device):
    """Mean ``mu``, dispersion ``alpha``: a Poisson of a Gamma(1 / alpha,
    mu * alpha) rate (the gamma-Poisson mixture of the reference)."""
    a = 1.0 / max(attrs["alpha"], 1e-12)
    lam = _gamma(_full(shape, a, device), generator) * attrs["mu"] / a
    return _poisson(lam, generator)


def _randint(attrs, generator, shape, device):
    """Integers in ``[low, high)``."""
    return torch.randint(attrs["low"], attrs["high"], shape,
                         generator=generator, device=device,
                         dtype=torch.int64)


for _name, _draw, _extra, _dt in (
        ("uniform", _uniform, {"low": param(float, 0.0),
                               "high": param(float, 1.0)}, "float32"),
        ("normal", _normal, {"loc": param(float, 0.0),
                             "scale": param(float, 1.0)}, "float32"),
        ("gamma", _gamma_op, {"alpha": param(float, 1.0),
                              "beta": param(float, 1.0)}, "float32"),
        ("exponential", _exponential, {"lam": param(float, 1.0)}, "float32"),
        ("poisson", _poisson_op, {"lam": param(float, 1.0)}, "float32"),
        ("negative_binomial", _negative_binomial,
         {"k": param(int, 1), "p": param(float, 1.0)}, "float32"),
        ("generalized_negative_binomial", _generalized_negative_binomial,
         {"mu": param(float, 1.0), "alpha": param(float, 1.0)}, "float32"),
        ("randint", _randint, {"low": param(int, 0), "high": param(int, 1)},
         "int32")):
    _aliases = ("random_" + _name,)
    if _name in ("uniform", "normal"):
        _aliases = (_name,) + _aliases
    register("_random_" + _name, aliases=_aliases, needs_rng=True,
             params={**_SAMPLE_COMMON, **_extra})(_sampler(_draw, _dt))


def _multinomial_nout(attrs):
    return 2 if attrs["get_prob"] else 1


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True, nout=_multinomial_nout,
          params={"shape": param("shape", ()), "get_prob": param(bool, False),
                  "dtype": param("dtype", "int32")})
def _sample_multinomial(attrs, generator, data):
    """Category draws from the probabilities along ``data``'s last axis:
    ``shape`` draws (one, of shape (), when ``shape`` is empty) for a 1-D
    ``data``, ``(n,) + shape`` for an (n, k) one (``init_random.py:
    155-167``).  With ``get_prob`` a second output holds each draw's
    log-probability, ``log(data[draw])``, differentiable in ``data``
    (upstream MXNet's ``get_prob``, which the REINFORCE examples
    train through)."""
    shape = tuple(attrs["shape"] or ())
    n = int(np.prod(shape)) if shape else 1
    lead = tuple(data.shape[:-1])
    out_shape = lead + shape
    dtype = _out_dtype(attrs, "int32")
    if data.device.type == "meta":
        out = torch.empty(out_shape, dtype=dtype, device=data.device)
        return (out, torch.empty(out_shape, dtype=data.dtype,
                                 device=data.device)) \
            if attrs["get_prob"] else out
    probs = data.detach().reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=_generator(generator, data.device))
    draws = draws.reshape(out_shape)
    if not attrs["get_prob"]:
        return draws.to(dtype)
    flat = data.reshape(-1, data.shape[-1])
    logp = torch.log(flat.gather(1, draws.reshape(flat.shape[0], n)))
    return draws.to(dtype), logp.reshape(out_shape)


@register("_shuffle", aliases=("shuffle",), needs_rng=True)
def _shuffle(attrs, generator, data):
    """``data`` with its first axis permuted (``init_random.py:170-172``)."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_generator(generator, data.device))
    return data[perm]


def per_element_sampler(draw):
    """An op of per-element parameter arrays: each element draws
    ``shape`` samples, so the output is ``params[0].shape + shape``;
    ``draw(generator, *params)`` gets the parameters broadcast to that
    shape (``init_random.py:176-199``, ``misc_parity.py:253-281``)."""
    def fn(attrs, generator, *params):
        shape = tuple(attrs["shape"] or ())
        out_shape = tuple(params[0].shape) + shape
        dtype = _out_dtype(attrs)
        if params[0].device.type == "meta":
            return torch.empty(out_shape, dtype=dtype,
                               device=params[0].device)
        ps = [p.float().reshape(tuple(p.shape) + (1,) * len(shape))
              .expand(out_shape) for p in params]
        return draw(_generator(generator, params[0].device), *ps).to(dtype)
    fn.__doc__ = draw.__doc__
    return fn


def _sample_uniform(gen, low, high):
    """U[low, high) with per-element bounds."""
    return low + (high - low) * torch.rand(low.shape, generator=gen,
                                           device=low.device)


def _sample_normal(gen, mu, sigma):
    """N(mu, sigma²) with per-element parameters."""
    return mu + sigma * torch.randn(mu.shape, generator=gen,
                                    device=mu.device)


def _sample_gamma(gen, alpha, beta):
    """Gamma(alpha, beta) with per-element parameters; differentiable in
    both (``_standard_gamma``'s implicit gradient)."""
    return _gamma(alpha, gen) * beta


for _name, _draw, _args in (
        ("uniform", _sample_uniform, ("low", "high")),
        ("normal", _sample_normal, ("mu", "sigma")),
        ("gamma", _sample_gamma, ("alpha", "beta"))):
    register("_sample_" + _name, aliases=("sample_" + _name,),
             needs_rng=True, arg_names=_args,
             params={"shape": param("shape", ()),
                     "dtype": param("dtype", None)})(
        per_element_sampler(_draw))
