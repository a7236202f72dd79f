"""``sym.random`` (counterpart of ``mxnet_tpu/symbol/random.py``): the
names of ``nd.random`` as graph nodes.  A node with no inputs draws on the
executor's device from the generator the plan hands it; a distribution
whose parameters are Symbols becomes the ``_sample_*`` node of
per-element parameters, ``shape`` draws an element."""
from __future__ import annotations

from .symbol import Symbol, _create

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def _draw(op, names, params, shape, dtype, name):
    syms = [p for p in params if isinstance(p, Symbol)]
    if syms:
        if len(syms) != len(params):
            raise TypeError("sym.random.%s: give every parameter as a "
                            "Symbol, or none" % op)
        return _create("_sample_" + op, list(params),
                       {"shape": shape, "dtype": dtype}, name)
    return _create("_random_" + op, [],
                   dict(zip(names, params), shape=shape, dtype=dtype), name)


def uniform(low=0.0, high=1.0, shape=(), dtype=None, name=None, **kwargs):
    """Samples from U[low, high)."""
    return _draw("uniform", ("low", "high"), (low, high), shape, dtype, name)


def normal(loc=0.0, scale=1.0, shape=(), dtype=None, name=None, **kwargs):
    """Samples from N(loc, scale²)."""
    return _draw("normal", ("loc", "scale"), (loc, scale), shape, dtype,
                 name)


def randn(*shape, **kwargs):
    """Standard normal samples of ``shape`` ((1,) when none is given)."""
    return normal(shape=shape or (1,), **kwargs)


def gamma(alpha=1.0, beta=1.0, shape=(), dtype=None, name=None, **kwargs):
    """Samples from Gamma(alpha, beta), beta the scale."""
    return _draw("gamma", ("alpha", "beta"), (alpha, beta), shape, dtype,
                 name)


def exponential(lam=1.0, shape=(), dtype=None, name=None, **kwargs):
    """Samples from the exponential distribution of rate ``lam``."""
    return _draw("exponential", ("lam",), (lam,), shape, dtype, name)


def poisson(lam=1.0, shape=(), dtype=None, name=None, **kwargs):
    """Samples from the Poisson distribution of rate ``lam``."""
    return _draw("poisson", ("lam",), (lam,), shape, dtype, name)


def negative_binomial(k=1, p=1.0, shape=(), dtype=None, name=None,
                      **kwargs):
    """Failures before the ``k``-th success at success rate ``p``."""
    return _draw("negative_binomial", ("k", "p"), (k, p), shape, dtype, name)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype=None,
                                  name=None, **kwargs):
    """Samples of mean ``mu`` and dispersion ``alpha``."""
    return _draw("generalized_negative_binomial", ("mu", "alpha"),
                 (mu, alpha), shape, dtype, name)


def randint(low, high, shape=(), dtype=None, name=None, **kwargs):
    """Integers in [low, high), int32 unless ``dtype`` says otherwise."""
    return _create("_random_randint", [], {"low": low, "high": high,
                                           "shape": shape, "dtype": dtype},
                   name)


def multinomial(data, shape=(), get_prob=False, dtype="int32", name=None,
                **kwargs):
    """Category draws from the probabilities along ``data``'s last axis."""
    return _create("_sample_multinomial", [data],
                   {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                   name)


def shuffle(data, name=None, **kwargs):
    """``data`` with its first axis randomly permuted."""
    return _create("_shuffle", [data], {}, name)
