"""Random arrays (counterpart of ``mxnet_tpu/ndarray/random.py``): every
name runs a registered sampler through :func:`~.register.invoke`, so a draw
comes from its context's generator (:mod:`mxnet_tpu_torch.random`, seeded
by ``mx.random.seed``; ``ctx``, else ``out``'s, else the current one),
takes ``out=``, and records under ``autograd`` like
any op.  A distribution whose parameters are NDArrays runs the
``_sample_*`` op of per-element parameters, ``shape`` draws an element;
a number beside an NDArray is broadcast to its shape."""
from __future__ import annotations

from .ndarray import NDArray, full
from .register import invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def _arrays(*params):
    """The parameters as NDArrays of the first NDArray's shape and
    context, or None when none is an NDArray."""
    first = next((p for p in params if isinstance(p, NDArray)), None)
    if first is None:
        return None
    return [p if isinstance(p, NDArray)
            else full(first.shape, float(p), ctx=first.context,
                      dtype=first._data.dtype)
            for p in params]


def _draw(op, names, params, shape, dtype, ctx, out):
    """The ``_sample_<op>`` op on NDArray parameters, else ``_random_<op>``
    with the numbers as attributes."""
    arrays = _arrays(*params)
    if arrays is not None:
        return invoke("_sample_" + op, *arrays, shape=shape, dtype=dtype,
                      out=out)
    return invoke("_random_" + op, shape=shape, dtype=dtype,
                  ctx=_context(ctx, out), out=out, **dict(zip(names, params)))


def _context(ctx, out):
    """``ctx``, else ``out``'s context (None: the current one)."""
    if ctx is None and isinstance(out, NDArray):
        return out.context
    return ctx


def uniform(low=0.0, high=1.0, shape=(), dtype=None, ctx=None, out=None,
            **kwargs):
    """Samples from U[low, high)."""
    return _draw("uniform", ("low", "high"), (low, high), shape, dtype, ctx,
                 out)


def normal(loc=0.0, scale=1.0, shape=(), dtype=None, ctx=None, out=None,
           **kwargs):
    """Samples from N(loc, scale²)."""
    return _draw("normal", ("loc", "scale"), (loc, scale), shape, dtype,
                 ctx, out)


def randn(*shape, **kwargs):
    """Standard normal samples of ``shape`` ((1,) when none is given);
    ``loc``, ``scale``, ``dtype``, ``ctx`` and ``out`` as :func:`normal`."""
    return normal(shape=shape or (1,), **kwargs)


def gamma(alpha=1.0, beta=1.0, shape=(), dtype=None, ctx=None, out=None,
          **kwargs):
    """Samples from Gamma(alpha, beta), beta the scale."""
    return _draw("gamma", ("alpha", "beta"), (alpha, beta), shape, dtype,
                 ctx, out)


def exponential(lam=1.0, shape=(), dtype=None, ctx=None, out=None,
                **kwargs):
    """Samples from the exponential distribution of rate ``lam``."""
    return _draw("exponential", ("lam",), (lam,), shape, dtype, ctx, out)


def poisson(lam=1.0, shape=(), dtype=None, ctx=None, out=None, **kwargs):
    """Samples from the Poisson distribution of rate ``lam``."""
    return _draw("poisson", ("lam",), (lam,), shape, dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=(), dtype=None, ctx=None, out=None,
                      **kwargs):
    """Failures before the ``k``-th success at success rate ``p``."""
    return _draw("negative_binomial", ("k", "p"), (k, p), shape, dtype, ctx,
                 out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype=None,
                                  ctx=None, out=None, **kwargs):
    """Samples of mean ``mu`` and dispersion ``alpha``."""
    return _draw("generalized_negative_binomial", ("mu", "alpha"),
                 (mu, alpha), shape, dtype, ctx, out)


def randint(low, high, shape=(), dtype=None, ctx=None, out=None, **kwargs):
    """Integers in [low, high), int32 unless ``dtype`` says otherwise."""
    return invoke("_random_randint", low=low, high=high, shape=shape,
                  dtype=dtype, ctx=_context(ctx, out), out=out)


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None,
                **kwargs):
    """Category draws from the probabilities along ``data``'s last axis;
    with ``get_prob`` also each draw's log-probability."""
    return invoke("_sample_multinomial", data, shape=shape,
                  get_prob=get_prob, dtype=dtype, out=out)


def shuffle(data, out=None, **kwargs):
    """``data`` with its first axis randomly permuted."""
    return invoke("_shuffle", data, out=out)
