"""Parameters from the reference package (``mxnet_tpu``) into the port.

The reference keeps parameters as ``{name: array}`` dicts, with or without
the checkpoint's ``arg:``/``aux:`` prefixes, and writes them with
``mxnet_tpu.nd.save`` into an npz ``.params`` file.  ``from_jax_params``
takes either form and places every array on a context, so both packages
can be fed the same weights.  ``from_jax_block`` carries a reference Gluon
block's parameters and auxiliary states into a port block of the same
structure, by name.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import MXNetError
from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["from_jax_params", "from_jax_block"]


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
