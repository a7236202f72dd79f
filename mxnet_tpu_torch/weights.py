"""Parameters from the reference package (``mxnet_tpu``) into the port.

The reference keeps parameters as ``{name: array}`` dicts, with or without
the checkpoint's ``arg:``/``aux:`` prefixes, and writes them with
``mxnet_tpu.nd.save`` into an npz ``.params`` file.  ``from_jax_params``
takes either form and places every array on a context, so both packages
can be fed the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional

from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["from_jax_params"]


def from_jax_params(params, ctx: Optional[Context] = None
                    ) -> Dict[str, nd.NDArray]:
    """``{name: NDArray}`` on ``ctx`` (default ``gpu(0)``) from a
    ``{name: array}`` dict (numpy arrays or anything with ``asnumpy()``)
    or a path to a ``.params`` file.  Names, prefixes included, are kept."""
    ctx = ctx or current_context()
    if isinstance(params, str):
        return {k: v.as_in_context(ctx) for k, v in nd.load(params).items()}
    return {k: nd.array(v.asnumpy() if hasattr(v, "asnumpy") else v, ctx)
            for k, v in dict(params).items()}
