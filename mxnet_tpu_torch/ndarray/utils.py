"""NDArray helpers (counterpart of ``mxnet_tpu/ndarray/utils.py``)."""
from __future__ import annotations

from .register import invoke

__all__ = ["zeros_like_fn"]


def zeros_like_fn(arr):
    """Zeros of ``arr``'s shape, dtype and context."""
    return invoke("zeros_like", arr)
