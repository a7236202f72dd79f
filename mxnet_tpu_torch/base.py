"""Foundations of the port (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Top-level framework error (parity with ``mxnet.base.MXNetError``)."""
