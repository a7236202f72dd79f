"""Foundations of the port (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os
from typing import Any

__all__ = ["MXNetError", "get_env"]


class MXNetError(RuntimeError):
    """Top-level framework error (parity with ``mxnet.base.MXNetError``)."""


def get_env(name: str, default: Any = None, dtype: type = str) -> Any:
    """Typed environment setting (``mxnet_tpu/base.py:60``): ``default``
    when ``name`` is unset, else its value as ``dtype``; a bool is false
    for "0", "false", "off" and "" (any case)."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is bool:
        return val.lower() not in ("0", "false", "off", "")
    return dtype(val)
