"""``sym.image`` (counterpart of ``mxnet_tpu/symbol/image.py``): one
constructor for each registered ``_image_<name>`` op, under ``<name>``."""
from __future__ import annotations

from ..ndarray.contrib import populate
from .register import _make_fn

populate(globals(), "_image_", _make_fn)
