"""``nd.image`` (counterpart of ``mxnet_tpu/ndarray/image.py``): one
function for each registered ``_image_<name>`` op, under ``<name>``."""
from __future__ import annotations

from .contrib import populate

populate(globals(), "_image_")
