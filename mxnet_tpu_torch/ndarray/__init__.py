"""NDArray package (counterpart of ``mxnet_tpu/ndarray``)."""
from .ndarray import NDArray, array, load, ones, save, zeros
from . import random

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load", "random"]
