"""NDArray package (counterpart of ``mxnet_tpu/ndarray``)."""
from .ndarray import NDArray, array, load, save, zeros

__all__ = ["NDArray", "array", "zeros", "save", "load"]
