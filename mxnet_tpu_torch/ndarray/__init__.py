"""NDArray package (counterpart of ``mxnet_tpu/ndarray``), with one
``nd.<op>`` function per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import NDArray, array, concatenate, load, ones, save, zeros
from . import random
from . import register as _register

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load",
           "concatenate", "random"]

_register.populate(globals())
