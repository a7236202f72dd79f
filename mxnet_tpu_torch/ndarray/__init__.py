"""NDArray package (counterpart of ``mxnet_tpu/ndarray``), with one
``nd.<op>`` function per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, arange, array, concatenate, empty, full, load,
                      moveaxis, onehot_encode, ones, save, waitall, zeros)
from . import register as _register
from . import contrib, image, random, utils
from .register import invoke
from .utils import zeros_like_fn

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "save", "load", "concatenate", "moveaxis", "waitall",
           "onehot_encode", "invoke", "maximum", "minimum", "random",
           "contrib", "image", "utils", "zeros_like_fn"]

_register.populate(globals())


def _scalar_or_array(op, scalar_op, fold, lhs, rhs):
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke(op, lhs, rhs)
    if isinstance(lhs, NDArray):
        return invoke(scalar_op, lhs, scalar=float(rhs))
    if isinstance(rhs, NDArray):
        return invoke(scalar_op, rhs, scalar=float(lhs))
    return fold(lhs, rhs)


def maximum(lhs, rhs):
    """The larger of two arrays, or of an array and a number, elementwise
    (``mxnet_tpu/ndarray/__init__.py:35``)."""
    return _scalar_or_array("broadcast_maximum", "_maximum_scalar", max,
                            lhs, rhs)


def minimum(lhs, rhs):
    """The smaller of two arrays, or of an array and a number,
    elementwise."""
    return _scalar_or_array("broadcast_minimum", "_minimum_scalar", min,
                            lhs, rhs)
