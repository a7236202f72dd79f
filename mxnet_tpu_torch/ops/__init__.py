"""Operators of the port (counterpart of ``mxnet_tpu/ops``); importing the
package registers them."""
from . import registry  # noqa: F401
from . import elemwise  # noqa: F401
from . import matrix  # noqa: F401
from . import nn  # noqa: F401
from . import reduce  # noqa: F401
from . import rnn  # noqa: F401
from .registry import OPS, get_op

__all__ = ["OPS", "get_op"]
