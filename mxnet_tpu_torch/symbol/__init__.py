"""Symbol package (counterpart of ``mxnet_tpu/symbol``): graph construction
plus one ``sym.<op>`` constructor per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .symbol import (Group, Symbol, Variable, arange, load, load_json,
                     var)
from . import register as _register
from . import contrib, image, random

_register.populate(globals())
