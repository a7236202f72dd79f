"""``nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``): one
function for each registered ``_contrib_<name>`` op, under ``<name>``.
The control-flow operators need ``ops/control_flow.py``, which is not
ported, and raise."""
from __future__ import annotations

from ..base import MXNetError
from ..ops.registry import OPS
from .register import _make_fn

_PREFIX = "_contrib_"


def populate(module_dict, prefix=_PREFIX, make=_make_fn):
    """Add ``make(op)`` under ``name`` for each registered ``prefix +
    name`` that ``module_dict`` does not hold yet."""
    for op_name in list(OPS):
        if op_name.startswith(prefix):
            short = op_name[len(prefix):]
            if short not in module_dict:
                fn = make(op_name)
                fn.__name__ = fn.__qualname__ = short
                module_dict[short] = fn


def _control_flow(name):
    def fn(*args, **kwargs):
        raise MXNetError("contrib.%s is not ported yet: it needs "
                         "ops/control_flow.py (ROADMAP.md Queue 1 item 9)"
                         % name)
    fn.__name__ = fn.__qualname__ = name
    return fn


foreach = _control_flow("foreach")
while_loop = _control_flow("while_loop")
cond = _control_flow("cond")

populate(globals())
