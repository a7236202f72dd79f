"""``sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``): one
constructor for each registered ``_contrib_<name>`` op, under ``<name>``.
The control-flow operators need ``ops/control_flow.py``, which is not
ported, and raise."""
from __future__ import annotations

from ..ndarray.contrib import _control_flow, populate
from .register import _make_fn

foreach = _control_flow("foreach")
while_loop = _control_flow("while_loop")
cond = _control_flow("cond")

populate(globals(), "_contrib_", _make_fn)
