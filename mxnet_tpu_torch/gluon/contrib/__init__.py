"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the ``nn``
layers.  ``contrib.rnn`` is not ported yet (Queue 1 item 5)."""
from . import nn
