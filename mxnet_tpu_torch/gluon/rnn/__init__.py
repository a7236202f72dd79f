"""Gluon recurrent layers (counterpart of ``mxnet_tpu/gluon/rnn``; so far
the fused ``LSTM`` layer)."""
from .rnn_layer import *  # noqa: F401,F403
