"""Gluon contrib layers (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import *  # noqa: F401,F403
