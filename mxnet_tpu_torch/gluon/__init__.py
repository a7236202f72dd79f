"""Gluon: Blocks that build Symbol graphs (counterpart of
``mxnet_tpu/gluon``; so far what the ResNet v1 model zoo, the LSTM
language model and the fused trainer need)."""
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, HybridBlock
from . import nn
from . import rnn
from . import loss
from . import model_zoo
