"""Gluon (counterpart of ``mxnet_tpu/gluon``): Blocks that run op by op
under ``autograd`` or as Symbol graphs once hybridized, the losses,
``Trainer``, and what the ResNet v1 model zoo and the LSTM language model
need."""
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, HybridBlock
from . import nn
from . import rnn
from . import loss
from . import model_zoo
from .trainer import Trainer
