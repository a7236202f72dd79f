"""Gluon: Blocks that build Symbol graphs (counterpart of
``mxnet_tpu/gluon``; so far what the ResNet v1 model zoo and the fused
trainer need)."""
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, HybridBlock
from . import nn
from . import model_zoo
