"""Gluon (counterpart of ``mxnet_tpu/gluon``): Blocks that run op by op
under ``autograd`` or as Symbol graphs once hybridized, with their save,
load and export; the layers, ``contrib.nn``, the losses, ``Trainer``, the
data API and the vision model zoo."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import rnn
from . import data
from . import model_zoo
from . import contrib
from . import utils
from .utils import clip_global_norm, split_and_load, split_data
