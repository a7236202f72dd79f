"""mxnet_tpu_torch: the port of ``mxnet_tpu`` to PyTorch and CUDA.

The reference package runs on JAX and a TPU; this one runs on PyTorch and an
NVIDIA H100, and every Pallas kernel on its path is a CUDA kernel written by
hand for Hopper (``csrc/``, built with ``nvcc`` at first use).  Importing it
needs neither ``nvcc`` nor a GPU.  Entry points run on ``gpu(0)`` unless the
caller passes ``ctx=cpu()``; on the CPU each kernel's plain PyTorch version
runs instead.

Slice 1 serves: Symbol -> Executor -> Predictor -> ModelServer, with the
ops a ResNet needs.  Slice 2 trains: Gluon's ResNet v1 (``gluon``,
hybridized to a Symbol) under ``FusedTrainer``, with the 3x3 convolutions'
backward on the kernels too.  The same trainer trains Gluon's LSTM language
model (``gluon.nn.Embedding``, ``gluon.rnn.LSTM``, ``gluon.loss``), whose
recurrence runs forward and backward on two more hand-written kernels.
"""
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import ndarray as nd
from . import symbol as sym
from . import name
from . import random
from . import initializer
from . import gluon
from .fused import FusedTrainer
from .predictor import Predictor

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "nd", "sym", "name", "random", "initializer",
           "gluon", "FusedTrainer", "Predictor"]
