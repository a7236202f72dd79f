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
Slice 4 trains the decoder-only transformer LM (``models.transformer_lm``)
through ``mod.Module`` and its fused step (``fused_step``), fed by
``io.SyntheticLMIter``, with flash attention forward and backward on four
more hand-written kernels.  Slice 5 adds ``parallel``: a single-controller
device mesh with its collectives, and on it ring and Ulysses attention
(``models.long_context_attention``; the ring's per-shard pass is kernel 4,
its branch probe kernel 10), tensor-, expert- and pipeline-parallel blocks.
Slice 6 completes the classic Module API on one card: ``Module.fit``,
``score`` and ``predict`` over several contexts, with every optimizer
(``optimizer``, ``lr_scheduler``), ``metric``, ``callback``, the local
``kvstore``, ``io.NDArrayIter``/``PrefetchingIter`` and ``model``
checkpoints, and ``rtc.CudaModule``: user CUDA C compiled by NVRTC at run
time, the counterpart of the reference's runtime Pallas kernels.  Slice 15
completes the classic Module API: ``mod.BucketingModule`` over
``rnn.BucketSentenceIter`` (the bucketed LSTM LM, its buckets on one set of
parameter tensors), ``mod.SequentialModule``, ``mod.PythonLossModule``,
the file iterators ``io.CSVIter``/``MNISTIter``/``LibSVMIter``, and the
rest of ``Executor`` and ``Symbol`` (``reshape``, ``infer_shape_partial``).
Slice 16 adds the data layer's image path: ``recordio`` (``.rec``/``.idx``
files byte for byte the reference's), ``image`` (decode, resize, crop, the
augmenters, ``ImageIter``) and ``io.ImageRecordIter``, whose decode pool
feeds ``Module.fit`` batches on the card.  Slice 17 adds imperative
training: ``autograd`` (``record``, ``backward``, ``grad``, ``Function``)
over PyTorch's autograd, NDArray arithmetic with the elementwise,
reduction and matrix ops, Gluon blocks that run op by op until
hybridized, the Gluon losses and ``gluon.Trainer``, and ``AttrScope`` with
``group2ctx`` placement across devices.
"""
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import attribute
from .attribute import AttrScope
from . import autograd
from . import ndarray as nd
from .ndarray import NDArray
from . import symbol as sym
from .symbol import Symbol
from . import executor
from .executor import Executor
from . import name
from .name import NameManager
from . import random
from . import initializer
from . import initializer as init
from . import gluon
from . import io
from . import optimizer
from . import lr_scheduler
from . import metric
from . import callback
from . import kvstore
from . import kvstore as kv
from .kvstore import KVStore
from . import model
from .model import FeedForward
from . import rtc
from . import train_loop
from .train_loop import OverlappedLoop
from . import recordio
from . import image
from . import image as img
from . import module as mod
from . import rnn
from . import models
from . import parallel
from .fused import FusedTrainer
from .predictor import Predictor
from . import serving


def kvstore_create(name="local"):
    """``kvstore.create(name)`` (the reference's top-level alias)."""
    return kvstore.create(name)


__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "attribute", "AttrScope", "autograd",
           "num_gpus", "nd", "sym", "name", "random", "initializer", "init",
           "gluon", "io", "optimizer", "lr_scheduler", "metric",
           "callback", "kvstore", "kv", "model", "rtc", "train_loop", "mod",
           "rnn", "models",
           "parallel",
           "FusedTrainer",
           "Predictor", "NDArray", "Symbol", "executor", "Executor",
           "NameManager", "KVStore", "kvstore_create", "FeedForward",
           "OverlappedLoop", "recordio", "image", "img", "serving"]
