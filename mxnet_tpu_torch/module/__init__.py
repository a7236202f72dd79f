"""Module API (counterpart of ``mxnet_tpu/module``): a Symbol bound on one
or several contexts and trained with an optimizer (``fit``, or step by
step), through the fused step or the eager per-parameter loop.  The
bucketing, sequential and Python modules are not ported yet."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
