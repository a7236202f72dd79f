"""Module API (counterpart of ``mxnet_tpu/module``): a Symbol bound on one
context and trained with an optimizer, through the fused step or the eager
per-parameter loop."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
