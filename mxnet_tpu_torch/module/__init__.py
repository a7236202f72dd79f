"""Module API (counterpart of ``mxnet_tpu/module``): a Symbol bound on one
or several contexts and trained with an optimizer (``fit``, or step by
step), through the fused step or the eager per-parameter loop;
``BucketingModule`` (one Module per bucket on one set of parameters),
``SequentialModule`` (a chain of modules) and ``PythonModule`` /
``PythonLossModule`` (modules computed in Python)."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup",
           "BucketingModule", "SequentialModule", "PythonModule",
           "PythonLossModule"]
