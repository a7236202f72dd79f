"""bf16 mixed-precision policy (counterpart of ``mxnet_tpu/amp.py``), gated
by ``MXNET_TPU_BF16`` (default off), the reference's knob under its own name:

- parameters, activations and gradients are bf16;
- every trained low-precision weight carries a master fp32 copy in its
  optimizer state (``Optimizer.create_state_multi_precision``); the update
  runs in fp32 against the master and the bf16 weight is cast again from
  the new master (``Optimizer.fused_update`` on the fused step, the generic
  ``update_multi_precision`` on the eager path);
- labels, ``*_gamma``/``*_beta``, the loss, the softmax, BatchNorm's
  statistics and its moving averages stay fp32.

The flag is read when a Module binds (it decides the arrays' dtypes); the
ops key their behaviour on their inputs' dtypes alone.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["ENV_FLAG", "enabled", "is_low_precision", "compute_dtype",
           "type_dict_for"]

ENV_FLAG = "MXNET_TPU_BF16"

# dtypes that carry a master fp32 copy through the optimizer
_LOW_PRECISION = ("bfloat16", "float16")


def enabled() -> bool:
    """The ``MXNET_TPU_BF16`` gate; default off."""
    return os.environ.get(ENV_FLAG, "0").lower() not in \
        ("0", "false", "off", "")


def is_low_precision(dtype) -> bool:
    """Whether ``dtype`` (a torch or numpy dtype, or its name) is a storage
    dtype that needs an fp32 master."""
    if isinstance(dtype, torch.dtype):
        return dtype in (torch.bfloat16, torch.float16)
    if str(dtype) in _LOW_PRECISION:
        return True
    try:
        return np.dtype(dtype).name in _LOW_PRECISION
    except TypeError:
        return False


def compute_dtype() -> torch.dtype:
    """The policy's low-precision storage and compute dtype."""
    return torch.bfloat16


def type_dict_for(symbol, data_names, label_names):
    """The binding ``type_dict`` of ``symbol`` under the bf16 policy: every
    argument bf16 (gradients take their argument's dtype), except the
    labels and ``*_gamma``/``*_beta``, which stay fp32.  Auxiliary states
    (BatchNorm's moving statistics) are fp32 by ``infer_type``'s default.
    ``data_names`` is accepted for the reference's signature: data binds
    bf16 like the weights."""
    label_set = set(label_names or ())
    td = {}
    for n in symbol.list_arguments():
        if n in label_set or n.endswith("_gamma") or n.endswith("_beta"):
            td[n] = np.float32
        else:
            td[n] = compute_dtype()
    return td
