"""Image operators (counterpart of ``mxnet_tpu/ops/image_ops.py``), the
``nd.image``/``sym.image`` functions under Gluon's ``ToTensor`` and
``Normalize`` transforms: ``_image_to_tensor`` and ``_image_normalize``."""
from __future__ import annotations

import torch

from .registry import param, register

__all__ = []


@register("_image_to_tensor", aliases=("to_tensor",))
def _image_to_tensor(attrs, data):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    if data.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=("normalize",),
          params={"mean": param("floats", (0.0,)),
                  "std": param("floats", (1.0,))})
def _image_normalize(attrs, data):
    """``(data - mean) / std`` a channel of a CHW / NCHW float tensor."""
    shape = [1] * data.dim()
    shape[0 if data.dim() == 3 else 1] = -1
    mean = torch.tensor(attrs["mean"], dtype=torch.float32,
                        device=data.device).reshape(shape)
    std = torch.tensor(attrs["std"], dtype=torch.float32,
                       device=data.device).reshape(shape)
    return (data - mean) / std
