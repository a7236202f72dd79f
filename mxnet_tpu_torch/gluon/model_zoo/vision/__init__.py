"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``; so
far ResNet v1)."""
from .resnet import *  # noqa: F401,F403
