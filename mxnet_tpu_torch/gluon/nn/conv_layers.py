"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``; so far ``Conv2D``, ``MaxPool2D`` and
``GlobalAvgPool2D``).  A Conv2D lowers to the ``Convolution`` op, whose
dispatch sends the 3x3 stride-1 and stride-2 pad-1 cases to the
hand-written kernels."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]

_NUMERIC = (int, float)


def _tuple(v, n):
    return (int(v),) * n if isinstance(v, _NUMERIC) else tuple(v)


class Conv2D(HybridBlock):
    """2-D convolution, NCHW data, OIHW weight (in_channels=0: known at the
    first forward)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        kernel = _tuple(kernel_size, 2)
        with self.name_scope():
            self._kwargs = {
                "kernel": kernel, "stride": _tuple(strides, 2),
                "dilate": _tuple(dilation, 2), "pad": _tuple(padding, 2),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups) + kernel,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _alias(self):
        return "conv"

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, name="fwd", **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, name="fwd", **self._kwargs)
        return self.act(out) if self.act is not None else out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _tuple(strides, len(pool_size)),
            "pad": _tuple(padding, len(pool_size)),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)


class MaxPool2D(_Pooling):
    """Max pooling over (pool_size) windows, NCHW."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class GlobalAvgPool2D(_Pooling):
    """Mean over H and W, keeping (N, C, 1, 1)."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)
