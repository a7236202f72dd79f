"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``, every name of it): convolutions in
1, 2 and 3 D and their transposes (the ``Deconvolution`` op), max and
average pools in 1, 2 and 3 D with the global ones, and
``ReflectionPad2D`` (the ``Pad`` op).  A ``Conv2D`` lowers to the
``Convolution`` op, whose dispatch sends the 3x3 stride-1 and stride-2
pad-1 cases to the hand-written kernels."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_NUMERIC = (int, float)


def _tuple(v, n):
    return (int(v),) * n if isinstance(v, _NUMERIC) else tuple(v)


class _Conv(HybridBlock):
    """A convolution (``op_name`` "Convolution") or a transposed one
    ("Deconvolution"), data in ``layout``, its weight (out, in / groups,
    k...) or (in, out / groups, k...); ``in_channels=0``: known at the
    first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        n = len(kernel_size)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._op_name = op_name
            self._kwargs = {
                "kernel": tuple(kernel_size), "stride": _tuple(strides, n),
                "dilate": _tuple(dilation, n), "pad": _tuple(padding, n),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups)
            else:
                wshape = (in_channels, channels // groups)
            self.weight = self.params.get(
                "weight", shape=wshape + tuple(kernel_size),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _alias(self):
        return "conv"

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, name="fwd", **self._kwargs)
        else:
            out = op(x, weight, bias, name="fwd", **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        k = self._kwargs
        n = len(k["kernel"])
        s = "%s(%s -> %s, kernel_size=%s, stride=%s" % (
            self.__class__.__name__,
            self.weight.shape[1] if self.weight.shape[1] else None,
            self.weight.shape[0], k["kernel"], k["stride"])
        if k["pad"] != (0,) * n:
            s += ", padding=%s" % (k["pad"],)
        if k["dilate"] != (1,) * n:
            s += ", dilation=%s" % (k["dilate"],)
        if getattr(self, "out_pad", (0,) * n) != (0,) * n:
            s += ", output_padding=%s" % (self.out_pad,)
        if k["num_group"] != 1:
            s += ", groups=%s" % k["num_group"]
        if self.bias is None:
            s += ", bias=False"
        return s + ")"


def _conv_class(n, name, layout):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=layout, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _Conv.__init__(self, channels, _tuple(kernel_size, n), strides,
                       padding, dilation, groups, layout, in_channels,
                       activation, use_bias, weight_initializer,
                       bias_initializer, **kwargs)
    return type(name, (_Conv,), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": "%d-D convolution, %s data (``conv_layers.py``)."
                   % (n, layout)})


Conv1D = _conv_class(1, "Conv1D", "NCW")
Conv2D = _conv_class(2, "Conv2D", "NCHW")
Conv3D = _conv_class(3, "Conv3D", "NCDHW")


def _conv_transpose_class(n, name, layout):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=layout,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        self.out_pad = _tuple(output_padding, n)
        _Conv.__init__(self, channels, _tuple(kernel_size, n), strides,
                       padding, dilation, groups, layout, in_channels,
                       activation, use_bias, weight_initializer,
                       bias_initializer, op_name="Deconvolution",
                       adj=self.out_pad, **kwargs)
    return type(name, (_Conv,), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": "Transposed %d-D convolution, %s data, on the "
                   "``Deconvolution`` op." % (n, layout)})


Conv1DTranspose = _conv_transpose_class(1, "Conv1DTranspose", "NCW")
Conv2DTranspose = _conv_transpose_class(2, "Conv2DTranspose", "NCHW")
Conv3DTranspose = _conv_transpose_class(3, "Conv3DTranspose", "NCDHW")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=None,
                 **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        n = len(pool_size)
        self._kwargs = {
            "kernel": tuple(pool_size), "stride": _tuple(strides, n),
            "pad": _tuple(padding, n), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        k = self._kwargs
        return "%s(size=%s, stride=%s, padding=%s, ceil_mode=%s)" % (
            self.__class__.__name__, k["kernel"], k["stride"], k["pad"],
            k["pooling_convention"] == "full")


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _check_layout(layout, want):
    if layout != want:
        raise ValueError("only the %s layout is supported, got %s"
                         % (want, layout))


def _pool_class(n, name, pool_type):
    layout0 = _LAYOUTS[n]
    if pool_type == "max":
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=layout0, ceil_mode=False, **kwargs):
            _check_layout(layout, layout0)
            _Pooling.__init__(self, _tuple(pool_size, n), strides, padding,
                              ceil_mode, False, "max", **kwargs)
    else:
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=layout0, ceil_mode=False, count_include_pad=True,
                     **kwargs):
            _check_layout(layout, layout0)
            _Pooling.__init__(self, _tuple(pool_size, n), strides, padding,
                              ceil_mode, False, "avg", count_include_pad,
                              **kwargs)
    return type(name, (_Pooling,), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": "%s pooling over windows of %d-D %s data." % (
            "Max" if pool_type == "max" else "Average", n, layout0)})


def _global_pool_class(n, name, pool_type):
    layout0 = _LAYOUTS[n]

    def __init__(self, layout=layout0, **kwargs):
        _check_layout(layout, layout0)
        _Pooling.__init__(self, (1,) * n, None, 0, True, True, pool_type,
                          **kwargs)
    return type(name, (_Pooling,), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": "Global %s pooling of %d-D %s data, keeping size-1 "
                   "spatial axes." % (pool_type, n, layout0)})


MaxPool1D = _pool_class(1, "MaxPool1D", "max")
MaxPool2D = _pool_class(2, "MaxPool2D", "max")
MaxPool3D = _pool_class(3, "MaxPool3D", "max")
AvgPool1D = _pool_class(1, "AvgPool1D", "avg")
AvgPool2D = _pool_class(2, "AvgPool2D", "avg")
AvgPool3D = _pool_class(3, "AvgPool3D", "avg")
GlobalMaxPool1D = _global_pool_class(1, "GlobalMaxPool1D", "max")
GlobalMaxPool2D = _global_pool_class(2, "GlobalMaxPool2D", "max")
GlobalMaxPool3D = _global_pool_class(3, "GlobalMaxPool3D", "max")
GlobalAvgPool1D = _global_pool_class(1, "GlobalAvgPool1D", "avg")
GlobalAvgPool2D = _global_pool_class(2, "GlobalAvgPool2D", "avg")
GlobalAvgPool3D = _global_pool_class(3, "GlobalAvgPool3D", "avg")


class ReflectionPad2D(HybridBlock):
    """Pads the last two axes by reflection; ``padding`` is a number, or
    the ``Pad`` op's 8 widths."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, _NUMERIC):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise ValueError("ReflectionPad2D takes a number or 8 pad "
                             "widths, got %r" % (padding,))
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
