"""Gluon basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``,
every name of it): ``Sequential``, ``HybridSequential``, ``Dense``,
``Dropout``, ``Embedding``, ``BatchNorm``, ``InstanceNorm``, ``LayerNorm``,
``Flatten``, ``Lambda`` and ``HybridLambda``."""
from __future__ import annotations

import re

import numpy as np

from ... import ndarray, symbol
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Flatten", "Lambda",
           "HybridLambda"]


def _indent(s):
    return re.sub("(?m)^", "  ", s).strip()


class _Stack:
    """What both sequential containers share: ``add``, indexing (a slice
    is a new container of the same prefix), ``len`` and the repr."""

    def add(self, *blocks):
        """Add blocks on top of the stack."""
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __repr__(self):
        modstr = "\n".join("  (%s): %s" % (key, _indent(repr(block)))
                           for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)


class Sequential(_Stack, Block):
    """Stacks Blocks in order; ``hybridize`` reaches the HybridBlocks
    among them."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stacks HybridBlocks in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def _infer_out_shape(self, in_shape):
        """Child by child, each from the output shape of the one before."""
        for block in self._children.values():
            in_shape = block._infer_out_shape(in_shape)
        return in_shape


class Dense(HybridBlock):
    """Fully connected layer, ``act(x Wᵀ + b)``; with ``flatten`` the input
    is flattened to (batch, -1) first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer, dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        else:
            out = F.FullyConnected(x, weight, bias, no_bias=False,
                                   num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, %s)" % (self.__class__.__name__,
                                     shape[1] if shape[1] else None,
                                     shape[0], self.act or "linear")


class Dropout(HybridBlock):
    """Zeroes each element (or each slice along ``axes``) with probability
    ``rate`` in training and scales the rest by ``1 / (1 - rate)``; the
    identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")

    def __repr__(self):
        return "%s(p = %s, axes=%s)" % (self.__class__.__name__, self._rate,
                                        self._axes)


class Embedding(HybridBlock):
    """Turns integer ids (given as any dtype) into rows of a learned
    (input_dim, output_dim) table.  ``sparse_grad`` (a row-sparse
    gradient) is not ported yet (Queue 1 item 5)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        if sparse_grad:
            from ...base import MXNetError
            raise MXNetError("Embedding(sparse_grad=True) is not ported yet "
                             "(Queue 1 item 5)")
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics; batch statistics in
    training, moving ones otherwise (Gluon's defaults: ``epsilon=1e-5``,
    ``momentum=0.9``).  ``scale=False`` fixes gamma at 1 and
    ``center=False`` freezes beta (neither takes a gradient)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        shape = (in_channels,)
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null", shape=shape,
            init=gamma_initializer, allow_deferred_init=True,
            differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null", shape=shape,
            init=beta_initializer, allow_deferred_init=True,
            differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=shape,
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=shape,
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def cast(self, dtype):
        """float16 stays float32 (``basic_layers.py:233``)."""
        if str(dtype) == "float16" or dtype is np.float16:
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class InstanceNorm(HybridBlock):
    """Each (sample, channel) normalized over the other axes, then ``*
    gamma + beta`` a channel (Ulyanov et al., 2016); ``axis`` is the
    channel axis.  Gamma takes a gradient only with ``scale``, beta only
    with ``center``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        return F.swapaxes(F.InstanceNorm(x, gamma, beta, name="fwd",
                                         eps=self._epsilon),
                          dim1=1, dim2=self._axis)


class LayerNorm(HybridBlock):
    """Normalizes over ``axis`` with learned gamma and beta (Ba et al.,
    2016).  Gamma takes a gradient only with ``scale``, beta only with
    ``center``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)


class Flatten(HybridBlock):
    """(N, d1, d2, ...) -> (N, d1 * d2 * ...)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


def _named(function, modules):
    from ...base import MXNetError
    if not all(hasattr(m, function) for m in modules):
        raise MXNetError("function %s is not found in %s" % (
            function, "/".join(m.__name__.rsplit(".", 1)[-1]
                               for m in modules)))


class Lambda(Block):
    """A function as a Block: an ``nd`` op's name, or a callable of
    NDArrays."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _named(function, (ndarray,))
            self._func_impl = getattr(ndarray, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("unrecognized function in lambda: %r of type %s"
                             % (function, type(function)))
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)


class HybridLambda(HybridBlock):
    """A function as a HybridBlock: an op's name in both ``nd`` and
    ``sym``, or a callable ``f(F, x, *args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _named(function, (ndarray, symbol))
            funcs = {ndarray: getattr(ndarray, function),
                     symbol: getattr(symbol, function)}
            self._func = lambda F, *args: funcs[F](*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("unrecognized function in lambda: %r of type %s"
                             % (function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)
