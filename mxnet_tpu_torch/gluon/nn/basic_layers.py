"""Gluon basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``;
so far ``HybridSequential``, ``Dense``, ``Embedding``, ``BatchNorm`` and
``Flatten``)."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["HybridSequential", "Dense", "Embedding", "BatchNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

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


class Embedding(HybridBlock):
    """Turns integer ids (given as any dtype) into rows of a learned
    (input_dim, output_dim) table."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
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
    ``momentum=0.9``, learned gamma and beta).  ``center=False`` (a frozen
    beta) waits for ``gluon.Trainer``, the trainer that reads it."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5,
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
            "gamma", shape=shape, init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", shape=shape, init=beta_initializer,
            allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=shape,
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=shape,
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class Flatten(HybridBlock):
    """(N, d1, d2, ...) -> (N, d1 * d2 * ...)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)
