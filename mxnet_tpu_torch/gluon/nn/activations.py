"""Gluon activation blocks (counterpart of
``mxnet_tpu/gluon/nn/activations.py``, every name of it): ``Activation``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU`` and ``Swish``, the leaky family
on the ``LeakyReLU`` op."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish"]


class Activation(HybridBlock):
    """Applies 'relu', 'sigmoid', 'tanh', 'softrelu' or 'softsign'."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._act_type)


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("alpha must be greater than or equal to 0, got "
                             "%s" % alpha)
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with one learned slope, initialized at 0.25."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """``x`` above 0, ``alpha * (exp(x) - 1)`` below."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (Klambauer et al., 2017)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (Ramachandran et al., 2017)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x, name="fwd")
