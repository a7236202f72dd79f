"""BaseModule: the training-harness interface (counterpart of
``mxnet_tpu/module/base_module.py``).  ``fit``, ``score`` and ``predict``
need ``metric.py`` and ``callback.py`` and are not ported yet."""
from __future__ import annotations

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self):
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def bind(self, *a, **kw):
        raise NotImplementedError

    def init_params(self, *a, **kw):
        raise NotImplementedError

    def init_optimizer(self, *a, **kw):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def forward_backward(self, data_batch):
        """A forward in training mode, then the backward."""
        self.forward(data_batch, is_train=True)
        self.backward()
