"""SequentialModule: modules chained one after another (counterpart of
``mxnet_tpu/module/sequential_module.py``).

    seq = SequentialModule()
    seq.add(Module(features, label_names=None))
    seq.add(Module(head, data_names=("hidden",)), take_labels=True)
    seq.fit(train_iter, num_epoch=2)

``bind`` binds each module on the previous one's output shapes, renamed to
its own data names (the reference's auto-wiring), the labels going to the
modules added with ``take_labels=True``; every module after the first is
bound with ``inputs_need_grad`` so the backward can pass its input
gradients on.  ``forward`` feeds each module the previous one's outputs
(the tensors themselves, uncopied) with the batch's labels; ``backward``
runs the modules in reverse, each one's head gradients the next one's
input gradients; ``update`` updates every module with its own optimizer.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules = []
        self._metas = []

    def add(self, module, **kwargs):
        """Append ``module``; ``take_labels=True`` binds it with the
        labels.  Returns self, so calls chain."""
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        shapes = data_shapes
        for i, mod in enumerate(self._modules):
            take_labels = self._metas[i].get(self.META_TAKE_LABELS, False)
            mod.bind(shapes, label_shapes if take_labels else None,
                     for_training, inputs_need_grad or i > 0,
                     force_rebind, grad_req=grad_req)
            names = (mod.data_names if i + 1 >= len(self._modules)
                     else self._modules[i + 1].data_names)
            shapes = [DataDesc(n, s)
                      for n, (_, s) in zip(names, mod.output_shapes)]
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def init_params(self, **kwargs):
        for mod in self._modules:
            mod.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        for mod in self._modules:
            mod.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for mod in self._modules:
            mod.forward(batch, is_train)
            batch = DataBatch(mod.get_outputs(), data_batch.label)

    def backward(self, out_grads=None):
        for i in range(len(self._modules) - 1, -1, -1):
            mod = self._modules[i]
            mod.backward(out_grads)
            if i > 0 or self.inputs_need_grad:
                out_grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def update_metric(self, eval_metric, labels):
        self._modules[-1].update_metric(eval_metric, labels)
