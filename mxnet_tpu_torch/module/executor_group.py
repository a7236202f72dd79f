"""The executor of a Module (counterpart of
``mxnet_tpu/module/executor_group.py``), for one context: one
``simple_bind`` executor with the Module's gradient requests, fed whole
batches.  Batch slicing over several contexts comes with the port's
multi-device layer."""
from __future__ import annotations

from typing import Dict

from ..base import MXNetError
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("the port's Module binds on one context, got %d"
                             % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                             for l in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]
        req: Dict[str, str] = {}
        for n in self.arg_names:
            if n in self.data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self.label_names or not for_training:
                req[n] = "null"
            else:
                req[n] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(n, "write")
        self.grad_req = req
        shapes = {d.name: d.shape for d in self.data_shapes}
        shapes.update({l.name: l.shape for l in self.label_shapes})
        self.execs = [symbol.simple_bind(ctx=contexts[0], grad_req=req,
                                         **shapes)]

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def feeds(self, data_batch):
        """{input name: NDArray on the context} of a batch."""
        ctx = self.contexts[0]
        feed = {}
        for name, arr in zip(self.data_names, data_batch.data):
            feed[name] = arr.as_in_context(ctx)
        for name, arr in zip(self.label_names, data_batch.label or []):
            feed[name] = arr.as_in_context(ctx)
        return feed

    def forward(self, data_batch, is_train=None):
        is_train = self.for_training if is_train is None else is_train
        self.execs[0].forward(is_train=is_train, **self.feeds(data_batch))

    def forward_backward(self, data_batch):
        self.execs[0].forward_backward(**self.feeds(data_batch))

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return self.execs[0].outputs

    @property
    def grad_arrays(self):
        return [[ex.grad_dict[n] for ex in self.execs if n in ex.grad_dict]
                for n in self.param_names]

    @property
    def param_arrays(self):
        return [[ex.arg_dict[n] for ex in self.execs]
                for n in self.param_names]
