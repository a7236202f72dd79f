"""The executors of a Module (counterpart of
``mxnet_tpu/module/executor_group.py``): one ``simple_bind`` executor per
context, each fed its slice of the batch (``_split_input_slice`` by
``workload``), with the Module's gradient requests (``"null"`` for the
inputs, the labels and ``fixed_param_names``; ``grad_req`` may be one
request or a dict by name).  A context list may repeat one device, as the
port's meshes do, and every executor is then a replica on that device.
``get_params`` averages the replicas' parameters, as the reference does.
``type_dict`` gives arguments (and their gradients) their dtypes, as the
bf16 policy's ``amp.type_dict_for`` makes it.  With ``shared_group`` each
executor binds the parameters, their gradients and the auxiliary states
of the same context's executor there, where the shapes agree
(``simple_bind(shared_exec=)``): ``BucketingModule``'s buckets share one
set of tensors.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..io import DataDesc
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, concatenate

__all__ = ["DataParallelExecutorGroup", "_split_input_slice"]


def _split_input_slice(batch_size: int, work_load_list: Sequence[float]):
    """``[0, batch_size)`` split into one slice per device, in proportion
    to ``work_load_list`` (the last takes the remainder)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        n = int(round(batch_size * w / total)) \
            if i < len(work_load_list) - 1 else batch_size - start
        slices.append(slice(start, start + n))
        start += n
    return slices


def _mean(arrays: List[NDArray]) -> NDArray:
    acc = arrays[0]._data.detach().clone()
    for a in arrays[1:]:
        acc += a._data.to(acc.device)
    return NDArray(acc / len(arrays) if len(arrays) > 1 else acc)


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", type_dict=None,
                 shared_group=None, group2ctxs=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = list(workload or [1.0] * len(self.contexts))
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                             for l in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        req: Dict[str, str] = {}
        for n in self.arg_names:
            if n in self.data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self.label_names or n in self.fixed_param_names \
                    or not for_training:
                req[n] = "null"
            else:
                req[n] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(n, "write")
        self.grad_req = req
        # group2ctxs (``executor_group.py:68-81``): a dict places the
        # groups of every replica, a list gives one dict per context
        if isinstance(group2ctxs, dict) or group2ctxs is None:
            group2ctxs = [group2ctxs] * len(self.contexts)
        if len(group2ctxs) != len(self.contexts):
            raise MXNetError("group2ctxs must match the number of contexts")
        self.group2ctxs = group2ctxs
        self.execs = []
        for i, (ctx, slc) in enumerate(zip(self.contexts, self.slices)):
            rows = slc.stop - slc.start
            shapes = {d.name: (rows,) + tuple(d.shape[1:])
                      for d in self.data_shapes + self.label_shapes}
            shared = shared_group.execs[i] if shared_group is not None \
                else None
            self.execs.append(symbol.simple_bind(
                ctx=ctx, grad_req=req, type_dict=type_dict,
                group2ctx=group2ctxs[i], shared_arg_names=param_names,
                shared_exec=shared, **shapes))

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The parameters and auxiliary states averaged over the
        executors, into the given dicts."""
        with torch.no_grad():
            for name in self.param_names:
                arg_params[name] = _mean([ex.arg_dict[name]
                                          for ex in self.execs])
            for name in self.aux_names:
                aux_params[name] = _mean([ex.aux_dict[name]
                                          for ex in self.execs])

    def feeds(self, data_batch):
        """One ``{input name: NDArray}`` per executor: its rows of the
        batch on its context (the whole batch, uncopied when it is already
        there, on one context)."""
        whole = len(self.execs) == 1
        arrays = list(zip(self.data_names, data_batch.data)) \
            + list(zip(self.label_names, data_batch.label or []))
        return [{name: (arr if whole else arr[slc]).as_in_context(ctx)
                 for name, arr in arrays}
                for ctx, slc in zip(self.contexts, self.slices)]

    def forward(self, data_batch, is_train=None):
        is_train = self.for_training if is_train is None else is_train
        for ex, feed in zip(self.execs, self.feeds(data_batch)):
            ex.forward(is_train=is_train, **feed)

    def forward_backward(self, data_batch):
        for ex, feed in zip(self.execs, self.feeds(data_batch)):
            ex.forward_backward(**feed)

    def backward(self, out_grads=None):
        for ex in self.execs:
            ex.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        """Each output, joined over the executors on the first context
        (or, without ``merge_multi_context``, one list per output)."""
        if len(self.execs) == 1:
            return self.execs[0].outputs
        per_output = [[ex.outputs[i] for ex in self.execs]
                      for i in range(len(self.execs[0].outputs))]
        if not merge_multi_context:
            return per_output
        return [concatenate(parts) for parts in per_output]

    def get_input_grads(self, merge_multi_context=True):
        grads = []
        for name in self.data_names:
            parts = [ex.grad_dict[name] for ex in self.execs]
            if len(parts) == 1:
                grads.append(parts[0])
            else:
                grads.append(concatenate(parts) if merge_multi_context
                             else parts)
        return grads

    def update_metric(self, eval_metric, labels):
        for ex, slc in zip(self.execs, self.slices):
            eval_metric.update([l[slc] for l in labels], ex.outputs)

    @property
    def grad_arrays(self):
        """Per parameter, its gradient array on each executor."""
        return [[ex.grad_dict[n] for ex in self.execs if n in ex.grad_dict]
                for n in self.param_names]

    @property
    def param_arrays(self):
        return [[ex.arg_dict[n] for ex in self.execs]
                for n in self.param_names]
