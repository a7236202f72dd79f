"""Imperative autograd (counterpart of ``mxnet_tpu/autograd.py``): the
``record``/``pause``/``train_mode``/``predict_mode`` scopes, variables
marked with gradient buffers, ``backward``, ``grad`` and ``Function``.

Built on PyTorch's autograd, not on a tape of its own.  A marked array
(:func:`mark_variables`, ``NDArray.attach_grad``, every initialized Gluon
``Parameter``) holds a leaf tensor with ``requires_grad``; an op called
under :func:`record` runs with grad mode on, so its output carries the
graph, and outside ``record`` (or under :func:`pause`) with grad mode off.
:func:`backward` takes the gradients of the marked leaves that the heads
reach with ``torch.autograd.grad`` and writes them into each leaf's
gradient buffer by its ``grad_req``: ``"write"`` replaces the buffer's
value (it never accumulates the way ``Tensor.grad`` does), ``"add"`` adds
to it, ``"null"`` leaves it.  Contributions from several paths within one
backward sum, as the reference's do.  A marked array whose tensor was
replaced by a plain one (an optimizer's update, ``x[:] = v`` on an
unmarked buffer) is made a leaf again when an op reads it under
``record``.
"""
from __future__ import annotations

import threading
import weakref
from typing import List, Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_state = threading.local()
# every marked NDArray by id (NDArray's == is elementwise, so no WeakSet),
# so that backward finds the leaves the heads reach
_MARKED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording() -> bool:
    """Whether ops called now are recorded for :func:`backward`."""
    return _st().recording


def is_training() -> bool:
    """Whether train-aware ops (``BatchNorm``, ``Dropout``) run in their
    training mode."""
    return _st().training


def set_recording(flag: bool) -> bool:
    """Set the recording flag; returns the previous one."""
    st = _st()
    old, st.recording = st.recording, bool(flag)
    return old


def set_training(flag: bool) -> bool:
    """Set the training flag; returns the previous one."""
    st = _st()
    old, st.training = st.training, bool(flag)
    return old


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._old = None

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode: bool = True) -> _Scope:
    """Scope in which ops are recorded (training mode unless told)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope in which ops are not recorded (prediction mode unless
    told)."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    """Scope in which train-aware ops run in training mode."""
    return _Scope(None, True)


def predict_mode() -> _Scope:
    """Scope in which train-aware ops run in prediction mode."""
    return _Scope(None, False)


def _leaf_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a leaf that requires grad: itself when it is one, flagged
    in place when it is a plain tensor, else a detached alias; an integer
    tensor, which has no gradient, as it is."""
    if (t.requires_grad and t.is_leaf) or not t.is_floating_point():
        return t
    if not t.is_leaf or t.is_inference():
        t = t.detach().clone() if t.is_inference() else t.detach()
    return t.requires_grad_()


def is_marked(arr) -> bool:
    """Whether ``arr`` has a gradient buffer that a backward writes."""
    return arr._grad is not None and arr._grad_req != "null"


def lift(arrays):
    """Make each marked array among ``arrays`` a leaf that requires grad
    again where its tensor was replaced by a plain one; called by every op
    that runs under :func:`record`."""
    for a in arrays:
        if is_marked(a) and not (a._data.requires_grad and a._data.is_leaf):
            a._data = _leaf_tensor(a._data)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Give each array of ``variables`` its gradient buffer (the matching
    array of ``gradients``) and request (``"write"``, ``"add"`` or
    ``"null"``)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        v._grad = g
        v._grad_req = req
        if req != "null":
            v._data = _leaf_tensor(v._data)
            _MARKED[id(v)] = v


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None or isinstance(head_grads, NDArray):
        head_grads = [head_grads] * len(heads) if head_grads is None \
            else [head_grads]
    outs, gs = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError("cannot differentiate: the head is not "
                             "connected to any recorded computation")
        outs.append(t)
        gs.append(torch.ones_like(t) if hg is None
                  else hg._data.to(t.device, t.dtype))
    return outs, gs


def _autograd_grad(outs, gs, inputs, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(outs, inputs, gs, retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError(
                "the gradient graph was freed by an earlier backward(); "
                "pass retain_graph=True to differentiate it again") from e
        raise


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (ones unless ``head_grads``) with respect to
    every marked array they reach, written into its gradient buffer by its
    ``grad_req``.  ``train_mode`` is accepted for the reference's
    signature: the recorded graph already fixed each op's mode."""
    outs, gs = _heads(heads, head_grads)
    leaves: List = [arr for arr in list(_MARKED.values()) if is_marked(arr)
                    and arr._data.requires_grad and arr._data.is_leaf]
    tensors = list({id(a._data): a._data for a in leaves}.values())
    if not tensors:
        return
    grads = _autograd_grad(outs, gs, tensors, retain_graph)
    by_tensor = {id(t): g for t, g in zip(tensors, grads)}
    with torch.no_grad():
        for arr in leaves:
            g = by_tensor[id(arr._data)]
            if g is None:
                continue
            buf = arr._grad
            g = g.to(buf._data.dtype)
            if arr._grad_req == "add":
                buf._data = buf._data + g
            else:
                buf._data = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (marked
    arrays), returned as new arrays; no gradient buffer is touched.
    ``create_graph`` records the gradients' own graph, so they can be
    differentiated again."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    for v in variables:
        if not (v._data.requires_grad and v._data.is_leaf):
            raise MXNetError("variables passed to grad() must have been "
                             "marked (attach_grad) before recording")
    outs, gs = _heads(heads, head_grads)
    retain = create_graph if retain_graph is None else retain_graph
    grads = _autograd_grad(outs, gs, [v._data for v in variables], retain,
                           create_graph)
    res = [NDArray(torch.zeros_like(v._data) if g is None else g, v._ctx)
           for v, g in zip(variables, grads)]
    return res[0] if single else res


class Function:
    """A differentiable function written with NDArrays: subclass it with
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)``
    (``autograd.py:363``).  Under :func:`record` a call runs as a
    ``torch.autograd.Function``, whose backward calls this one's; both run
    paused (not recorded, prediction mode), as the reference's."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        lift(inputs)
        fn, shape = self, {}

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause():
                    outs = fn.forward(*[NDArray(t) for t in tensors])
                shape["single"] = isinstance(outs, NDArray)
                outs = [outs] if shape["single"] else list(outs)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *cots):
                with pause():
                    res = fn.backward(*[NDArray(c) for c in cots])
                res = [res] if isinstance(res, NDArray) else list(res)
                return tuple(None if g is None else g._data for g in res)

        outs = _Apply.apply(*[a._data for a in inputs])
        outs = [NDArray(t) for t in outs]
        return outs[0] if shape["single"] else outs
