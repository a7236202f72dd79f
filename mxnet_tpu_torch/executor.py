"""Executor: a bound symbolic graph run forward, backward, or both in one
step (counterpart of ``mxnet_tpu/executor.py``), and the graph plan that
the training steps and ``CachedOp`` share.

The reference package traces its plan into XLA programs; here the plan is a
topological walk that calls each op's function eagerly, so every op
launches its own kernels on the calling thread's current stream.  A forward
runs under ``torch.inference_mode()`` (or ``no_grad`` when training an
executor without gradient arguments; a training forward also writes
BatchNorm's moving statistics back); ``backward`` and
``forward_backward`` run the ``train=True`` plan with autograd on and take
the gradients of every argument whose ``grad_req`` is not ``"null"`` with
``torch.autograd.grad``.  A training forward of an executor with gradient
arguments runs under autograd and keeps its graph, and the ``backward``
that follows takes the gradients from it, so a ``forward`` then
``backward`` (the classic Module loop, ``BucketingModule``'s) runs each op
forward once.  Where the arguments changed in between, or no training
forward came first, ``backward`` runs the forward again (as the reference
recomputes it inside its fused program), with the generators of the last
forward, so a step with dropout sees the same masks.

An inference plan (``train=False``) runs each ResNet v1 identity bottleneck
it finds as one step (:class:`_FusedBottleneck`): on a bf16 input, its
BatchNorms folded into the three convolutions and the block on kernel 13
(``ops/hopper_block.py``).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]

_Entry = Tuple[int, int]
_ADD_OPS = ("broadcast_add", "elemwise_add")
# the body of an identity bottleneck from its last node back to its first
_BODY = ("BatchNorm", "1x1", "relu", "BatchNorm", "3x3", "relu", "BatchNorm",
         "1x1")


def _conv_is(attrs, kernel):
    """A stride-1, ungrouped, undilated NCHW convolution: 1x1 with pad 0 or
    3x3 with pad 1."""
    pad = (0, 0) if kernel == "1x1" else (1, 1)
    return (tuple(attrs["kernel"]) == ((1, 1) if kernel == "1x1" else (3, 3))
            and tuple(attrs["stride"] or (1, 1)) == (1, 1)
            and tuple(attrs["pad"] or (0, 0)) == pad
            and tuple(attrs["dilate"] or (1, 1)) == (1, 1)
            and attrs["num_group"] == 1 and attrs["layout"] in (None, "NCHW"))


def _find_bottlenecks(ops, heads) -> Dict[int, "_FusedBottleneck"]:
    """Every ResNet v1 identity bottleneck among ``ops``, keyed by the id of
    its last node: Convolution 1x1 -> BatchNorm -> relu -> Convolution 3x3
    -> BatchNorm -> relu -> Convolution 1x1 -> BatchNorm -> add of the
    block's input -> relu, with BatchNorm on axis 1 and each convolution at
    stride 1 (:func:`_conv_is`).  The add's other operand must be the very
    entry the first convolution reads; every node before the last has its
    first output read once, by the next node, and no other output read, and
    none of them is a head."""
    uses: Dict[_Entry, int] = {}
    for node in ops:
        for p, i in node.inputs:
            uses[(id(p), i)] = uses.get((id(p), i), 0) + 1

    def private(node):
        return all((id(node), i) not in heads
                   and uses.get((id(node), i), 0) == (i == 0)
                   for i in range(node.num_outputs()))

    def body(entry, x_entry):
        nodes = []
        for kind in _BODY:
            node, idx = entry
            if idx or node.is_var or not private(node):
                return None
            name, attrs = node.op.name, node.parsed_attrs()
            if kind == "BatchNorm":
                ok = name == kind and attrs["axis"] in (1, -3)
            elif kind == "relu":
                ok = name == "Activation" and attrs["act_type"] == "relu"
            else:
                ok = name == "Convolution" and _conv_is(attrs, kind)
            if not ok:
                return None
            nodes.append(node)
            entry = node.inputs[0]
        return nodes[::-1] if entry == x_entry else None

    found = {}
    for relu in ops:
        if relu.op.name != "Activation" or \
                relu.parsed_attrs()["act_type"] != "relu":
            continue
        add, idx = relu.inputs[0]
        if idx or add.is_var or add.op.name not in _ADD_OPS \
                or not private(add):
            continue
        a, b = add.inputs
        for branch, x_entry in ((a, b), (b, a)):
            nodes = body(branch, x_entry)
            if nodes:
                found[id(relu)] = _FusedBottleneck(nodes + [add, relu],
                                                   x_entry)
                break
    return found


class _FusedBottleneck:
    """One step of an inference plan for an identity bottleneck's ten nodes
    (``nodes``: conv1, bn1, relu, conv2, bn2, relu, conv3, bn3, add, relu).

    On a bf16 input the three BatchNorms are folded into the convolutions
    (:func:`~mxnet_tpu_torch.weights.fold_bottleneck`) and the block runs
    as :func:`~mxnet_tpu_torch.ops.hopper_block.fused_bottleneck`, on
    kernel 13 for a tensor on the card and its plain version on the CPU.
    The folded weights are cached, keyed on each source tensor's identity
    and version, so they follow every change of the parameters.  An input
    of any other dtype, or one whose channels the last convolution does not
    give back (the add would broadcast), runs the ten original steps: fp32
    inference is unchanged, since kernel 13 is a bf16 kernel.  The step
    has no backward, and raises when autograd would record it."""

    def __init__(self, nodes, x_entry):
        self.nodes = nodes
        self.attrs = [n.parsed_attrs() for n in nodes]
        self.x_entry = (id(x_entry[0]), x_entry[1])
        self.params = [(id(p), i) for n in nodes[:8]
                       if n.op.name != "Activation" for p, i in n.inputs[1:]]
        self.inputs = [self.x_entry] + self.params
        # conv3's weight: after it, conv3's bias (if any) and bn3's 4 inputs
        self._w3 = len(self.params) - len(nodes[6].inputs) - 3
        self._cache = None

    def _fold_args(self, params):
        it = iter(params)
        args = []
        for node, attrs in zip(self.nodes[:8], self.attrs):
            if node.op.name == "Convolution":
                w = next(it)
                bias = next(it) if len(node.inputs) > 2 else None
                args += [w, None if attrs["no_bias"] else bias]
            elif node.op.name == "BatchNorm":
                args.append(tuple(next(it) for _ in range(4))
                            + (attrs["eps"], attrs["fix_gamma"]))
        return args

    def _folded(self, params):
        cache = self._cache
        if cache is not None and all(
                ref() is t and version == t._version
                for (ref, version), t in zip(cache[0], params)):
            return cache[1]
        from .weights import fold_bottleneck
        folded = fold_bottleneck(*self._fold_args(params))
        if not any(t.is_inference() for t in params):
            self._cache = ([(weakref.ref(t), t._version) for t in params],
                           folded)
        return folded

    def _unfused(self, x, params):
        env = {self.x_entry: x}
        env.update(zip(self.params, params))
        for node, attrs in zip(self.nodes, self.attrs):
            res = node.op.fn(attrs, *[env[(id(p), i)] for p, i in node.inputs])
            for i, o in enumerate(res if isinstance(res, tuple) else (res,)):
                env[(id(node), i)] = o
        return env[(id(self.nodes[-1]), 0)]

    def __call__(self, attrs, x, *params):
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in params)):
            raise MXNetError("the fused identity bottleneck of an inference "
                             "plan has no backward; gradients take the "
                             "training plan")
        if x.dtype != torch.bfloat16 or x.dim() != 4 \
                or params[self._w3].shape[0] != x.shape[1]:
            return self._unfused(x, params)
        from .ops import hopper_block
        y = hopper_block.fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(),
                                          *self._folded(params))
        return y.permute(0, 3, 1, 2)


class _Plan:
    """Precomputed plan of a symbol graph (``mxnet_tpu/executor.py:64-160``):
    the op nodes in topological order with their parsed attrs, and for each
    the entries it reads last, which are dropped after it runs so that
    activations do not outlive their use.

    With ``train=True`` every ``train_aware`` op sees ``__train__`` in its
    attrs, and each op output that an ``aux_writeback`` maps onto a bound
    auxiliary state replaces that state in the ``new_aux`` that
    :meth:`execute` returns (BatchNorm's moving statistics).  Each
    ``needs_rng`` op gets a slot (``n_rng`` in all), as in the reference
    (``executor.py:79-100``): :meth:`execute` hands it the generator of its
    slot, or ``None`` when it is given none.

    With ``train=False`` (and ``fuse``) each identity bottleneck that
    :func:`_find_bottlenecks` finds becomes one :class:`_FusedBottleneck`
    step (``n_fused`` in all) in place of its ten nodes; ``fuse=False``
    keeps the ten, for an inference plan that autograd records."""

    def __init__(self, symbol, train: bool = False, fuse: bool = True):
        self.train = train
        self.topo = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.out_entries = [(id(n), i) for n, i in symbol._outputs]
        aux_ids = {id(n): n.name for n in self.topo
                   if n.is_var and n.name in set(self.aux_names)}
        ops = [node for node in self.topo if not node.is_var]
        keep = set(self.out_entries)
        fused = {} if train or not fuse else _find_bottlenecks(ops, keep)
        inside = {id(n) for f in fused.values() for n in f.nodes[:-1]}
        # (out id, input entries, fn, attrs, writeback, rng slot) per step
        units = []
        self.n_rng = 0
        for node in ops:
            if id(node) in inside:
                continue
            if id(node) in fused:
                f = fused[id(node)]
                units.append((id(node), f.inputs, f, None, {}, None))
                continue
            attrs = node.parsed_attrs()
            if node.op.train_aware:
                attrs = dict(attrs, __train__=train)
            writeback = {}
            if train:
                for oi, ii in node.op.aux_writeback.items():
                    if ii < len(node.inputs) and \
                            id(node.inputs[ii][0]) in aux_ids:
                        writeback[oi] = aux_ids[id(node.inputs[ii][0])]
            slot = None
            if node.op.needs_rng:
                slot = self.n_rng
                self.n_rng += 1
            units.append((id(node), [(id(p), i) for p, i in node.inputs],
                          node.op.fn, attrs, writeback, slot))
        #: identity bottlenecks run as one step each (inference plans only)
        self.n_fused = len(fused)
        last_use: Dict[_Entry, int] = {}
        for s, unit in enumerate(units):
            for entry in unit[1]:
                last_use[entry] = s
        release: List[List[_Entry]] = [[] for _ in units]
        for entry, s in last_use.items():
            if entry not in keep:
                release[s].append(entry)
        self.steps = [unit[:5] + (release[s], unit[5])
                      for s, unit in enumerate(units)]

    def placements(self, group2ctx, default) -> Optional[Dict[int, Any]]:
        """{step: Context} of every op step from its node's ``ctx_group``
        through ``group2ctx``, ``default`` (the bind context) for a node
        with no group there (``executor.py:356-368``); None without
        ``group2ctx``."""
        if not group2ctx:
            return None
        groups = {id(n): n.attrs.get("ctx_group") for n in self.topo}
        return {out_id: group2ctx.get(groups.get(out_id), default)
                for out_id, *_ in self.steps}

    def execute(self, values: Dict[str, torch.Tensor],
                generators: Optional[Sequence[torch.Generator]] = None,
                placements: Optional[Dict[int, Any]] = None,
                device: Optional[torch.device] = None
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """Run the plan on {variable name: tensor}, arguments and auxiliary
        states alike, with one generator per rng slot (or none); returns
        (heads, new auxiliary states).  With ``placements``
        (:meth:`placements`) each step runs on its device, its inputs
        copied there first: a copy that autograd differentiates, so the
        backward crosses the same boundaries.  An op with no inputs runs on
        the first value's device, else on ``device`` (a graph with no
        arguments)."""
        env: Dict[Tuple[int, int], Any] = {}
        for node in self.topo:
            if node.is_var:
                if node.name not in values:
                    raise MXNetError("unbound variable %r" % node.name)
                env[(id(node), 0)] = values[node.name]
        new_aux = {n: values[n] for n in self.aux_names}
        if values:
            device = next(iter(values.values())).device
        for out_id, inputs, fn, attrs, writeback, release, slot in \
                self.steps:
            ins = [env[e] for e in inputs]
            if placements is not None:
                device = placements[out_id].torch_device
                ins = [t.to(device) for t in ins]
            if not ins:
                attrs = dict(attrs, __device__=device)
            if slot is not None:
                ins.insert(0, generators[slot] if generators else None)
            res = fn(attrs, *ins)
            outs = res if isinstance(res, tuple) else (res,)
            for i, o in enumerate(outs):
                env[(out_id, i)] = o
            for oi, aux_name in writeback.items():
                new_aux[aux_name] = outs[oi]
            for entry in release:
                del env[entry]
        return [env[e] for e in self.out_entries], new_aux


class Executor:
    """A bound executor (parity: ``mxnet.executor.Executor``).

    ``arg_dict``/``grad_dict``/``aux_dict`` map names to NDArrays on the
    executor's context; ``grad_req`` maps each argument to ``"write"``,
    ``"add"`` or ``"null"`` (the arguments with a gradient array and a
    request other than ``"null"`` get gradients)."""

    def __init__(self, symbol, ctx: Context, args: Dict[str, NDArray],
                 aux_states: Dict[str, NDArray],
                 args_grad: Optional[Dict[str, NDArray]] = None,
                 grad_req: Optional[Dict[str, str]] = None,
                 group2ctx: Optional[Dict[str, Context]] = None):
        self.ctx = ctx
        self._group2ctx = dict(group2ctx or {})
        self._symbol = symbol
        self.arg_dict = args
        self.aux_dict = aux_states
        self.grad_dict = dict(args_grad or {})
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        missing = [n for n in self.aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        self._grad_req = {n: "null" for n in self.arg_names}
        self._grad_req.update(grad_req or {})
        self._grad_args = [n for n in self.arg_names
                           if self._grad_req[n] != "null"
                           and n in self.grad_dict]
        self._plans: Dict[bool, _Plan] = {}
        self._last_seeds: Optional[List[int]] = None
        # the last training forward's live heads and leaves, and the
        # arguments it read (tensor, version), for the next backward
        self._kept = None
        self.outputs: List[NDArray] = []

    @property
    def arg_arrays(self) -> List[NDArray]:
        """The arguments in ``list_arguments`` order (``executor.py:827``)."""
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        """Each argument's gradient array, None where it has none."""
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        """The auxiliary states in ``list_auxiliary_states`` order."""
        return [self.aux_dict[n] for n in self.aux_names]

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs) -> "Executor":
        """An executor of the same symbol for new input shapes
        (``executor.py:866``): each argument and auxiliary state whose
        shape is unchanged is the same NDArray, the others are new zeros,
        and every gradient array is new.  ``partial_shaping`` and
        ``allow_up_sizing`` are accepted and ignored, as the reference
        ignores them."""
        from .ndarray import ndarray as nd
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep(cur, shape):
            return cur if cur.shape == tuple(shape) else \
                nd.zeros(shape, ctx=self.ctx, dtype=cur._data.dtype)

        args = {n: keep(self.arg_dict[n], s)
                for n, s in zip(self.arg_names, arg_shapes)}
        auxs = {n: keep(self.aux_dict[n], s)
                for n, s in zip(self.aux_names, aux_shapes)}
        grads = {n: nd.zeros(a.shape, ctx=self.ctx, dtype=a._data.dtype)
                 for n, a in args.items() if n in self.grad_dict}
        return Executor(self._symbol, self.ctx, args, auxs, grads,
                        self._grad_req, group2ctx=self._group2ctx)

    def _plan(self, train: bool) -> _Plan:
        plan = self._plans.get(train)
        if plan is None:
            plan = self._plans[train] = _Plan(self._symbol, train)
            plan.placed = plan.placements(self._group2ctx, self.ctx)
        return plan

    def _wrap(self, plan, outs) -> List[NDArray]:
        """The heads as NDArrays, each on the context of the node that made
        it."""
        placed = plan.placed or {}
        return [NDArray(o, placed.get(out_id, self.ctx))
                for o, (out_id, _) in zip(outs, plan.out_entries)]

    def _execute(self, plan, values, gens=None):
        return plan.execute(values, gens, plan.placed, self.ctx.torch_device)

    def _feed(self, kwargs):
        """Bind new input values: an NDArray's tensor is adopted as is when
        its device and dtype match (else converted), anything else is
        copied in; a kept graph is dropped."""
        self._kept = None
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            dst = self.arg_dict[k]
            if isinstance(v, NDArray):
                dst._data = v._data.to(dst._data.device, dst._data.dtype)
            else:
                dst[:] = np.asarray(v)

    def _generators(self, plan, reuse=False):
        """One generator per rng slot on the executor's device, from fresh
        seeds (:func:`mxnet_tpu_torch.random.next_seed`), or from the last
        forward's seeds with ``reuse``."""
        if not plan.n_rng:
            return None
        if not reuse or self._last_seeds is None:
            self._last_seeds = [_random.next_seed() for _ in range(plan.n_rng)]
        dev = self.ctx.torch_device
        return [torch.Generator(device=dev).manual_seed(s)
                for s in self._last_seeds]

    def _values(self):
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        return values

    def _writeback_aux(self, new_aux):
        for n in self.aux_names:
            dst = self.aux_dict[n]
            dst._data = new_aux[n].detach().to(dst._data.device)

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; keyword arguments replace bound inputs first (an
        NDArray is adopted as is when its device and dtype match, anything
        else is copied in).  ``is_train`` runs the training plan (batch
        statistics, dropout) and writes the new moving statistics back;
        with gradient arguments it runs under autograd and keeps the graph
        for the next :meth:`backward`."""
        self._feed(kwargs)
        plan = self._plan(bool(is_train))
        if is_train and self._grad_args:
            live, new_aux, leaves = self._forward_graph(
                self._generators(plan))
            self._kept = (live, leaves, self._stamp())
            outs = [o.detach() for o in live]
            self._writeback_aux(new_aux)
        elif is_train:
            gens = self._generators(plan)
            with torch.no_grad():
                outs, new_aux = self._execute(plan, self._values(), gens)
            self._writeback_aux(new_aux)
        else:
            with torch.inference_mode():
                outs, _ = self._execute(plan, self._values())
        self.outputs = self._wrap(plan, outs)
        return self.outputs

    def _head_grads(self, outs, out_grads):
        """Head gradients: ones for every head when none are given (a
        ``make_loss`` head seeds ones, ``executor.py:725-735``)."""
        if out_grads is None:
            return [torch.ones_like(o) for o in outs]
        if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
            out_grads = [out_grads]
        gs = []
        for g, o in zip(out_grads, outs):
            if isinstance(g, NDArray):
                g = g._data
            elif not isinstance(g, torch.Tensor):
                g = torch.from_numpy(np.asarray(g))
            gs.append(g.to(o.device, o.dtype))
        return gs

    def _forward_graph(self, gens):
        """The training plan under autograd: (live heads, new aux states,
        the gradient arguments' leaves)."""
        values = {n: t.detach() for n, t in self._values().items()}
        leaves = [values[n].requires_grad_() for n in self._grad_args]
        with torch.enable_grad():
            outs, new_aux = self._execute(self._plan(True), values, gens)
        return outs, new_aux, leaves

    def _grads_of(self, outs, leaves, out_grads):
        """{argument: gradient} of live heads ``outs`` (their graph is
        freed)."""
        with torch.enable_grad():
            heads = [(o, g) for o, g in zip(outs, self._head_grads(
                outs, out_grads)) if o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in heads], leaves, [g for _, g in heads],
                allow_unused=True) if heads and leaves else [None] * len(leaves)
        return dict(zip(self._grad_args, grads))

    def _stamp(self):
        """Each argument's tensor and version: a kept graph is valid while
        they are unchanged."""
        return [(a._data, a._data._version) for a in self.arg_dict.values()]

    def _run_with_grads(self, out_grads, gens):
        """The training plan under autograd: (outputs, new aux states,
        {argument: gradient})."""
        outs, new_aux, leaves = self._forward_graph(gens)
        grads = self._grads_of(outs, leaves, out_grads)
        return [o.detach() for o in outs], new_aux, grads

    def _apply_grads(self, grads):
        for n, g in grads.items():
            dst = self.grad_dict[n]
            g = torch.zeros_like(dst._data) if g is None \
                else g.to(dst._data.dtype)
            if self._grad_req[n] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the heads (ones unless ``out_grads``) with respect
        to every argument with a gradient request, written into
        ``grad_dict`` (added for ``"add"``).  They come from the graph of
        the last training forward while its arguments are unchanged, else
        from the forward run again with that forward's generators.
        ``is_train`` is accepted and ignored, as the reference's is."""
        kept, self._kept = self._kept, None
        if kept is not None and all(
                t is u and v == w
                for (t, v), (u, w) in zip(kept[2], self._stamp())):
            grads = self._grads_of(kept[0], kept[1], out_grads)
        else:
            gens = self._generators(self._plan(True), reuse=True)
            _, _, grads = self._run_with_grads(out_grads, gens)
        self._apply_grads(grads)

    def forward_backward(self, out_grads=None, **kwargs) -> List[NDArray]:
        """One training step's forward and backward in one pass
        (``executor.py:763``): outputs, new moving statistics and
        gradients."""
        self._feed(kwargs)
        gens = self._generators(self._plan(True))
        outs, new_aux, grads = self._run_with_grads(out_grads, gens)
        self._writeback_aux(new_aux)
        self._apply_grads(grads)
        self.outputs = self._wrap(self._plan(True), outs)
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown parameter %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % k)
