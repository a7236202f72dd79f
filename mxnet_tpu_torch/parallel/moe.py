"""Expert parallelism: a Mixture-of-Experts FFN sharded over a mesh axis
(counterpart of ``mxnet_tpu/parallel/moe.py``).

The GShard/Switch layer of the reference, step for step: a top-k softmax
gate, dispatch into a fixed capacity buffer of ``C`` slots an expert
(tokens past capacity are dropped: their combine weight is zero), the
expert MLPs, and the weighted combine.  With a mesh, the tokens are split
over ``mesh[axis]`` and so are the experts (``E/n`` a device); each shard
gates its own tokens with a capacity computed from its own token count, as
the reference's ``shard_map`` body does, and two ``all_to_all``s carry the
expert inputs to the experts' devices and the outputs back.  That capacity
differs from the capacity without a mesh, so the two agree only where no
token is dropped.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import Mesh, all_to_all, replicate, shard, unshard

__all__ = ["top_k_gating", "moe_ffn", "MoEParams", "init_moe_params",
           "load_balancing_loss"]


def top_k_gating(logits, k: int):
    """Top-k softmax gate: (weights, ids), the weights renormalised over
    the chosen k."""
    gates = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.topk(gates, k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights.to(logits.dtype), ids


def _dispatch_mask(ids, weights, num_experts: int, capacity: int):
    """(T, k) routed ids -> dispatch one-hot (T, E, C) and combine weights
    (T, E, C): a token's slot is its rank among the tokens routed to that
    expert, in order of (token, choice); ranks past ``capacity`` drop."""
    T, k = ids.shape
    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, num_experts)                    # (T*k, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos < capacity
    disp = (onehot.float()[:, :, None]
            * F.one_hot(torch.where(keep, pos, torch.zeros_like(pos)),
                        capacity).float()[:, None, :])
    disp = (disp * keep[:, None, None].float()).reshape(
        T, k, num_experts, capacity)
    combine = (disp * weights.reshape(T, k, 1, 1).float()).sum(dim=1)
    return disp.sum(dim=1), combine


class MoEParams:
    """The gate and the experts' weights: ``wg`` (D, E), ``w1`` (E, D, H),
    ``w2`` (E, H, D)."""

    def __init__(self, wg, w1, w2):
        self.wg = wg
        self.w1 = w1
        self.w2 = w2

    def to(self, device) -> "MoEParams":
        return MoEParams(self.wg.to(device), self.w1.to(device),
                         self.w2.to(device))


def init_moe_params(rng: np.random.RandomState, d_model: int,
                    d_hidden: int, num_experts: int,
                    dtype=np.float32) -> MoEParams:
    """Uniform(±1/sqrt(fan_in)) weights drawn from ``rng`` in the
    reference's order, as CPU tensors (``MoEParams.to`` places them)."""
    s1 = 1.0 / np.sqrt(d_model)
    s2 = 1.0 / np.sqrt(d_hidden)
    draw = lambda lim, shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-lim, lim, shape).astype(dtype))
    return MoEParams(draw(s1, (d_model, num_experts)),
                     draw(s1, (num_experts, d_model, d_hidden)),
                     draw(s2, (num_experts, d_hidden, d_model)))


def _gate_and_dispatch(xs, wg, k, num_experts, capacity):
    weights, ids = top_k_gating(xs @ wg.to(xs.dtype), k)
    dispatch, combine = _dispatch_mask(ids, weights, num_experts, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(xs.dtype), xs)
    return expert_in, combine


def _expert_mlp(expert_in, w1, w2, act):
    h = act(torch.einsum("ecd,edh->ech", expert_in, w1.to(expert_in.dtype)))
    return torch.einsum("ech,ehd->ecd", h, w2.to(expert_in.dtype))


def moe_ffn(x, params: MoEParams, mesh: Optional[Mesh] = None,
            axis: str = "ep", k: int = 2, capacity_factor: float = 1.25,
            act=torch.relu):
    """MoE FFN of ``(T, D)`` tokens: top-k routed expert MLPs.  Without a
    mesh every expert runs on x's device with capacity ``ceil(cf k T /
    E)``; with one, experts and tokens split over ``mesh[axis]`` and each
    shard's capacity is ``ceil(cf k (T/n) / E)``."""
    E = params.wg.shape[1]
    T = x.shape[0]
    if mesh is None:
        capacity = int(np.ceil(capacity_factor * k * T / E))
        expert_in, combine = _gate_and_dispatch(x, params.wg, k, E, capacity)
        expert_out = _expert_mlp(expert_in, params.w1, params.w2, act)
        return torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    n = mesh.shape[axis]
    if E % n:
        raise ValueError("num_experts %d not divisible by %s=%d"
                         % (E, axis, n))
    local_capacity = int(np.ceil(capacity_factor * k * (T // n) / E))
    xs = shard(x, mesh, axis, 0)
    gated = [_gate_and_dispatch(t, wg, k, E, local_capacity)
             for t, wg in zip(xs, replicate(params.wg, mesh, axis))]
    # every shard sends each expert's slots to the expert's device
    expert_in = all_to_all([g[0] for g in gated], 0, 1)
    expert_out = [_expert_mlp(e, w1, w2, act) for e, w1, w2 in zip(
        expert_in, shard(params.w1, mesh, axis, 0),
        shard(params.w2, mesh, axis, 0))]
    expert_out = all_to_all(expert_out, 1, 0)
    ys = [torch.einsum("tec,ecd->td", c.to(t.dtype), eo)
          for t, (_, c), eo in zip(xs, gated, expert_out)]
    return unshard(ys, 0, x.device)


def load_balancing_loss(logits, ids, num_experts: int):
    """Switch-Transformer auxiliary loss: E * sum_e (fraction of tokens
    whose first choice is e) * (mean gate probability of e)."""
    gates = torch.softmax(logits.float(), dim=-1)
    me = gates.mean(dim=0)
    ce = F.one_hot(ids[:, 0], num_experts).float().mean(dim=0)
    return num_experts * (me * ce).sum()
