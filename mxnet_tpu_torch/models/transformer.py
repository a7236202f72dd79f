"""Decoder-only transformer LM (counterpart of
``mxnet_tpu/models/transformer.py``), in two forms that share the op
implementations:

* the Symbol graph, :func:`transformer_lm` / :func:`transformer_block`, that
  binds through ``Module`` and trains with its fused step: token and learned
  position embeddings, pre-norm blocks around the ``MultiHeadAttention`` op
  (flash attention on the hand-written kernels), a gelu FFN, the final
  LayerNorm, an untied LM head and ``make_loss(mean(streaming CE))``.  The
  parameter names and the graph's JSON are the reference's;
* the functional block, :func:`init_block_params` / :func:`block_apply`:
  the same block on tensors, through the same registered op functions,
  and what the parallel layer (``mxnet_tpu_torch.parallel``) composes:
  :func:`long_context_attention` shards the sequence over a mesh ``sp``
  axis with ring attention, :func:`moe_transformer_ffn` swaps the dense FFN
  for the expert-parallel MoE layer, and :func:`pipeline_transformer` runs
  blocks as GPipe stages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.registry import OPS
from .configs import TransformerConfig

__all__ = ["transformer_lm", "transformer_block", "init_block_params",
           "block_apply", "long_context_attention", "moe_transformer_ffn",
           "pipeline_transformer"]


# ---------------------------------------------------------------------------
# Symbol graph
# ---------------------------------------------------------------------------
def transformer_block(x, cfg: TransformerConfig, idx: int, prefix: str):
    """One pre-norm decoder block: x + Attn(LN(x)); x + FFN(LN(x))."""
    from .. import symbol as sym
    n = "%sl%d_" % (prefix, idx)
    h = sym.LayerNorm(x, name=n + "ln1")
    a = sym.MultiHeadAttention(h, num_heads=cfg.n_heads, causal=True,
                               name=n + "attn")
    x = sym.elemwise_add(x, a, name=n + "attn_res")
    h = sym.LayerNorm(x, name=n + "ln2")
    f = sym.FullyConnected(h, num_hidden=cfg.d_ff, flatten=False,
                           no_bias=False, name=n + "ffn_fc1")
    f = sym.Activation(f, act_type="gelu", name=n + "ffn_gelu")
    f = sym.FullyConnected(f, num_hidden=cfg.d_model, flatten=False,
                           no_bias=False, name=n + "ffn_down")
    return sym.elemwise_add(x, f, name=n + "ffn_res")


def transformer_lm(cfg: TransformerConfig, prefix: str = "tfm_",
                   loss: bool = True):
    """The decoder LM Symbol: data ``(B, T)`` token ids, label
    ``softmax_label`` ``(B, T)`` next tokens, ``T == cfg.seq_len``.

    ``loss=True`` (training) returns ``make_loss(mean(streaming CE))``, a
    scalar head whose backward seeds ones, so ``get_outputs()[0]`` is the
    batch loss; ``loss=False`` returns the ``(B, T, vocab)`` logits."""
    from .. import symbol as sym
    data = sym.Variable("data")
    tok = sym.Embedding(data, input_dim=cfg.vocab_size,
                        output_dim=cfg.d_model,
                        name=prefix + "tok_embedding")
    # learned positions: arange(T) broadcast over the batch, through the
    # same Embedding op
    pos_ids = sym.broadcast_like(
        sym.expand_dims(sym.arange(0, cfg.seq_len, name=prefix + "iota"),
                        axis=0),
        data, name=prefix + "pos_ids")
    pos = sym.Embedding(pos_ids, input_dim=cfg.seq_len,
                        output_dim=cfg.d_model,
                        name=prefix + "pos_embedding")
    x = sym.broadcast_add(tok, pos, name=prefix + "embed_sum")
    for i in range(cfg.n_layers):
        x = transformer_block(x, cfg, i, prefix)
    x = sym.LayerNorm(x, name=prefix + "final_ln")
    logits = sym.FullyConnected(x, num_hidden=cfg.vocab_size,
                                flatten=False, no_bias=True,
                                name=prefix + "lm_head")
    if not loss:
        return logits
    label = sym.Variable("softmax_label")
    ce = sym.streaming_softmax_ce(logits, label, axis=-1,
                                  name=prefix + "ce")
    return sym.make_loss(sym.mean(ce), name=prefix + "loss")


# ---------------------------------------------------------------------------
# Functional block (the same op functions as the Symbol graph)
# ---------------------------------------------------------------------------
_LN_ATTRS = {"axis": -1, "eps": 1e-5, "output_mean_var": False}


def _ln(x, gamma, beta):
    return OPS["LayerNorm"].fn(_LN_ATTRS, x, gamma, beta)[0]


def _mha(cfg, x, wq, wk, wv, wo):
    return OPS["MultiHeadAttention"].fn(
        {"num_heads": cfg.n_heads, "causal": True}, x, wq, wk, wv, wo)


def init_block_params(cfg: TransformerConfig, rng: np.random.RandomState):
    """One block's parameters as a dict of fp32 CPU tensors, drawn from
    ``rng`` in the reference's order (weights N(0, 0.02²), (out, in))."""
    d, f = cfg.d_model, cfg.d_ff

    def w(*shape, scale=0.02):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32)

    def const(value, n):
        return torch.full((n,), value, dtype=torch.float32)

    return {
        "ln1_gamma": const(1.0, d), "ln1_beta": const(0.0, d),
        "query_weight": w(d, d), "key_weight": w(d, d),
        "value_weight": w(d, d), "out_proj_weight": w(d, d),
        "ln2_gamma": const(1.0, d), "ln2_beta": const(0.0, d),
        "fc1_weight": w(f, d), "fc1_bias": const(0.0, f),
        "down_weight": w(d, f), "down_bias": const(0.0, d),
    }


def block_apply(cfg: TransformerConfig, params, x):
    """The pre-norm block on a ``(B, T, d_model)`` tensor, the same math as
    :func:`transformer_block`."""
    h = _ln(x, params["ln1_gamma"], params["ln1_beta"])
    x = x + _mha(cfg, h, params["query_weight"], params["key_weight"],
                 params["value_weight"], params["out_proj_weight"])
    h = _ln(x, params["ln2_gamma"], params["ln2_beta"])
    h = F.linear(h, params["fc1_weight"], params["fc1_bias"])
    h = F.gelu(h, approximate="none")
    h = F.linear(h, params["down_weight"], params["down_bias"])
    return x + h


# ---------------------------------------------------------------------------
# Parallel composition
# ---------------------------------------------------------------------------
def long_context_attention(q, k, v, mesh, axis: str = "sp",
                           causal: bool = True, block_size: int = 512,
                           scale: Optional[float] = None):
    """Sequence-parallel exact attention for contexts too long for one
    device: ``parallel.ring_attention`` over the mesh ``axis``, K/V blocks
    going round the ring while each device keeps its Q block.  ``[B, H, T,
    D]`` in and out."""
    from ..parallel.ring_attention import ring_attention
    return ring_attention(q, k, v, mesh, axis=axis, causal=causal,
                          block_size=block_size, scale=scale)


def moe_transformer_ffn(x, moe_params, mesh=None, axis: str = "ep",
                        k: int = 2, capacity_factor: float = 1.25):
    """The MoE FFN in place of the dense FFN half of :func:`block_apply`
    (the caller keeps the pre-norm and the residual): tokens of any leading
    shape, experts over the mesh ``axis``, exact gelu as the dense path."""
    from ..parallel.moe import moe_ffn
    out = moe_ffn(x.reshape(-1, x.shape[-1]), moe_params, mesh=mesh,
                  axis=axis, k=k, capacity_factor=capacity_factor,
                  act=lambda a: F.gelu(a, approximate="none"))
    return out.reshape(x.shape)


def pipeline_transformer(mesh, axis: str, cfg: TransformerConfig,
                         stage_params, x, n_micro: int):
    """Transformer blocks as GPipe stages over ``mesh[axis]``, one block a
    stage: ``stage_params`` is a dict of ``(S, ...)`` tensors with
    :func:`init_block_params`'s names; ``x`` is ``(B, T, d_model)``."""
    from ..parallel.pipeline import pipeline_apply
    return pipeline_apply(mesh, axis,
                          lambda params, xb: block_apply(cfg, params, xb),
                          stage_params, x, n_micro)
