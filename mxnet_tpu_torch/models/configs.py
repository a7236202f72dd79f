"""Decoder-LM size ladder: tiny (CI/CPU) up to gpt2-small-ish (the port's
copy of ``mxnet_tpu/models/configs.py``, which is pure Python; the port
imports nothing of the reference package).

The ladder exists so every consumer — tests, bench.py --transformer,
serving — names shapes the same way instead of re-inventing ad-hoc
dims.  ``flops_per_token`` uses the standard dense-training accounting
(6N weight-FLOPs + attention score/value terms, PaLM appendix B
convention, causal masking NOT halved) so MFU numbers are comparable
across published results.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab_size: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    seq_len: int

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model %d not divisible by n_heads %d"
                             % (self.d_model, self.n_heads))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        """Weight count of the matmul-bearing parameters (embedding +
        per-block QKVO/FFN + untied LM head; norms excluded — noise)."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        return v * d + L * (4 * d * d + 2 * d * f) + d * v

    def flops_per_token(self) -> float:
        """Training (fwd+bwd) FLOPs per token: 6 per matmul weight plus
        the attention score/value matmuls, 12·L·T·d_model."""
        d, L, f, v = (self.d_model, self.n_layers, self.d_ff,
                      self.vocab_size)
        matmul_params = v * d + L * (4 * d * d + 2 * d * f)
        return 6.0 * matmul_params + 12.0 * L * self.seq_len * d


CONFIGS = {
    # CI / CPU smoke shape: compiles in seconds, exercises every layer
    "tiny": TransformerConfig("tiny", vocab_size=256, n_layers=2,
                              d_model=64, n_heads=4, d_ff=256, seq_len=64),
    # CPU bench shape: big enough that tokens/s has signal
    "mini": TransformerConfig("mini", vocab_size=1024, n_layers=4,
                              d_model=128, n_heads=4, d_ff=512,
                              seq_len=128),
    # single-chip dev shape
    "small": TransformerConfig("small", vocab_size=8192, n_layers=6,
                               d_model=384, n_heads=6, d_ff=1536,
                               seq_len=256),
    # gpt2-small-ish (124M): the chip target for bench.py --transformer
    "gpt2-small": TransformerConfig("gpt2-small", vocab_size=50257,
                                    n_layers=12, d_model=768, n_heads=12,
                                    d_ff=3072, seq_len=1024),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    """Ladder lookup with field overrides (e.g. a shorter seq_len)."""
    from dataclasses import replace
    try:
        cfg = CONFIGS[name]
    except KeyError:
        raise KeyError("unknown transformer config %r (have: %s)"
                       % (name, ", ".join(sorted(CONFIGS))))
    return replace(cfg, **overrides) if overrides else cfg
