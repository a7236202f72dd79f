"""Model symbols of the port: ResNet-50 for serving, and the decoder-only
transformer LM (``transformer``) with its size ladder (``configs``) and its
parallel compositions."""
from . import resnet  # noqa: F401
from . import configs
from . import transformer
from .configs import CONFIGS, TransformerConfig, get_config
from .transformer import (block_apply, init_block_params,
                          long_context_attention, moe_transformer_ffn,
                          pipeline_transformer, transformer_block,
                          transformer_lm)

__all__ = ["configs", "transformer", "TransformerConfig", "CONFIGS",
           "get_config", "transformer_lm", "transformer_block",
           "init_block_params", "block_apply", "long_context_attention",
           "moe_transformer_ffn", "pipeline_transformer"]
