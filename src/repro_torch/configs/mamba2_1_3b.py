"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD stack.

48L d_model=2048, d_inner=2*d_model=4096, ssm_state=128, head_dim=64
(64 SSM heads), conv width 4, vocab=50280, no MLP (d_ff=0), RMSNorm,
tied embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    vocab_size=50_280,
    block="mamba2",
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, vocab_size=256,
)
