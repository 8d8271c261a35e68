"""Hymba-1.5B [arXiv:2411.13676] — hybrid parallel attention + SSM heads.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16, parallel attn+mamba per block fused by per-branch RMSNorm
averaging.  Sliding-window attention (1024) everywhere except 3 global
full-attention layers (first / middle / last), as in the paper.  Hymba's
learnable meta tokens are represented by the first tokens of the sequence
(stub; noted in docs/DESIGN.md section 9).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    vocab_size=32_001,
    block="hymba",
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    d_ff=5504,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,  # smaller chunk halves the per-head L^2 decay-mask bytes
    rope_theta=10_000.0,
    attn_seq_shard=True,  # 5 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
    sliding_window=8, global_layers=(0, 2),
)
