"""Qwen3-14B [hf:Qwen/Qwen3-14B, family spec hf:Qwen/Qwen3-8B].

40L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=17408 vocab=151936,
qk-norm, SwiGLU, RMSNorm.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    n_layers=40,
    d_model=5120,
    vocab_size=151_936,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    qk_norm=True,
    d_ff=17408,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    attn_seq_shard=True,  # 8 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
)
