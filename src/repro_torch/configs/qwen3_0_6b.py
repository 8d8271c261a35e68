"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B, family spec hf:Qwen/Qwen3-8B].

28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072 vocab=151936,
qk-norm, SwiGLU, RMSNorm, tied embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    vocab_size=151_936,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    qk_norm=True,
    d_ff=3072,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    attn_seq_shard=True,  # 8 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
)
