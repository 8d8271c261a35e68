"""Qwen2-0.5B [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2, head_dim=64) d_ff=4864 vocab=151936,
QKV bias, SwiGLU, RMSNorm, tied embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    n_layers=24,
    d_model=896,
    vocab_size=151_936,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    qkv_bias=True,
    d_ff=4864,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    attn_seq_shard=True,  # 2 kv heads can't shard the 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
)
