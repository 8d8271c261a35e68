"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8, head_dim=64) d_ff=512 vocab=49155,
MoE 32 experts top-8, SwiGLU experts, RMSNorm, tied embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    vocab_size=49_155,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    n_experts=32,
    top_k=8,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    attn_seq_shard=True,  # 8 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, n_experts=8, top_k=2, vocab_size=256,
)
