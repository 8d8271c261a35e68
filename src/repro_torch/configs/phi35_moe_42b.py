"""Phi-3.5-MoE (42B total, 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=6400 vocab=32064,
MoE 16 experts top-2 in every layer, SwiGLU experts, LayerNorm.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    vocab_size=32_064,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    n_experts=16,
    top_k=2,
    mlp_gated=True,
    mlp_act="silu",
    norm="layernorm",
    rope_theta=10_000.0,
    attn_seq_shard=True,  # 8 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, n_experts=4, top_k=2, vocab_size=256,
)
