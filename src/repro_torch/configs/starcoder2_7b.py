"""StarCoder2-7B [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4, head_dim=128) d_ff=18432 vocab=49152,
RoPE, LayerNorm, plain GELU MLP with bias.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    vocab_size=49_152,
    n_heads=36,
    n_kv_heads=4,
    d_head=128,
    qkv_bias=True,
    attn_out_bias=True,
    d_ff=18432,
    mlp_gated=False,
    mlp_act="gelu",
    mlp_bias=True,
    norm="layernorm",
    rope_theta=1_000_000.0,
    attn_seq_shard=True,  # 4 kv heads vs 16-way model axis
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256,
)
