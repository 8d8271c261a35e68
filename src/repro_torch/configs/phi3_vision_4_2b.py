"""Phi-3-vision-128k (4.2B) [hf:microsoft/Phi-3-vision-128k-instruct].

Phi-3-mini text backbone: 32L d_model=3072 32H (MHA kv=32, head_dim=96)
d_ff=8192 vocab=32064, SwiGLU, RMSNorm.  The CLIP vision tower is a STUB:
``input_specs()`` provides precomputed patch embeddings projected to
d_model, prepended to the token sequence.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    n_layers=32,
    d_model=3072,
    vocab_size=32_064,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    frontend="vision_stub",
    num_patches=1024,  # stub image -> 1024 patch embeddings
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256, num_patches=8,
)
