"""Whisper-medium [arXiv:2212.04356] — encoder-decoder backbone.

24L (each side) d_model=1024 16H (MHA kv=16, head_dim=64) d_ff=4096
vocab=51865, GELU MLP, LayerNorm, learned decoder positions, sinusoidal
encoder positions.  The conv1d audio frontend is a STUB per the brief:
``input_specs()`` provides precomputed frame embeddings (B, T, d_model).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    n_layers=24,
    n_encoder_layers=24,
    encoder_decoder=True,
    d_model=1024,
    vocab_size=51_865,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    mlp_gated=False,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    attn_out_bias=True,
    norm="layernorm",
    max_target_len=448,
    frontend="audio_stub",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256, max_target_len=16,
)
