"""Granite-4.0-H-Small [hf:ibm-granite/granite-4.0-h-small, config.json],
as one chip of an expert-parallel deployment.

Published: 40L d_model=4096, ``layer_types`` 36 Mamba-2 layers and 4 GQA
attention layers (indices 5, 15, 25, 35); Mamba-2 128 heads x 64,
d_state 128, n_groups 1, conv width 4 with bias, expand 2, chunk 256;
attention 32 q heads, 8 kv heads, head_dim 128 (4096 / 32), no bias,
NoPE, scores scaled by ``attention_multiplier`` 0.0078125; MoE 72 routed
experts top-10 of width 768 (``intermediate_size``) and one shared expert
of width 1536 in every layer, SwiGLU; ``embedding_multiplier`` 12,
``residual_multiplier`` 0.22, logits divided by ``logits_scaling`` 16;
vocab 100352, tied embeddings, RMSNorm eps 1e-5.

The cut: one 8xH100 node serves the model with expert parallelism 8, and
this config is one chip's share of it.  The chip holds 9 of each layer's
72 routed experts (experts 0-8) and 1/8 of the vocabulary, 12544 rows
(ids are drawn from that slice, and logits are over it); the mixers, the
routers (4096 x 72) and the shared experts are whole.  All 40 layers are
kept.  The chip computes its 9 experts' part for the tokens routed to
them; what the other 63 would add is left out.  About 8.06 B parameters.

Departures, each an assumption: weights stored in bfloat16 (the tile
grid's 2-byte class) and computed in float32 (``dtype``), the precision
the plain reference is held to; the routers' top-10 gates are a softmax
over the 10 selected logits (HF ``GraniteMoeTopKGating``); Mamba-2's
fused ``in_proj`` and ``conv1d`` are the port's per-stream projections
and conv kernels (the same parameters, split); no load-balancing loss is
trained here, the auxiliary loss is the port's Switch form.
"""
import dataclasses

from ..models.config import HybridConfig

ATTENTION_LAYERS = (5, 15, 25, 35)
LAYER_TYPES = tuple("attention" if i in ATTENTION_LAYERS else "mamba" for i in range(40))

CONFIG = HybridConfig(
    name="granite-4.0-h-small",
    n_layers=40,
    d_model=4096,
    vocab_size=12_544,  # this chip's eighth of the published 100352
    block="hybrid",
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=768,
    n_experts=72,
    top_k=10,
    mlp_gated=True,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-5,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    param_dtype="bfloat16",
    dtype="float32",
    remat=False,
    layer_types=LAYER_TYPES,
    shared_d_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    rope=False,
    experts_held=9,  # of 72: expert parallelism 8
    expert_start=0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, layer_types=("mamba", "attention", "mamba", "mamba"),
    d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=32, shared_d_ff=48,
    n_experts=8, top_k=3, experts_held=4, vocab_size=256, ssm_state=16,
    ssm_head_dim=16, ssm_chunk=16,
)
