"""Unified model configuration covering all assigned architectures.

One dataclass describes dense GQA transformers, MoE transformers, Mamba-2
(SSD) stacks, Hymba-style hybrid (parallel attention+SSM) blocks, Whisper
encoder-decoder, and VLM backbones with stub frontends.  Per-architecture
instances live in ``repro_torch.configs``.  The port's own copy of
``repro.models.config``, field for field; only ``param_count`` builds its
tree on the ``meta`` device instead of ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    # ---- attention (n_heads == 0 -> attention-free / pure SSM stack)
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 -> full attention in every attention layer
    global_layers: Sequence[int] = ()  # full-attention layers when SWA is on
    # sequence-parallel attention: shard the q/scores *sequence* dim over the
    # model axis instead of (too few) KV heads; K/V replicate (cheap for
    # GQA with tiny kv_dim).  Set for archs whose kv head count cannot use
    # the TP axis (qwen2: 2 kv heads vs 16-way model).
    attn_seq_shard: bool = False
    # ---- MLP
    d_ff: int = 0
    mlp_gated: bool = True  # SwiGLU-style gate+up vs plain up
    mlp_act: str = "silu"  # silu | gelu
    mlp_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # ---- MoE (replaces the dense MLP in every layer when n_experts > 0)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ---- SSM (mamba2 / hybrid)
    block: str = "attention"  # attention | mamba2 | hymba
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # ---- encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_target_len: int = 448
    # ---- modality frontend stub
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_patches: int = 0  # vision: patch embeddings prepended to text
    # ---- embeddings / numerics
    tie_embeddings: bool = False
    param_dtype: str = "float32"  # training; serving casts to activation dtype
    dtype: str = "bfloat16"  # activation/compute dtype
    remat: bool = True

    # ------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a lane multiple so the embedding/logits shard
        evenly over the model axis (standard production padding; the loss
        and sampling mask the padding ids)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def has_attention(self) -> bool:
        return self.block in ("attention", "hymba") and self.n_heads > 0

    def has_ssm(self) -> bool:
        return self.block in ("mamba2", "hymba")

    def is_global_layer(self, layer: int) -> bool:
        """Full attention (vs sliding window) for this layer index."""
        return self.sliding_window == 0 or layer in tuple(self.global_layers)

    # ---------------------------------------------------------- accounting
    def param_count(self) -> int:
        """Exact parameter count (matches init_params, used for 6ND roofline):
        the tree built on the ``meta`` device, shapes only."""
        from . import model as _model  # lazy; avoids import cycle

        params = _model.init_meta_params(self)
        return sum(int(np_prod(x.shape)) for x in _model.tree_leaves(params))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        total = self.param_count()
        if self.n_experts == 0:
            return total
        # subtract the inactive expert fraction of expert weights
        expert_params = self.n_layers * self.n_experts * self._expert_params_per()
        active = self.n_layers * self.top_k * self._expert_params_per()
        return total - expert_params + active

    def _expert_params_per(self) -> int:
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
