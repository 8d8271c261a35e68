"""Unified model configuration covering all assigned architectures.

One dataclass describes dense GQA transformers, MoE transformers, Mamba-2
(SSD) stacks, Hymba-style hybrid (parallel attention+SSM) blocks, Whisper
encoder-decoder, and VLM backbones with stub frontends.  Per-architecture
instances live in ``repro_torch.configs``.  `ModelConfig` is the port's own
copy of ``repro.models.config``, field for field; only ``param_count``
builds its tree on the ``meta`` device instead of ``jax.eval_shape``.
`HybridConfig` extends it for the port alone: a stack whose layers pick
their mixer one by one (Granite-4.0-H), with a shared expert, scaled
residuals, scores and logits, and one chip's share of the routed experts.
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


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """Granite-4.0-H's ``granitemoehybrid`` stack (``block="hybrid"``).

    Layer ``i``'s token mixer is ``layer_types[i]``: ``"mamba"`` (the
    Mamba-2 SSD mixer of `models.mamba2`) or ``"attention"`` (GQA).  Every
    layer then runs the routed MoE beside a shared SwiGLU expert of width
    ``shared_d_ff``, and adds both branches times ``residual_multiplier``.
    The embedding is scaled by ``embedding_multiplier``, attention scores
    by ``attention_multiplier`` (0: ``1 / sqrt(d_head)``), the logits
    divided by ``logits_scaling``; ``rope=False`` is NoPE.

    Expert parallelism: the router keeps all ``n_experts`` outputs and
    routes every token over them, and this chip holds the ``experts_held``
    experts from ``expert_start`` on (0: all of them); a token's held
    experts give this chip's part of the layer's output, and what the
    other experts would add is left out."""

    layer_types: tuple[str, ...] = ()
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    rope: bool = True
    experts_held: int = 0
    expert_start: int = 0

    def __post_init__(self):
        if len(self.layer_types) != self.n_layers or not set(self.layer_types) <= {
                "mamba", "attention"}:
            raise ValueError("layer_types needs one of 'mamba' / 'attention' a layer")
        if self.expert_start < 0 or self.expert_start + self.held_experts > self.n_experts:
            raise ValueError("the held experts lie outside the router's")

    @property
    def held_experts(self) -> int:
        return self.experts_held or self.n_experts

    def layers_of(self, kind: str) -> list[int]:
        """The layer indices whose mixer is ``kind``, in order."""
        return [i for i, t in enumerate(self.layer_types) if t == kind]

    def plain_keys(self) -> dict:
        """The published keys the plain reference reads
        (`repro_torch.models.plain_granite4h`), from this config."""
        return dict(
            hidden_size=self.d_model, layer_types=list(self.layer_types),
            mamba_n_heads=self.ssm_heads, mamba_d_head=self.ssm_head_dim,
            mamba_d_state=self.ssm_state, mamba_d_conv=self.ssm_conv_width,
            num_attention_heads=self.n_heads, num_key_value_heads=self.n_kv_heads,
            num_experts_per_tok=self.top_k, embedding_multiplier=self.embedding_multiplier,
            residual_multiplier=self.residual_multiplier,
            attention_multiplier=self.attention_multiplier or self.d_head ** -0.5,
            logits_scaling=self.logits_scaling, rms_norm_eps=self.norm_eps,
            expert_start=self.expert_start,
        )


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
