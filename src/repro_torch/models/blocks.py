"""Decoder/encoder blocks assembled from the mixer + MLP primitives.

The port of ``repro.models.blocks`` (its training block in its forward
use only).  Block kinds (cfg.block):
  attention — pre-norm GQA attention + (MoE or dense) MLP
  mamba2    — pre-norm SSD mixer only (no MLP, as in mamba2-1.3b)
  hymba     — parallel attention + SSM heads fused by per-branch RMSNorm
              averaging (Hymba, arXiv:2411.13676), then MLP
Whisper uses `encoder` blocks (bidirectional attention) and decoder blocks
with cross-attention (`use_cross=True`).

The port's own ``hybrid`` block (`HybridConfig`, Granite-4.0-H) has one
mixer a layer, Mamba-2 or NoPE attention by ``layer_types``, then the
routed MoE beside the shared expert:
``h += m * mixer(norm1(h))``, ``h += m * (MoE(x) + Shared(x))`` with
``x = norm2(h)`` and ``m`` the residual multiplier.  Its parameters come
in two parts, the layer's own (``common``: the norms, the MoE, the shared
expert) and its mixer's.
"""
from __future__ import annotations

import torch

from .attention import attn_apply, attn_decode, attn_init
from .config import ModelConfig
from .layers import apply_norm, dtype_of, mlp_apply, mlp_init, norm_init
from .mamba2 import ssm_apply, ssm_decode, ssm_init
from .moe import moe_apply, moe_ep_apply, moe_ep_init, moe_init, shared_apply, shared_init
from .redistribute import pad_local


def _branch_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _hymba_mix(cfg: ModelConfig, p: dict, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return 0.5 * (
        _branch_norm(p["branch_a"], a, cfg.norm_eps)
        + _branch_norm(p["branch_s"], s, cfg.norm_eps)
    )


def block_init(cfg: ModelConfig, gen, dtype, device, use_cross: bool = False) -> dict:
    p: dict = {"norm1": norm_init(cfg, cfg.d_model, dtype, device)}
    if cfg.block in ("attention", "hymba"):
        p["attn"] = attn_init(cfg, gen, dtype, device)
    if cfg.block in ("mamba2", "hymba"):
        p["ssm"] = ssm_init(cfg, gen, dtype, device)
    if cfg.block == "hymba":
        p["branch_a"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["branch_s"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if use_cross:
        p["norm_cross"] = norm_init(cfg, cfg.d_model, dtype, device)
        p["cross"] = attn_init(cfg, gen, dtype, device)
    if cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg, cfg.d_model, dtype, device)
        if cfg.n_experts > 0:
            p["moe"] = moe_init(cfg, gen, dtype, device)
        else:
            p["mlp"] = mlp_init(cfg, gen, dtype, device)
    return p


def _mlp_branch(cfg: ModelConfig, p: dict, h: torch.Tensor, compute_dtype):
    """The (MoE or dense) MLP's residual branch and the MoE's aux loss."""
    hn = apply_norm(cfg, p["norm2"], h)
    if cfg.n_experts > 0:
        return moe_apply(cfg, p["moe"], hn, compute_dtype)
    return mlp_apply(cfg, p["mlp"], hn, compute_dtype), None


def _mixer_train(cfg, p, h, positions, window, compute_dtype, rope=True):
    """The token mixer on a full sequence. Returns the residual branch."""
    hn = apply_norm(cfg, p["norm1"], h)
    if cfg.block == "attention":
        return attn_apply(cfg, p["attn"], hn, positions, window, rope=rope)
    if cfg.block == "mamba2":
        return ssm_apply(cfg, p["ssm"], hn, compute_dtype)
    if cfg.block == "hymba":
        a = attn_apply(cfg, p["attn"], hn, positions, window, rope=rope)
        s = ssm_apply(cfg, p["ssm"], hn, compute_dtype)
        return _hymba_mix(cfg, p, a, s)
    raise ValueError(cfg.block)


def block_apply_train(
    cfg: ModelConfig,
    p: dict,
    h: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    cross_kv: torch.Tensor | None = None,
    cross_pos: torch.Tensor | None = None,
    causal: bool = True,
    rope: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (h, aux_loss)."""
    compute_dtype = dtype_of(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.block == "attention" and not causal:
        # encoder block: bidirectional attention
        hn = apply_norm(cfg, p["norm1"], h)
        h = h + attn_apply(cfg, p["attn"], hn, positions, 0, causal=False, rope=False)
    else:
        h = h + _mixer_train(cfg, p, h, positions, window, compute_dtype, rope=rope)
    if "cross" in p:
        hn = apply_norm(cfg, p["norm_cross"], h)
        h = h + attn_apply(
            cfg, p["cross"], hn, positions, 0, kv_x=cross_kv, k_pos=cross_pos,
            causal=False, rope=False,
        )
    if cfg.d_ff > 0:
        mlp_out, moe_aux = _mlp_branch(cfg, p, h, compute_dtype)
        if moe_aux is not None:
            aux = moe_aux
        h = h + mlp_out
    return h, aux


def block_prefill(
    cfg: ModelConfig,
    p: dict,
    h: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    cache_len: int,
    cross_kv: torch.Tensor | None = None,
    cross_pos: torch.Tensor | None = None,
    rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence block that also emits the decode cache (padded to
    ``cache_len``). Returns (h, cache)."""
    compute_dtype = dtype_of(cfg.dtype)
    cache: dict = {}
    s = h.shape[1]

    def pad_cache(kv):
        if cache_len < s:
            raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({s})")
        return pad_local(kv, (0, 0, 0, 0, 0, cache_len - s))

    def attend(params, hn, **kw):
        return attn_apply(
            cfg, params, hn, positions, window, rope=rope, return_kv=True,
            scores_dtype=compute_dtype, **kw,
        )

    hn = apply_norm(cfg, p["norm1"], h)
    if cfg.block == "attention":
        out, k, v = attend(p["attn"], hn)
        cache["k"], cache["v"] = pad_cache(k), pad_cache(v)
        h = h + out
    elif cfg.block == "mamba2":
        out, cache["ssm"] = ssm_apply(cfg, p["ssm"], hn, compute_dtype, return_state=True)
        h = h + out
    elif cfg.block == "hymba":
        a, k, v = attend(p["attn"], hn)
        s_out, cache["ssm"] = ssm_apply(cfg, p["ssm"], hn, compute_dtype, return_state=True)
        cache["k"], cache["v"] = pad_cache(k), pad_cache(v)
        h = h + _hymba_mix(cfg, p, a, s_out)
    if "cross" in p:
        hn = apply_norm(cfg, p["norm_cross"], h)
        out, ck, cv = attn_apply(
            cfg, p["cross"], hn, positions, 0, kv_x=cross_kv, k_pos=cross_pos,
            causal=False, rope=False, return_kv=True, scores_dtype=compute_dtype,
        )
        cache["cross_k"], cache["cross_v"] = ck, cv
        h = h + out
    if cfg.d_ff > 0:
        h = h + _mlp_branch(cfg, p, h, compute_dtype)[0]
    return h, cache


def block_decode(
    cfg: ModelConfig,
    p: dict,
    h: torch.Tensor,  # (B, 1, D)
    cache: dict,
    pos: int,
    window: int,
    rope: bool = True,
    defer_cache_write: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Single-token block step against the cache.

    With ``defer_cache_write`` (the decode path) the returned dict carries
    only the new token's (k, v) (and the new SSM state) — the caller makes
    one stacked cache write for all layers."""
    compute_dtype = dtype_of(cfg.dtype)
    new_cache = dict(cache)

    def attend(params, hn):
        return attn_decode(
            cfg, params, hn, cache["k"], cache["v"], pos, window, rope=rope,
            update_cache=not defer_cache_write,
        )

    hn = apply_norm(cfg, p["norm1"], h)
    if cfg.block == "attention":
        out, k, v = attend(p["attn"], hn)
        if defer_cache_write:
            new_cache = {"k_new": k, "v_new": v}
        else:
            new_cache["k"], new_cache["v"] = k, v
        h = h + out
    elif cfg.block == "mamba2":
        out, new_ssm = ssm_decode(cfg, p["ssm"], hn, cache["ssm"], compute_dtype)
        if defer_cache_write:
            new_cache = {"ssm": new_ssm}
        else:
            new_cache["ssm"] = new_ssm
        h = h + out
    elif cfg.block == "hymba":
        a, k, v = attend(p["attn"], hn)
        s, new_ssm = ssm_decode(cfg, p["ssm"], hn, cache["ssm"], compute_dtype)
        if defer_cache_write:
            new_cache = {"k_new": k, "v_new": v, "ssm": new_ssm}
        else:
            new_cache["k"], new_cache["v"], new_cache["ssm"] = k, v, new_ssm
        h = h + _hymba_mix(cfg, p, a, s)
    if "cross" in p:
        hn = apply_norm(cfg, p["norm_cross"], h)
        # cross K/V are precomputed at prefill; attend, never update.
        # pos=T so every encoder position is valid.
        out, _, _ = attn_decode(
            cfg, p["cross"], hn, cache["cross_k"], cache["cross_v"],
            cache["cross_k"].shape[1], 0, rope=False, update_cache=False,
            append_self=False,
        )
        h = h + out
    if cfg.d_ff > 0:
        h = h + _mlp_branch(cfg, p, h, compute_dtype)[0]
    return h, new_cache


# ---------------------------------------------------------- hybrid (Granite)
def hybrid_common_init(cfg, gen, dtype, device) -> dict:
    """A hybrid layer's own parameters (its mixer's are `attn_init` or
    `ssm_init`)."""
    return {
        "norm1": norm_init(cfg, cfg.d_model, dtype, device),
        "norm2": norm_init(cfg, cfg.d_model, dtype, device),
        "moe": moe_ep_init(cfg, gen, dtype, device),
        "shared": shared_init(cfg, gen, dtype, device),
    }


def _hybrid_ffn(cfg, p: dict, h: torch.Tensor, compute_dtype):
    """``h`` plus the MoE and shared-expert branch; and the MoE's aux loss."""
    x = apply_norm(cfg, p["norm2"], h)
    moe_out, aux = moe_ep_apply(cfg, p["moe"], x, compute_dtype)
    out = moe_out + shared_apply(cfg, p["shared"], x, compute_dtype)
    return h + out * cfg.residual_multiplier, aux


def hybrid_block_prefill(cfg, p: dict, kind: str, mp: dict, h: torch.Tensor,
                         positions: torch.Tensor, cache_len: int | None):
    """Full-sequence hybrid layer of mixer ``kind`` (``p`` its own
    parameters, ``mp`` its mixer's).  Returns (h, cache, aux): the decode
    cache padded to ``cache_len`` (``{"k", "v"}`` or ``{"ssm"}``; ``None``
    where ``cache_len`` is)."""
    compute_dtype = dtype_of(cfg.dtype)
    hn = apply_norm(cfg, p["norm1"], h)
    cache = None
    if kind == "mamba":
        if cache_len is None:
            out = ssm_apply(cfg, mp, hn, compute_dtype)
        else:
            out, ssm = ssm_apply(cfg, mp, hn, compute_dtype, return_state=True)
            cache = {"ssm": ssm}
    else:
        out, k, v = attn_apply(cfg, mp, hn, positions, 0, rope=cfg.rope, return_kv=True,
                               scores_dtype=compute_dtype, scale=cfg.attention_multiplier or None)
        if cache_len is not None:
            s = h.shape[1]
            if cache_len < s:
                raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({s})")
            pad = (0, 0, 0, 0, 0, cache_len - s)
            cache = {"k": pad_local(k, pad), "v": pad_local(v, pad)}
    h, aux = _hybrid_ffn(cfg, p, h + out * cfg.residual_multiplier, compute_dtype)
    return h, cache, aux


def hybrid_block_decode(cfg, p: dict, kind: str, mp: dict, h: torch.Tensor, cache: dict,
                        pos: int):
    """One token through a hybrid layer against its cache.  Returns (h, new):
    the new token's ``{"k_new", "v_new"}`` (the caller writes the stacked
    cache once) or the new ``{"ssm"}`` state."""
    compute_dtype = dtype_of(cfg.dtype)
    hn = apply_norm(cfg, p["norm1"], h)
    if kind == "mamba":
        out, ssm = ssm_decode(cfg, mp, hn, cache["ssm"], compute_dtype)
        new = {"ssm": ssm}
    else:
        out, k, v = attn_decode(cfg, mp, hn, cache["k"], cache["v"], pos, 0, rope=cfg.rope,
                                update_cache=False, scale=cfg.attention_multiplier or None)
        new = {"k_new": k, "v_new": v}
    h, _ = _hybrid_ffn(cfg, p, h + out * cfg.residual_multiplier, compute_dtype)
    return h, new
