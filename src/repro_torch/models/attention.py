"""GQA attention with RoPE, qk-norm, sliding windows, cross-attention, and a
memory-efficient blockwise (flash-style) path for long sequences.

The port of ``repro.models.attention``, in plain PyTorch and on the
reference's algorithm (the same dispatch at ``_BLOCK_KV``, the same
running max / sum, the same score dtypes), so the reference's invariants
test it as they test the reference.  The reference's GSPMD constraints
(``_seq_shard`` / ``_replicate_dims`` under ``cfg.attn_seq_shard``) are
DTensor redistributions here (`models.redistribute`), with the attention
core run shard-local on DTensors; a plain tensor passes through them
unchanged, so the serving and training paths never see them.

Where the reference asks for ``preferred_element_type=float32`` on
low-precision operands, the operands are cast to float32 first: the same
exact products, accumulated in float32.  Windows are Python ints (the
reference's layer segments make them static), and so is a decode
position.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import apply_rope, dense, dense_init, dtype_of, head_rms_norm
from .redistribute import (
    pad_local,
    replicate_dims,
    seq_shard,
    seq_sharded,
    shard_local,
)

NEG_INF = -1e30
_BLOCK_KV = 1024  # KV block for the flash-style path


def attn_init(cfg: ModelConfig, gen, dtype, device) -> dict:
    p = {
        "q": dense_init(gen, cfg.d_model, cfg.attn_dim, dtype, device, cfg.qkv_bias),
        "k": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, device, cfg.qkv_bias),
        "v": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, device, cfg.qkv_bias),
        "o": dense_init(gen, cfg.attn_dim, cfg.d_model, dtype, device, cfg.attn_out_bias),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.d_head,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((cfg.d_head,), dtype=dtype, device=device)
    return p


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=dtype)`` for operands no
    wider than ``dtype``."""
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


def _inv_sqrt(d: int, dtype) -> float:
    """The reference's float32 ``1 / sqrt(d)``, rounded to ``dtype``, as a
    Python float: multiplying a ``dtype`` tensor by it rounds once, as the
    reference's product of two ``dtype`` values does, and needs no copy to
    the device."""
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    return float(torch.tensor(float(scale), dtype=torch.float32).to(dtype))


def _project_qkv(cfg: ModelConfig, params, x, kv_x, q_pos, k_pos, compute_dtype, rope: bool):
    """Returns q (B,S,Hkv,G,dh), k/v (B,T,Hkv,dh)."""
    b, s, _ = x.shape
    t = kv_x.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    q = dense(params["q"], x, compute_dtype)
    k = dense(params["k"], kv_x, compute_dtype)
    v = dense(params["v"], kv_x, compute_dtype)
    if cfg.attn_seq_shard:
        # SP attention: q sharded on sequence (its heads replicated where
        # the sequence does not divide, as a decode token's), K/V
        # replicated over the model axis (a small all-gather, vs
        # score-sized partial sums when the contraction is split instead);
        # so head counts that do not divide the model axis never split
        q = replicate_dims(seq_shard(q, 1), (2,))
        k = replicate_dims(k, (1, 2))
        v = replicate_dims(v, (1, 2))
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = head_rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = head_rms_norm(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q.reshape(b, s, hkv, g, dh), k, v


def _mask_bias(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """(S, T) additive float32 bias from positions; window <= 0 means
    unlimited."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones(dq.shape[:1] + dk.shape[1:], dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dq - dk < window)
    return torch.zeros(ok.shape, dtype=torch.float32, device=ok.device).masked_fill(
        ~ok, NEG_INF
    )


def _score_scale(d: int, dtype, scale: float | None) -> float:
    """The scores' scale: ``scale`` (a config's multiplier) rounded to
    ``dtype``, or the reference's `_inv_sqrt` of the head size."""
    if scale is None:
        return _inv_sqrt(d, dtype)
    return float(torch.tensor(float(scale), dtype=torch.float32).to(dtype))


def _sdpa(q, k, v, bias, scores_dtype=torch.float32, scale=None):
    """q (B,S,N,G,D), k/v (B,T,N,D), bias (S,T) -> (B,S,N,G,D).

    ``scores_dtype`` controls the materialized score precision: fp32 for
    training numerics; the serving path passes its compute dtype (bf16
    halves the dominant memory term of long-context attention, with the
    softmax's max and sum reduced in fp32).  ``scale`` multiplies the
    scores (``None``: ``1 / sqrt(d_head)``)."""
    scale = _score_scale(q.shape[-1], scores_dtype, scale)
    scores = _einsum("bsngd,btnd->bngst", q, k, scores_dtype)
    scores = scores * scale + bias[None, None, None, :, :].to(scores_dtype)
    if scores_dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        # serving: keep the S x T tensors in bf16; reductions in fp32
        m = scores.float().amax(-1, keepdim=True)
        p = torch.exp(scores - m.to(scores_dtype))
        s = p.float().sum(-1, keepdim=True)
        probs = (p / s.clamp_min(1e-30).to(scores_dtype)).to(q.dtype)
    return torch.einsum("bngst,btnd->bsngd", probs, v)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, window: int, causal: bool,
                    scores_dtype=torch.float32, scale=None):
    """Flash-style attention: a loop over KV blocks with running max/sum.

    Memory is O(S * block) instead of O(S * T)."""
    b, s, n, g, d = q.shape
    t = k.shape[1]
    nblk = -(-t // _BLOCK_KV)
    pad = nblk * _BLOCK_KV - t
    if pad:
        k = pad_local(k, (0, 0, 0, 0, 0, pad))
        v = pad_local(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)  # masked out
    scale = _score_scale(d, scores_dtype, scale)
    acc = torch.zeros((b, s, n, g, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, n, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, n, g, s), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * _BLOCK_KV, (i + 1) * _BLOCK_KV)
        kb, vb, pb = k[:, blk], v[:, blk], k_pos[blk]
        bias = _mask_bias(q_pos, pb, window, causal)  # (S, blk)
        # the (S, blk) score/prob tensors stay in scores_dtype; running
        # max/sum and the accumulator remain fp32
        scores = (
            _einsum("bsngd,btnd->bngst", q, kb, scores_dtype) * scale
            + bias[None, None, None, :, :].to(scores_dtype)
        )
        blk_max = scores.float().amax(-1)
        new_max = torch.maximum(row_max, blk_max)
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(scores - new_max[..., None].to(scores_dtype))
        row_sum = row_sum * correction + probs.float().sum(-1)
        upd = torch.einsum("bngst,btnd->bsngd", probs.to(q.dtype), vb)
        acc = acc * correction.permute(0, 3, 1, 2)[..., None] + upd.float()
        row_max = new_max
    out = acc / row_sum.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype)


def _sdpa_windowed_blocks(q, k, v, window: int, block_q: int = 1024,
                          scores_dtype=torch.float32, q_offset: int = 0, scale=None):
    """Sliding-window attention with *static* block skipping.

    For a window of W tokens, each q block [i*Bq, (i+1)*Bq) can only attend
    to k in [i*Bq - W + 1, (i+1)*Bq) — a contiguous, statically-known slice.
    Plain softmax attention per q block against that slice; the other KV
    blocks are never touched.

    Assumes self-attention with q_pos == k_pos == arange(S) (the prefill /
    train path), ``q`` holding positions from ``q_offset`` on (a sequence
    shard; the whole sequence when 0); requires an int window > 0.
    """
    s = q.shape[1]
    bq = min(block_q, s)
    nblk = -(-s // bq)
    outs = []
    for i in range(nblk):
        q0, q1 = i * bq, min((i + 1) * bq, s)
        a0, a1 = q0 + q_offset, q1 + q_offset  # absolute positions
        k0 = max(0, a0 - window + 1)
        bias = _mask_bias(
            torch.arange(a0, a1, device=q.device), torch.arange(k0, a1, device=q.device),
            window, causal=True,
        )
        outs.append(_sdpa(q[:, q0:q1], k[:, k0:a1], v[:, k0:a1], bias, scores_dtype, scale))
    return torch.cat(outs, dim=1)


def attn_apply(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    q_pos: torch.Tensor,
    window: int,  # <= 0 -> full attention
    kv_x: torch.Tensor | None = None,
    k_pos: torch.Tensor | None = None,
    causal: bool = True,
    rope: bool = True,
    return_kv: bool = False,
    scores_dtype=torch.float32,
    scale: float | None = None,
):
    """Full-sequence attention (training / prefill). Cross-attn when kv_x set.

    With ``return_kv`` also returns the projected (k, v) — used by prefill to
    populate the decode cache without recomputation.  ``scale`` multiplies
    the scores (``None``: ``1 / sqrt(d_head)``)."""
    compute_dtype = dtype_of(cfg.dtype)
    kv_src = x if kv_x is None else kv_x
    k_pos = q_pos if k_pos is None else k_pos
    q, k, v = _project_qkv(cfg, params, x, kv_src, q_pos, k_pos, compute_dtype, rope)
    windowed = window > 0 and causal and kv_x is None and kv_src.shape[1] > _BLOCK_KV

    def core(q, k, v, q_pos, q_offset):
        if windowed:
            return _sdpa_windowed_blocks(q, k, v, window, scores_dtype=scores_dtype,
                                         q_offset=q_offset, scale=scale)
        if kv_src.shape[1] > _BLOCK_KV:
            return _sdpa_blockwise(
                q, k, v, q_pos, k_pos, window, causal, scores_dtype=scores_dtype, scale=scale
            )
        bias = _mask_bias(q_pos, k_pos, window, causal)
        return _sdpa(q, k, v, bias, scores_dtype, scale)

    out = shard_local(core, q, (k, v), q_pos)
    b, s = x.shape[:2]
    out = dense(params["o"], out.reshape(b, s, cfg.attn_dim), compute_dtype)
    if return_kv:
        return out, k, v
    return out


def attn_decode(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,  # (B, 1, D) new token hidden
    k_cache: torch.Tensor,  # (B, T, Hkv, dh)
    v_cache: torch.Tensor,
    pos: int,  # index of the new token
    window: int,  # <= 0 full
    rope: bool = True,
    update_cache: bool = True,
    append_self: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a (possibly sliding-window) KV cache.

    Two cache disciplines, as in the reference:
    * ``update_cache=True`` — write the token into (a copy of) the cache
      first and attend over it; returns (out, new_k_cache, new_v_cache).
    * ``update_cache=False, append_self=True`` — *deferred write*: attend
      over the frozen cache (positions < pos) plus the fresh (k, v) of this
      token; returns (out, k_new, v_new) and the caller performs one
      stacked cache write for all layers.

    For windowed layers only the last `window` cache entries are sliced and
    attended; global layers read the whole cache.  ``scale`` multiplies the
    scores (``None``: ``1 / sqrt(d_head)``).
    """
    compute_dtype = dtype_of(cfg.dtype)
    pos = int(pos)
    q_pos = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x, x, q_pos, q_pos, compute_dtype, rope)
    t = k_cache.shape[1]
    if update_cache:
        # dynamic_update_slice clamps the start into the cache
        at = min(max(pos, 0), t - 1)
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        k_cache[:, at:at + 1] = k_new.to(k_cache.dtype)
        v_cache[:, at:at + 1] = v_new.to(v_cache.dtype)
    # hist = number of already-cached positions to attend (self excluded in
    # deferred mode — it is appended explicitly below)
    self_in_cache = update_cache
    if 0 < window < t:
        span = window if self_in_cache else window - 1
        start = min(max(pos - span + (1 if self_in_cache else 0), 0), t - span)
        k_att = k_cache[:, start:start + span]
        v_att = v_cache[:, start:start + span]
        k_pos = start + torch.arange(span, dtype=torch.int32, device=x.device)
    else:
        k_att, v_att = k_cache, v_cache
        k_pos = torch.arange(t, dtype=torch.int32, device=x.device)
    valid = (k_pos <= pos) if self_in_cache else (k_pos < pos)
    k_att = k_att.to(compute_dtype)
    v_att = v_att.to(compute_dtype)
    bias = torch.zeros(valid.shape, dtype=torch.float32, device=x.device).masked_fill(
        ~valid, NEG_INF
    )[None, :]
    b = x.shape[0]
    if update_cache or not append_self:
        def core(q, k_att, v_att, _pos, _off):
            return _sdpa(q, k_att, v_att, bias, scores_dtype=compute_dtype, scale=scale)
        kvs = (k_att, v_att)
    else:
        # deferred write: two-part softmax merge of (frozen cache, self)
        def core(q, k_att, v_att, k_new, v_new, _pos, _off):
            return _sdpa_merge_self(q, k_att, v_att, bias, k_new, v_new, scale)
        kvs = (k_att, v_att, k_new, v_new)
    if seq_sharded(k_att):
        # a cache sharded on its sequence (ring-style reads): the softmax
        # spans the shards, so the core runs on the DTensors themselves
        out = core(q, *kvs, q_pos, 0)
    else:
        out = shard_local(core, q, kvs, q_pos)
    out = dense(params["o"], out.reshape(b, 1, cfg.attn_dim), compute_dtype)
    if update_cache:
        return out, k_cache, v_cache
    return out, k_new, v_new


def _sdpa_merge_self(q, k_cache, v_cache, bias, k_new, v_new, scale=None):
    """Decode attention over [cache, self] without concatenation.

    q (B,1,N,G,D); k/v_cache (B,T,N,D); bias (1,T); k/v_new (B,1,N,D).
    Flash-style: unnormalized cache attention merged with the self term.
    """
    f32 = torch.float32
    scale = _score_scale(q.shape[-1], f32, scale)
    sc = _einsum("bsngd,btnd->bngst", q, k_cache, f32) * scale + bias[None, None, None, :, :]
    m_c = sc.amax(-1, keepdim=True)  # (B,N,G,1,1)
    p = torch.exp(sc - m_c)
    s_c = p.sum(-1, keepdim=True)
    acc = _einsum("bngst,btnd->bsngd", p.to(q.dtype), v_cache, f32)  # (B,1,N,G,D)
    s_self = _einsum("bsngd,btnd->bngst", q, k_new, f32) * scale  # (B,N,G,1,1)
    m = torch.maximum(m_c, s_self)
    alpha = torch.exp(m_c - m)  # (B,N,G,1,1)
    beta = torch.exp(s_self - m)
    alpha_b = alpha[:, :, :, 0, 0][:, None, :, :, None]  # (B,1,N,G,1)
    beta_b = beta[:, :, :, 0, 0][:, None, :, :, None]
    num = acc * alpha_b + v_new[:, :, :, None, :].float() * beta_b
    den = (s_c * alpha + beta)[:, :, :, 0, 0][:, None, :, :, None]
    return (num / den.clamp_min(1e-30)).to(q.dtype)
