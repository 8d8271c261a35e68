"""Mamba-2 (SSD — state space duality, arXiv:2405.21060) block in PyTorch.

The port of ``repro.models.mamba2``.  The chunked SSD algorithm: within
chunks of length L the output is a masked (C B^T)-attention against decay
factors (dense matmuls); the inter-chunk recurrence carries the (H, P, N)
state through a loop over chunks (the reference's ``lax.scan``).  Decode
is the exact single-step SSM recurrence.  Where the reference contracts
compute-dtype operands with ``preferred_element_type=float32``, the
operands are rounded to the compute dtype and contracted in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense, dense_init, truncated_normal_init
from .redistribute import fit_split, pad_local, ssd_local


def ssm_init(cfg: ModelConfig, gen, dtype, device) -> dict:
    """Parameters of one mamba2 mixer (used standalone and inside hymba).

    Separate per-stream projections (z, x, B, C, dt) and one depthwise conv
    kernel per stream, the reference's tensor-parallel layout (same math and
    parameter count as Mamba2's fused in_proj).
    """
    di, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    kw = cfg.ssm_conv_width

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "z_proj": dense_init(gen, cfg.d_model, di, dtype, device),
        "x_proj": dense_init(gen, cfg.d_model, di, dtype, device),
        "b_proj": dense_init(gen, cfg.d_model, n, dtype, device),
        "c_proj": dense_init(gen, cfg.d_model, n, dtype, device),
        "dt_proj": dense_init(gen, cfg.d_model, h, dtype, device),
        "conv_x": truncated_normal_init(gen, (kw, di), 1.0, dtype, device),
        "conv_x_bias": zeros(di),
        "conv_b": truncated_normal_init(gen, (kw, n), 1.0, dtype, device),
        "conv_b_bias": zeros(n),
        "conv_c": truncated_normal_init(gen, (kw, n), 1.0, dtype, device),
        "conv_c_bias": zeros(n),
        "a_log": torch.log(
            torch.arange(1, h + 1, dtype=torch.float32, device=device)
        ).to(dtype),
        "dt_bias": zeros(h),
        "d_skip": ones(h),
        "norm_scale": ones(di),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype, device),
    }


def _project_streams(cfg: ModelConfig, params: dict, x_in, compute_dtype):
    """Per-stream projections; returns (z, x, b, c, dt) pre-conv."""
    z = dense(params["z_proj"], x_in, compute_dtype)
    xs = dense(params["x_proj"], x_in, compute_dtype)
    bs = dense(params["b_proj"], x_in, compute_dtype)
    cs = dense(params["c_proj"], x_in, compute_dtype)
    dt = dense(params["dt_proj"], x_in, compute_dtype)
    return z, xs, bs, cs, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    """Mamba2's RMSNorm(y * silu(z)) output gate."""
    dt = y.dtype
    g = (y * F.silu(z)).float()
    var = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _causal_conv(kernel: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with a (K, C) kernel, as the
    reference's explicit shift-and-sum."""
    kweight = kernel.to(x.dtype)
    kw = kweight.shape[0]
    xpad = pad_local(x, (0, 0, kw - 1, 0))
    out = sum(
        xpad[:, i : i + x.shape[1], :] * kweight[i][None, None, :] for i in range(kw)
    )
    return F.silu(out + bias.to(x.dtype))


def _segsum_mask(log_a: torch.Tensor) -> torch.Tensor:
    """log_a: (..., L) -> (..., L, L) lower-tri matrix exp(sum_{j<t<=i} log_a).

    The mask is applied *inside* the exp (large-negative fill) so the
    discarded upper triangle — where the raw difference is large and
    positive — cannot overflow."""
    csum = torch.cumsum(log_a, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]  # (..., i, j)
    size = log_a.shape[-1]
    il = torch.tril(torch.ones((size, size), dtype=torch.bool, device=log_a.device))
    return torch.exp(torch.where(il, diff, torch.full_like(diff, -1e30)))


def _einsum_f32(eq: str, compute_dtype, *ops: torch.Tensor) -> torch.Tensor:
    """Operands rounded to the compute dtype, contracted in float32."""
    return torch.einsum(eq, *(o.to(compute_dtype).float() for o in ops))


def _ssd(cfg: ModelConfig, compute_dtype, xs_conv, bmat, cmat, dt, dt_bias, a_log,
         d_skip):
    """The chunked SSD scan over the conv outputs: returns y (B, S, H*P) in
    the compute dtype, with the skip term, and the final (B, H, P, N)
    state.  The head count comes from ``dt``'s last dim (a head shard's
    own when `ssd_local` runs it per rank)."""
    b, s_orig, _ = xs_conv.shape
    n, h, p = bmat.shape[-1], dt.shape[-1], cfg.ssm_head_dim
    di = h * p
    lchunk = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % lchunk
    s = s_orig + pad
    nc = s // lchunk
    dev = xs_conv.device
    if pad:
        xs_conv = pad_local(xs_conv, (0, 0, 0, pad))
        bmat = pad_local(bmat, (0, 0, 0, pad))
        cmat = pad_local(cmat, (0, 0, 0, pad))
        dt = pad_local(dt, (0, 0, 0, pad))
    xs = xs_conv.reshape(b, s, h, p)
    dt = _softplus(dt.float() + dt_bias.float())  # (B, S, H)
    a = -torch.exp(a_log.float())  # (H,)
    log_a = dt * a[None, None, :]  # (B, S, H) negative
    xdt = xs.float() * dt[..., None]  # dt-weighted input
    if pad:
        # padded steps must be identity on the state: decay 1, no input
        valid = (torch.arange(s, device=dev) < s_orig)[None, :]
        log_a = torch.where(valid[..., None], log_a, 0.0)
        xdt = torch.where(valid[..., None, None], xdt, 0.0)
        bmat = torch.where(valid[..., None], bmat, torch.zeros((), dtype=bmat.dtype, device=dev))

    # reshape into chunks: (B, C, L, ...)
    xc = xdt.reshape(b, nc, lchunk, h, p)
    bc = bmat.reshape(b, nc, lchunk, n).float()
    cc = cmat.reshape(b, nc, lchunk, n).float()
    la = log_a.reshape(b, nc, lchunk, h)

    # --- intra-chunk (diagonal blocks): masked (C B^T) attention; decay
    # cumsums stay fp32, the L x L products are rounded to the compute dtype
    lmask = _segsum_mask(la.permute(0, 1, 3, 2))  # (B, C, H, L, L): [h,i,j]
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B, C, L, L)
    y_diag = _einsum_f32("bcij,bchij,bcjhp->bcihp", compute_dtype, cb, lmask, xc)

    # --- chunk summaries: state contributed by each chunk
    csum = torch.cumsum(la, dim=2)  # (B, C, L, H)
    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)  # (B, C, L, H)
    states = _einsum_f32("bcln,bclh,bclhp->bchpn", compute_dtype, bc, decay_to_end, xc)
    chunk_decay = torch.exp(csum[:, :, -1, :])  # (B, C, H) total decay per chunk

    # --- inter-chunk recurrence (tiny per-step state, sequential loop)
    h_state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    h_in = []
    for c in range(nc):
        h_in.append(h_state)  # the state *entering* the chunk
        h_state = h_state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_final = h_state
    h_in = torch.stack(h_in, dim=1)  # (B, C, H, P, N)

    # --- off-diagonal: contribution of previous chunks' state
    decay_from_start = torch.exp(csum)  # (B, C, L, H)
    y_off = _einsum_f32("bcln,bclh,bchpn->bclhp", compute_dtype, cc, decay_from_start, h_in)

    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + xs.float() * d_skip.float()[None, None, :, None]
    y = y.reshape(b, s, di)[:, :s_orig].to(compute_dtype)
    return y, h_final


def ssm_apply(
    cfg: ModelConfig, params: dict, x_in: torch.Tensor, compute_dtype,
    return_state: bool = False,
):
    """Full-sequence SSD. x_in: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode cache dict (final SSM state
    + conv tail) so prefill can hand off to single-step decoding."""
    s_orig = x_in.shape[1]
    z, xs_raw, bs_raw, cs_raw, dt = _project_streams(cfg, params, x_in, compute_dtype)
    xs_conv = _causal_conv(params["conv_x"], params["conv_x_bias"], xs_raw)
    bmat = _causal_conv(params["conv_b"], params["conv_b_bias"], bs_raw)
    cmat = _causal_conv(params["conv_c"], params["conv_c_bias"], cs_raw)
    y, h_final = ssd_local(
        lambda *t: _ssd(cfg, compute_dtype, *t),
        xs_conv, bmat, cmat, dt, (params["dt_bias"], params["a_log"], params["d_skip"]),
    )
    y = _gated_norm(params["norm_scale"], y, z, cfg.norm_eps)
    out = dense(params["out_proj"], y, compute_dtype)
    if return_state:
        # decode's conv cache holds the *pre-conv* input tails per stream
        kw = cfg.ssm_conv_width - 1

        def tail(stream):
            t_ = stream[:, max(0, s_orig - kw) : s_orig, :]
            if s_orig < kw:  # left-pad zeros (conv history before t=0)
                t_ = pad_local(t_, (0, 0, kw - s_orig, 0))
            return t_.to(compute_dtype)

        cache = {
            "conv": torch.cat([tail(xs_raw), tail(bs_raw), tail(cs_raw)], dim=-1),
            "state": h_final,
        }
        return out, cache
    return out


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = di + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
    }


def ssm_decode(
    cfg: ModelConfig, params: dict, x_in: torch.Tensor, cache: dict, compute_dtype
) -> tuple[torch.Tensor, dict]:
    """One-token SSM step. x_in: (B, 1, D)."""
    b = x_in.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs_raw, bs_raw, cs_raw, dt = _project_streams(cfg, params, x_in, compute_dtype)
    new_tok = torch.cat([xs_raw, bs_raw, cs_raw], dim=-1)
    window = torch.cat([cache["conv"].to(compute_dtype), new_tok], dim=1)
    kweight = torch.cat(
        [params["conv_x"], params["conv_b"], params["conv_c"]], dim=-1
    ).to(compute_dtype)
    kbias = torch.cat(
        [params["conv_x_bias"], params["conv_b_bias"], params["conv_c_bias"]], dim=-1
    ).to(compute_dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, kweight) + kbias
    conv_out = fit_split(F.silu(conv_out)[:, None, :], -1, h)  # (B, 1, C)
    new_conv_cache = window[:, 1:, :].to(cache["conv"].dtype)

    xs = conv_out[..., :di].reshape(b, h, p).float()
    bvec = conv_out[..., di : di + n].reshape(b, n).float()
    cvec = conv_out[..., di + n :].reshape(b, n).float()
    dt1 = _softplus(dt[:, 0, :].float() + params["dt_bias"].float())  # (B, H)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt1 * a[None, :])  # (B, H)
    xdt = xs * dt1[..., None]  # (B, H, P)
    state = cache["state"] * decay[..., None, None] + torch.einsum("bhp,bn->bhpn", xdt, bvec)
    y = torch.einsum("bhpn,bn->bhp", state, cvec)
    y = y + xs * params["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(compute_dtype)
    y = _gated_norm(params["norm_scale"], y, z, cfg.norm_eps)
    out = dense(params["out_proj"], y, compute_dtype)
    return out, {"conv": new_conv_cache, "state": fit_split(state, 1, h)}
