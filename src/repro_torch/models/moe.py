"""Top-k MoE with grouped GShard-style one-hot dispatch/combine.

The port of ``repro.models.moe``: tokens are split into groups of
``MOE_GROUP`` so the dispatch/combine tensors stay small: per group the
dispatch one-hot is (g, e*c) with ``c = g * top_k * cf / e``.  The
capacity queue is built exactly as the reference builds it (one-hot of
the chosen experts, a cumsum over the group's (token, slot) order, slots
past capacity dropped), so a token keeps its place in every expert's FIFO.

FLOP accounting matches `6 * N_active * D`: expert GEMMs run on
``top_k * cf`` slots per token, never on all experts.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import activation, truncated_normal_init
from .redistribute import (
    expert_local,
    fit_split,
    pad_local,
    pin_batch,
    router_local,
)

MOE_GROUP = 512  # tokens per dispatch group


def moe_init(cfg: ModelConfig, gen, dtype, device) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": truncated_normal_init(gen, (d, e), 1.0, dtype, device),
        "up": truncated_normal_init(gen, (e, d, f), 1.0, dtype, device),
        "down": truncated_normal_init(gen, (e, f, d), 1.0, dtype, device),
    }
    if cfg.mlp_gated:
        p["gate"] = truncated_normal_init(gen, (e, d, f), 1.0, dtype, device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(
    cfg: ModelConfig, params: dict, x: torch.Tensor, compute_dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Over-capacity tokens are dropped."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    g = min(MOE_GROUP, n)
    pad = (-n) % g
    xt = pin_batch(x).reshape(n, d).to(compute_dtype)
    if pad:
        xt = pad_local(xt, (0, 0, 0, pad))
    ng = (n + pad) // g
    xg = fit_split(xt, 0, ng).reshape(ng, g, d)  # (G, g, d)

    # the router's products in float32 (the reference's preferred_element_type)
    logits = router_local(
        lambda xg, router: torch.einsum(
            "Gnd,de->Gne", xg.float(), router.to(compute_dtype).float()),
        xg, params["router"],
    )
    probs = torch.softmax(logits, dim=-1)  # (G, g, e) fp32
    # jax.lax.top_k's order: ties go to the lower expert index (the padded
    # rows' uniform probabilities are all ties, and the aux loss counts them)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (G, g, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = max(1, int(g * k * cfg.capacity_factor / e))
    # position of each (token, slot) within its expert queue, FIFO over (g*k)
    assign = _one_hot(gate_idx.reshape(ng, g * k), e, torch.float32)
    pos = torch.cumsum(assign, dim=1) * assign - assign  # (G, g*k, e)
    pos = pos.sum(-1).reshape(ng, g, k)  # position per slot
    keep = pos < cap  # (G, g, k)

    # flat slot id = expert * cap + pos; invalid slots point past the table
    slot = torch.where(keep, gate_idx * cap + pos.to(torch.int64), e * cap)
    slot_oh = _one_hot(slot, e * cap, compute_dtype)  # (G, g, k, e*c)
    dispatch = slot_oh.sum(2)  # (G, g, e*c)
    combine = (slot_oh * gate_vals[..., None].to(compute_dtype)).sum(2)

    expert_in = torch.einsum("Gns,Gnd->Gsd", dispatch, xg).reshape(ng, e, cap, d)

    def ffn(expert_in, up_w, down_w, gate_w=None):
        up = torch.einsum("Gecd,edf->Gecf", expert_in, up_w.to(compute_dtype))
        if gate_w is not None:
            gate = torch.einsum("Gecd,edf->Gecf", expert_in, gate_w.to(compute_dtype))
            h = activation(cfg.mlp_act, gate) * up
        else:
            h = activation(cfg.mlp_act, up)
        return torch.einsum("Gecf,efd->Gecd", h, down_w.to(compute_dtype))

    tables = [params["up"], params["down"]]
    if cfg.mlp_gated:
        tables.append(params["gate"])
    expert_out = expert_local(ffn, expert_in, tables).reshape(ng, e * cap, d)
    out = torch.einsum("Gns,Gsd->Gnd", combine, expert_out)
    out = pin_batch(out.reshape(n + pad, d)[:n].reshape(b, s, d))

    # load-balance auxiliary loss (Switch/GShard)
    me = probs.reshape(-1, e).mean(0)
    ce = _one_hot(gate_idx.reshape(-1, k)[:, 0], e, torch.float32).mean(0)
    aux = (me * ce).sum() * e * cfg.router_aux_weight
    return out, aux.float()
