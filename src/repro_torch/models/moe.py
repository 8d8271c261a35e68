"""Top-k MoE with grouped GShard-style one-hot dispatch/combine.

The port of ``repro.models.moe``: tokens are split into groups of
``MOE_GROUP`` so the dispatch/combine tensors stay small: per group the
dispatch one-hot is (g, e*c) with ``c = g * top_k * cf / e``.  The
capacity queue is built exactly as the reference builds it (one-hot of
the chosen experts, a cumsum over the group's (token, slot) order, slots
past capacity dropped), so a token keeps its place in every expert's FIFO.

FLOP accounting matches `6 * N_active * D`: expert GEMMs run on
``top_k * cf`` slots per token, never on all experts.  The counter
``moe.dropped`` (`repro_torch.obs`, read while recording is on) adds the
(token, slot) assignments dropped past capacity.

`moe_ep_apply` is the port's own expert-parallel layer (`HybridConfig`,
Granite-4.0-H): it routes every token over all ``n_experts`` with the
gates a softmax over the ``top_k`` selected logits, and computes the part
of the output that this chip's held experts give, every assignment to a
held expert included (no capacity, so nothing is dropped);
`shared_apply` is the shared SwiGLU expert beside it.
"""
from __future__ import annotations

import torch

from .. import obs
from .config import HybridConfig, ModelConfig
from .layers import activation, dense, dense_init, truncated_normal_init
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
    if obs.enabled():
        obs.count("moe.dropped", int((~keep).reshape(-1, k)[:n].sum()))

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


# ------------------------------------------------- expert parallel (Granite)
def moe_ep_init(cfg: HybridConfig, gen, dtype, device) -> dict:
    """The router over all ``n_experts`` and the held experts' tables."""
    e, d, f = cfg.held_experts, cfg.d_model, cfg.d_ff
    return {
        "router": truncated_normal_init(gen, (d, cfg.n_experts), 1.0, dtype, device),
        "gate": truncated_normal_init(gen, (e, d, f), 1.0, dtype, device),
        "up": truncated_normal_init(gen, (e, d, f), 1.0, dtype, device),
        "down": truncated_normal_init(gen, (e, f, d), 1.0, dtype, device),
    }


def shared_init(cfg: HybridConfig, gen, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.shared_d_ff
    return {
        "gate": dense_init(gen, d, f, dtype, device),
        "up": dense_init(gen, d, f, dtype, device),
        "down": dense_init(gen, f, d, dtype, device),
    }


def shared_apply(cfg: HybridConfig, params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The shared expert: ``silu(x Wg) * (x Wu)`` times ``Wd``."""
    h = activation(cfg.mlp_act, dense(params["gate"], x, compute_dtype)) * dense(
        params["up"], x, compute_dtype)
    return dense(params["down"], h, compute_dtype)


def moe_ep_apply(
    cfg: HybridConfig, params: dict, x: torch.Tensor, compute_dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (this chip's experts' part of the output, aux loss).

    The router's products in float32; each token's ``top_k`` experts of
    all ``n_experts`` (``torch.topk``) with gates ``softmax`` over their
    logits.  The assignments to held experts are sorted by expert, and
    each held expert runs its SwiGLU on its own tokens (one host read of
    the per-expert counts); its outputs, times their gates, are added in
    float32.  The aux loss is the Switch form over all experts, as
    `moe_apply`'s."""
    b, s, d = x.shape
    e_all, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(b * s, d).to(compute_dtype)
    logits = xt.float() @ params["router"].to(compute_dtype).float()  # (n, E)
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_logits, dim=-1)
    local = top_idx - cfg.expert_start
    held = (local >= 0) & (local < cfg.held_experts)
    tok, slot = held.nonzero(as_tuple=True)
    ex = local[tok, slot]
    order = torch.argsort(ex, stable=True)
    tok, slot, ex = tok[order], slot[order], ex[order]
    weight = gates[tok, slot]
    counts = torch.bincount(ex, minlength=cfg.held_experts).tolist()
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    at = 0
    for e, c in enumerate(counts):
        if c:
            rows = tok[at:at + c]
            xe = xt[rows]
            h = activation(cfg.mlp_act, xe @ params["gate"][e].to(compute_dtype)) * (
                xe @ params["up"][e].to(compute_dtype))
            ye = h @ params["down"][e].to(compute_dtype)
            out.index_add_(0, rows, ye.float() * weight[at:at + c, None])
            at += c
    obs.count("moe.dropped", len(tok) - at)

    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(0)
    ce = _one_hot(top_idx[:, 0], e_all, torch.float32).mean(0)
    aux = (me * ce).sum() * e_all * cfg.router_aux_weight
    return out.to(compute_dtype).reshape(b, s, d), aux
