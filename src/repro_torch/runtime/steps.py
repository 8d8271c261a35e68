"""Step factories: the train / prefill / decode functions (the port of
``repro.runtime.steps``).

``make_train_step`` supports microbatched gradient accumulation (a loop
over micro-slices of the batch's leading axis) and optional bf16 gradient
all-reduce compression (gradients cast before the update; parameters and
optimizer state stay float32).  Gradients come from
``torch.autograd.grad`` over the parameter tree's leaves: each step takes
detached copies of the leaves that require grad, so the caller's tensors
never carry a graph, and the step returns a fresh `TrainState`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: Any


def _grads(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, metrics, grads) of `train_loss` at ``params``; every output
    detached, each gradient in its leaf's dtype (zeros for a leaf the loss
    does not reach)."""
    leaves: list[torch.Tensor] = []

    def track(x):
        x = x.detach().requires_grad_(True)
        leaves.append(x)
        return x

    with torch.enable_grad():
        tracked = M.tree_map(track, params)
        loss, metrics = M.train_loss(cfg, tracked, batch)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = iter(
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, flat)
    )
    grads = M.tree_map(lambda _: next(flat), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if accum_steps > 1:
            # microbatch over the leading batch dim: (B,) -> (A, B/A)
            micro = {
                k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                for k, v in batch.items()
            }
            grads = M.tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                params,
            )
            device = next(M.tree_leaves(params)).device
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for a in range(accum_steps):
                loss, _, g = _grads(cfg, params, {k: v[a] for k, v in micro.items()})
                grads = M.tree_map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = M.tree_map(lambda g: g / accum_steps, grads)
            loss = loss_sum / accum_steps
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = _grads(cfg, params, batch)

        if opt_cfg.grad_allreduce_dtype == "bfloat16":
            # gradient compression: halve DP all-reduce bytes
            grads = M.tree_map(lambda g: g.to(torch.bfloat16), grads)

        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, state.opt
        )
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["total_loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)

    return decode_step
