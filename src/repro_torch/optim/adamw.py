"""AdamW + cosine schedule + global-norm clipping, over parameter trees
(the port of ``repro.optim.adamw``).

Parameters are the model's nested dicts of tensors.  The optimizer state
mirrors that tree (``m`` and ``v`` in float32) plus a 0-d int32 ``step``
tensor, so the checkpoint layer serializes it like any other tree, under
the reference's keys.  The schedule, the bias corrections and the clip
scale are float32 tensor arithmetic on the step, as in the reference:
the same expressions in Python floats (float64) give another learning
rate in the last bits.  Leaves are visited in the reference's flattening
order (dict keys sorted), so the global norm sums them in its order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.model import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # cast gradients to bf16 before the cross-replica mean (DP all-reduce
    # compression; fp32 master weights keep the update exact-ish)
    grad_allreduce_dtype: str = "float32"


def _leaves(tree):
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor or int), as a 0-d
    float32 tensor on the step's device."""
    step_f = torch.as_tensor(step).float()
    warm = step_f / max(1.0, cfg.warmup_steps)
    progress = (step_f - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps
    )
    progress = progress.clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.where(step_f < cfg.warmup_steps, warm, decay)


def adamw_init(params) -> dict:
    """Zero ``m`` and ``v`` (float32, on each parameter's device) and a 0-d
    int32 ``step`` on the first parameter's device."""
    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    device = next(_leaves(params)).device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in _leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics); the inputs are left as
    they are.  ``metrics`` holds the raw (unclipped) ``grad_norm`` and the
    step's ``learning_rate``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / gnorm.clamp_min(1e-9), 1.0)
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * g32.square()
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (vhat.sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    metrics = {"grad_norm": gnorm, "learning_rate": lr}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics
