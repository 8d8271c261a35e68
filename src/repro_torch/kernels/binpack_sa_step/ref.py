"""Plain PyTorch versions of the fused SA delta-cost kernels (K3 / K4).

Reuses the fitness cost primitive, as ``repro.kernels.binpack_sa_step.ref``
does: one move's delta is the cost of the touched bins after it minus their
cost before, summed per chain.  Returns int64.
"""
from __future__ import annotations

import torch

from ..binpack_fitness.ref import binpack_fitness_kinds_ref, binpack_fitness_ref


def sa_step_deltas_ref(
    old_w: torch.Tensor,  # (C, T) touched-bin geometry before the move
    old_h: torch.Tensor,
    new_w: torch.Tensor,  # (C, T) geometry after the move (0 = no bin)
    new_h: torch.Tensor,
    modes,
) -> torch.Tensor:
    """(C,) int64 total cost delta per chain."""
    new_cost = binpack_fitness_ref(new_w, new_h, modes)
    old_cost = binpack_fitness_ref(old_w, old_h, modes)
    return (new_cost - old_cost).sum(dim=-1)


def sa_step_deltas_kinds_ref(
    old_w: torch.Tensor,
    old_h: torch.Tensor,
    old_k: torch.Tensor,  # (C, T) RAM-kind indices before the move
    new_w: torch.Tensor,
    new_h: torch.Tensor,
    new_k: torch.Tensor,  # (C, T) RAM-kind indices after the move
    kind_tables,
) -> torch.Tensor:
    """Heterogeneous variant: kind lanes select per-bin mode tables and
    weights (a RAM-kind flip is a delta with equal geometry, other kinds)."""
    new_cost = binpack_fitness_kinds_ref(new_w, new_h, new_k, kind_tables)
    old_cost = binpack_fitness_kinds_ref(old_w, old_h, old_k, kind_tables)
    return (new_cost - old_cost).sum(dim=-1)
