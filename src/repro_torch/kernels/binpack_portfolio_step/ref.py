"""Plain PyTorch versions of the fused portfolio step (K5).

Built from the port's own K1/K2 and K3/K4 plain versions, as
``repro.kernels.binpack_portfolio_step.ref`` is built from the reference's:
the GA half is the per-row sum of the fitness plane, the SA half the
per-chain delta.  Both int64 and exact.
"""
from __future__ import annotations

import torch

from ..binpack_fitness.ref import binpack_fitness_kinds_ref, binpack_fitness_ref
from ..binpack_sa_step.ref import sa_step_deltas_kinds_ref, sa_step_deltas_ref


def portfolio_step_ref(
    widths: torch.Tensor,  # (rows, NB) stacked GA population geometry
    heights: torch.Tensor,
    old_w: torch.Tensor,  # (C, T) SA touched-bin geometry before the move
    old_h: torch.Tensor,
    new_w: torch.Tensor,  # (C, T) geometry after the move
    new_h: torch.Tensor,
    modes,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((rows,) population totals, (C,) SA deltas)."""
    totals = binpack_fitness_ref(widths, heights, modes).sum(dim=1)
    return totals, sa_step_deltas_ref(old_w, old_h, new_w, new_h, modes)


def portfolio_step_kinds_ref(
    widths: torch.Tensor,
    heights: torch.Tensor,
    kinds: torch.Tensor,  # (rows, NB) RAM-kind lanes of the populations
    old_w: torch.Tensor,
    old_h: torch.Tensor,
    old_k: torch.Tensor,  # (C, T) RAM-kind lanes before the move
    new_w: torch.Tensor,
    new_h: torch.Tensor,
    new_k: torch.Tensor,  # (C, T) RAM-kind lanes after the move
    kind_tables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous variant: kind lanes select per-kind mode tables and
    weights on both halves."""
    totals = binpack_fitness_kinds_ref(widths, heights, kinds, kind_tables).sum(dim=1)
    deltas = sa_step_deltas_kinds_ref(
        old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
    )
    return totals, deltas
