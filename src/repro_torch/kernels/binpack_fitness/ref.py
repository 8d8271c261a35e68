"""Plain PyTorch versions of the binpack fitness kernels (K1 / K2).

The arithmetic of ``repro.kernels.binpack_fitness.ref`` in torch ops, on
whatever device the inputs live on: the CPU path of the kernel wrappers,
the ``torch`` backend, and the oracle the CUDA kernels are held to.
Per-bin costs are int64 (exact for every int32 geometry).
"""
from __future__ import annotations

import torch


def binpack_fitness_ref(
    widths: torch.Tensor, heights: torch.Tensor, modes
) -> torch.Tensor:
    """Per-bin ``min_m ceil(w / w_m) * ceil(h / d_m)``; 0 where ``w == 0``."""
    w = widths.to(torch.int64).unsqueeze(-1)
    h = heights.to(torch.int64).unsqueeze(-1)
    mode_w = torch.tensor([m[0] for m in modes], dtype=torch.int64, device=w.device)
    mode_d = torch.tensor([m[1] for m in modes], dtype=torch.int64, device=w.device)
    per_mode = ((w + mode_w - 1) // mode_w) * ((h + mode_d - 1) // mode_d)
    best = per_mode.min(dim=-1).values
    return torch.where(widths > 0, best, torch.zeros_like(best))


def binpack_fitness_kinds_ref(
    widths: torch.Tensor, heights: torch.Tensor, kinds: torch.Tensor, kind_tables
) -> torch.Tensor:
    """Heterogeneous variant: per-bin RAM-kind indices select the mode table
    and the unit weight (``kind_tables[k] = (weight, modes)``); a kind index
    outside the table costs 0, as in the reference."""
    out = torch.zeros(widths.shape, dtype=torch.int64, device=widths.device)
    for k, (weight, modes) in enumerate(kind_tables):
        ck = binpack_fitness_ref(widths, heights, modes) * int(weight)
        out = torch.where(kinds == k, ck, out)
    return out
