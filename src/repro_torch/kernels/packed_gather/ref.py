"""Plain PyTorch version of the packed-bank segment matvec (K6).

``y[r] = sum_c bank[r, c] * x[seg[r], c]``, and 0 where ``seg[r]`` lies
outside ``[0, N)``.

That last rule is the Pallas kernel's (``repro.kernels.packed_gather.
kernel``: a row whose segment matches no ``n`` keeps its zero
accumulator), which this port replaces.  The reference's own jnp oracle,
``repro.kernels.packed_gather.ref.packed_gather_ref``, disagrees there: its
gather wraps a negative index and clamps one past the end, so it returns
the dot with some row of ``x`` instead of 0.  The port's kernel and this
version follow the Pallas kernel.
"""
from __future__ import annotations

import torch


def packed_gather_ref(bank: torch.Tensor, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(R, C) bank, (N, C) activations, (R,) segment ids -> (R,) outputs."""
    n = x.shape[0]
    if n == 0:
        return bank.new_zeros(bank.shape[0])
    seg = seg.long()
    y = (bank * x[seg.clamp(0, n - 1)]).sum(dim=1)
    return torch.where((seg >= 0) & (seg < n), y, torch.zeros_like(y))
