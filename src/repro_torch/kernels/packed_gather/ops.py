"""Evaluate all logical matvecs of one packed bank (the port's
``repro.kernels.packed_gather.ops``).

Backends: ``"torch"`` the plain version (``ref.py``), ``"cuda"`` the
hand-written kernel K6 (``kernel.py``; on a CPU tensor its wrapper takes
the plain version), ``"auto"`` = ``"cuda"`` for a CUDA bank, else
``"torch"``.  Outputs agree within float32 rounding, not bit for bit: the
kernel sums each row in another order.
"""
from __future__ import annotations

import torch

from .kernel import packed_gather_cuda
from .ref import packed_gather_ref

BACKENDS = ("auto", "torch", "cuda")


def bank_matvec(bank, x, seg, backend: str = "auto") -> torch.Tensor:
    """(R, C) bank, (N, C) activations, (R,) int32 segment ids -> (R,)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if bank.device.type == "cuda" else "torch"
    if backend == "cuda":
        return packed_gather_cuda(bank, x, seg)
    return packed_gather_ref(bank, x, seg)


def split_outputs(y, seg, n_logical: int) -> list[torch.Tensor]:
    """Scatter the fused (R,) result back into per-logical-buffer outputs."""
    seg = torch.as_tensor(seg, device=y.device)
    return [y[seg == n] for n in range(n_logical)]
