"""Per-individual total RAM cost for a padded population (the GA's
generation-evaluation primitive).

Rows are individuals, columns are bins, entries are the bin geometry; empty
(padded) slots carry ``width == 0`` and cost nothing.  The engines keep
their state in host numpy, so this layer copies the geometry to ``device``,
evaluates, and copies the totals back.  Backends:

* ``"cuda"`` — the hand-written kernels K1 / K2 (``kernel.py``); on a CPU
  device their wrappers take the plain version.
* ``"torch"`` — the plain PyTorch version (``ref.py``) on ``device``.

Heterogeneous OCM problems pass a parallel ``kinds`` matrix plus the
problem's ``kind_tables`` (``((weight, modes), ...)`` per RAM kind).
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import binpack_fitness_cuda, binpack_fitness_kinds_cuda
from .ref import binpack_fitness_kinds_ref, binpack_fitness_ref

BACKENDS = ("cuda", "torch")


def _plane(x, device, nb) -> torch.Tensor:
    """A host array as a contiguous (rows, nb) int32 tensor on ``device``."""
    x = np.ascontiguousarray(x, dtype=np.int32).reshape(-1, nb)
    return torch.from_numpy(x).to(device)


def population_costs(
    widths,
    heights,
    modes=None,
    backend: str = "cuda",
    kinds=None,
    kind_tables=None,
    device="cuda",
) -> np.ndarray:
    """(P, NB) host geometry -> (P,) int64 total cost per individual (host
    numpy).

    ``kinds`` (a (P, NB) int matrix of RAM-kind indices) together with
    ``kind_tables`` routes evaluation through per-kind mode tables; without
    them the single mode set ``modes`` (default ``BRAM18_MODES``) applies to
    every bin.  A leading *problem axis* is accepted too: ``(NP, P, NB)``
    inputs return ``(NP, P)`` totals, by reshape to one ``(NP * P, NB)``
    call (padded problem rows have width 0 and cost nothing).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if kinds is not None and kind_tables is None:
        raise ValueError("kinds requires kind_tables")
    if modes is None:
        from ...core.problem import BRAM18_MODES

        modes = BRAM18_MODES
    lead = tuple(np.shape(widths)[:-1])
    nb = np.shape(widths)[-1]
    w = _plane(widths, device, nb)
    h = _plane(heights, device, nb)
    if kinds is not None:
        k = _plane(kinds, device, nb)
        if backend == "cuda":
            totals = binpack_fitness_kinds_cuda(w, h, k, kind_tables)
        else:
            totals = binpack_fitness_kinds_ref(w, h, k, kind_tables).sum(dim=1)
    elif backend == "cuda":
        totals = binpack_fitness_cuda(w, h, modes)
    else:
        totals = binpack_fitness_ref(w, h, modes).sum(dim=1)
    return totals.cpu().numpy().reshape(lead)
