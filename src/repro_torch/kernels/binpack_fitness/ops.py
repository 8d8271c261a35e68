"""Per-individual total RAM cost for a padded population (the GA's
generation-evaluation primitive).

Rows are individuals, columns are bins, entries are the bin geometry; empty
(padded) slots carry ``width == 0`` and cost nothing.  The engines keep
their state in host numpy, so this layer moves the geometry to ``device`` in
ONE copy from one pinned ``(2|3, R, NB)`` host buffer
(``kernels/staging.py``), evaluates on views of it, and brings the totals
back with one ``.cpu()`` copy.  Backends:

* ``"cuda"`` — the hand-written kernels K1 / K2 (``kernel.py``); on a CPU
  device their wrappers take the plain version.
* ``"torch"`` — the plain PyTorch version (``ref.py``) on ``device``.

Heterogeneous OCM problems pass a parallel ``kinds`` matrix plus the
problem's ``kind_tables`` (``((weight, modes), ...)`` per RAM kind).

The kernel (or plain version) call is the span ``ops.launch``
(`repro_torch.obs`), inside the call's ``ops.call`` (`kernels/probshard.py`).

``mesh`` (a `launch.mesh.SweepMesh`) row-shards a call: the rows are
zero-padded to a multiple of the mesh size, each mesh device stages and
costs its contiguous block, and the totals come back bit-identical to the
unsharded call (`kernels/probshard.py`).

Domain: ``w, h >= 0`` (int32); a slot with ``w == 0`` is empty and costs
0.  A slot with ``w > 0`` and ``h < 0`` is outside it (the backends may
disagree there) and is not checked per call: the GA, SA and portfolio
engines never make one (``tests/test_torch_kernel_domain.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ..probshard import run_rows
from ..staging import stage
from .kernel import binpack_fitness_cuda, binpack_fitness_kinds_cuda
from .ref import binpack_fitness_kinds_ref, binpack_fitness_ref

BACKENDS = ("cuda", "torch")


def population_costs(
    widths,
    heights,
    modes=None,
    backend: str = "cuda",
    kinds=None,
    kind_tables=None,
    device="cuda",
    mesh=None,
) -> np.ndarray:
    """(P, NB) non-negative int32 host geometry -> (P,) int64 total cost per
    individual (host numpy).

    ``kinds`` (a (P, NB) int matrix of RAM-kind indices) together with
    ``kind_tables`` routes evaluation through per-kind mode tables; without
    them the single mode set ``modes`` (default ``BRAM18_MODES``) applies to
    every bin.  A leading *problem axis* is accepted too: ``(NP, P, NB)``
    inputs return ``(NP, P)`` totals, by reshape to one ``(NP * P, NB)``
    call (padded problem rows have width 0 and cost nothing).  ``mesh``
    row-shards the ``NP * P`` rows over a sweep mesh of ``device``'s type.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if kinds is not None and kind_tables is None:
        raise ValueError("kinds requires kind_tables")
    if modes is None:
        from ...core.problem import BRAM18_MODES

        modes = BRAM18_MODES
    lead = tuple(np.shape(widths)[:-1])
    planes = (widths, heights) + (() if kinds is None else (kinds,))

    def body(dev, *planes) -> torch.Tensor:
        """The (R,) int64 totals of one block, on ``dev`` (not fetched)."""
        staged = stage(planes, dev)
        tok = obs.begin("ops.launch")
        if kinds is not None:
            w, h, k = staged.unbind(0)
            if backend == "cuda":
                out = binpack_fitness_kinds_cuda(w, h, k, kind_tables)
            else:
                out = binpack_fitness_kinds_ref(w, h, k, kind_tables).sum(dim=1)
        else:
            w, h = staged.unbind(0)
            if backend == "cuda":
                out = binpack_fitness_cuda(w, h, modes)
            else:
                out = binpack_fitness_ref(w, h, modes).sum(dim=1)
        obs.end(tok)
        return out

    totals = run_rows(body, planes, device, mesh)
    return totals.reshape(lead)
