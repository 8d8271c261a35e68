"""Dispatcher for the fused portfolio step: GA fitness + SA deltas at once.

``portfolio_step`` answers one fused barrier cycle of the island portfolio
(`core.portfolio._advance_fused`): a stacked GA generation's population
fitness (the ``binpack_fitness`` contract) AND one SA fleet step's
touched-bin delta costs (the ``binpack_sa_step`` contract).  Backends:

* ``"python"`` — host numpy for both halves.
* ``"torch"`` — the plain PyTorch version (``ref.py``) on ``device``.
* ``"cuda"`` — the hand-written kernel K5 (``kernel.py``), one launch for
  both halves; on a CPU device its wrappers take the plain version.

The engines' state is host numpy, so the torch and cuda backends move both
halves' planes to ``device`` in ONE copy from one pinned host buffer
(``kernels/staging.stage_groups``: the ``NB``-wide population planes and the
``T``-wide step planes back to back) and bring both results back in ONE
``.cpu()`` of one ``(rows + C,)`` int64 tensor.  Every backend is exact
integer arithmetic: the totals equal ``binpack_fitness.ops.population_costs``
and the deltas ``binpack_sa_step.ops.sa_step_deltas`` on the same inputs,
so a fused barrier cannot change any engine trajectory.  Spans
(`repro_torch.obs`): ``ops.call`` around the device backends' call,
``ops.launch`` around the fused kernel (or plain version), ``ops.wait``
around the ``.cpu()``.

``mesh`` (a `launch.mesh.SweepMesh`) row-shards a call on the torch and
cuda backends: the population rows and the step rows pad to a multiple of
the mesh size independently, and each mesh device gets ONE fused call on
its block of both halves (`kernels/probshard.py`); ``python`` ignores it.

Domain: ``w, h >= 0`` (int32) on both halves; a slot with ``w == 0`` is
empty and costs 0.  A slot with ``w > 0`` and ``h < 0`` is outside it (the
backends may disagree there) and is not checked per call: the GA, SA and
portfolio engines never make one (``tests/test_torch_kernel_domain.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ..binpack_sa_step.ops import _bin_costs_kinds_numpy, _bin_costs_numpy
from ..probshard import fetch, mesh_size, pad_rows, row_shard
from ..staging import stage_groups
from .kernel import portfolio_step_joined_cuda, portfolio_step_kinds_joined_cuda
from .ref import portfolio_step_kinds_ref, portfolio_step_ref

BACKENDS = ("python", "torch", "cuda")


def portfolio_step(
    W,
    H,
    old_w,
    old_h,
    new_w,
    new_h,
    modes=None,
    backend: str = "cuda",
    kinds=None,
    old_k=None,
    new_k=None,
    kind_tables=None,
    device="cuda",
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """One fused call: ``(W, H)`` population geometry (any leading shape,
    bins on the last axis) plus ``(R, T)`` touched-bin SA step geometry,
    both non-negative int32 -> ``(totals, deltas)``.

    ``totals`` is float64 with ``W``'s leading shape (exact integer values,
    as the GA's batched costs); ``deltas`` is ``(R,)`` int64 (as
    ``sa_step_deltas``).  Heterogeneous problems pass the kind lanes of
    BOTH halves (``kinds`` for the populations, ``old_k`` / ``new_k`` for
    the touched slots) plus the shared ``kind_tables`` — all-or-none, since
    a portfolio's islands share one problem.  ``mesh`` row-shards both
    halves over a sweep mesh of ``device``'s type.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    hetero = kind_tables is not None
    sides = (kinds is not None, old_k is not None, new_k is not None)
    if hetero != all(sides) or (not hetero and any(sides)):
        raise ValueError(
            "kinds/old_k/new_k/kind_tables must be passed together (the "
            "portfolio's islands share one problem) or not at all"
        )
    if modes is None:
        from ...core.problem import BRAM18_MODES

        modes = BRAM18_MODES
    if backend == "python":
        if hetero:
            per_bin = _bin_costs_kinds_numpy(W, H, kinds, kind_tables)
            new_c = _bin_costs_kinds_numpy(new_w, new_h, new_k, kind_tables)
            old_c = _bin_costs_kinds_numpy(old_w, old_h, old_k, kind_tables)
        else:
            per_bin = _bin_costs_numpy(W, H, modes)
            new_c = _bin_costs_numpy(new_w, new_h, modes)
            old_c = _bin_costs_numpy(old_w, old_h, modes)
        totals = per_bin.sum(axis=-1).astype(np.float64)
        return totals, np.sum(new_c - old_c, axis=-1)
    lead = tuple(np.shape(W)[:-1])
    step_lead = tuple(np.shape(old_w)[:-1])
    pop = (W, H) + ((kinds,) if hetero else ())
    step = (
        (old_w, old_h, old_k, new_w, new_h, new_k) if hetero
        else (old_w, old_h, new_w, new_h)
    )
    cuda, plain = (
        (portfolio_step_kinds_joined_cuda, portfolio_step_kinds_ref) if hetero
        else (portfolio_step_joined_cuda, portfolio_step_ref)
    )
    tables = kind_tables if hetero else modes

    def body(dev, *planes) -> torch.Tensor:
        """One block's ``(rows + C,)`` int64 totals then deltas, on ``dev``
        (not fetched): both halves staged with one copy, one fused call."""
        pop_s, step_s = stage_groups((planes[:len(pop)], planes[len(pop):]), dev)
        tok = obs.begin("ops.launch")
        args = (*pop_s.unbind(0), *step_s.unbind(0), tables)
        out = cuda(*args) if backend == "cuda" else torch.cat(plain(*args))
        obs.end(tok)
        return out

    tok = obs.begin("ops.call")
    if mesh is None:
        both = fetch(body(torch.device(device), *pop, *step))
        rows = int(np.prod(lead))
        totals, deltas = both[:rows], both[rows:]
    else:
        k = mesh_size(mesh)
        nb, t = np.shape(W)[-1], np.shape(old_w)[-1]
        pop_p, n_pop = pad_rows([np.reshape(a, (-1, nb)) for a in pop], k)
        step_p, n_step = pad_rows([np.reshape(a, (-1, t)) for a in step], k)
        # block i's output is its rows' totals, then its chains' deltas
        rb, cb = len(pop_p[0]) // k, len(step_p[0]) // k
        both = row_shard(mesh, body, (*pop_p, *step_p), device).reshape(k, rb + cb)
        totals = both[:, :rb].reshape(-1)[:n_pop]
        deltas = both[:, rb:].reshape(-1)[:n_step]
    obs.end(tok)
    return (
        totals.astype(np.float64).reshape(lead),
        deltas.reshape(step_lead),
    )
