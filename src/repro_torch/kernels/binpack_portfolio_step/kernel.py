"""CUDA wrappers for the fused portfolio step K5 (one launch for both halves).

``portfolio_step_cuda`` replaces ``portfolio_step_pallas`` and
``portfolio_step_kinds_cuda`` replaces ``portfolio_step_kinds_pallas``
(``repro.kernels.binpack_portfolio_step.kernel``); the source is
``kernels/csrc/binpack_portfolio_step.cu``.  Each takes the ``(rows, NB)``
int32 population planes and the ``(C, T)`` int32 SA step planes, and
returns ``(totals, deltas)``: the ``(rows,)`` and ``(C,)`` int64 views of
one ``(rows + C,)`` tensor, which ``portfolio_step_joined_cuda`` /
``portfolio_step_kinds_joined_cuda`` return whole, so the ops layer fetches
both halves with one copy.  A CUDA tensor launches the kernel (or raises);
a CPU tensor, and only a CPU tensor, takes the plain version in ``ref.py``.
Each kernel's launches, through either of its functions, are counted
under ``portfolio_step_cuda`` / ``portfolio_step_kinds_cuda``
(`build.count_launch`, read with `kernels.launch_counts`).

Domain: ``w, h >= 0`` (int32); a slot with ``w == 0`` is empty and costs
0.  A slot with ``w > 0`` and ``h < 0`` is outside it: the kernel and the
plain version may disagree there, and no call checks for it (the engines
never make one).  Both halves cost slots with K1 / K2's by-value table
(``build.FitnessTables``, built once per distinct table and cached).

Launch geometry (``grid_blocks``): blocks of ``build.PORTFOLIO_THREADS``
threads, one per population row, then ``ceil(C / portfolio_chain_rows(T))``
blocks of chain rows.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import (
    check_planes, count_launch, fitness_modes_struct, fitness_tables_struct, launch, load,
    portfolio_chain_rows,
)
from .ref import portfolio_step_kinds_ref, portfolio_step_ref

_MAX_BLOCKS = 2**31 - 1


def grid_blocks(rows: int, c: int, t: int) -> int:
    """K5's grid for ``rows`` population rows and ``C`` chain rows of ``T``
    slots; raises past the grid's limit."""
    blocks = rows + -(-c // portfolio_chain_rows(t))
    if blocks > _MAX_BLOCKS:
        raise ValueError(
            f"portfolio_step: {rows} rows + {c} chains of {t} slots need {blocks} "
            f"blocks, past the grid's {_MAX_BLOCKS}"
        )
    return blocks


def _device(pop, step) -> torch.device:
    device = check_planes("portfolio_step population", pop)
    if check_planes("portfolio_step SA step", step) != device:
        raise ValueError("portfolio_step: both halves must share one device")
    return device


def _run(wrapper, entry, pop, step, tables, plain) -> torch.Tensor:
    """One ``(rows + C,)`` int64 tensor: the totals, then the deltas."""
    device = _device(pop, step)
    (rows, nb), (c, t) = pop[0].shape, step[0].shape
    blocks = grid_blocks(rows, c, t)
    if device.type == "cpu":
        return torch.cat(plain())
    out = torch.empty(rows + c, dtype=torch.int64, device=device)
    if blocks > 0:
        launch(
            device, getattr(load("binpack_portfolio_step"), entry),
            *(x.data_ptr() for x in pop), out.data_ptr(), rows, nb,
            *(x.data_ptr() for x in step), out[rows:].data_ptr(), c, t,
            ctypes.byref(tables),
        )
        count_launch(wrapper)
    return out


def portfolio_step_joined_cuda(
    widths, heights, old_w, old_h, new_w, new_h, modes
) -> torch.Tensor:
    """K5 (K1's row totals and K3's chain deltas in one launch) on
    non-negative int32 geometry, as one ``(rows + C,)`` int64 tensor."""
    pop, step = (widths, heights), (old_w, old_h, new_w, new_h)
    return _run(portfolio_step_cuda, "portfolio_step_launch", pop, step,
                fitness_modes_struct(modes), lambda: portfolio_step_ref(*pop, *step, modes))


def portfolio_step_cuda(
    widths, heights, old_w, old_h, new_w, new_h, modes
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(totals, deltas)``, views of `portfolio_step_joined_cuda`'s tensor."""
    both = portfolio_step_joined_cuda(widths, heights, old_w, old_h, new_w, new_h, modes)
    return both[:widths.shape[0]], both[widths.shape[0]:]


def portfolio_step_kinds_joined_cuda(
    widths, heights, kinds, old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
) -> torch.Tensor:
    """K5 with kind lanes (K2's row totals and K4's chain deltas in one
    launch, both halves on the same ``kind_tables``) on non-negative int32
    geometry, as one ``(rows + C,)`` int64 tensor."""
    pop = (widths, heights, kinds)
    step = (old_w, old_h, old_k, new_w, new_h, new_k)
    return _run(portfolio_step_kinds_cuda, "portfolio_step_kinds_launch", pop, step,
                fitness_tables_struct(kind_tables),
                lambda: portfolio_step_kinds_ref(*pop, *step, kind_tables))


def portfolio_step_kinds_cuda(
    widths, heights, kinds, old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 with kind lanes: ``(totals, deltas)``, views of
    `portfolio_step_kinds_joined_cuda`'s tensor."""
    both = portfolio_step_kinds_joined_cuda(widths, heights, kinds, old_w, old_h, old_k,
                                            new_w, new_h, new_k, kind_tables)
    return both[:widths.shape[0]], both[widths.shape[0]:]
