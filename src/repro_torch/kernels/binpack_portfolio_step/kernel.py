"""CUDA wrappers for the fused portfolio step K5 (one launch for both halves).

``portfolio_step_cuda`` replaces ``portfolio_step_pallas`` and
``portfolio_step_kinds_cuda`` replaces ``portfolio_step_kinds_pallas``
(``repro.kernels.binpack_portfolio_step.kernel``); the source is
``kernels/csrc/binpack_portfolio_step.cu``.  Each takes the ``(rows, NB)``
int32 population planes and the ``(C, T)`` int32 SA step planes, and
returns ``((rows,) int64 totals, (C,) int64 deltas)``.  A CUDA tensor
launches the kernel (or raises); a CPU tensor, and only a CPU tensor, takes
the plain version in ``ref.py``.  Each wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import (
    check_planes, count_launch, kind_tables_struct, launch, load, modes_struct,
)
from .ref import portfolio_step_kinds_ref, portfolio_step_ref

_THREADS = 256  # kThreads in the source: chains per SA block
_MAX_BLOCKS = 2**31 - 1


def _device(pop, step) -> torch.device:
    device = check_planes("portfolio_step population", pop)
    if check_planes("portfolio_step SA step", step) != device:
        raise ValueError("portfolio_step: both halves must share one device")
    return device


def _outputs(pop, step, device):
    rows, nb = pop[0].shape
    c, t = step[0].shape
    if rows + -(-c // _THREADS) > _MAX_BLOCKS:
        raise ValueError(f"portfolio_step: {rows} rows + {c} chains exceed the grid")
    totals = torch.empty(rows, dtype=torch.int64, device=device)
    deltas = torch.empty(c, dtype=torch.int64, device=device)
    return totals, deltas, (rows, nb, c, t)


def portfolio_step_cuda(
    widths, heights, old_w, old_h, new_w, new_h, modes
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: K1's row totals and K3's chain deltas in one launch."""
    pop, step = (widths, heights), (old_w, old_h, new_w, new_h)
    device = _device(pop, step)
    tables = modes_struct(modes)
    if device.type == "cpu":
        return portfolio_step_ref(*pop, *step, modes)
    totals, deltas, (rows, nb, c, t) = _outputs(pop, step, device)
    if rows == 0 and c == 0:
        return totals, deltas
    lib = load("binpack_portfolio_step")
    launch(
        device, lib.portfolio_step_launch,
        widths.data_ptr(), heights.data_ptr(), totals.data_ptr(), rows, nb,
        old_w.data_ptr(), old_h.data_ptr(), new_w.data_ptr(), new_h.data_ptr(),
        deltas.data_ptr(), c, t, ctypes.byref(tables),
    )
    count_launch(portfolio_step_cuda)
    return totals, deltas


portfolio_step_cuda.launches = 0


def portfolio_step_kinds_cuda(
    widths, heights, kinds, old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 with kind lanes: K2's row totals and K4's chain deltas in one
    launch, both halves on the same ``kind_tables``."""
    pop = (widths, heights, kinds)
    step = (old_w, old_h, old_k, new_w, new_h, new_k)
    device = _device(pop, step)
    tables = kind_tables_struct(kind_tables)
    if device.type == "cpu":
        return portfolio_step_kinds_ref(*pop, *step, kind_tables)
    totals, deltas, (rows, nb, c, t) = _outputs(pop, step, device)
    if rows == 0 and c == 0:
        return totals, deltas
    lib = load("binpack_portfolio_step")
    launch(
        device, lib.portfolio_step_kinds_launch,
        widths.data_ptr(), heights.data_ptr(), kinds.data_ptr(), totals.data_ptr(),
        rows, nb, old_w.data_ptr(), old_h.data_ptr(), old_k.data_ptr(),
        new_w.data_ptr(), new_h.data_ptr(), new_k.data_ptr(), deltas.data_ptr(),
        c, t, ctypes.byref(tables),
    )
    count_launch(portfolio_step_kinds_cuda)
    return totals, deltas


portfolio_step_kinds_cuda.launches = 0
