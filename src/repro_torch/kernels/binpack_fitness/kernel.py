"""CUDA wrappers for the binpack fitness kernels K1 / K2 (row sums fused).

``binpack_fitness_cuda`` replaces ``binpack_fitness_pallas`` and
``binpack_fitness_kinds_cuda`` replaces ``binpack_fitness_kinds_pallas``
(``repro.kernels.binpack_fitness.kernel``); the sources are
``kernels/csrc/binpack_fitness.cu``.  Both take ``(P, NB)`` int32 planes and
return the ``(P,)`` int64 per-row totals.  A CUDA tensor launches the
kernel (or raises); a CPU tensor, and only a CPU tensor, takes the plain
version in ``ref.py``.  Each wrapper counts its launches
(`build.count_launch`, read with `kernels.launch_counts`).
The by-value table argument (``build.FitnessTables``: each divisor as a
magic number and a shift) is built once per distinct table and cached.

Domain: ``w, h >= 0`` (int32); a slot with ``w == 0`` is empty and costs
0.  A slot with ``w > 0`` and ``h < 0`` is outside it: the kernel and the
plain version may disagree there, and no call checks for it (the engines
never make one).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import (
    check_planes, count_launch, fitness_modes_struct, fitness_tables_struct, launch, load,
)
from .ref import binpack_fitness_kinds_ref, binpack_fitness_ref


def binpack_fitness_cuda(
    widths: torch.Tensor, heights: torch.Tensor, modes
) -> torch.Tensor:
    """K1: ``(P, NB)`` non-negative int32 geometry -> ``(P,)`` int64 total
    cost per row."""
    device = check_planes("binpack_fitness", (widths, heights))
    tables = fitness_modes_struct(modes)
    if device.type == "cpu":
        return binpack_fitness_ref(widths, heights, modes).sum(dim=1)
    p, nb = widths.shape
    out = torch.empty(p, dtype=torch.int64, device=device)
    if p == 0:
        return out
    lib = load("binpack_fitness")
    launch(
        device, lib.binpack_fitness_launch,
        widths.data_ptr(), heights.data_ptr(), out.data_ptr(), p, nb,
        ctypes.byref(tables),
    )
    count_launch(binpack_fitness_cuda)
    return out


def binpack_fitness_kinds_cuda(
    widths: torch.Tensor, heights: torch.Tensor, kinds: torch.Tensor, kind_tables
) -> torch.Tensor:
    """K2: K1 with a ``(P, NB)`` int32 RAM-kind plane selecting, per bin,
    the mode table and unit weight of ``kind_tables``; geometry
    non-negative int32."""
    device = check_planes("binpack_fitness_kinds", (widths, heights, kinds))
    tables = fitness_tables_struct(kind_tables)
    if device.type == "cpu":
        return binpack_fitness_kinds_ref(widths, heights, kinds, kind_tables).sum(dim=1)
    p, nb = widths.shape
    out = torch.empty(p, dtype=torch.int64, device=device)
    if p == 0:
        return out
    lib = load("binpack_fitness")
    launch(
        device, lib.binpack_fitness_kinds_launch,
        widths.data_ptr(), heights.data_ptr(), kinds.data_ptr(), out.data_ptr(),
        p, nb, ctypes.byref(tables),
    )
    count_launch(binpack_fitness_kinds_cuda)
    return out
