"""CUDA wrappers for the fused SA delta-cost kernels K3 / K4.

``sa_step_deltas_cuda`` replaces ``sa_step_deltas_pallas`` and
``sa_step_deltas_kinds_cuda`` replaces ``sa_step_deltas_kinds_pallas``
(``repro.kernels.binpack_sa_step.kernel``); the sources are
``kernels/csrc/binpack_sa_step.cu``.  Both take ``(C, T)`` int32 planes and
return the ``(C,)`` int64 per-chain deltas.  A CUDA tensor launches the
kernel (or raises); a CPU tensor, and only a CPU tensor, takes the plain
version in ``ref.py``.  Each wrapper counts its launches
(`build.count_launch`, read with `kernels.launch_counts`).

Domain: ``w, h >= 0`` (int32); a slot with ``w == 0`` is empty and costs
0.  A slot with ``w > 0`` and ``h < 0`` is outside it: the kernel and the
plain version may disagree there, and no call checks for it (the engines
never make one).  The kernels cost slots with K1 / K2's by-value table
(``build.FitnessTables``, built once per distinct table and cached).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import (
    check_planes, count_launch, fitness_modes_struct, fitness_tables_struct, launch, load,
)
from .ref import sa_step_deltas_kinds_ref, sa_step_deltas_ref


def sa_step_deltas_cuda(old_w, old_h, new_w, new_h, modes) -> torch.Tensor:
    """K3: four (C, T) non-negative int32 planes -> (C,) int64
    ``sum_t cost(new) - cost(old)``."""
    device = check_planes("sa_step_deltas", (old_w, old_h, new_w, new_h))
    tables = fitness_modes_struct(modes)
    if device.type == "cpu":
        return sa_step_deltas_ref(old_w, old_h, new_w, new_h, modes)
    c, t = old_w.shape
    out = torch.empty(c, dtype=torch.int64, device=device)
    if c == 0:
        return out
    lib = load("binpack_sa_step")
    launch(
        device, lib.sa_step_deltas_launch,
        old_w.data_ptr(), old_h.data_ptr(), new_w.data_ptr(), new_h.data_ptr(),
        out.data_ptr(), c, t, ctypes.byref(tables),
    )
    count_launch(sa_step_deltas_cuda)
    return out


def sa_step_deltas_kinds_cuda(
    old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
) -> torch.Tensor:
    """K4: K3 with old/new (C, T) RAM-kind lanes selecting each slot's mode
    table and unit weight; geometry non-negative int32."""
    device = check_planes(
        "sa_step_deltas_kinds", (old_w, old_h, old_k, new_w, new_h, new_k)
    )
    tables = fitness_tables_struct(kind_tables)
    if device.type == "cpu":
        return sa_step_deltas_kinds_ref(
            old_w, old_h, old_k, new_w, new_h, new_k, kind_tables
        )
    c, t = old_w.shape
    out = torch.empty(c, dtype=torch.int64, device=device)
    if c == 0:
        return out
    lib = load("binpack_sa_step")
    launch(
        device, lib.sa_step_deltas_kinds_launch,
        old_w.data_ptr(), old_h.data_ptr(), old_k.data_ptr(),
        new_w.data_ptr(), new_h.data_ptr(), new_k.data_ptr(),
        out.data_ptr(), c, t, ctypes.byref(tables),
    )
    count_launch(sa_step_deltas_kinds_cuda)
    return out
