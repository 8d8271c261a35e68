"""Dispatcher for the fused SA step: per-chain delta cost + Metropolis rule.

``sa_step_deltas`` is the hot primitive of both swap annealers: four padded
(C, T) int32 matrices (touched-bin geometry before/after one step's moves
per chain) reduce to a (C,) integer delta-cost vector in one call.
Backends:

* ``"python"`` — vectorized host numpy, the port's independent oracle.
* ``"torch"`` — the plain PyTorch version (``ref.py``) on ``device``.
* ``"cuda"`` — the hand-written kernels K3 / K4 (``kernel.py``); on a CPU
  device their wrappers take the plain version.

The engines' state is host numpy, so the torch and cuda backends move a
step's planes to ``device`` in ONE copy from one pinned ``(P, R, T)`` host
buffer (``kernels/staging.py``) and the deltas back in one ``.cpu()``
copy.  All backends use exact integer arithmetic and return bit-identical
deltas, so the annealer's trajectory cannot depend on the backend.  The
kernel (or plain version) call is the span ``ops.launch``
(`repro_torch.obs`), inside the call's ``ops.call`` (`kernels/probshard.py`).

The Metropolis *comparison* (``u < exp(-d_e / T)``) deliberately stays on
the host in float64 (`metropolis_mask`, or a conditional scalar draw in the
single-chain engine): the reference's scalar loop draws its uniform only for
uphill moves and compares against ``math.exp``, and per-seed bit parity pins
that exact stream and rounding.  Fusing the compare into a float32 kernel
would break parity for ~1-ulp boundary cases.

``mesh`` (a `launch.mesh.SweepMesh`) row-shards a call on the torch and
cuda backends: the chain rows are zero-padded to a multiple of the mesh
size, each mesh device stages and costs its contiguous block, and the
deltas come back bit-identical (`kernels/probshard.py`); ``python``
ignores it.

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
from .kernel import sa_step_deltas_cuda, sa_step_deltas_kinds_cuda
from .ref import sa_step_deltas_kinds_ref, sa_step_deltas_ref

BACKENDS = ("python", "torch", "cuda")


def _bin_costs_numpy(w: np.ndarray, h: np.ndarray, modes) -> np.ndarray:
    w = np.asarray(w, dtype=np.int64)[..., None]
    h = np.asarray(h, dtype=np.int64)[..., None]
    mode_w = np.asarray([m[0] for m in modes], dtype=np.int64)
    mode_d = np.asarray([m[1] for m in modes], dtype=np.int64)
    per_mode = -(-w // mode_w) * -(-h // mode_d)  # ceil div
    return np.where(w[..., 0] > 0, np.min(per_mode, axis=-1), 0)


def _bin_costs_kinds_numpy(w, h, k, kind_tables) -> np.ndarray:
    """Per-slot unit cost with a RAM-kind lane selecting the mode table."""
    k = np.asarray(k)
    out = np.zeros(np.asarray(w).shape, dtype=np.int64)
    for ki, (weight, modes) in enumerate(kind_tables):
        out = np.where(k == ki, _bin_costs_numpy(w, h, modes) * int(weight), out)
    return out


def sa_step_deltas(
    old_w,
    old_h,
    new_w,
    new_h,
    modes=None,
    backend: str = "cuda",
    old_k=None,
    new_k=None,
    kind_tables=None,
    device="cuda",
    mesh=None,
) -> np.ndarray:
    """(C, T) non-negative int32 touched-bin geometry before/after -> (C,)
    int64 cost deltas.

    Empty slots (w == 0) cost nothing on either side, so rows may be
    zero-padded to a common touched-bin count.  Heterogeneous problems pass
    per-slot RAM-kind lanes ``old_k``/``new_k`` plus the problem's
    ``kind_tables``: each slot is costed on its own mode table, so a kind
    flip (same geometry, different kind) is just another delta.  A leading
    problem axis is accepted too: ``(NP, C, T)`` inputs return ``(NP, C)``
    deltas, by reshape to one ``(NP * C, T)`` call.  ``mesh`` row-shards
    the rows over a sweep mesh of ``device``'s type.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    hetero = old_k is not None
    if hetero and (new_k is None or kind_tables is None):
        raise ValueError("old_k/new_k/kind_tables must be passed together")
    if modes is None:
        from ...core.problem import BRAM18_MODES

        modes = BRAM18_MODES
    lead = tuple(np.shape(old_w)[:-1])
    if backend == "python":
        if hetero:
            new_c = _bin_costs_kinds_numpy(new_w, new_h, new_k, kind_tables)
            old_c = _bin_costs_kinds_numpy(old_w, old_h, old_k, kind_tables)
        else:
            new_c = _bin_costs_numpy(new_w, new_h, modes)
            old_c = _bin_costs_numpy(old_w, old_h, modes)
        return np.sum(new_c - old_c, axis=-1)
    planes = (
        (old_w, old_h, old_k, new_w, new_h, new_k) if hetero
        else (old_w, old_h, new_w, new_h)
    )

    def body(dev, *planes) -> torch.Tensor:
        """The (R,) int64 deltas of one block, on ``dev`` (not fetched): the
        planes as views of one staged ``(P, R, T)`` tensor (one copy)."""
        staged = stage(planes, dev)
        tok = obs.begin("ops.launch")
        if hetero:
            fn = sa_step_deltas_kinds_cuda if backend == "cuda" else sa_step_deltas_kinds_ref
            out = fn(*staged.unbind(0), kind_tables)
        else:
            fn = sa_step_deltas_cuda if backend == "cuda" else sa_step_deltas_ref
            out = fn(*staged.unbind(0), modes)
        obs.end(tok)
        return out

    out = run_rows(body, planes, device, mesh)
    return out.reshape(lead)


def metropolis_mask(d_e, temps, u) -> np.ndarray:
    """Vectorized Metropolis rule: accept downhill, else ``u < exp(-d/T)``.

    Float64 throughout, matching the scalar loop's ``math.exp`` comparison.
    ``T <= 0`` freezes uphill moves entirely (greedy descent).
    """
    d = np.asarray(d_e, dtype=np.float64)
    t = np.asarray(temps, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    safe_t = np.where(t > 0, t, 1.0)
    p = np.exp(-np.maximum(d, 0.0) / safe_t)
    return (d < 0) | ((t > 0) & (u < p))
