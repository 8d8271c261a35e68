"""Row sharding of the batched kernels over a 1-D ``("prob",)`` sweep mesh
(the port's counterpart of the reference's `repro.kernels.probshard`).

The three batched bin-packing kernels (``binpack_fitness`` K1 / K2,
``binpack_sa_step`` K3 / K4, ``binpack_portfolio_step`` K5) are row
programs: every operand carries the fleet's problem / chain / population
rows on its leading axis and every row is independent.  Sharding one over
a `launch.mesh.SweepMesh` is therefore mechanical:

1. zero-pad each operand's leading axis to a multiple of the mesh size
   (`pad_rows`; a zero row has width 0 in every slot, which costs 0 under
   the kernels' domain ``w, h >= 0``),
2. split every operand's leading axis into ``k`` contiguous blocks and run
   the ops body once per mesh device on its block (`row_shard`) — the rule
   the reference states in GSPMD terms as ``prob_axis_spec`` (leading axis
   on ``"prob"``, trailing axes replicated),
3. concatenate the blocks' outputs in mesh order and slice the padding off.

Every block is staged to its own device with the ops layer's one copy and
comes back with its own ``.cpu()``; every block is launched before the
first is fetched, so blocks on different cards overlap.  All kernels use
exact integer arithmetic, so the sharded result is bit-identical to the
unsharded one.

Spans (`repro_torch.obs`): ``ops.call`` (one a `run_rows` call) and
``ops.wait`` (each ``.cpu()``, which waits for the device).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs


def mesh_size(mesh) -> int:
    """Width of the ``"prob"`` axis (validates the mesh is a sweep mesh)."""
    try:
        return int(mesh.shape["prob"])
    except (AttributeError, KeyError, TypeError) as e:
        raise ValueError(
            "mesh= must be a 1-D ('prob',) sweep mesh "
            "(launch.mesh.make_sweep_mesh / SweepMesh); got axes "
            f"{getattr(mesh, 'axis_names', mesh)!r}"
        ) from e


def mesh_devices(mesh, device=None) -> tuple[torch.device, ...]:
    """The mesh's devices, one per ``"prob"`` position.  With ``device``
    (the caller's), raises ``ValueError`` unless the mesh's devices are of
    its type: work never moves to a device the caller did not name."""
    k = mesh_size(mesh)
    devices = tuple(torch.device(d) for d in getattr(mesh, "devices", ()))
    if len(devices) != k:
        raise ValueError(
            f"mesh= must list one device per 'prob' position; got {mesh!r}"
        )
    if device is not None:
        kind = torch.device(device).type
        if any(d.type != kind for d in devices):
            raise ValueError(
                f"mesh devices {[str(d) for d in devices]} are not of the "
                f"requested device type {kind!r}"
            )
    return devices


def pad_rows(arrays, k: int):
    """Zero-pad each array's leading axis to a multiple of ``k`` rows.

    Returns ``(padded, n)`` where ``n`` is the original row count; callers
    slice outputs back with ``out[:n]``.  Zero rows are cost-free under the
    kernels' domain, so padding never perturbs results.  ``None`` entries
    pass through.
    """
    ns = {np.shape(a)[0] for a in arrays if a is not None}
    if len(ns) != 1:
        raise ValueError(f"operands disagree on row count: {sorted(ns)}")
    (n,) = ns
    pad = (-n) % k
    if pad == 0:
        return tuple(arrays), n
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        block = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, block], axis=0))
    return tuple(out), n


def row_shard(mesh, body, arrays, device=None) -> np.ndarray:
    """Run ``body(dev, *blocks)`` once per mesh device on its contiguous
    block of every operand's leading axis and return the blocks' outputs
    concatenated in mesh order, as host numpy.

    Every leading axis must be a multiple of the mesh size (`pad_rows`);
    operands may differ in row count (the fused portfolio step's two
    halves), each splitting into ``k`` equal blocks of its own.  ``body``
    stages its blocks to ``dev``, launches, and returns the result as a
    tensor on ``dev`` without fetching it; every block is launched before
    the first ``.cpu()``.  ``device`` is the caller's, checked against the
    mesh (`mesh_devices`).
    """
    devices = mesh_devices(mesh, device)
    k = len(devices)
    sizes = []
    for a in arrays:
        n = 0 if a is None else int(np.shape(a)[0])
        if n % k:
            raise ValueError(f"{n} rows do not split into {k} blocks; pad_rows first")
        sizes.append(n // k)
    pending = [
        body(dev, *(
            None if a is None else a[i * b:(i + 1) * b]
            for a, b in zip(arrays, sizes)
        ))
        for i, dev in enumerate(devices)
    ]
    return np.concatenate([fetch(out) for out in pending], axis=0)


def fetch(out: torch.Tensor) -> np.ndarray:
    """``out`` on the host, as numpy: one ``.cpu()``, which waits for the
    device to finish the work before it (span ``ops.wait``)."""
    tok = obs.begin("ops.wait")
    host = out.cpu().numpy()
    obs.end(tok)
    return host


def run_rows(body, planes, device, mesh=None) -> np.ndarray:
    """One ops call over every row of ``planes`` (host arrays of one
    ``(..., T)`` shape): ``body(device, *planes)`` fetched with one
    ``.cpu()``, or, with a mesh, the planes flattened to ``(R, T)``,
    zero-padded, row-split with `row_shard` and the padding sliced off.
    Returns the ``(R,)`` outputs as host numpy."""
    tok = obs.begin("ops.call")
    if mesh is None:
        out = fetch(body(torch.device(device), *planes))
    else:
        t = np.shape(planes[0])[-1]
        padded, n = pad_rows([np.reshape(p, (-1, t)) for p in planes], mesh_size(mesh))
        out = row_shard(mesh, body, padded, device)[:n]
    obs.end(tok)
    return out
