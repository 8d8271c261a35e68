"""The chip's peaks and the least work each kernel call needs.

A kernel's roofline share is the least time the chip could take for the
calls it served, over the device time the calls took: the larger of the
bytes over the memory rate and the operations over their issue rate.  The
counting rule (as the port's own kernel table states it): every width
plane read once, since it says which slots are live; the heights and kinds
read at live slots only, since an empty slot costs nothing whatever it
holds; the int64 result written once; four integer operations a mode a
live slot (two ceiling divisions, a product, a minimum), on the slot's own
kind's mode table.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "memory_bytes_per_s": 3.35e12,
        # no integer rate is published: 132 SMs x 64 INT32 lanes x the
        # 1.98 GHz boost clock, one counted operation an instruction
        "int32_ops_per_s": 132 * 64 * 1.98e9,
    },
}


def peaks(device_name: str) -> dict:
    """The table's peaks for ``device_name``; a card it does not list has
    no roofline (KeyError)."""
    return PEAKS[device_name]


def least_seconds(n_bytes: float, n_ops: float, device_name: str) -> float:
    p = peaks(device_name)
    return max(n_bytes / p["memory_bytes_per_s"], n_ops / p["int32_ops_per_s"])


def _rows(x) -> np.ndarray:
    x = np.asarray(x)
    return x.reshape(-1, x.shape[-1])


def _n_modes(kwargs) -> int:
    """Modes of a one-kind call (the ops layers default to BRAM18's six)."""
    modes = kwargs.get("modes")
    return 6 if modes is None else len(modes)


def _kind_modes(kwargs) -> np.ndarray:
    return np.asarray([len(m) for _, m in kwargs["kind_tables"]], dtype=np.int64)


def fitness_work(args, kwargs):
    """Bytes and operations of one population-fitness call (K1 without a
    kind plane, K2 with one): ``(widths, heights)`` of shape ``(..., NB)``."""
    w = _rows(args[0])
    kinds = kwargs.get("kinds")
    live = w > 0
    n_live = int(live.sum())
    plane = 4 if kinds is None else 8
    n_bytes = 4 * w.size + plane * n_live + 8 * w.shape[0]
    n_ops = 4 * (_n_modes(kwargs) * n_live if kinds is None
                 else int(_kind_modes(kwargs)[_rows(kinds)][live].sum()))
    return dict(kernel="k2" if kinds is not None else "k1", bytes=n_bytes, ops=n_ops)


def sa_step_work(args, kwargs):
    """Bytes and operations of one SA delta step (K3 without kind planes,
    K4 with them): ``(old_w, old_h, new_w, new_h)`` of shape ``(..., T)``."""
    ow, nw = _rows(args[0]), _rows(args[2])
    ok, nk = kwargs.get("old_k"), kwargs.get("new_k")
    plane = 4 if ok is None else 8
    n_live = int((ow > 0).sum()) + int((nw > 0).sum())
    n_bytes = 4 * (ow.size + nw.size) + plane * n_live + 8 * ow.shape[0]
    if ok is None:
        n_ops = 4 * _n_modes(kwargs) * n_live
    else:
        lengths = _kind_modes(kwargs)
        n_ops = 4 * int(lengths[_rows(ok)][ow > 0].sum() + lengths[_rows(nk)][nw > 0].sum())
    return dict(kernel="k4" if ok is not None else "k3", bytes=n_bytes, ops=n_ops)


def roofline_pct(run, label: str, kernel: str, name_part: str):
    """Percent of the roofline: the summed least time of the calls of
    ``label`` that ran ``kernel``, over the device seconds of the kernels
    named ``name_part``; nothing where no such kernel was traced."""
    if run.trace is None:
        return None
    calls = [n for n in run.notes.get(label, ()) if n["kernel"] == kernel]
    dev_s, launches = run.trace.kernel_seconds(name_part)
    if not calls or dev_s <= 0:
        return None
    least = sum(least_seconds(n["bytes"], n["ops"], run.device_name) for n in calls)
    return 100.0 * least / dev_s
