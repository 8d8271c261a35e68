"""The full NFD pass and its kind assignment as compiled host loops
(``csrc/nfd_pass.c``).

`pack_order` packs a given order with Algorithm 1's admission rule and
returns the bins with their geometry rows, equal bit for bit to
`nfd.nfd_pack_order` followed by the first `Solution._refresh`, and moves
the generator on by exactly the draws that loop would take.
`assign_kinds` gives a packing's bins their RAM kinds on a bounded
multi-kind inventory, the body of `problem.greedy_assign_kinds`: the same
kinds as the reference's numpy loop, decision for decision, and the rows
`Solution._refresh` would compute for them.

The source compiles with the host's C compiler (``cc -O2 -shared -fPIC``)
into a library with a plain C interface, loaded with ``ctypes`` at first
use, never at import, by the port's loader (`repro_torch.native`,
``build/host/``, named by a hash of the source and the flags).  Where no
library is built and no C compiler is found, the first use raises.

Spans (`repro_torch.obs`): ``nfd.native.load`` (the first use: find, build
and load) and ``nfd.native.build`` (the compiler run inside it).  Counter:
``nfd.kinds.moves``, the moves `assign_kinds` made off the bins' cheapest
kinds (with two kinds, the bins it left off them), summed over calls.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .. import native, obs

SOURCE = Path(__file__).resolve().parent / "csrc" / "nfd_pass.c"
NATIVE = native.Libraries("nfd.native", native.CC, ("-std=c99", "-O2", "-shared", "-fPIC"),
                          native.BUILD_ROOT / "host")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "nfd_pass": [_I64, _P, _P, _P, _P, _I64, _P, _P, _I64, _I64, ctypes.c_int32,
                 ctypes.c_double, ctypes.c_double, _P, _I64, _P, _P, _P],
    "assign_kinds": [_I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _bind(cdll):
    fns = []
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = _I64
        fns.append(fn)
    return tuple(fns)


def library():
    """``(nfd_pass, assign_kinds)``, built and loaded at the first call
    (once, whichever threads ask at once).  Raises where no C compiler is
    found or the compiler fails."""
    return NATIVE.load(SOURCE, _bind)


def pack_order(prob, order: np.ndarray, rng: np.random.Generator, p_adm_w: float,
               p_adm_h: float, intra_layer: bool):
    """``(bins, geom)``: the pass over ``order`` (int64) as lists of buffer
    indices and their ``(len(bins), 6)`` int64 geometry rows on kind 0, with
    ``rng`` moved on as the Python loop moves it.  Raises ``TypeError`` for
    a generator that is not a numpy ``Generator`` and ``ValueError`` (``rng``
    untouched) for a mode size below 1."""
    if not isinstance(rng, np.random.Generator):
        raise TypeError(f"rng must be a numpy Generator, got {type(rng).__name__}")
    fn = library()[0]
    order = np.ascontiguousarray(order, dtype=np.int64)
    n = len(order)
    if order.ndim != 1 or (n and (order.min() < 0 or order.max() >= prob.n)):
        raise ValueError(f"order must be 1-D indices into the problem's {prob.n} buffers")
    # the draws the loop may take (at most two a buffer), read from the
    # stream and then given back: `random` never touches the generator's
    # buffered 32-bit half, and the state is restored whole before the
    # generator is moved on by the draws actually used
    state = rng.bit_generator.state
    uniforms = rng.random(2 * n)
    rng.bit_generator.state = state
    mode_w, mode_d = prob._kind_mode_w[0], prob._kind_mode_d[0]
    starts = np.empty(n + 1, dtype=np.int64)
    geom = np.empty((n, 6), dtype=np.int64)
    used = np.zeros(1, dtype=np.int64)
    nb = fn(
        n, order.ctypes.data, prob.widths.ctypes.data, prob.depths.ctypes.data,
        prob.layers.ctypes.data, len(mode_w), mode_w.ctypes.data, mode_d.ctypes.data,
        int(prob.kind_weights[0]), prob.max_items, int(bool(intra_layer)),
        float(p_adm_w), float(p_adm_h), uniforms.ctypes.data, len(uniforms),
        starts.ctypes.data, geom.ctypes.data, used.ctypes.data,
    )
    if nb == -1:
        raise ValueError(f"{prob.name}: a mode size below 1 on kind 0")
    if nb < 0:
        raise RuntimeError(f"nfd_pass failed with {nb}")
    if used[0]:
        rng.random(int(used[0]))
    flat = order.tolist()
    cuts = starts[: nb + 1].tolist()
    bins = [flat[a:b] for a, b in zip(cuts, cuts[1:])]
    return bins, geom[:nb]


def assign_kinds(prob, kinds: np.ndarray, geom: np.ndarray) -> int:
    """Give each bin its RAM kind, in place: ``kinds`` (int64, one a bin)
    and the unit-cost and primitive columns of ``geom`` (the bins'
    ``(len(kinds), 6)`` int64 rows, whose widths and heights it reads) on
    ``prob``'s inventory, as the reference's `greedy_assign_kinds` does.  Returns
    the moves made off the cheapest kinds, also added to the counter
    ``nfd.kinds.moves``.  Raises ``ValueError`` (nothing written) for
    arrays the C code cannot index by or a mode size below 1."""
    nb, nk = len(kinds), prob.n_kinds
    for a, shape in ((kinds, (nb,)), (geom, (nb, 6))):
        if (a.dtype != np.int64 or a.shape != shape or not a.flags.c_contiguous
                or not a.flags.writeable):
            raise ValueError(f"kinds and geom must be writable C-contiguous int64 arrays of "
                             f"shapes ({nb},) and ({nb}, 6)")
    fn = library()[1]
    n_modes = np.asarray([len(m) for m in prob._kind_mode_w], dtype=np.int64)
    mode_w = np.concatenate(prob._kind_mode_w)
    mode_d = np.concatenate(prob._kind_mode_d)
    table = np.empty(2 * nb * nk + nk, dtype=np.int64)
    regret = np.empty(nb * nk, dtype=np.float64)
    moves = fn(
        nb, nk, n_modes.ctypes.data, mode_w.ctypes.data, mode_d.ctypes.data,
        prob._kind_weights_arr.ctypes.data, prob._kind_counts_arr.ctypes.data,
        kinds.ctypes.data, geom.ctypes.data, table.ctypes.data, regret.ctypes.data,
    )
    if moves < 0:
        raise ValueError(f"{prob.name}: a mode size below 1")
    obs.count("nfd.kinds.moves", moves)
    return moves
