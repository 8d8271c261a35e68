"""The SA fleet step's host code as one compiled host loop (``csrc/sa_step.c``).

`fleet_step` binds a `_BlockState`'s arrays to the three C calls that make
the step body of `SimulatedAnnealingPacker._block_gen`: `FleetStep.propose`
(the moves from the step's uniform block), `FleetStep.gather` (the request
planes, and on a bounded inventory the usage change and penalty delta) and
`FleetStep.commit` (everything after the Metropolis mask).  State, planes,
penalty, counters and traces are equal bit for bit to the reference's numpy
body (`repro.core.sa`); the draws and the Metropolis compare stay in numpy.

The pointers are taken once, when the state is bound (a `_block_gen` call,
and again after the arrays the exchange rebinds), never per step.  The
library is built at first use by the port's loader (`repro_torch.native`,
``build/host/``, no FP contraction); ``ctypes.CDLL`` drops the interpreter
lock for each call, so a sharded fleet's threads overlap.  `fleet_step`
raises ``ValueError`` for an array that lacks the dtype, shape,
C-contiguity, writability or range the C code indexes by (a state restored
from a snapshot is input from outside the program), and ``RuntimeError``
where no library is built and no C compiler is found.

Spans (`repro_torch.obs`): ``sa.native.load`` (the first use: find, build
and load) and ``sa.native.build`` (the compiler run inside it).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .. import native

SOURCE = Path(__file__).resolve().parent / "csrc" / "sa_step.c"
NATIVE = native.Libraries(
    "sa.native", native.CC, ("-std=c99", "-O2", "-ffp-contract=off", "-shared", "-fPIC"),
    native.BUILD_ROOT / "host")

_I64, _F64, _P = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
_INTS = ("n_probs", "n_chains", "n_rows", "n_moves", "n_slots", "cap", "n_kinds", "n_u",
         "tab_len", "max_modes", "hetero", "intra_layer", "bounded", "float_pcosts", "ilam")
_FLOATS = ("p_kind", "lam")
_POINTERS = (
    "wtab", "dtab", "ltab", "caps_r", "kind_counts", "kind_weights", "n_modes", "mode_w",
    "mode_d", "items", "counts", "bw", "bh", "bk", "live", "costs", "stale", "steps", "uk",
    "pcosts", "best_pcosts", "up_prop", "up_acc", "gbest_pcost", "gbest_cost", "g_live",
    "g_uk", "g_items", "g_counts", "g_kinds", "u_all", "active", "tslots", "entry_ok",
    "bk_new", "flips", "applied", "snap_items", "snap_counts", "old_w", "old_h", "new_w",
    "new_h", "old_k", "new_k", "duk", "pen", "d_e", "accept", "improved",
)


class _Step(ctypes.Structure):
    """``Step`` of ``csrc/sa_step.c``, field for field."""

    _fields_ = ([(n, _I64) for n in _INTS] + [(n, _F64) for n in _FLOATS]
                + [(n, _P) for n in _POINTERS])


def _bind(cdll):
    fns = []
    for name in ("sa_propose", "sa_gather", "sa_commit"):
        fn = getattr(cdll, name)
        fn.argtypes = [_P]
        fn.restype = _I64
        fns.append(fn)
    return tuple(fns)


def library():
    """``(sa_propose, sa_gather, sa_commit)``, built and loaded at the first
    call (once, whichever threads ask at once).  Raises where no C compiler
    is found or the compiler fails."""
    return NATIVE.load(SOURCE, _bind)


class FleetStep:
    """One `_block_gen` call's step body in C over ``st``'s arrays.

    ``request`` is the step's ``(old_w, old_h, new_w, new_h, old_k, new_k)``
    (kind planes ``None`` on single-kind fleets): buffers written in place
    every step.  Build with `fleet_step`."""

    def __init__(self, fns, st, packer):
        self._propose, self._gather, self._commit = fns
        hetero = bool(st.hetero)
        R, P, C, M, K = st.n_rows, st.n_probs, packer.n_chains, st.n_moves, st.n_kinds
        NB, CAP = st.items.shape[1:]
        T = st.wtab.shape[-1]
        self.hetero, self.bounded = hetero, hetero and bool(st.any_bounded)
        prob = st.probs[0]
        n_modes = np.asarray([len(w) for w in prob._kind_mode_w[:K]], dtype=np.int64)
        mode_w = np.ones((K, int(n_modes.max())), dtype=np.int64)
        mode_d = np.ones_like(mode_w)
        for k in range(K):
            mode_w[k, : n_modes[k]] = prob._kind_mode_w[k]
            mode_d[k, : n_modes[k]] = prob._kind_mode_d[k]
        if (n_modes < 1).any() or (mode_w < 1).any() or (mode_d < 1).any():
            raise ValueError("a mode size below 1")
        # penalized costs: int64 on a single-kind fleet (they alias costs)
        # and under an integer penalty weight, else float64
        pc = np.dtype(np.int64) if not hetero else getattr(st.pcosts, "dtype", None)
        if pc not in (np.float64, np.int64):
            raise ValueError(f"pcosts: dtype {pc} (the helper takes float64 or int64)")
        lam = packer.inventory_penalty
        s = self._s = _Step(
            n_probs=P, n_chains=C, n_rows=R, n_moves=M, n_slots=NB, cap=CAP, n_kinds=K,
            n_u=st.n_u, tab_len=T, max_modes=mode_w.shape[1], hetero=int(hetero),
            intra_layer=int(bool(packer.intra_layer)), bounded=int(self.bounded),
            float_pcosts=int(pc == np.float64), ilam=0 if pc == np.float64 else int(lam),
            p_kind=float(packer.p_kind) if hetero else 0.0, lam=float(lam))
        i32, i64 = np.int32, np.int64
        tab = (np.int64, (T,) if P == 1 else (P, T))
        self._spec = dict(
            wtab=tab, dtab=tab, ltab=tab, caps_r=(i64, (R,)), kind_counts=(i64, (P, K)),
            kind_weights=(i64, (K,)), n_modes=(i64, (K,)), mode_w=(i64, mode_w.shape),
            mode_d=(i64, mode_w.shape), items=(i32, (R, NB, CAP)), counts=(i32, (R, NB)),
            bw=(i32, (R, NB)), bh=(i32, (R, NB)), bk=(i32, (R, NB)), live=(i64, (R,)),
            costs=(i64, (R,)), stale=(i64, (R,)), steps=(i64, (R,)), uk=(i64, (R, K)),
            pcosts=(pc, (R,)), best_pcosts=(pc, (R,)), up_prop=(i64, (P,)),
            up_acc=(i64, (P,)), gbest_pcost=(pc, (P,)), gbest_cost=(i64, (P,)),
            g_live=(i64, (P,)), g_uk=(i64, (P, K)), g_items=(i32, (P, NB, CAP)),
            g_counts=(i32, (P, NB)), g_kinds=(i32, (P, NB)),
            u_all=(np.float64, (P, M, st.n_u, C)), tslots=(i64, (R, 2 * M)),
            entry_ok=(np.bool_, (R, 2 * M)),
        )
        self._keep = {}  # every array the struct points at
        z = np.zeros
        # scratch: a step's inputs, snapshots and outputs, allocated once
        self.active, self.accept = z(R, dtype=np.bool_), z(R, dtype=np.bool_)
        self.d_e, self.pen, self.improved = z(R, dtype=i64), z(R, dtype=pc), z(P, dtype=i64)
        plane = lambda: z((R, 2 * M), dtype=i32)  # noqa: E731
        self.request = (plane(), plane(), plane(), plane(),
                        plane() if hetero else None, plane() if hetero else None)
        self._raw(dict(zip(("old_w", "old_h", "new_w", "new_h", "old_k", "new_k"),
                           self.request)))
        self._raw(dict(active=self.active, accept=self.accept, d_e=self.d_e, pen=self.pen,
                       improved=self.improved, duk=z((R, K), dtype=i64),
                       flips=z((R, M), dtype=i64), applied=z((R, M), dtype=np.bool_),
                       snap_items=z((R, M, 2, CAP), dtype=i32),
                       snap_counts=z((R, M, 2), dtype=i32),
                       bk_new=z((R, NB), dtype=i32) if hetero else None))
        self.bind(
            wtab=st.wtab, dtab=st.dtab, ltab=st.ltab, caps_r=st.caps_r,
            kind_counts=st.batch.kind_counts, kind_weights=st.batch.kind_weights,
            n_modes=n_modes, mode_w=mode_w, mode_d=mode_d, items=st.items,
            counts=st.counts, bw=st.bw, bh=st.bh, live=st.live, costs=st.costs,
            stale=st.stale, steps=st.steps, pcosts=st.pcosts, best_pcosts=st.best_pcosts,
            up_prop=st.up_prop, up_acc=st.up_acc, gbest_pcost=st.gbest_pcost,
            gbest_cost=st.gbest_cost, g_live=st.g_live, g_items=st.g_items,
            g_counts=st.g_counts, u_all=st.u_all, tslots=st.tslots, entry_ok=st.entry_ok,
            **(dict(bk=st.bk, uk=st.UK, g_kinds=st.g_kinds, g_uk=st.g_UK) if hetero else {}))
        # the C code indexes by these values: a chain's slots, counts and ids
        if not (0 <= st.live.min() and st.live.max() <= NB
                and 0 <= st.counts.min() and st.counts.max() <= CAP
                and st.caps_r.max() <= CAP
                and -1 <= st.items.min() and st.items.max() < T):
            raise ValueError("items, counts or live: a chain's slots, counts or items "
                             "are out of range")
        self._addr = ctypes.addressof(s)

    def _raw(self, arrays: dict) -> None:
        for name, arr in arrays.items():
            self._keep[name] = arr
            setattr(self._s, name, None if arr is None else arr.ctypes.data)

    def bind(self, **arrays) -> None:
        """Point the struct at these arrays (named as its fields: the loop
        rebinds ``items``, ``counts``, ``bw``, ``bh``, ``live``, ``pcosts``
        and ``bk`` at an exchange); raises ``ValueError`` naming one that
        lacks the dtype, shape, C-contiguity or writability the helper
        needs."""
        for name, arr in arrays.items():
            dtype, shape = self._spec[name]
            if not isinstance(arr, np.ndarray):
                raise ValueError(f"{name}: expected a numpy array, got {type(arr).__name__}")
            if arr.dtype != dtype or arr.shape != shape:
                raise ValueError(f"{name}: {arr.dtype}{list(arr.shape)} where the helper "
                                 f"takes {np.dtype(dtype)}{list(shape)}")
            if not (arr.flags.c_contiguous and arr.flags.writeable):
                raise ValueError(f"{name}: not a C-contiguous writable array")
        costs = arrays.get("costs", self._keep.get("costs"))
        if not self.hetero and "pcosts" in arrays and arrays["pcosts"] is not costs:
            raise ValueError("pcosts: must alias costs on a single-kind fleet")
        self._raw(arrays)
        if "bk" in arrays:
            np.copyto(self._keep["bk_new"], arrays["bk"])

    def propose(self) -> None:
        """The moves of every row (after ``u_all`` and ``active`` are
        filled)."""
        self._propose(self._addr)

    def gather(self) -> None:
        """Fill ``request`` (and on a bounded inventory ``pen``)."""
        self._gather(self._addr)

    def deltas(self, d_e) -> np.ndarray:
        """Take the delta call's answer; the annealed delta (``d_e + pen``
        on a bounded inventory, else ``d_e``)."""
        np.copyto(self.d_e, d_e)
        return self.d_e + self.pen if self.bounded else self.d_e

    def commit(self, accept) -> list[int]:
        """Roll back, commit and keep the books for the mask ``accept``;
        the problems whose best improved, ascending."""
        np.copyto(self.accept, accept)
        n = self._commit(self._addr)
        return self.improved[:n].tolist() if n else []


def fleet_step(st, packer) -> FleetStep:
    """The compiled step over ``st``'s arrays.  Raises ``ValueError`` where
    an array does not fit it and ``RuntimeError`` where the library cannot
    be built."""
    return FleetStep(library(), st, packer)
