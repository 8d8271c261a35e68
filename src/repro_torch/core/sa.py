"""Simulated-annealing memory packer — Algorithm 3 of the paper, scaled out.

SA-S reproduces Vasiljevic & Chow's MPack approach (buffer-swap
perturbation); SA-NFD replaces the perturbation with the paper's Next-Fit
Dynamic repack.  Temperature follows a Lundy-Mees schedule
``T = T0 / (1 + Rc * iter)`` parameterized by the paper's Table 2 (T0, Rc);
acceptance of uphill moves is Metropolis: ``P_A = exp(-dE / T)``.

The port's copy of ``repro.core.sa``: the host code is the reference's, so
every RNG draw happens in the reference's order, and only the delta-cost
call goes through the port's kernels.  Three engines share this class:

* The **scalar loop** (always for the NFD perturbation, whose repack is
  inherently sequential Python): one chain, one full ``Solution`` copy per
  proposed move.
* The **single-chain delta engine** (``n_chains=1``, swap perturbation):
  moves are applied to the incumbent *in place* with an undo log, and only
  the touched bins' before/after geometry goes through
  ``kernels.binpack_sa_step`` — one ``(1, 2 * swap_moves)`` call per
  iteration.  It consumes its ``np.random.Generator`` in exactly the scalar
  loop's order (the Metropolis uniform drawn only for uphill moves) and
  compares against float64 ``math.exp``.
* The **vectorized multi-chain engine** (``n_chains=C > 1``): chain state
  lives in padded ``(C, NB, max_items)`` item matrices plus ``(C, NB)``
  geometry matrices, and the whole step — move generation from one uniform
  block, move application, one ``(C, 2 * swap_moves)`` delta-cost call,
  Metropolis acceptance, rollback of rejected chains — runs over all chains
  at once: the moves, the touched slots' geometry and the commit in one
  compiled host loop (`sa_native`, ``csrc/sa_step.c``, equal bit for bit
  to the reference's numpy body), the draws and the float64 Metropolis
  compare in numpy.  Chains form a temperature ladder
  (`_chain_t0s`) with periodic best-chain exchange.  The engine is a
  *fleet* core (`_anneal_block`, P problems x C chains); a single-problem
  run is ``P == 1``.

Every engine keeps its loop state in a run object (`_BlockState` /
`_ScalarRun` / `_SingleChainRun`) created by a ``_start`` helper, advanced
by a ``_run`` helper that accepts an iteration barrier (``it_limit``), and
closed by a ``_finish`` helper.

Backends (``backend=``, resolved against ``device``): ``python`` computes
deltas in host numpy, ``torch`` with the plain PyTorch version on
``device``, ``cuda`` with the kernels K3 / K4.  Delta costs are exact
integers in every backend, so the backend can never fork a trajectory.

On heterogeneous OCM problems every engine anneals the inventory-penalized
cost: with probability ``p_kind`` a move is a RAM-kind flip of a random bin
(scalar loop + single-chain engine share the draw inside
``apply_swap_moves``; the multi-chain engine widens its uniform block from
4 to 6 rows), the delta step routes per-slot kind lanes through the
per-kind mode tables of ``binpack_sa_step``, and the penalty delta comes
from exact per-kind primitive bookkeeping.  Single-kind problems take none
of these branches.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np

from .. import obs
from ..device import check_backend, resolve_backend, resolve_device
# imported here, on the importing thread, never first on an island or
# shard thread (two threads importing kernel packages can deadlock on
# their module locks); called through the module, so patches apply
from ..kernels.binpack_sa_step import ops as sa_ops
from . import sa_native
from .ga import (
    apply_swap_moves,
    buffer_swap,
    kind_reassign,
    undo_swap_moves,
)
from .nfd import nfd_from_scratch, nfd_repack
from .problem import (
    DEFAULT_INVENTORY_PENALTY,
    PackingProblem,
    PackingResult,
    Solution,
    decode_chain_items,
    encode_chain_geometry,
    encode_chain_items,
    encode_chain_kinds,
    encode_problem_batch,
)


@dataclasses.dataclass
class _BlockOut:
    """Per-problem outcome of one `_anneal_block` fleet run."""

    best: Solution
    best_cost: int
    trace: list
    iterations: int
    uphill: tuple[int, int]
    wall: float
    # (problem, items, counts, kinds, pcosts) views of the problem's chain
    # rows; decoded only when `chains` / `incumbent` are read
    rows: tuple = dataclasses.field(default=(), repr=False)

    @property
    def chains(self) -> list[Solution]:
        prob, items, counts, kinds, _ = self.rows
        return [
            decode_chain_items(
                prob, items[c], counts[c], None if kinds is None else kinds[c]
            )
            for c in range(len(counts))
        ]

    @property
    def incumbent(self) -> int:
        """Index of the chain holding the best incumbent state."""
        return int(self.rows[4].argmin())


class _BlockState:
    """Resumable state of one `_anneal_block` fleet (P problems x C chains):
    built by `_block_start`, advanced by `_block_run` (optionally only up to
    an iteration barrier), decoded by `_block_finish`.

    ``CODEC_*`` is the serialization contract consumed by ``core.resume``,
    field for field the reference's (so a snapshot written by either
    package restores in the other): array fields land in a checkpoint's
    ``arrays.npz``, scalar fields (plus RNG bit-generator states and
    traces, handled by the codec) in its JSON manifest.  Scratch buffers
    refilled every step (``tslots``/``entry_ok``/``u_all``/``u_metro``),
    start-derived constants (tables, ladders, row maps) and the problems
    themselves are rebuilt by `_block_start` and never serialized.
    """

    done: bool = False      # budget/wall exhausted or every problem frozen
    frozen: bool = False    # every problem past patience (subset of done)

    CODEC_ARRAYS = (
        "items", "counts", "bw", "bh", "live", "costs", "best_pcosts",
        "stale", "steps", "gbest_pcost", "gbest_cost", "g_items",
        "g_counts", "g_live", "up_prop", "up_acc",
    )
    CODEC_ARRAYS_HETERO = ("pcosts", "bk", "UK", "g_kinds", "g_UK")
    CODEC_SCALARS = ("it", "done", "frozen")


class _ScalarRun:
    """Resumable state of the scalar SA loop (one chain, Solution copies).

    ``CODEC_*``: the ``core.resume`` contract (see `_BlockState`);
    ``sol``/``best`` serialize as bins + kind lanes, with geometry caches
    rebuilt cold on restore.
    """

    done: bool = False

    CODEC_SCALARS = ("cost", "ovf", "best_cost", "best_ovf", "it", "stale",
                     "done")
    CODEC_SOLUTIONS = ("sol", "best")


class _SingleChainRun:
    """Resumable state of the single-chain delta engine.

    ``CODEC_*``: the ``core.resume`` contract (see `_BlockState`).  The
    geometry rows (``chain_w``/``chain_h``/``chain_k``) and primitive usage
    (``used``) are derived from ``sol`` on restore; the ``undo`` log and
    delta scratch rows are per-iteration transients, and barriers always
    fall between iterations.
    """

    done: bool = False

    CODEC_SCALARS = ("cost", "ovf", "best_cost", "best_ovf", "uphill_prop",
                     "uphill_acc", "it", "stale", "done")
    CODEC_SOLUTIONS = ("sol", "best")


class SimulatedAnnealingPacker:
    def __init__(
        self,
        perturbation: str = "nfd",  # "nfd" (SA-NFD) or "swap" (SA-S)
        t0: float = 30.0,
        rc: float = 1.0,
        p_adm_w: float = 0.0,
        p_adm_h: float = 0.1,
        nfd_threshold: float = 0.95,
        nfd_extra_frac: float = 0.01,
        nfd_max_bins: int = 8,
        swap_moves: int = 2,
        intra_layer: bool = False,
        max_seconds: float = 60.0,
        max_iterations: int = 2_000_000,
        patience: int = 20_000,
        seed: int = 0,
        n_chains: int = 1,
        backend: str = "auto",
        exchange_every: int = 256,
        ladder_min: float = 0.25,
        ladder_max: float = 4.0,
        p_kind: float = 0.15,
        inventory_penalty: float = DEFAULT_INVENTORY_PENALTY,
        device=None,
    ):
        if perturbation not in ("nfd", "swap"):
            raise ValueError(f"unknown perturbation {perturbation!r}")
        check_backend(backend)
        if n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        self.__dict__.update(locals())
        del self.__dict__["self"]
        self.device = resolve_device(device)
        self._hetero = False  # set per problem in pack()
        # warm state of the last pack() for the thread-pool portfolio's
        # restarts: a chain list, or the fleet result whose chains decode
        # on first read (`last_chains_`)
        self._warm = None

    @property
    def name(self) -> str:
        base = "SA-NFD" if self.perturbation == "nfd" else "SA-S"
        if self.perturbation == "swap" and self.n_chains > 1:
            base += f"x{self.n_chains}"
        return base

    def _resolve_backend(self) -> str:
        return resolve_backend(self.backend, self.device)

    @property
    def last_chains_(self) -> list[Solution] | None:
        """One warm incumbent a chain from the last `pack()` (None before
        the first)."""
        warm = self._warm
        return warm if warm is None or isinstance(warm, list) else warm.chains

    def _perturb(self, sol: Solution, rng: np.random.Generator) -> Solution:
        if self.perturbation == "nfd":
            # heterogeneous OCM: a fraction of NFD perturbations reassign RAM
            # kinds instead (no RNG draw at all on single-kind problems)
            if self._hetero and rng.random() < self.p_kind:
                return kind_reassign(sol, rng)
            return nfd_repack(
                sol,
                rng,
                threshold=self.nfd_threshold,
                p_adm_w=self.p_adm_w,
                p_adm_h=self.p_adm_h,
                intra_layer=self.intra_layer,
                extra_frac=self.nfd_extra_frac,
                max_bins=self.nfd_max_bins,
            )
        return buffer_swap(
            sol, rng, n_moves=self.swap_moves, intra_layer=self.intra_layer,
            p_kind=self.p_kind if self._hetero else 0.0,
        )

    def pack(
        self,
        prob: PackingProblem,
        init: Solution | Sequence[Solution] | None = None,
    ) -> PackingResult:
        """Anneal from scratch, or warm-start from ``init``.

        ``init`` may be a single solution or a per-chain list (extra chains
        start from fresh NFD packings).  The NFD perturbation always runs
        the scalar loop (its repack is sequential Python); for the swap
        perturbation the backend selects the engine, ``legacy`` being the
        scalar loop.
        """
        self._hetero = prob.n_kinds > 1
        if self.perturbation == "nfd" or self._resolve_backend() == "legacy":
            return self._pack_scalar(prob, init)
        if self.n_chains == 1:
            return self._pack_single_chain(prob, init, self._resolve_backend())
        return self._pack_multi_chain(prob, init, self._resolve_backend())

    # ------------------------------------------------------------ scalar loop
    def _pack_scalar(self, prob: PackingProblem, init) -> PackingResult:
        """The seed's serial annealer (one chain, one Solution copy per
        move)."""
        st = self._scalar_start(prob, init)
        self._scalar_run(st)
        return self._scalar_finish(st)

    def _scalar_start(
        self, prob: PackingProblem, init, rng: np.random.Generator | None = None
    ) -> _ScalarRun:
        if init is not None and not isinstance(init, Solution):
            init = init[0] if len(init) else None
        st = _ScalarRun()
        st.prob = prob
        st.rng = rng if rng is not None else np.random.default_rng(self.seed)
        st.t_start = time.perf_counter()
        sol = init.copy() if init is not None else nfd_from_scratch(
            prob,
            st.rng,
            p_adm_w=self.p_adm_w,
            p_adm_h=self.p_adm_h,
            intra_layer=self.intra_layer,
        )
        st.hetero = self._hetero
        st.lam = self.inventory_penalty
        st.sol = sol
        st.cost = sol.cost()
        st.ovf = sol.inventory_overflow() if st.hetero else 0
        st.best, st.best_cost, st.best_ovf = sol.copy(), st.cost, st.ovf
        # hetero traces record the penalized cost (the annealed quantity) so
        # the curve stays monotone; raw == penalized on single-kind problems
        st.trace = [(time.perf_counter() - st.t_start,
                     st.best_cost + st.lam * st.best_ovf if st.hetero
                     else st.best_cost)]
        st.it = 0
        st.stale = 0
        st.done = False
        return st

    def _scalar_run(self, st: _ScalarRun, it_limit: int | None = None) -> None:
        """Advance until ``it_limit`` (a barrier), the iteration / patience
        budget, or the wall cap; pausing at a barrier and resuming is
        bit-identical to one uninterrupted run."""
        limit = (
            self.max_iterations if it_limit is None
            else min(self.max_iterations, it_limit)
        )
        hetero, lam, rng = st.hetero, st.lam, st.rng
        while st.it < limit and st.stale < self.patience:
            if (st.it & 0xFF) == 0 and (
                time.perf_counter() - st.t_start > self.max_seconds
            ):
                st.done = True
                return
            temp = self.t0 / (1.0 + self.rc * st.it)
            cand = self._perturb(st.sol, rng)
            cand_cost = cand.cost()
            # the annealed energy is the inventory-penalized cost; the two
            # int deltas are kept separate so the single-kind path stays in
            # exact integer arithmetic (d_e is then just the cost delta)
            d_e = cand_cost - st.cost
            if hetero:
                cand_ovf = cand.inventory_overflow()
                d_e = d_e + lam * (cand_ovf - st.ovf)
            else:
                cand_ovf = 0
            if d_e < 0 or (temp > 0 and rng.random() < math.exp(-d_e / temp)):
                st.sol, st.cost, st.ovf = cand, cand_cost, cand_ovf
            if hetero:
                improved = (st.cost - st.best_cost) + lam * (st.ovf - st.best_ovf) < 0
            else:
                improved = st.cost < st.best_cost
            if improved:
                st.best, st.best_cost, st.best_ovf = st.sol.copy(), st.cost, st.ovf
                st.trace.append((time.perf_counter() - st.t_start,
                                 st.best_cost + lam * st.best_ovf if hetero
                                 else st.best_cost))
                st.stale = 0
            else:
                st.stale += 1
            st.it += 1
        if st.it >= self.max_iterations or st.stale >= self.patience:
            st.done = True

    def _scalar_finish(self, st: _ScalarRun) -> PackingResult:
        # the trace holds the monotone improvement curve only; the run's end
        # lives in wall_time_s (the seed appended a duplicate terminal tuple)
        wall = time.perf_counter() - st.t_start
        self._warm = [st.sol]
        return self._result(
            st.best, int(st.best_cost), wall, st.trace, st.it, "legacy",
            uphill=None,
        )

    def _scalar_migrate(self, st: _ScalarRun, sol: Solution) -> bool:
        """Portfolio barrier hook: the migrant replaces the incumbent iff it
        strictly beats its penalized cost.  A finished run is never touched
        and ``stale`` is never reset, so migration cannot revive a frozen
        island (it stops drawing RNG exactly where a standalone run would).
        """
        if st.done or st.stale >= self.patience:
            return False
        lam = self.inventory_penalty
        cost = sol.cost()
        ovf = sol.inventory_overflow() if st.hetero else 0
        if cost + lam * ovf >= st.cost + lam * st.ovf:
            return False
        st.sol = sol.copy()
        st.cost = cost
        st.ovf = ovf
        # fold the migrant into the patience-reference best (no trace entry,
        # no stale reset): otherwise the next improved-check would treat the
        # migrant as this island's own discovery and revive its patience —
        # the same suppression `_block_migrate` does via best_pcosts
        if cost + lam * ovf < st.best_cost + lam * st.best_ovf:
            st.best, st.best_cost, st.best_ovf = st.sol.copy(), cost, ovf
        return True

    # ----------------------------------------------- single-chain delta engine
    def _pack_single_chain(self, prob: PackingProblem, init, backend):
        """One chain, in-place moves + undo, fused delta-cost evaluation.

        Bit-identical to the reference's scalar loop for the same seed: same RNG stream
        (scalar per-move draws, Metropolis uniform only on uphill moves),
        same float64 ``math.exp`` compare, exact integer deltas.
        """
        st = self._single_start(prob, init, backend)
        self._single_run(st)
        return self._single_finish(st)

    def _single_start(
        self, prob: PackingProblem, init, backend,
        rng: np.random.Generator | None = None,
    ) -> _SingleChainRun:
        st = _SingleChainRun()
        st.prob = prob
        st.backend = backend
        st.rng = rng if rng is not None else np.random.default_rng(self.seed)
        st.t_start = time.perf_counter()
        if init is not None and not isinstance(init, Solution):
            init = init[0] if len(init) else None
        sol = init.copy() if init is not None else nfd_from_scratch(
            prob,
            st.rng,
            p_adm_w=self.p_adm_w,
            p_adm_h=self.p_adm_h,
            intra_layer=self.intra_layer,
        )
        st.sol = sol
        st.hetero = self._hetero
        st.lam = self.inventory_penalty
        st.pk = self.p_kind if st.hetero else 0.0
        st.kt = prob.kind_tables if st.hetero else None
        st.modes0 = prob.kind_tables[0][1]  # == BRAM18_MODES on default problems
        st.cost = int(sol.cost())
        st.chain_w = np.zeros((1, prob.n), dtype=np.int32)
        st.chain_h = np.zeros_like(st.chain_w)
        sol.fill_geometry(st.chain_w[0], st.chain_h[0])
        if st.hetero:
            st.chain_k = np.zeros((1, prob.n), dtype=np.int32)
            sol.fill_kinds(st.chain_k[0])
            st.used = sol.used_primitives()
            st.ovf = int(prob.overflow_units(st.used))
        else:
            st.chain_k = None
            st.used = None
            st.ovf = 0
        st.best, st.best_cost, st.best_ovf = sol.copy(), st.cost, st.ovf
        st.trace = [(time.perf_counter() - st.t_start,
                     st.best_cost + st.lam * st.best_ovf if st.hetero
                     else st.best_cost)]
        width = 2 * max(self.swap_moves, 1)
        st.old_w = np.zeros((1, width), dtype=np.int32)
        st.old_h = np.zeros_like(st.old_w)
        st.new_w = np.zeros_like(st.old_w)
        st.new_h = np.zeros_like(st.old_w)
        st.old_k = np.zeros_like(st.old_w) if st.hetero else None
        st.new_k = np.zeros_like(st.old_w) if st.hetero else None
        st.undo = []
        st.uphill_prop = 0
        st.uphill_acc = 0
        st.it = 0
        st.stale = 0
        st.done = False
        return st

    def _single_run(self, st: _SingleChainRun, it_limit: int | None = None) -> None:
        limit = (
            self.max_iterations if it_limit is None
            else min(self.max_iterations, it_limit)
        )
        prob, sol, rng = st.prob, st.sol, st.rng
        hetero, lam, pk, kt, modes0 = st.hetero, st.lam, st.pk, st.kt, st.modes0
        backend, device = st.backend, self.device
        chain_w, chain_h, chain_k = st.chain_w, st.chain_h, st.chain_k
        old_w, old_h = st.old_w, st.old_h
        new_w, new_h = st.new_w, st.new_h
        old_k, new_k = st.old_k, st.new_k
        undo = st.undo
        while st.it < limit and st.stale < self.patience:
            if (st.it & 0xFF) == 0 and (
                time.perf_counter() - st.t_start > self.max_seconds
            ):
                st.done = True
                return
            temp = self.t0 / (1.0 + self.rc * st.it)
            # --- propose in place (legacy RNG stream; kind moves only when
            # the problem is heterogeneous, matching the scalar loop)
            undo.clear()
            tset: set[int] = set()
            apply_swap_moves(
                sol, rng, n_moves=self.swap_moves,
                intra_layer=self.intra_layer, undo=undo, touched=tset,
                p_kind=pk,
            )
            tl = sorted(tset)
            k = len(tl)
            old_w[0] = 0
            old_h[0] = 0
            new_w[0] = 0
            new_h[0] = 0
            if k:
                old_w[0, :k] = chain_w[0, tl]
                old_h[0, :k] = chain_h[0, tl]
                ws, hs = sol.scan_bin_geometry(tl)
                new_w[0, :k] = ws
                new_h[0, :k] = hs
            if hetero:
                old_k[0] = 0
                new_k[0] = 0
                if k:
                    old_k[0, :k] = chain_k[0, tl]
                    new_k[0, :k] = sol.kinds[tl]
                d_cost = int(
                    sa_ops.sa_step_deltas(
                        old_w, old_h, new_w, new_h, backend=backend,
                        old_k=old_k, new_k=new_k, kind_tables=kt, device=device,
                    )[0]
                )
                # inventory-penalty delta from the touched bins' primitive
                # usage (exact integer bookkeeping, O(touched) cache hits)
                if prob._any_bounded:
                    used2 = st.used.copy()
                    for t in range(k):
                        if old_w[0, t] > 0:
                            used2[old_k[0, t]] -= prob.bin_primitives(
                                int(old_w[0, t]), int(old_h[0, t]), int(old_k[0, t])
                            )
                        if new_w[0, t] > 0:
                            used2[new_k[0, t]] += prob.bin_primitives(
                                int(new_w[0, t]), int(new_h[0, t]), int(new_k[0, t])
                            )
                    ovf2 = int(prob.overflow_units(used2))
                else:
                    used2, ovf2 = st.used, 0  # unbounded inventory never overflows
                d_e = d_cost + lam * (ovf2 - st.ovf)
            else:
                d_cost = int(
                    sa_ops.sa_step_deltas(
                        old_w, old_h, new_w, new_h, modes=modes0,
                        backend=backend, device=device,
                    )[0]
                )
                d_e = d_cost
            # --- Metropolis: the uniform is drawn only for uphill moves
            if d_e > 0:
                st.uphill_prop += 1
            if d_e < 0 or (temp > 0 and rng.random() < math.exp(-d_e / temp)):
                if d_e > 0:
                    st.uphill_acc += 1
                st.cost += d_cost
                if hetero:
                    st.used, st.ovf = used2, ovf2
                if tl:
                    sol.touch(*tl)
                    bins = sol.bins
                    if any(not bins[b] for b in tl):
                        sol.drop_empty()
                        sol.fill_geometry(chain_w[0], chain_h[0])
                        if hetero:
                            sol.fill_kinds(chain_k[0])
                    else:
                        chain_w[0, tl] = new_w[0, :k]
                        chain_h[0, tl] = new_h[0, :k]
                        if hetero:
                            chain_k[0, tl] = new_k[0, :k]
            else:
                undo_swap_moves(sol, undo)
            if hetero:
                improved = (st.cost - st.best_cost) + lam * (st.ovf - st.best_ovf) < 0
            else:
                improved = st.cost < st.best_cost
            if improved:
                st.best, st.best_cost, st.best_ovf = sol.copy(), st.cost, st.ovf
                st.trace.append((time.perf_counter() - st.t_start,
                                 st.best_cost + lam * st.best_ovf if hetero
                                 else st.best_cost))
                st.stale = 0
            else:
                st.stale += 1
            st.it += 1
        if st.it >= self.max_iterations or st.stale >= self.patience:
            st.done = True

    def _single_finish(self, st: _SingleChainRun) -> PackingResult:
        wall = time.perf_counter() - st.t_start
        self._warm = [st.sol]
        return self._result(
            st.best, st.best_cost, wall, st.trace, st.it, st.backend,
            uphill=(st.uphill_prop, st.uphill_acc),
        )

    def _single_migrate(self, st: _SingleChainRun, sol: Solution) -> bool:
        """Portfolio barrier hook for the single-chain engine; same contract
        as `_scalar_migrate` (strictly-better only, frozen never revived)."""
        if st.done or st.stale >= self.patience:
            return False
        lam = self.inventory_penalty
        cost = int(sol.cost())
        ovf = int(sol.inventory_overflow()) if st.hetero else 0
        if cost + lam * ovf >= st.cost + lam * st.ovf:
            return False
        st.sol = sol.copy()
        st.cost = cost
        st.sol.fill_geometry(st.chain_w[0], st.chain_h[0])
        if st.hetero:
            st.sol.fill_kinds(st.chain_k[0])
            st.used = st.sol.used_primitives()
            st.ovf = int(st.prob.overflow_units(st.used))
        # patience-reference best absorbs the migrant (see _scalar_migrate)
        if cost + lam * st.ovf < st.best_cost + lam * st.best_ovf:
            st.best, st.best_cost, st.best_ovf = st.sol.copy(), cost, st.ovf
        return True

    # -------------------------------------------- vectorized multi-chain engine
    def _chain_t0s(self) -> np.ndarray:
        """Lundy-Mees T0 ladder: chain 0 at the configured T0 (single-chain
        parity), the rest log-spaced over [T0*ladder_min, T0*ladder_max]
        (a lone extra chain sits at the range's geometric mean)."""
        t0s = np.full(self.n_chains, float(self.t0))
        if self.n_chains == 2:
            t0s[1] = self.t0 * math.sqrt(self.ladder_min * self.ladder_max)
        elif self.n_chains > 2:
            t0s[1:] = self.t0 * np.geomspace(
                self.ladder_min, self.ladder_max, self.n_chains - 1
            )
        return t0s

    def _pack_multi_chain(self, prob, init, backend):
        """C temperature-laddered chains advanced in lock-step, all-numpy.

        A thin wrapper over the fleet engine `_anneal_block`: one problem,
        one RNG stream — the single-problem engine is literally ``P == 1``.
        """
        if init is None:
            inits: list[Solution] = []
        elif isinstance(init, Solution):
            inits = [init]
        else:
            inits = [s for s in init if s is not None][: self.n_chains]
        rng = np.random.default_rng(self.seed)
        out = self._anneal_block([prob], [rng], [inits], backend)[0]
        self._warm = out
        return self._result(
            out.best, out.best_cost, out.wall, out.trace, out.iterations,
            backend, uphill=out.uphill,
        )

    def _anneal_block(
        self,
        probs: Sequence[PackingProblem],
        rngs: Sequence[np.random.Generator],
        inits: Sequence[Sequence[Solution]],
        backend: str,
        mesh=None,
    ) -> list[_BlockOut]:
        """The vectorized annealer over a *fleet*: P problems x C chains.

        Every state matrix is laid out problem-major: row ``j * C + c`` is
        chain ``c`` of problem ``j``, padded to the fleet's common
        ``(NB, cap_max)`` envelope (`encode_problem_batch`).  Each problem
        consumes only its own ``rngs[j]`` stream — chain init first, then
        one uniform block plus one Metropolis block per step while the
        problem is live — so each problem's trajectory is bit-identical to
        a standalone ``n_chains=C`` run seeded the same way, and the
        single-problem engine is literally ``P == 1``.  A problem *freezes* (stops drawing RNG, stops moving)
        once every one of its chains exceeds ``patience``; the loop exits
        when all problems are frozen or the shared iteration/wall budget
        runs out.  Per-problem temperature ladders, best tracking, traces,
        and best-chain exchange stay independent; the delta-cost kernel and
        Metropolis rule run once over all ``P * C`` rows per step.

        Implemented as `_block_start` + `_block_run` + `_block_finish`;
        ``mesh`` row-shards every step's delta call (see `_block_start`).
        """
        st = self._block_start(probs, rngs, inits, backend, mesh=mesh)
        self._block_run(st)
        return self._block_finish(st)

    def _block_start(
        self,
        probs: Sequence[PackingProblem],
        rngs: Sequence[np.random.Generator],
        inits: Sequence[Sequence[Solution]],
        backend: str,
        n_slots: int | None = None,
        mesh=None,
        device=None,
    ) -> _BlockState:
        """Encode a fleet's chain state (no RNG draws beyond chain init);
        ``n_slots`` widens the bin-slot envelope (the portfolio passes
        ``prob.n`` so any migrant fits — envelope padding never affects
        trajectories).  ``mesh`` (a ``("prob",)`` sweep mesh) row-shards
        every step's delta call on the device backends; ``device`` (default
        ``self.device``) is the device this fleet's calls go to, so the
        shards of one packer, advanced on threads, each keep their own.
        Both are start-derived constants, never serialized: a snapshot may
        restore onto another mesh or shard count.  Spans: ``sa.start`` (the
        whole start, the chains' NFD passes in it) and ``sa.encode`` (the
        chains' encoding)."""
        tok = obs.begin("sa.start")
        st = _BlockState()
        st.mesh = mesh if backend in ("torch", "cuda") else None
        st.device = self.device if device is None else device
        n_probs = st.n_probs = len(probs)
        n_chains = self.n_chains
        n_rows = st.n_rows = n_probs * n_chains
        st.n_moves = max(self.swap_moves, 1)
        width = 2 * st.n_moves
        st.probs = list(probs)
        st.rngs = list(rngs)
        st.backend = backend
        batch = st.batch = encode_problem_batch(probs)
        hetero = st.hetero = batch.n_kinds > 1
        lam = self.inventory_penalty
        st.kt = batch.kind_tables if hetero else None
        st.modes0 = batch.kind_tables[0][1]  # == BRAM18_MODES on defaults
        st.n_kinds = batch.n_kinds
        st.cap_max = batch.cap_max
        st.any_bounded = bool((batch.kind_counts >= 0).any())
        st.t_start = time.perf_counter()

        # --- per-problem chain init: warm starts first, fresh NFD for the rest
        sols: list[Solution] = []
        for j, prob in enumerate(probs):
            mine = [s.copy() for s in inits[j][:n_chains]]
            mine += [
                nfd_from_scratch(
                    prob,
                    rngs[j],
                    p_adm_w=self.p_adm_w,
                    p_adm_h=self.p_adm_h,
                    intra_layer=self.intra_layer,
                    sort_by_width=(c % 2 == 1),
                )
                for c in range(len(mine), n_chains)
            ]
            sols.extend(mine)
        enc = obs.begin("sa.encode")
        st.items, st.counts = encode_chain_items(sols, st.cap_max, n_slots=n_slots)
        st.bw, st.bh, st.live = encode_chain_geometry(sols, st.items.shape[1])
        st.costs = np.asarray([s.cost() for s in sols], dtype=np.int64)

        st.pi = np.repeat(np.arange(n_probs), n_chains)  # row -> problem index
        st.caps_r = np.repeat(batch.max_items, n_chains)  # per-row cardinality
        # buffer lookup tables with a zero/empty sentinel in the last column;
        # a single-problem fleet keeps the flat 1-D tables (the hot path)
        wext, dext, lext = batch.ext_tables()
        if n_probs == 1:
            st.wtab, st.dtab, st.ltab = wext[0], dext[0], lext[0]
        else:
            st.wtab, st.dtab, st.ltab = wext, dext, lext
        st.sentinel = st.wtab.shape[-1] - 1

        if hetero:
            # per-chain RAM-kind lane + per-kind primitive usage (R, K)
            st.bk = encode_chain_kinds(sols, st.items.shape[1])
            st.UK = np.stack([s.used_primitives() for s in sols])
            st.pcosts = st.costs + lam * batch.overflow_rows(st.UK, st.pi)
        else:
            st.bk = None
            st.UK = None
            st.pcosts = st.costs
        obs.end(enc)

        st.best_pcosts = st.pcosts.copy()  # per-chain best (drives patience)
        st.poff = np.arange(n_probs) * n_chains
        gis = st.pcosts.reshape(n_probs, n_chains).argmin(axis=1) + st.poff
        st.gbest_pcost = st.pcosts[gis].copy()  # per-problem global best
        st.gbest_cost = st.costs[gis].copy()
        st.g_items = st.items[gis].copy()
        st.g_counts = st.counts[gis].copy()
        st.g_live = st.live[gis].copy()
        st.g_kinds = st.bk[gis].copy() if hetero else None
        st.g_UK = st.UK[gis].copy() if hetero else None
        # hetero traces record the penalized cost (monotone); raw otherwise
        now = time.perf_counter() - st.t_start
        st.traces = [
            [(now, float(st.gbest_pcost[j]) if hetero else int(st.gbest_cost[j]))]
            for j in range(n_probs)
        ]
        st.t0s = np.tile(self._chain_t0s(), n_probs)
        st.ri = np.arange(n_rows)
        st.stale = np.zeros(n_rows, dtype=np.int64)
        st.steps = np.zeros(n_rows, dtype=np.int64)
        st.tslots = np.zeros((n_rows, width), dtype=np.int64)
        st.entry_ok = np.zeros((n_rows, width), dtype=bool)
        st.up_prop = np.zeros(n_probs, dtype=np.int64)
        st.up_acc = np.zeros(n_probs, dtype=np.int64)
        st.n_u = 6 if hetero else 4
        st.u_all = np.zeros((n_probs, st.n_moves, st.n_u, n_chains))
        st.u_metro = np.zeros(n_rows)
        st.it = 0
        st.done = False
        st.frozen = False
        obs.end(tok)
        return st

    def _block_run(self, st: _BlockState, it_limit: int | None = None) -> None:
        """Advance the fleet until ``it_limit`` (a barrier), the iteration
        budget, the wall cap, or fleet-wide freezing — by driving
        `_block_gen` and answering every step request with one delta-cost
        call on ``st.device`` (row-sharded over ``st.mesh``).  All state
        lives in ``st``, so a barriered run is bit-identical to an
        uninterrupted one."""
        gen = self._block_gen(st, it_limit)
        req = next(gen, None)
        while req is not None:
            try:
                req = gen.send(self._block_eval(st, req))
            except StopIteration:
                break

    def _block_eval(self, st: _BlockState, req: tuple) -> np.ndarray:
        """Answer one `_block_gen` step request with one delta-cost call on
        ``st.device``, row-sharded over ``st.mesh`` (the portfolio's fused
        barrier answers the same requests through
        ``binpack_portfolio_step``)."""
        old_w, old_h, new_w, new_h, old_k, new_k = req
        if old_k is not None:
            return sa_ops.sa_step_deltas(
                old_w, old_h, new_w, new_h, backend=st.backend,
                old_k=old_k, new_k=new_k, kind_tables=st.kt,
                device=st.device, mesh=st.mesh,
            )
        return sa_ops.sa_step_deltas(
            old_w, old_h, new_w, new_h, modes=st.modes0,
            backend=st.backend, device=st.device, mesh=st.mesh,
        )

    def _block_gen(self, st: _BlockState, it_limit: int | None = None):
        """The fleet hot loop as a *step-request generator*.

        Yields one ``(old_w, old_h, new_w, new_h, old_k, new_k)`` touched-
        bin geometry request per annealing step (kind lanes are ``None`` on
        single-kind problems) and expects the ``(R,)`` int64 delta-cost
        vector back via ``send()`` — i.e. exactly the inputs and output of
        ``binpack_sa_step.ops.sa_step_deltas``.  Everything else (proposal,
        Metropolis, rollback/commit, best tracking, exchange) happens
        inside, so every consumer advances the *same* loop body and
        produces bit-identical trajectories.  Consumers must drain
        the generator to ``StopIteration`` so the rebound loop state is
        written back to ``st``.

        The moves, the planes and the commit run in C (`sa_native`) over
        ``st``'s arrays, bound once a call and again after an exchange
        rebinds them; the draws, the float64 Metropolis compare and the
        exchange stay in numpy.  A step is three spans (`repro_torch.obs`),
        each closed before the ``yield``: ``sa.propose`` (which chains are
        live, the draws and the moves), ``sa.gather`` (the touched slots'
        geometry, and on a bounded inventory the penalty delta),
        ``sa.accept`` (everything after the delta call)."""
        limit = (
            self.max_iterations if it_limit is None
            else min(self.max_iterations, it_limit)
        )
        n_probs, n_chains = st.n_probs, self.n_chains
        batch, rngs = st.batch, st.rngs
        hetero = st.hetero
        lam = self.inventory_penalty
        t_start = st.t_start
        wtab, dtab, sentinel = st.wtab, st.dtab, st.sentinel
        poff, t0s = st.poff, st.t0s
        u_all, u_metro = st.u_all, st.u_metro
        traces = st.traces
        gbest_pcost, gbest_cost = st.gbest_pcost, st.gbest_cost
        g_items, g_counts, g_live = st.g_items, st.g_counts, st.g_live
        g_kinds, g_UK, UK = st.g_kinds, st.g_UK, st.UK
        costs, best_pcosts, stale = st.costs, st.best_pcosts, st.stale
        # rebound by the exchange — written back to st on every exit
        items, counts = st.items, st.counts
        bw, bh, live, bk = st.bw, st.bh, st.live, st.bk
        pcosts = st.pcosts
        it = st.it
        nat = sa_native.fleet_step(st, self)

        while it < limit:
            if (it & 0xFF) == 0 and time.perf_counter() - t_start > self.max_seconds:
                st.done = True
                break
            tok = obs.begin("sa.propose")
            active = np.less(stale, self.patience, out=nat.active)
            act_p = active.reshape(n_probs, n_chains).any(axis=1)
            if not act_p.any():
                obs.end(tok)
                st.frozen = True
                st.done = True
                break
            # --- propose: each live problem draws one uniform block from its
            # own stream (two extra rows — kind-move gate and kind pick —
            # only on heterogeneous problems, so the single-kind block and
            # its trajectories are untouched); frozen problems draw nothing
            # and their rows stay masked by ``active``
            for j in np.flatnonzero(act_p):
                rngs[j].random(out=u_all[j])  # (n_moves, n_u, n_chains)
            nat.propose()
            obs.end(tok)
            tok = obs.begin("sa.gather")
            nat.gather()
            obs.end(tok)
            d_e = yield nat.request
            tok = obs.begin("sa.accept")
            d_tot = nat.deltas(d_e)
            # --- Metropolis acceptance: per-problem draws, one batched rule
            temps = t0s / (1.0 + self.rc * it)
            for j in np.flatnonzero(act_p):
                lo = j * n_chains
                rngs[j].random(out=u_metro[lo : lo + n_chains])
            accept = sa_ops.metropolis_mask(d_tot, temps, u_metro) & active
            for j in nat.commit(accept):
                traces[j].append((
                    time.perf_counter() - t_start,
                    float(gbest_pcost[j]) if hetero else int(gbest_cost[j]),
                ))
            # --- periodic per-problem best-chain exchange + compaction
            # (gated on the loop-top activity mask: a frozen problem's
            # standalone run has already exited its loop, so reviving it
            # here — stale[r] = 0 — would draw RNG the standalone run never
            # draws and break the fleet parity contract)
            if self.exchange_every > 0 and (it + 1) % self.exchange_every == 0:
                worst = pcosts.reshape(n_probs, n_chains).argmax(axis=1) + poff
                for j in np.flatnonzero((pcosts[worst] > gbest_pcost) & act_p):
                    r = worst[j]
                    items[r] = g_items[j]
                    counts[r] = g_counts[j]
                    live[r] = g_live[j]
                    ids = np.where(g_items[j] >= 0, g_items[j], sentinel)
                    wt = wtab if wtab.ndim == 1 else wtab[j]
                    dt = dtab if dtab.ndim == 1 else dtab[j]
                    bw[r] = wt[ids].max(-1)
                    bh[r] = dt[ids].sum(-1)
                    costs[r] = gbest_cost[j]
                    if hetero:
                        bk[r] = g_kinds[j]
                        UK[r] = g_UK[j]
                    best_pcosts[r] = min(best_pcosts[r], gbest_pcost[j])
                    stale[r] = 0
                if hetero:
                    pcosts = costs + lam * batch.overflow_rows(UK, st.pi)
                order = np.argsort(counts == 0, axis=1, kind="stable")
                items = np.take_along_axis(items, order[:, :, None], 1)
                counts = np.take_along_axis(counts, order, 1)
                bw = np.take_along_axis(bw, order, 1)
                bh = np.take_along_axis(bh, order, 1)
                if hetero:
                    bk = np.take_along_axis(bk, order, 1)
                live = (counts > 0).sum(1)
                nat.bind(items=items, counts=counts, bw=bw, bh=bh, live=live,
                         pcosts=pcosts, **({"bk": bk} if hetero else {}))
            obs.end(tok)
            it += 1
        # --- write the rebound loop state back (the C code and the exchange
        # write every other array in place)
        st.items, st.counts = items, counts
        st.bw, st.bh, st.live, st.bk = bw, bh, live, bk
        st.pcosts = pcosts
        st.it = it
        if it >= self.max_iterations:
            st.done = True

    def _block_finish(self, st: _BlockState) -> list[_BlockOut]:
        tok = obs.begin("sa.finish")
        wall = time.perf_counter() - st.t_start
        hetero, n_chains = st.hetero, self.n_chains
        outs: list[_BlockOut] = []
        for j in range(st.n_probs):
            lo, hi = j * n_chains, (j + 1) * n_chains
            gbest = decode_chain_items(
                st.probs[j], st.g_items[j], st.g_counts[j],
                st.g_kinds[j] if hetero else None,
            )
            outs.append(_BlockOut(
                best=gbest,
                best_cost=int(st.gbest_cost[j]),
                trace=st.traces[j],
                iterations=int(st.steps[lo:hi].sum()),
                uphill=(int(st.up_prop[j]), int(st.up_acc[j])),
                wall=wall,
                rows=(st.probs[j], st.items[lo:hi], st.counts[lo:hi],
                      st.bk[lo:hi] if hetero else None, st.pcosts[lo:hi]),
            ))
        obs.end(tok)
        return outs

    # ------------------------------------------------- portfolio barrier hooks
    def _block_frozen(self, st: _BlockState, j: int) -> bool:
        """True when fleet problem ``j`` has every chain past patience."""
        lo = j * self.n_chains
        return not (st.stale[lo : lo + self.n_chains] < self.patience).any()

    def _block_migrate(self, st: _BlockState, j: int, sol: Solution) -> bool:
        """Portfolio barrier hook: land a migrant into fleet problem ``j``'s
        worst chain slot iff it strictly beats that slot's penalized cost.
        A frozen problem is never touched — and patience counters are never
        reset — so migration cannot revive a problem that already stopped
        drawing RNG (its trajectory stays exactly its standalone one)."""
        if st.done or self._block_frozen(st, j):
            return False
        lam = self.inventory_penalty
        n_chains = self.n_chains
        lo = j * n_chains
        r = lo + int(st.pcosts[lo : lo + n_chains].argmax())
        cost = int(sol.cost())
        ovf = int(sol.inventory_overflow()) if st.hetero else 0
        if cost + lam * ovf >= st.pcosts[r]:
            return False
        nb = st.items.shape[1]
        if len(sol.bins) > nb:  # cannot encode into this fleet's envelope
            return False
        items_row, counts_row = encode_chain_items([sol], st.cap_max, n_slots=nb)
        st.items[r] = items_row[0]
        st.counts[r] = counts_row[0]
        st.live[r] = int((counts_row[0] > 0).sum())
        sol.fill_geometry(st.bw[r], st.bh[r])
        st.costs[r] = cost
        if st.hetero:
            sol.fill_kinds(st.bk[r])
            st.UK[r] = sol.used_primitives()
            st.pcosts[r] = cost + lam * st.batch.overflow_rows(
                st.UK[r : r + 1], st.pi[r : r + 1]
            )[0]
        else:
            st.pcosts[r] = cost  # pcosts aliases costs on single-kind fleets
        st.best_pcosts[r] = min(st.best_pcosts[r], st.pcosts[r])
        return True

    # Racing (``pack_portfolio(auto=True)``) treats the iteration budget as a
    # portfolio-level ledger: a surviving island's budget is *extended*
    # barrier by barrier, and an eliminated island simply stops advancing.
    # Extension only lifts the budget ceiling (never touches patience, RNG,
    # or the wall cap); elimination reuses the freeze mechanism — a frozen
    # problem draws no RNG, so fleet siblings' streams are untouched.

    def _block_extend(self, st: _BlockState, it_limit: int) -> None:
        """Raise the fleet's iteration budget to at least ``it_limit``,
        reviving a state that stopped *on budget* (never one frozen on
        patience or cut by the wall cap)."""
        if st.done and not st.frozen and st.it >= self.max_iterations:
            st.done = False
        self.max_iterations = max(self.max_iterations, int(it_limit))

    def _block_eliminate(self, st: _BlockState, j: int) -> None:
        """Stop fleet problem ``j`` forever by pushing every chain past
        patience: the loop-top activity mask skips frozen problems before
        any RNG draw, so siblings' streams are as if ``j`` had stopped."""
        lo = j * self.n_chains
        st.stale[lo : lo + self.n_chains] = self.patience

    def _loop_extend(self, st, it_limit: int) -> None:
        """Raise a scalar/single-chain state's iteration budget to
        ``it_limit``, reviving it only if its budget alone stopped it (never
        a patience or wall-cap stop)."""
        if st.done and st.stale < self.patience and st.it >= self.max_iterations:
            st.done = False
        self.max_iterations = max(self.max_iterations, int(it_limit))

    def _loop_eliminate(self, st) -> None:
        """Stop a scalar/single-chain state forever (`_ScalarRun` and
        `_SingleChainRun` both gate their loops on ``st.done``)."""
        st.done = True

    # ------------------------------------------------------------------ result
    def _result(self, best, best_cost, wall, trace, iterations, backend, uphill):
        params = dict(
            t0=self.t0,
            rc=self.rc,
            p_adm_w=self.p_adm_w,
            p_adm_h=self.p_adm_h,
            seed=self.seed,
            backend=backend,
            n_chains=self.n_chains if backend != "legacy" else 1,
        )
        if uphill is not None:
            params["exchange_every"] = self.exchange_every
            params["uphill_proposed"], params["uphill_accepted"] = uphill
        if self._hetero:
            params["p_kind"] = self.p_kind
            params["inventory_penalty"] = self.inventory_penalty
            params["overflow"] = best.inventory_overflow()
        algorithm = "SA-NFD" if self.perturbation == "nfd" else "SA-S"
        if params["n_chains"] > 1:
            algorithm += f"x{params['n_chains']}"
        return PackingResult(
            solution=best,
            cost=best_cost,
            efficiency=best.efficiency(),
            wall_time_s=wall,
            algorithm=algorithm + ("-intra" if self.intra_layer else ""),
            trace=trace,
            iterations=iterations,
            params=params,
        )
