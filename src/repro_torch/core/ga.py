"""Genetic-algorithm memory packer — Algorithm 2 of the paper.

Bin-per-gene chromosome (Falkenauer encoding): an individual IS a packing
solution; each gene is one bin (a group of buffer indices).  There is no
crossover — as in the paper, mutation (buffer swap for GA-S, NFD repack for
GA-NFD) drives exploration, and tournament selection drives exploitation.
Fitness is the multi-objective weighted sum of BRAM cost and mean distinct
layers per bin (placement locality).

The port's copy of ``repro.core.ga``: the host code is the reference's, so
every RNG draw happens in the reference's order, and only the batched
fitness call goes through the port's kernels.  Evaluation backends
(`GeneticPacker(backend=...)`, resolved against ``device`` by
`repro_torch.device`):

* ``"python"`` — incremental scalar path: mutations carry per-bin record
  caches (see `Solution`), so evaluating a mutated individual is O(touched
  bins).
* ``"torch"`` / ``"cuda"`` — batched path: the population's bin geometry
  lives in padded ``(P, NB)`` int32 host matrices updated in place from each
  mutation's dirty bins, and the whole generation's costs are computed in one
  `kernels.binpack_fitness.ops.population_costs` call on ``device`` (the
  plain PyTorch version, or the CUDA kernels K1 / K2).
* ``"auto"`` — ``cuda`` on a CUDA device, ``torch`` on the CPU.
* ``"legacy"`` — the seed's from-scratch scalar evaluation (no caches), kept
  as the benchmark baseline; identical RNG stream and results.

All backends are bit-identical for a fixed seed: cost arithmetic is exact
integer math and the RNG consumption order never depends on the backend.
The generation loop is factored into phase helpers over a `_GARun` state
(`_start_run` / `_mutation_phase` / `_apply_costs` / `_track_best` /
`_tournament`), as in the reference; the ``lockstep_*`` functions drive
several runs together and stack their fitness into one leading-axis call
(the island portfolio, `core.portfolio`).  Each phase is a span
(`repro_torch.obs`): ``ga.start``, ``ga.eval``, ``ga.mutation``,
``ga.apply``, ``ga.best``, ``ga.selection``, ``ga.finish``.

Heterogeneous OCM problems (``PackingProblem(ocm=...)``) add a RAM-kind
dimension: with probability ``p_kind`` a mutation reassigns random bins'
RAM kinds instead of moving buffers, fitness adds ``inventory_penalty`` per
unit of inventory overflow, and selection/best-tracking use the penalized
cost so a feasible packing always beats an overflowing one.  The batched
backends carry a parallel (P, NB) kind matrix through the per-kind-mode
``binpack_fitness`` tables.  Single-kind problems skip every hetero branch
(and its RNG draws), keeping the legacy streams bit-exact.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from .. import obs
from ..device import check_backend, resolve_backend, resolve_device
# imported here, on the importing thread, never first on an island or
# shard thread (two threads importing kernel packages can deadlock on
# their module locks); called through the module, so patches apply
from ..kernels.binpack_fitness import ops as fitness_ops
from .nfd import nfd_from_scratch, nfd_repack
from .problem import (
    DEFAULT_INVENTORY_PENALTY,
    PackingProblem,
    PackingResult,
    Solution,
)


def _apply_one_swap_move(
    bins: list[list[int]],
    prob: PackingProblem,
    src: int,
    dst: int,
    item_pick: int,
    swap_pick,
    intra_layer: bool,
    undo: list | None,
    touched: set | None,
) -> None:
    """Apply one already-drawn buffer-swap move to ``bins`` in place.

    ``item_pick`` indexes into the source bin; ``swap_pick`` is a callable
    returning the displaced-item index when the destination is full (so the
    draw only happens when the legacy RNG stream would make it).  Inverse
    ops are appended to ``undo``; touched bin indices are added to
    ``touched``.  The caller owns the geometry-cache bookkeeping.
    """
    layers = prob.layers_py
    src_bin = bins[src]
    item = src_bin[item_pick]
    dst_bin = bins[dst]
    if intra_layer and dst_bin and layers[dst_bin[0]] != layers[item]:
        return
    if len(dst_bin) >= prob.max_items:
        # swap instead of move to preserve cardinality feasibility
        j = swap_pick(len(dst_bin))
        other = dst_bin[j]
        if intra_layer and layers[other] != (
            layers[src_bin[0]] if src_bin else layers[item]
        ):
            return
        dst_bin[j] = item
        k = src_bin.index(item)
        src_bin[k] = other
        if undo is not None:
            undo.append((src, k, item, dst, j, other))
    else:
        k = src_bin.index(item)
        del src_bin[k]
        dst_bin.append(item)
        if undo is not None:
            undo.append((src, k, item, dst, -1, -1))
    if touched is not None:
        touched.add(src)
        touched.add(dst)


def _draw_other_kind(rng: np.random.Generator, old_k: int, n_kinds: int) -> int:
    """One RNG draw -> a uniformly random kind different from ``old_k``.

    Shared by the GA's ``kind_reassign`` and the SA move path inside
    ``apply_swap_moves`` so the two streams stay bit-identical by
    construction (the parity tests pin both)."""
    return (old_k + 1 + int(rng.integers(n_kinds - 1))) % n_kinds


def apply_swap_moves(
    sol: Solution,
    rng: np.random.Generator,
    n_moves: int = 1,
    intra_layer: bool = False,
    undo: list | None = None,
    touched: set | None = None,
    p_kind: float = 0.0,
) -> None:
    """Apply an MPack buffer-swap move sequence to ``sol.bins`` IN PLACE.

    Consumes ``rng`` in exactly the order the historical ``buffer_swap``
    did (the engine backend-parity tests pin trajectories on this stream).
    With ``p_kind > 0`` on a heterogeneous problem, each move is — with
    that probability — a RAM-kind reassignment of a random bin instead of
    a buffer swap (recorded in ``undo`` with the ``j == -2`` sentinel).
    ``p_kind == 0`` (the default, and the only value single-kind engines
    pass) draws nothing extra, preserving the legacy stream exactly.
    The geometry cache is NOT updated: callers either commit with
    ``sol.touch(*touched)`` + ``sol.drop_empty()`` or roll back with
    :func:`undo_swap_moves`.
    """
    bins = sol.bins
    prob = sol.problem
    n_kinds = prob.n_kinds
    kind_moves = p_kind > 0.0 and n_kinds > 1
    for _ in range(n_moves):
        if kind_moves and rng.random() < p_kind:
            bi = int(rng.integers(len(bins)))
            old_k = int(sol.kinds[bi])
            sol.kinds[bi] = _draw_other_kind(rng, old_k, n_kinds)
            if undo is not None:
                undo.append((bi, old_k, -1, -1, -2, -1))
            if touched is not None:
                touched.add(bi)
            continue
        if len(bins) < 2:
            break
        src = int(rng.integers(len(bins)))
        dst = int(rng.integers(len(bins)))
        if src == dst or not bins[src]:
            continue
        item_pick = int(rng.integers(len(bins[src])))
        _apply_one_swap_move(
            bins, prob, src, dst, item_pick,
            lambda n: int(rng.integers(n)), intra_layer, undo, touched,
        )


def undo_swap_moves(sol: Solution, undo: list) -> None:
    """Reverse a recorded move sequence, restoring exact bin contents/order
    (and kind lanes, for ``j == -2`` kind-reassignment entries)."""
    bins = sol.bins
    for src, k, item, dst, j, other in reversed(undo):
        if j == -2:
            sol.kinds[src] = k
        elif j < 0:
            bins[dst].pop()
            bins[src].insert(k, item)
        else:
            bins[dst][j] = other
            bins[src][k] = item


def buffer_swap(
    sol: Solution,
    rng: np.random.Generator,
    n_moves: int = 1,
    intra_layer: bool = False,
    p_kind: float = 0.0,
) -> Solution:
    """MPack-style perturbation: move random buffers between random bins.

    Reports every touched bin to the solution's record cache, so the child's
    ``cost()`` re-evaluates at most ``2 * n_moves`` bins.
    """
    out = sol.copy()
    touched: set[int] = set()
    apply_swap_moves(out, rng, n_moves=n_moves, intra_layer=intra_layer,
                     touched=touched, p_kind=p_kind)
    if touched:
        out.touch(*touched)
    out.drop_empty()
    return out


def kind_reassign(
    sol: Solution, rng: np.random.Generator, n_moves: int = 1
) -> Solution:
    """Heterogeneous mutation: move random bins to a random other RAM kind.

    The inventory penalty in the fitness turns this into directed pressure:
    reassignments that relieve an over-subscribed kind survive selection.
    Only meaningful on multi-kind problems (``problem.n_kinds > 1``).
    """
    out = sol.copy()
    n_kinds = out.problem.n_kinds
    touched: set[int] = set()
    for _ in range(n_moves):
        bi = int(rng.integers(len(out.bins)))
        out.kinds[bi] = _draw_other_kind(rng, int(out.kinds[bi]), n_kinds)
        touched.add(bi)
    out.touch(*touched)
    return out


def fitness(
    sol: Solution,
    layer_weight: float,
    cost: int | float | None = None,
    inventory_penalty: float = 0.0,
    overflow: int | None = None,
) -> float:
    """Weighted-sum fitness; pass a precomputed ``cost`` to avoid re-deriving it.

    ``inventory_penalty`` scales the unit-weighted inventory overflow
    (heterogeneous devices; zero and free on single-kind problems); pass a
    precomputed ``overflow`` to avoid re-deriving that too."""
    f = float(sol.cost() if cost is None else cost)
    if layer_weight > 0.0:
        f += layer_weight * sol.distinct_layers_per_bin()
    if inventory_penalty > 0.0:
        f += inventory_penalty * (
            sol.inventory_overflow() if overflow is None else overflow
        )
    return f


class GeneticPacker:
    def __init__(
        self,
        mutation: str = "nfd",  # "nfd" (GA-NFD) or "swap" (GA-S)
        n_pop: int = 50,
        n_tour: int = 5,
        p_mut: float = 0.4,
        p_adm_w: float = 0.0,
        p_adm_h: float = 0.1,
        nfd_threshold: float = 0.95,
        nfd_extra_frac: float = 0.01,
        nfd_max_bins: int = 12,
        swap_moves: int = 4,
        layer_weight: float = 0.01,
        intra_layer: bool = False,
        max_seconds: float = 60.0,
        max_generations: int = 100_000,
        patience: int = 200,
        seed: int = 0,
        backend: str = "auto",
        p_kind: float = 0.25,
        inventory_penalty: float = DEFAULT_INVENTORY_PENALTY,
        device=None,
    ):
        if mutation not in ("nfd", "swap"):
            raise ValueError(f"unknown mutation {mutation!r}")
        check_backend(backend)
        self.__dict__.update(locals())
        del self.__dict__["self"]
        self.device = resolve_device(device)
        # warm state for the thread-pool portfolio's restarts (set after
        # each pack())
        self.last_population_: list[Solution] | None = None

    @property
    def name(self) -> str:
        return "GA-NFD" if self.mutation == "nfd" else "GA-S"

    def _resolve_backend(self) -> str:
        return resolve_backend(self.backend, self.device)

    def _mutate(
        self,
        sol: Solution,
        rng: np.random.Generator,
        use_cache: bool = True,
        hetero: bool = False,
    ) -> Solution:
        # heterogeneous OCM: a fraction of mutations reassign RAM kinds
        # instead of moving buffers (the gate is skipped entirely — no RNG
        # draw — on single-kind problems, pinning the legacy stream)
        if hetero and rng.random() < self.p_kind:
            return kind_reassign(sol, rng)
        if self.mutation == "nfd":
            return nfd_repack(
                sol,
                rng,
                threshold=self.nfd_threshold,
                p_adm_w=self.p_adm_w,
                p_adm_h=self.p_adm_h,
                intra_layer=self.intra_layer,
                extra_frac=self.nfd_extra_frac,
                max_bins=self.nfd_max_bins,
                use_cache=use_cache,
            )
        return buffer_swap(
            sol, rng, n_moves=self.swap_moves, intra_layer=self.intra_layer
        )

    # ---------------------------------------------------------------- eval
    def _batched_costs(self, run: "_GARun", mesh=None) -> np.ndarray:
        """One generation's population totals on ``self.device`` (float64
        holding exact integers, as the reference's batched path); ``mesh``
        row-shards the call over a sweep mesh."""
        return _population_totals(
            run.W, run.H, run.Km, run, run.backend, self.device, mesh=mesh
        )

    def _fitness_legacy(self, sol: Solution, cost: float, hetero: bool) -> float:
        f = float(cost)
        if self.layer_weight > 0.0:
            f += self.layer_weight * sol.distinct_layers_per_bin_full()
        if hetero and self.inventory_penalty > 0.0:
            f += self.inventory_penalty * sol.inventory_overflow()
        return f

    # ---------------------------------------------------------------- pack
    #
    # The generation loop is split into phase helpers operating on a `_GARun`
    # state object, as in the reference (whose DSE and portfolio loops
    # interleave many runs through them); `pack()` below composes them into
    # the single-problem loop.

    def _start_run(
        self,
        prob: PackingProblem,
        rng: np.random.Generator,
        init_pop: Sequence[Solution] | None,
        backend: str,
    ) -> "_GARun":
        """Build one problem's population + evaluation matrices (no RNG
        draws beyond the population init itself)."""
        tok = obs.begin("ga.start")
        run = _GARun()
        run.prob = prob
        run.rng = rng
        run.t0 = time.perf_counter()
        run.backend = backend
        run.batched = backend in ("torch", "cuda")
        run.use_cache = backend != "legacy"
        run.hetero = prob.n_kinds > 1
        run.inv_pen = self.inventory_penalty if run.hetero else 0.0
        run.modes0 = prob.kind_tables[0][1]  # == BRAM18_MODES on defaults
        pop: list[Solution] = [s.copy() for s in (init_pop or [])][: self.n_pop]
        pop += [
            nfd_from_scratch(
                prob,
                rng,
                p_adm_w=self.p_adm_w,
                p_adm_h=self.p_adm_h,
                intra_layer=self.intra_layer,
                sort_by_width=(k % 2 == 0),  # seed half the population width-aware
            )
            for k in range(len(pop), self.n_pop)
        ]
        run.pop = pop
        # on heterogeneous problems selection AND best-tracking use the
        # inventory-penalized cost, so an overflowing packing can never beat
        # a feasible one; ``ovfs`` mirrors ``costs`` per individual
        run.ovfs = np.zeros(self.n_pop, dtype=np.float64) if run.hetero else None
        if run.batched:
            # population geometry matrices: row i = per-bin (width, height) of
            # pop[i], zero-padded to the worst case of one buffer per bin
            run.W = np.zeros((self.n_pop, prob.n), dtype=np.int32)
            run.H = np.zeros((self.n_pop, prob.n), dtype=np.int32)
            # heterogeneous problems add a parallel RAM-kind matrix
            run.Km = (
                np.zeros((self.n_pop, prob.n), dtype=np.int32)
                if run.hetero
                else None
            )
            run.kt = prob.kind_tables if run.hetero else None
            for i, s in enumerate(pop):
                s.fill_geometry(run.W[i], run.H[i])
                if run.Km is not None:
                    s.fill_kinds(run.Km[i])
        else:
            run.W = run.H = run.Km = None
            run.kt = None
        if run.ovfs is not None:
            for i, s in enumerate(pop):
                run.ovfs[i] = s.inventory_overflow()
        obs.end(tok)
        return run

    def _eval_init(self, run: "_GARun", totals=None) -> None:
        """Initial population evaluation (one batched call on the batched
        backends, cached scalar costs on ``python``).  ``totals`` carries
        the batched costs when the caller computed them already (the DSE's
        lockstep lane evaluates every problem's population in one stacked
        call); otherwise the batched backends make their own call.
        ``legacy`` recomputes every cost from scratch (`cost_full`)."""
        tok = obs.begin("ga.eval")
        if run.batched:
            costs = (
                self._batched_costs(run) if totals is None
                else np.asarray(totals, dtype=np.float64)
            )
        elif run.use_cache:
            costs = np.asarray([s.cost() for s in run.pop], dtype=np.float64)
        else:
            costs = np.asarray([s.cost_full() for s in run.pop], dtype=np.float64)
        if run.use_cache:
            fits = np.asarray(
                [
                    fitness(s, self.layer_weight, cost=c,
                            inventory_penalty=run.inv_pen,
                            overflow=None if run.ovfs is None else run.ovfs[i])
                    for i, (s, c) in enumerate(zip(run.pop, costs))
                ]
            )
        else:
            fits = np.asarray(
                [self._fitness_legacy(s, c, run.hetero) for s, c in zip(run.pop, costs)]
            )
        run.costs = costs
        run.fits = fits
        sel = costs if run.ovfs is None else costs + run.inv_pen * run.ovfs
        best_i = int(np.argmin(sel))
        run.best = run.pop[best_i].copy()
        run.best_cost = int(costs[best_i])
        run.best_sel = float(sel[best_i])
        # hetero traces record the penalized cost (the annealed/selected
        # quantity) so the curve stays monotone; raw == penalized otherwise
        run.trace = [(time.perf_counter() - run.t0,
                      run.best_sel if run.hetero else run.best_cost)]
        run.stale = 0
        run.gen = 0
        obs.end(tok)

    def _mutation_phase(self, run: "_GARun") -> list[int]:
        """One generation's mutations (mutated individuals are fresh objects;
        unmutated ones may be shared references from selection, never mutated
        in place).  Returns the mutated indices; on the batched path their
        kernel costs are applied afterwards via `_apply_costs`."""
        tok = obs.begin("ga.mutation")
        mutated: list[int] = []
        for i in range(self.n_pop):
            if run.rng.random() < self.p_mut:
                run.pop[i] = self._mutate(
                    run.pop[i], run.rng, use_cache=run.use_cache,
                    hetero=run.hetero,
                )
                if run.ovfs is not None:
                    run.ovfs[i] = run.pop[i].inventory_overflow()
                if run.batched:
                    run.pop[i].fill_geometry(run.W[i], run.H[i])
                    if run.Km is not None:
                        run.pop[i].fill_kinds(run.Km[i])
                    mutated.append(i)
                elif run.use_cache:
                    run.costs[i] = run.pop[i].cost()
                    run.fits[i] = fitness(
                        run.pop[i], self.layer_weight, cost=run.costs[i],
                        inventory_penalty=run.inv_pen,
                        overflow=None if run.ovfs is None else run.ovfs[i],
                    )
                else:
                    run.costs[i] = run.pop[i].cost_full()
                    run.fits[i] = self._fitness_legacy(
                        run.pop[i], run.costs[i], run.hetero
                    )
        obs.end(tok)
        return mutated

    def _apply_costs(self, run: "_GARun", totals, mutated: list[int]) -> None:
        tok = obs.begin("ga.apply")
        for i in mutated:
            run.costs[i] = totals[i]
            run.fits[i] = fitness(
                run.pop[i], self.layer_weight, cost=run.costs[i],
                inventory_penalty=run.inv_pen,
                overflow=None if run.ovfs is None else run.ovfs[i],
            )
        obs.end(tok)

    def _track_best(self, run: "_GARun") -> None:
        # --- track best (penalized on heterogeneous problems)
        tok = obs.begin("ga.best")
        sel = (
            run.costs
            if run.ovfs is None
            else run.costs + run.inv_pen * run.ovfs
        )
        gi = int(np.argmin(sel))
        if float(sel[gi]) < run.best_sel:
            run.best_sel = float(sel[gi])
            run.best_cost = int(run.costs[gi])
            run.best = run.pop[gi].copy()
            run.trace.append((time.perf_counter() - run.t0,
                              run.best_sel if run.hetero else run.best_cost))
            run.stale = 0
        else:
            run.stale += 1
        obs.end(tok)

    def _tournament(self, run: "_GARun") -> None:
        # --- tournament selection (with replacement) + elitism
        tok = obs.begin("ga.selection")
        idx = run.rng.integers(self.n_pop, size=(self.n_pop, self.n_tour))
        winners = idx[np.arange(self.n_pop), np.argmin(run.fits[idx], axis=1)]
        winners[0] = int(np.argmin(run.fits))  # elitism: best survives
        run.pop = [run.pop[int(w)] for w in winners]
        run.costs = run.costs[winners]
        run.fits = run.fits[winners]
        if run.ovfs is not None:
            run.ovfs = run.ovfs[winners]
        if run.batched:
            run.W = run.W[winners]
            run.H = run.H[winners]
            if run.Km is not None:
                run.Km = run.Km[winners]
        obs.end(tok)

    def _finish_run(self, run: "_GARun") -> PackingResult:
        tok = obs.begin("ga.finish")
        wall = time.perf_counter() - run.t0
        run.trace.append((wall, run.best_sel if run.hetero else run.best_cost))
        self.last_population_ = run.pop
        extra = (
            dict(p_kind=self.p_kind, inventory_penalty=self.inventory_penalty,
                 overflow=run.best.inventory_overflow())
            if run.hetero
            else {}
        )
        result = PackingResult(
            solution=run.best,
            cost=run.best_cost,
            efficiency=run.best.efficiency(),
            wall_time_s=wall,
            algorithm=self.name + ("-intra" if self.intra_layer else ""),
            trace=run.trace,
            iterations=run.gen,
            params=dict(
                n_pop=self.n_pop,
                n_tour=self.n_tour,
                p_mut=self.p_mut,
                p_adm_w=self.p_adm_w,
                p_adm_h=self.p_adm_h,
                seed=self.seed,
                backend=run.backend,
                **extra,
            ),
        )
        obs.end(tok)
        return result

    # ------------------------------------------------- portfolio barrier hooks
    def _migrate_in(self, run: "_GARun", sol: Solution) -> bool:
        """Portfolio barrier hook: the migrant replaces this run's worst
        individual (by penalized selection cost) iff strictly better.  A
        finished run is never touched and ``stale`` is never reset, so
        migration cannot revive a converged island."""
        if run.done or run.stale >= self.patience:
            return False
        sel = (
            run.costs
            if run.ovfs is None
            else run.costs + run.inv_pen * run.ovfs
        )
        worst = int(np.argmax(sel))
        cost = float(sol.cost())
        ovf = float(sol.inventory_overflow()) if run.ovfs is not None else 0.0
        mig_sel = cost + run.inv_pen * ovf
        if mig_sel >= float(sel[worst]):
            return False
        mig = sol.copy()
        run.pop[worst] = mig
        run.costs[worst] = cost
        if run.ovfs is not None:
            run.ovfs[worst] = ovf
        run.fits[worst] = fitness(
            mig, self.layer_weight, cost=cost, inventory_penalty=run.inv_pen,
            overflow=None if run.ovfs is None else ovf,
        )
        if run.batched:
            mig.fill_geometry(run.W[worst], run.H[worst])
            if run.Km is not None:
                mig.fill_kinds(run.Km[worst])
        # fold the migrant into the best-tracking reference (no trace entry,
        # no stale reset): otherwise the next _track_best would record the
        # migrant as this run's own improvement and revive its patience
        if mig_sel < run.best_sel:
            run.best_sel = mig_sel
            run.best_cost = int(cost)
            run.best = mig.copy()
        return True

    def _extend_run(self, run: "_GARun", gen_limit: int) -> None:
        """Racing budget reallocation: raise this run's generation budget to
        at least ``gen_limit``, reviving a run that stopped *on budget*
        (never one converged on patience or cut by the wall cap)."""
        if run.done and run.stale < self.patience and run.gen >= self.max_generations:
            run.done = False
        self.max_generations = max(self.max_generations, int(gen_limit))

    def _eliminate_run(self, run: "_GARun") -> None:
        """Racing elimination: stop this run forever.  `lockstep_begin`
        skips done runs before any mutation draw, so the surviving runs
        consume exactly the RNG streams they would have without it."""
        run.done = True

    def pack(
        self, prob: PackingProblem, init_pop: Sequence[Solution] | None = None
    ) -> PackingResult:
        rng = np.random.default_rng(self.seed)
        backend = self._resolve_backend()
        run = self._start_run(prob, rng, init_pop, backend)
        self._eval_init(run)
        while run.gen < self.max_generations:
            run.gen += 1
            now = time.perf_counter() - run.t0
            if now > self.max_seconds or run.stale >= self.patience:
                break
            mutated = self._mutation_phase(run)
            if run.batched and mutated:
                self._apply_costs(run, self._batched_costs(run), mutated)
            self._track_best(run)
            self._tournament(run)
        return self._finish_run(run)


def _population_totals(
    W, H, Km, run: "_GARun", backend: str, device, mesh=None
) -> np.ndarray:
    """Population totals of ``(..., NB)`` geometry under ``run``'s mode
    tables, as float64 holding exact integers; ``mesh`` row-shards the
    call."""
    totals = fitness_ops.population_costs(
        W, H, modes=run.modes0, backend=backend, kinds=Km,
        kind_tables=run.kt, device=device, mesh=mesh,
    )
    return np.asarray(totals, dtype=np.float64)


def stack_geometry(runs: Sequence["_GARun"]):
    """Stack several runs' ``(n_pop, NB_j)`` geometry (and kind) matrices
    into one zero-padded ``(A, n_pop, NB_max)`` block.

    Padded lanes have width 0 and cost nothing, so leading-axis totals
    equal the per-run 2-D fitness calls exactly.  Returns ``(W, H, Km)``
    with ``Km is None`` on single-kind problems."""
    nb = max(r.W.shape[1] for r in runs)
    n_pop = runs[0].W.shape[0]
    W = np.zeros((len(runs), n_pop, nb), dtype=np.int32)
    H = np.zeros_like(W)
    hetero = runs[0].Km is not None
    Km = np.zeros_like(W) if hetero else None
    for a, r in enumerate(runs):
        W[a, :, : r.W.shape[1]] = r.W
        H[a, :, : r.H.shape[1]] = r.H
        if hetero:
            Km[a, :, : r.Km.shape[1]] = r.Km
    return W, H, Km


def stacked_population_costs(
    runs: Sequence["_GARun"], backend: str, device, mesh=None
) -> np.ndarray:
    """One leading-axis ``(A, n_pop)`` fitness call over several GA runs on
    ``device`` (see :func:`stack_geometry` for the padding contract); the
    DSE's lockstep lane and the portfolio's island loop stack through it.
    ``mesh`` (a ``("prob",)`` sweep mesh) row-shards the stacked call."""
    W, H, Km = stack_geometry(runs)
    return _population_totals(W, H, Km, runs[0], backend, device, mesh=mesh)


def lockstep_begin(
    pairs: Sequence[tuple[GeneticPacker, "_GARun"]],
    gen_limit: int | None = None,
) -> tuple[list, list]:
    """Segment phase 1 of one lockstep generation: per-run bookkeeping
    (budget/patience/wall checks) plus the mutation phase.

    Returns ``(advanced, batches)``: ``advanced`` is the live ``(packer,
    run)`` pairs that entered this generation, ``batches`` the pending
    fitness work as lists of ``(packer, run, mutated)`` entries grouped by
    population size — each batch is one stacked fitness call (directly via
    :func:`stacked_population_costs`, or fused with SA fleet work through
    ``binpack_portfolio_step``).  Callers feed the totals to
    :func:`lockstep_apply`, then close the generation with
    :func:`lockstep_finish`.  ``gen_limit`` *pauses* runs that reached a
    portfolio barrier without marking them done."""
    advanced: list[tuple[GeneticPacker, _GARun]] = []
    pending: list[tuple[GeneticPacker, _GARun, list[int]]] = []
    for packer, run in pairs:
        if run.done:
            continue
        if gen_limit is not None and run.gen >= gen_limit:
            continue
        if run.gen >= packer.max_generations:
            run.done = True
            continue
        run.gen += 1
        now = time.perf_counter() - run.t0
        if now > packer.max_seconds or run.stale >= packer.patience:
            run.done = True
            continue
        mutated = packer._mutation_phase(run)
        advanced.append((packer, run))
        if run.batched and mutated:
            pending.append((packer, run, mutated))
    groups: dict[int, list] = {}
    for entry in pending:
        groups.setdefault(entry[1].W.shape[0], []).append(entry)
    return advanced, list(groups.values())


def lockstep_apply(batch: Sequence[tuple], totals) -> None:
    """Segment phase 2: land one batch's stacked fitness totals (row ``a``
    of ``totals`` belongs to ``batch[a]``'s run)."""
    for (packer, run, mutated), tot in zip(batch, totals):
        packer._apply_costs(run, tot, mutated)


def lockstep_finish(advanced: Sequence[tuple]) -> bool:
    """Segment phase 3: best tracking + tournament selection for every pair
    that advanced; returns True while any pair advanced."""
    for packer, run in advanced:
        packer._track_best(run)
        packer._tournament(run)
    return bool(advanced)


def lockstep_generation(
    pairs: Sequence[tuple[GeneticPacker, "_GARun"]],
    gen_limit: int | None = None,
    mesh=None,
) -> bool:
    """Advance ONE generation for every live (packer, run) pair in lockstep.

    All batched pairs' mutated populations are evaluated in stacked
    fitness calls (grouped by population size, via
    :func:`stacked_population_costs`); each run consumes only its own RNG
    stream, so every trajectory is bit-identical to the standalone
    ``pack()`` loop.  ``gen_limit`` pauses runs at a portfolio barrier;
    budget/patience/wall exhaustion marks ``run.done``.  Returns True while
    any pair advanced.  ``mesh`` row-shards each stacked fitness call over a
    ``("prob",)`` sweep mesh (bit-identical; device backends only)."""
    advanced, batches = lockstep_begin(pairs, gen_limit)
    for batch in batches:
        packer, run, _ = batch[0]
        totals = stacked_population_costs(
            [r for _, r, _ in batch], run.backend, packer.device, mesh=mesh
        )
        lockstep_apply(batch, totals)
    return lockstep_finish(advanced)


class _GARun:
    """One problem's GA state, advanced generation-wise by the phase helpers
    of `GeneticPacker` (its own `pack()` loop, `core.dse`'s lockstep
    multi-problem lane, or the portfolio's island loop, all through the
    ``lockstep_*`` phases).

    ``CODEC_*`` is the serialization contract consumed by ``core.resume``
    (the reference's, so snapshots cross packages): ``costs``/``fits`` (and
    ``ovfs`` on heterogeneous problems, all float64) land in a checkpoint's
    ``arrays.npz``; the scalars, RNG state, population, best solution, and
    trace in its JSON manifest.  The geometry matrices ``W``/``H``/``Km``
    are refilled from the restored population, and shared-reference
    aliasing inside ``pop`` (tournament winners) need not survive
    serialization: mutation always replaces ``pop[i]`` with a fresh object,
    never edits one in place.
    """

    CODEC_ARRAYS = ("costs", "fits")
    CODEC_ARRAYS_HETERO = ("ovfs",)
    CODEC_SCALARS = ("best_cost", "best_sel", "gen", "stale", "done")

    __slots__ = (
        "prob", "rng", "t0", "backend", "batched", "use_cache", "hetero",
        "inv_pen", "modes0", "kt", "pop", "costs", "fits", "ovfs",
        "W", "H", "Km", "best", "best_cost", "best_sel", "trace",
        "stale", "gen", "done",
    )

    def __init__(self):
        self.done = False
