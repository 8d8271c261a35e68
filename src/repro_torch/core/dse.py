"""Cross-problem batched DSE solver: pack a *fleet* of problems in one run
(the port's `repro.core.dse`).

Memory packing sits inside a design-space-exploration inner loop: every
(network x folding x device x precision) candidate of an accelerator build
needs a packed OCM estimate, and sweeps span hundreds of candidates.
Solving them one at a time leaves the batched kernels, which already
vectorize over chains and populations *within* one problem, idle across
the problem axis.  :func:`pack_sweep` closes that gap:

* Candidates are deduplicated by :meth:`PackingProblem.fingerprint` (and
  optionally served from a caller-owned ``cache`` dict), so repeated DSE
  candidates are free.
* The remaining fleet is grouped by cost-model signature
  (:func:`problem.batch_group_key`) and each group is padded to a common
  ``(NB, max_items)`` envelope (:func:`problem.encode_problem_batch`).
* ``sa-s`` groups run the multi-problem chain-block annealer
  (`SimulatedAnnealingPacker._anneal_block`): P problems x C chains advance
  in lock-step, and each step's ``(P * C, 2 * swap_moves)`` delta costs go
  through one ``binpack_sa_step`` call (K3 / K4 on ``cuda``).  Each problem
  consumes its own RNG stream, so its result is **bit-identical** to a
  standalone ``pack(prob, "sa-s", n_chains=C, seed=...)`` run.
* ``ga-nfd``/``ga-s`` groups on a device backend (``torch`` / ``cuda``) run
  a *lockstep* lane over the GA's phase helpers: mutations stay
  per-problem Python, but every generation's population fitness is one
  leading-problem-axis ``binpack_fitness`` call over the stacked
  ``(P, n_pop, NB)`` matrices (K1 / K2 on ``cuda``).  Again bit-identical
  per problem to standalone runs.
* Everything else (``sa-nfd``, single-chain SA, the ``legacy`` backend,
  the GA on ``python``, the one-shot heuristics, ``portfolio``) runs a
  serial per-problem loop
  through :func:`api.pack` — same results, no batching.

Every result equals the reference's ``repro.core.pack_sweep`` for the same
arguments and iteration budgets.  Nothing falls back: a kernel that fails
to build or launch raises out of the sweep.

Budget semantics: ``max_seconds`` is the wall-clock budget of one engine
*invocation* — a batched group shares one clock (its problems advance
together), the serial lane spends it per problem.  For reproducible,
parity-testable sweeps use iteration budgets (``max_iterations`` /
``max_generations`` with a huge ``max_seconds``), which freeze each problem
at exactly the same trajectory point as its standalone run.

Scaling past one fleet: ``n_shards`` splits each batched group into that
many contiguous sub-fleets (SA) / lockstep sub-packs (GA), advanced
concurrently on host threads; ``mesh`` (a `launch.mesh.SweepMesh`)
row-shards each kernel call over its devices (one shard) or pins the
sub-fleets to them round-robin (several).  Both are execution-shape knobs
only: per-problem trajectories do not depend on the fleet's composition,
so every shard count and mesh is bit-identical to ``n_shards=1``, and
snapshots are cut in one canonical merged layout that resumes at any
other shard count.  On a one-card machine a mesh is k logical shards of
that card (``SweepMesh([cuda:0] * k)``): it runs the row split and the
pinning, not a scaling across cards.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from .. import obs
from ..device import resolve_device
from ..kernels.probshard import mesh_devices
from .ga import (
    lockstep_apply,
    lockstep_begin,
    lockstep_finish,
    stacked_population_costs,
)
from .problem import (
    PackingProblem,
    PackingResult,
    batch_group_key,
)
from .resume import (
    SweepCheckpointer,
    encode_block_state,
    encode_ga_group,
    group_digest,
    merge_block_states,
    sweep_config_key,
)

# algorithms whose batched lane exists (everything else runs serially)
_SA_BATCHED = ("sa-s",)
_GA_LOCKSTEP = ("ga-nfd", "ga-s")
# GA backends that evaluate a stacked population in one call
_GA_DEVICE_BACKENDS = ("torch", "cuda")


def normalize_hyper(algorithm: str, hyper: dict) -> dict:
    """Apply the sweep-level hyperparameter defaults for ``algorithm``.

    ``pack_sweep`` gives ``sa-s`` fleets ``n_chains=8`` unless told
    otherwise; anything that derives task identities for sweep-solved work
    must normalize the same way or identical requests would hash to
    different tasks.
    """
    out = dict(hyper)
    if algorithm.lower() in _SA_BATCHED:
        out.setdefault("n_chains", 8)
    return out


def task_key(
    prob: PackingProblem,
    algorithm: str,
    seed: int,
    intra_layer: bool = False,
    backend: str = "auto",
    max_seconds: float = 30.0,
    hyper: dict | None = None,
) -> tuple:
    """Stable identity of one solve: everything that can change its answer.

    Two requests with equal keys are interchangeable — same problem
    fingerprint, algorithm, seed, and settings — so they may share one
    result object (``pack_sweep`` dedups on this).  Callers passing
    ``hyper`` should run it through :func:`normalize_hyper` first if they
    want keys comparable with ``pack_sweep``'s.  The key is the
    reference's, and holds ``backend`` as given (unresolved): a port key
    equals the reference's for ``"auto"`` and ``"python"``.
    """
    hkey = tuple(sorted((k, repr(v)) for k, v in (hyper or {}).items()))
    return (
        prob.fingerprint(), algorithm.lower(), int(seed), bool(intra_layer),
        backend, float(max_seconds), hkey,
    )


# --------------------------------------------------------------- sweep result
@dataclasses.dataclass
class SweepResult:
    """Outcome of one :func:`pack_sweep` call.

    ``results[i]`` is the :class:`PackingResult` of ``problems[i]`` —
    positions with equal task fingerprints share one result object.
    ``fresh`` holds the positions that were actually solved this call (the
    rest came from the fingerprint dedup or the caller's ``cache``).
    """

    results: list[PackingResult]
    problems: list[PackingProblem]
    wall_time_s: float
    n_solved: int
    cache_hits: int
    n_groups: int
    algorithm: str
    fresh: tuple[int, ...] = ()
    #: sweep-level counters: ``solved`` unique tasks solved this call,
    #: ``cache_hits`` unique tasks served from the cache / checkpoint store,
    #: ``dedup_hits`` positions collapsed by fingerprint dedup (so
    #: ``solved + cache_hits + dedup_hits == len(problems)``), plus the
    #: execution-shape knob ``n_shards``.
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.results)

    @property
    def candidates_per_sec(self) -> float:
        """Aggregate DSE throughput: candidates scored per wall second."""
        return self.size / max(self.wall_time_s, 1e-9)

    def costs(self) -> np.ndarray:
        return np.asarray([r.cost for r in self.results], dtype=np.int64)

    def pareto_indices(self) -> list[int]:
        """Non-dominated candidates over (cost down, Eq.-1 efficiency up).

        Across a sweep of *different* workloads this is the standard DSE
        screen: a candidate survives unless another candidate stores its
        bits at least as efficiently in no more RAM.  Callers with a real
        throughput model should build their own front from ``results``.
        """
        cost = self.costs()
        eff = np.asarray([r.efficiency for r in self.results])
        out = []
        for i in range(self.size):
            dominated = np.any(
                (cost <= cost[i]) & (eff >= eff[i])
                & ((cost < cost[i]) | (eff > eff[i]))
            )
            if not dominated:
                out.append(i)
        return out

    def table(self) -> str:
        """Efficiency/Pareto report, one row per candidate."""
        pareto = set(self.pareto_indices())
        fresh = set(self.fresh)
        lines = [
            f"{'#':>3} {'candidate':<24} {'bufs':>5} {'baseline':>9} "
            f"{'packed':>7} {'dBRAM':>6} {'eff%':>6} {'ovf':>5} {'src':>6} "
            f"{'pareto':>6}"
        ]
        for i, (prob, r) in enumerate(zip(self.problems, self.results)):
            ovf = r.solution.inventory_overflow()
            lines.append(
                f"{i:>3} {prob.name[:24]:<24} {prob.n:>5} "
                f"{prob.baseline_cost():>9} {r.cost:>7} "
                f"{r.baseline_cost / max(r.cost, 1):>6.2f} "
                f"{r.efficiency * 100:>6.1f} {ovf:>5} "
                f"{'solve' if i in fresh else 'cache':>6} "
                f"{'*' if i in pareto else '':>6}"
            )
        lines.append(self.summary())
        return "\n".join(lines)

    def summary(self) -> str:
        return (
            f"sweep[{self.algorithm}]: {self.size} candidates in "
            f"{self.wall_time_s:.2f}s ({self.candidates_per_sec:.2f}/s), "
            f"{self.n_solved} solved fresh in {self.n_groups} group(s), "
            f"{self.cache_hits} served from dedup/cache"
        )


def _task_keys(problems, algorithm, seeds, intra_layer, backend,
               max_seconds, hyper) -> list[tuple]:
    return [
        task_key(prob, algorithm, s, intra_layer, backend, max_seconds, hyper)
        for prob, s in zip(problems, seeds)
    ]


def _group_by_cost_model(indices, problems) -> list[list[int]]:
    """One group per cost-model signature, deliberately NOT sub-chunked by
    size: per-step work in the batched engines is dominated by
    ``(P*C, touched)``-shaped operations that barely see the padded
    envelope, so one big group amortizes the fixed per-step overhead best.
    Grouping never changes results — each problem consumes its own RNG
    stream and padding never affects trajectories."""
    groups: dict = {}
    for i in indices:
        groups.setdefault(batch_group_key(problems[i]), []).append(i)
    return list(groups.values())


def shard_chunks(n: int, k: int) -> list[list[int]]:
    """Contiguous balanced split of ``range(n)`` into ``min(k, n)`` chunks.

    The first ``n % k`` chunks carry one extra row.  Contiguity is
    load-bearing: shard boundaries become plain row slices of the canonical
    merged checkpoint layout (``resume.merge_block_states``), so snapshots
    restore onto ANY shard count.
    """
    k = max(1, min(int(k), n))
    base, rem = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append(list(range(lo, lo + size)))
        lo += size
    return out


def check_shards(n_shards, mesh, device) -> int:
    """Validate the two execution-shape knobs against the caller's
    ``device`` (``None`` means ``"cuda"``): ``n_shards >= 1``, and a mesh
    that is a ``("prob",)`` sweep mesh of ``device``'s type (work never
    moves to a device the caller did not name).  Returns ``n_shards``."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if mesh is not None:
        mesh_devices(mesh, "cuda" if device is None else device)
    return n_shards


def _shard_devices(mesh, n_chunks: int, backend: str):
    """Round-robin device pins for host-split shards (``n_shards > 1`` AND
    a mesh): shard ``i`` dispatches on ``devices[i % len]``.  With one
    chunk the mesh row-shards each kernel call instead, and the ``python``
    backend launches nothing."""
    if mesh is None or n_chunks <= 1 or backend not in ("torch", "cuda"):
        return None
    return list(mesh_devices(mesh))


def _run_threads(fn, items) -> None:
    """``fn(item)`` for every item, on one thread each when there are
    several; an exception in any thread propagates."""
    if len(items) <= 1:
        for item in items:
            fn(item)
        return
    with ThreadPoolExecutor(max_workers=len(items)) as ex:
        for _ in ex.map(fn, items):
            pass


def _solve_sa_group_sharded(
    packer, probs, rngs, backend, n_shards, mesh, gkeys=None, ck=None
) -> list:
    """One cost-model group annealed as ``n_shards`` concurrent sub-fleets.

    Each shard is a contiguous problem slice started as its own
    `_block_start` block (pinned to its mesh device, if any) and advanced
    on a thread; per-problem trajectories are fleet-composition-independent
    (each live problem consumes only its own RNG stream and frozen problems
    never draw), so results are bit-identical to the one-fleet lane.
    Checkpoints are cut in the canonical MERGED layout
    (`resume.merge_block_states`), identical to the unsharded snapshot, so a
    crashed sharded sweep may resume at any other shard count.
    """
    chunks = shard_chunks(len(probs), n_shards)
    shard_mesh = mesh if len(chunks) == 1 else None
    devices = _shard_devices(mesh, len(chunks), backend)
    sts = [
        packer._block_start(
            [probs[j] for j in c], [rngs[j] for j in c],
            [[] for _ in c], backend, mesh=shard_mesh,
            device=None if devices is None else devices[si % len(devices)],
        )
        for si, c in enumerate(chunks)
    ]
    gd = None
    if ck is not None:
        gd = group_digest(gkeys)
        ck.restore_block_shards(gd, sts, packer.patience)

    while not all(st.done for st in sts):
        if ck is None:
            limit = None  # each shard drains to its budgets in one call
        else:
            it = max(st.it for st in sts if not st.done)
            limit = (it // ck.every + 1) * ck.every
        _run_threads(lambda st: packer._block_run(st, limit),
                     [st for st in sts if not st.done])
        if ck is not None and not all(st.done for st in sts):
            arrays, extra = merge_block_states(sts)
            ck.save_progress(group=gd, arrays=arrays, engine=extra)
    blocks = []
    for st in sts:
        blocks.extend(packer._block_finish(st))
    return blocks


def _solve_sa_groups(
    packer, groups, problems, seeds, backend, keys=None, ck=None,
    n_shards=1, mesh=None,
) -> dict[int, PackingResult]:
    out: dict[int, PackingResult] = {}
    for group in groups:
        probs = [problems[i] for i in group]
        rngs = [np.random.default_rng(seeds[i]) for i in group]
        packer._hetero = probs[0].n_kinds > 1
        if n_shards > 1 and len(group) > 1:
            gkeys = [keys[i] for i in group] if keys is not None else None
            blocks = _solve_sa_group_sharded(
                packer, probs, rngs, backend, n_shards, mesh,
                gkeys=gkeys, ck=ck,
            )
        elif ck is None:
            blocks = packer._anneal_block(
                probs, rngs, [[] for _ in group], backend, mesh=mesh
            )
        else:
            # checkpointed lane: same start/run/finish phases, but paused at
            # iteration barriers for durable snapshots.  Barrier segmentation
            # never changes trajectories, so results stay bit-identical to
            # the uncheckpointed lane.
            gd = group_digest([keys[i] for i in group])
            st = packer._block_start(
                probs, rngs, [[] for _ in group], backend, mesh=mesh
            )
            ck.restore_block(gd, st)  # overwrite from snapshot if it matches
            while not st.done:
                packer._block_run(st, (st.it // ck.every + 1) * ck.every)
                if not st.done:
                    arrays, extra = encode_block_state(st)
                    ck.save_progress(group=gd, arrays=arrays, engine=extra)
            blocks = packer._block_finish(st)
        for i, blk in zip(group, blocks):
            packer.seed = seeds[i]  # per-problem seed lands in result params
            out[i] = packer._result(
                blk.best, blk.best_cost, blk.wall, blk.trace,
                blk.iterations, backend, uphill=blk.uphill,
            )
            if ck is not None:
                ck.mark_done(keys[i], out[i])
        if ck is not None:
            ck.save_progress()  # group complete: results only, no engine state
    return out


def _lockstep_drain(pairs, gen_limit=None, mesh=None, device=None) -> bool:
    """One lockstep generation through the GA segment API — identical to
    ``ga.lockstep_generation`` (which wraps the same phases), written out so
    the sweep lane exercises the begin/apply/finish contract the portfolio's
    fused barrier dispatch builds on.  The stacked fitness calls go to
    ``device`` (default: the packer's; a sub-pack pinned to a mesh device
    passes its own, never writing it to the packer its threads share),
    row-sharded over ``mesh``."""
    advanced, batches = lockstep_begin(pairs, gen_limit)
    for batch in batches:
        packer, run, _ = batch[0]
        lockstep_apply(
            batch,
            stacked_population_costs(
                [r for _, r, _ in batch], run.backend,
                packer.device if device is None else device, mesh=mesh,
            ),
        )
    return lockstep_finish(advanced)


def _solve_ga_groups(
    packer, groups, problems, seeds, backend, keys=None, ck=None,
    n_shards=1, mesh=None,
) -> dict[int, PackingResult]:
    out: dict[int, PackingResult] = {}
    for group in groups:
        runs = [
            packer._start_run(
                problems[i], np.random.default_rng(seeds[i]), None, backend
            )
            for i in group
        ]
        chunks = shard_chunks(len(runs), n_shards)
        shard_mesh = mesh if len(chunks) == 1 else None
        devices = _shard_devices(mesh, len(chunks), backend)
        totals = stacked_population_costs(
            runs, backend, packer.device, mesh=shard_mesh
        )
        for run, tot in zip(runs, totals):
            packer._eval_init(run, tot)
        # drive the GA segment API directly (ga.lockstep_begin / apply /
        # finish): per generation, one mutation phase across every live run,
        # one stacked fitness call per population-size batch, then
        # selection.  With ``n_shards > 1`` the group's runs split into
        # contiguous lockstep sub-packs, each drained on its own thread:
        # fitness values are per-individual, so stack membership never
        # changes any trajectory.
        pair_chunks = [[(packer, runs[j]) for j in c] for c in chunks]

        def drain_chunk(ci, glimit):
            device = None if devices is None else devices[ci % len(devices)]
            while _lockstep_drain(pair_chunks[ci], glimit, mesh=shard_mesh,
                                  device=device):
                pass

        def drain_all(glimit):
            live = [
                ci for ci, c in enumerate(chunks)
                if any(not runs[j].done for j in c)
            ]
            _run_threads(lambda ci: drain_chunk(ci, glimit), live)

        if ck is None:
            drain_all(None)
        else:
            gd = group_digest([keys[i] for i in group])
            ck.restore_ga_group(gd, runs)
            while True:
                live = [run.gen for run in runs if not run.done]
                if not live:
                    break
                glimit = (min(live) // ck.every + 1) * ck.every
                drain_all(glimit)
                if all(run.done for run in runs):
                    break
                arrays, extras = encode_ga_group(runs)
                ck.save_progress(group=gd, arrays=arrays, engine=extras)
        for i, run in zip(group, runs):
            packer.seed = seeds[i]  # per-problem seed lands in result params
            out[i] = packer._finish_run(run)
            if ck is not None:
                ck.mark_done(keys[i], out[i])
        if ck is not None:
            ck.save_progress()
    return out


def _solve_positions(
    todo, problems, seeds, algorithm, *, seed=0, max_seconds=30.0,
    intra_layer=False, backend="auto", device=None, keys=None, ck=None,
    n_shards=1, mesh=None, hyper=None,
) -> tuple[dict[int, PackingResult], int]:
    """Solve the given positions of ``problems`` through the right lane.

    The shared lane dispatcher behind :func:`pack_sweep` (which feeds it
    the deduplicated representatives) and :func:`solve_batch` (which feeds
    it everything).  Returns ``({position: result}, n_groups)``.
    """
    from .api import make_packer, pack as _pack  # late: api re-exports us

    hyper = hyper or {}
    solved: dict[int, PackingResult] = {}
    todo = sorted(todo)
    if not todo:
        return solved, 0
    if algorithm in _SA_BATCHED or algorithm in _GA_LOCKSTEP:
        packer = make_packer(
            algorithm, seed=seed, max_seconds=max_seconds,
            intra_layer=intra_layer, backend=backend, device=device, **hyper,
        )
        resolved = packer._resolve_backend()
    else:
        packer = resolved = None
    if (
        algorithm in _SA_BATCHED
        and resolved != "legacy"
        and packer.n_chains > 1
    ):
        groups = _group_by_cost_model(todo, problems)
        solved = _solve_sa_groups(
            packer, groups, problems, seeds, resolved, keys=keys, ck=ck,
            n_shards=n_shards, mesh=mesh,
        )
    elif algorithm in _GA_LOCKSTEP and resolved in _GA_DEVICE_BACKENDS:
        groups = _group_by_cost_model(todo, problems)
        solved = _solve_ga_groups(
            packer, groups, problems, seeds, resolved, keys=keys, ck=ck,
            n_shards=n_shards, mesh=mesh,
        )
    else:
        # serial lane: scalar engines, the GA on python / legacy, heuristics,
        # portfolio (``n_shards`` / ``mesh`` do not apply).  Checkpoint
        # granularity here is whole candidates: each finished solve is
        # durable, an in-flight one restarts from scratch.
        groups = [[i] for i in todo]
        for i in todo:
            solved[i] = _pack(
                problems[i], algorithm, seed=seeds[i],
                max_seconds=max_seconds, intra_layer=intra_layer,
                backend=backend, device=device, **hyper,
            )
            if ck is not None:
                ck.mark_done(keys[i], solved[i])
                ck.save_progress()
    return solved, len(groups)


def _seed_list(problems, seed, seeds) -> list[int]:
    if seeds is None:
        return [seed] * len(problems)
    seeds = [int(s) for s in seeds]
    if len(seeds) != len(problems):
        raise ValueError("seeds must align with problems")
    return seeds


def solve_batch(
    problems: Sequence[PackingProblem],
    algorithm: str = "sa-s",
    seed: int = 0,
    seeds: Sequence[int] | None = None,
    max_seconds: float = 30.0,
    intra_layer: bool = False,
    backend: str = "auto",
    n_shards: int = 1,
    mesh=None,
    device=None,
    **hyper,
) -> list[PackingResult]:
    """Solve one micro-batch of problems as a single batched fleet.

    The reusable single-batch entry point: no dedup, no caching, no
    checkpointing — just the lane dispatch of :func:`pack_sweep` applied to
    *every* position, returning one :class:`PackingResult` per problem in
    order.  Mixed batches split into one group per cost model.  Each result
    is identical to the standalone ``pack(problems[i], algorithm,
    seed=seeds[i], ...)`` run.  ``device`` as in :func:`api.pack`
    (``None`` means ``"cuda"``); ``n_shards`` and ``mesh`` as in
    :func:`pack_sweep`.
    """
    problems = list(problems)
    if not problems:
        raise ValueError("solve_batch needs at least one problem")
    algorithm = algorithm.lower()
    seeds = _seed_list(problems, seed, seeds)
    hyper = normalize_hyper(algorithm, hyper)
    n_shards = check_shards(n_shards, mesh, device)
    device = resolve_device(device)
    solved, _ = _solve_positions(
        range(len(problems)), problems, seeds, algorithm, seed=seed,
        max_seconds=max_seconds, intra_layer=intra_layer, backend=backend,
        device=device, n_shards=n_shards, mesh=mesh, hyper=hyper,
    )
    return [solved[i] for i in range(len(problems))]


def pack_sweep(
    problems: Sequence[PackingProblem],
    algorithm: str = "sa-s",
    seed: int = 0,
    seeds: Sequence[int] | None = None,
    max_seconds: float = 30.0,
    intra_layer: bool = False,
    backend: str = "auto",
    cache: dict | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 256,
    resume: bool = False,
    on_checkpoint=None,
    n_shards: int = 1,
    mesh=None,
    device=None,
    **hyper,
) -> SweepResult:
    """Solve a fleet of packing problems in one vectorized run.

    The arguments are the reference's (`repro.core.pack_sweep`), plus
    ``device`` (``None`` means ``"cuda"`` and raises where CUDA is not
    available; pass ``"cpu"`` to run on the host).  Parameters mirror
    :func:`api.pack` (the paper's Table-2 hyperparameter names pass
    through ``hyper``), applied to every candidate:

    * ``problems`` — the DSE candidates; duplicates (by
      :meth:`PackingProblem.fingerprint` + seed + settings) are solved once.
    * ``seed`` / ``seeds`` — one base seed for all candidates (the default,
      which maximizes dedup), or an explicit per-candidate seed list.
    * ``intra_layer`` — forbid mixing layers within a bin (fleet-wide).
    * ``backend`` — as in :func:`api.pack`; the GA's batched lane needs a
      device backend (``torch`` / ``cuda``, or ``auto``), on ``python`` it
      runs the serial loop.
    * ``cache`` — optional caller-owned dict carrying solutions across
      sweeps; hits skip solving entirely.
    * ``algorithm="sa-s"`` (the default) gets ``n_chains=8`` unless given;
      each candidate's result is bit-identical to the standalone
      ``pack(prob, algorithm, seed=..., n_chains=...)`` run, so batching
      changes throughput only — never answers.

    Crash safety: with ``checkpoint_dir`` the sweep cuts a durable snapshot
    every ``checkpoint_every`` engine iterations/generations (plus one per
    completed group) — completed candidates and the in-flight batched
    group's full engine state.  ``resume=True`` restarts from the newest
    *intact* snapshot (corrupt or torn steps are skipped) and lands on
    results bit-identical to an uninterrupted same-seed run; a snapshot of
    the reference's ``pack_sweep`` resumes here and the other way round.
    ``on_checkpoint(step)`` fires after each durable write.  Resumed
    candidates count as cache hits, not fresh solves.

    Scaling past one fleet (execution shape only, never answers):

    * ``n_shards`` — split each batched group into that many contiguous
      sub-fleets (SA) / lockstep sub-packs (GA), advanced concurrently on
      host threads.  Per-problem trajectories are fleet-composition-
      independent, so any shard count is **bit-identical** to
      ``n_shards=1``; checkpoints are cut in a canonical merged layout, so
      a crashed sharded sweep resumes at any other shard count (and in the
      reference).  ``params["n_shards"]`` holds the requested count.
    * ``mesh`` — a 1-D ``("prob",)`` `launch.mesh.SweepMesh` of
      ``device``'s type (another type raises ``ValueError``).  With
      ``n_shards=1`` every kernel call is row-split over the mesh's
      devices, one launch each; with ``n_shards > 1`` the sub-fleets are
      pinned round-robin to them instead.  Device backends (``torch`` /
      ``cuda``) only; ``python`` and the serial lane ignore it.  On one
      card, ``SweepMesh([cuda:0] * k)`` runs k logical shards of it: the
      row split and the pinning, not a scaling across cards.

    The call is the entry span ``dse.sweep`` (`repro_torch.obs`).
    """
    with obs.span("dse.sweep", entry=True):
        problems = list(problems)
        if not problems:
            raise ValueError("pack_sweep needs at least one problem")
        algorithm = algorithm.lower()
        seeds = _seed_list(problems, seed, seeds)
        hyper = normalize_hyper(algorithm, hyper)
        n_shards = check_shards(n_shards, mesh, device)
        device = resolve_device(device)
        t_start = time.perf_counter()

        keys = _task_keys(problems, algorithm, seeds, intra_layer, backend,
                          max_seconds, hyper)
        ck = None
        if checkpoint_dir is not None:
            ck = SweepCheckpointer(
                checkpoint_dir, sweep_config_key(keys), every=checkpoint_every,
                resume=resume, on_checkpoint=on_checkpoint,
            )
        results_by_key: dict[tuple, PackingResult] = {}
        if cache is not None:
            for k in set(keys):
                if k in cache:
                    results_by_key[k] = cache[k]
        if ck is not None:
            # candidates completed before the crash are served, not re-solved
            for i, k in enumerate(keys):
                if k not in results_by_key:
                    prev = ck.result_for(k, problems[i])
                    if prev is not None:
                        results_by_key[k] = prev
        rep: dict[tuple, int] = {}  # first position of each unsolved unique task
        for i, k in enumerate(keys):
            if k not in results_by_key and k not in rep:
                rep[k] = i
        fresh = tuple(sorted(rep.values()))
        cache_hits = len(problems) - len(fresh)

        # --- lane dispatch for the unsolved representatives
        n_groups = 0
        if rep:
            solved, n_groups = _solve_positions(
                rep.values(), problems, seeds, algorithm, seed=seed,
                max_seconds=max_seconds, intra_layer=intra_layer,
                backend=backend, device=device, keys=keys, ck=ck,
                n_shards=n_shards, mesh=mesh, hyper=hyper,
            )
            for i, res in solved.items():
                results_by_key[keys[i]] = res
                if cache is not None:
                    cache[keys[i]] = res

        return SweepResult(
            results=[results_by_key[k] for k in keys],
            problems=problems,
            wall_time_s=time.perf_counter() - t_start,
            n_solved=len(fresh),
            cache_hits=cache_hits,
            n_groups=n_groups,
            algorithm=algorithm,
            fresh=fresh,
            params=dict(
                solved=len(fresh),
                cache_hits=len(set(keys)) - len(fresh),
                dedup_hits=len(problems) - len(set(keys)),
                n_shards=n_shards,
            ),
        )
