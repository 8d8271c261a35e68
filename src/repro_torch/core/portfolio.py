"""Multi-seed island portfolio: a deterministic fleet of GA/SA islands (the
port's `repro.core.portfolio`).

K islands (differently-seeded GA/SA instances, possibly with different
algorithms or hyperparameters) evolve on one problem and periodically
exchange their best packing.  The portfolio is fleet-native and
iteration-budgeted, as in the reference:

* every multi-chain ``sa-s`` island rides one SA fleet core
  (`SimulatedAnnealingPacker._block_start` / `_block_run`): K same-problem
  islands are a ``P = K`` fleet with one ``np.random.Generator`` per island;
* GA islands advance generation by generation through the ``lockstep_*``
  phases of `core.ga`, stacking every island's population fitness into one
  leading-axis ``(A, n_pop, NB)`` call;
* scalar engines (``sa-nfd``'s sequential NFD repack, single-chain ``sa-s``,
  the ``legacy`` backend) run their own resumable loops, advanced in
  segments;
* **migration is a deterministic array exchange at fixed barriers**: the
  global best lands in each *other* island's worst warm slot iff strictly
  better under the inventory-penalized cost; patience counters are never
  touched, so a frozen island is never revived.

Because islands advance by iteration counts and each consumes only its own
seeded RNG stream, ``pack_portfolio(prob, seed=s, ...)`` is bit-identical
to ``repro.core.pack_portfolio`` with the same arguments (given iteration
budgets; ``max_seconds`` is an outer safety cap only), under both
schedulers, fused or not, and with ``auto=True`` racing.

**Fused barriers.**  Where the SA fleet and the GA islands both run on a
device backend (``torch`` / ``cuda``), one barrier cycle answers the
fleet's step request and the GA generation's stacked fitness batch with
one ``binpack_portfolio_step`` call — on ``cuda`` the single launch of
kernel K5.  Cycles where only one engine has work (the fleet drained while
the GA runs on, or several population sizes) go through K1/K2 and K3/K4
separately.  Both routes give the same integers, so the trajectory is the
same.

**Two host threads.**  The concurrent scheduler runs the main lane (the
fleet, or the fused pair) on the calling thread and every other group on a
`ThreadPoolExecutor` side lane, so kernel calls come from two threads.
Each launches on its thread's current stream — the device's default stream
unless a caller set another — and each ops call ends in a synchronising
copy back, so no result is read before its own launch has finished and no
buffer of one thread is written by the other's launch.  The launch counters
take a lock (`kernels.build.count_launch`).

**Sharded fleets.**  ``n_shards`` splits the SA fleet's islands into
contiguous sub-fleets, one block state each, advanced concurrently on
threads at every barrier; ``mesh`` (a `launch.mesh.SweepMesh`) row-splits
each fleet step and GA fitness call over its devices (one shard) or pins
the sub-fleets to them round-robin (several).  Both are execution-shape
knobs only — each island consumes only its own RNG stream, so any shard
count and mesh is bit-identical to the one-fleet layout, and snapshots
resume across shard counts.  Fused dispatch needs the fleet in one piece,
so a split fleet runs unfused.  On a one-card machine a mesh is k logical
shards of that card: it runs the row split and the pinning, not a scaling
across cards.

**Crash safety.**  With ``checkpoint_dir`` the run cuts a durable snapshot
(`core.resume.PortfolioCheckpointer`) every ``checkpoint_every`` barriers;
``resume=True`` restarts from the newest intact one.  The snapshot is the
reference's, so a run checkpointed by either package resumes in the other.

The reference's wall-clock thread-pool portfolio is here too, as
:func:`pack_portfolio_threads`: a benchmark baseline only, outside the
determinism and resume contracts.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..device import resolve_device
# imported here, on the importing thread, never first on an island or
# shard thread (two threads importing kernel packages can deadlock on
# their module locks); called through the module, so patches apply
from ..kernels.binpack_portfolio_step import ops as portfolio_ops
from .dse import _run_threads, _shard_devices, check_shards, shard_chunks
from .ga import (
    GeneticPacker,
    lockstep_apply,
    lockstep_begin,
    lockstep_finish,
    lockstep_generation,
    stack_geometry,
    stacked_population_costs,
)
from .problem import (
    DEFAULT_INVENTORY_PENALTY,
    PackingProblem,
    PackingResult,
    Solution,
    decode_chain_items,
)
from .resume import PortfolioCheckpointer, portfolio_config_key
from .sa import SimulatedAnnealingPacker

# default barrier spacing: SA iterations / GA generations between migrations
DEFAULT_MIGRATION_EVERY = 64

# Per-engine-family barrier strides on heterogeneous lineups (>1 engine
# group): one barrier advances the delta-kernel SA engines (fleet and
# single-chain sa-s) ``migration_every`` annealing steps, scaled up by the
# lineup's GA island count, the scalar loops (sa-nfd) a quarter of that
# base, and the GA lockstep pack 1/32 of it in generations.  The divisors
# are static constants of the reference, so strides depend only on the
# lineup and ``migration_every``, never on machine speed, and trajectories
# stay bit-identical to the reference's.  Homogeneous lineups (a single
# engine group) keep the uniform stride.
_SCALAR_STRIDE_DIV = 4
_GA_STRIDE_DIV = 32

# Racing ledger currency (``pack_portfolio(auto=True)``): one unit is one
# chain-annealing step.  A fleet island burns ``stride * n_chains`` units per
# barrier, a scalar/single-chain island ``stride``, and a GA island
# ``stride * n_pop * _GA_GEN_WORK``.  The weights are static functions of
# the lineup, so the ledger and every elimination are machine-independent.
_GA_GEN_WORK = 5

# Default race grid for ``pack_portfolio(auto=True)``: ``(algorithm,
# hyper-overrides)`` entries over the axes the paper shows the mappers are
# sensitive to; island k races with seed ``seed + k``.
DEFAULT_RACE_GRID = (
    ("sa-s", {}),
    ("sa-s", {"n_chains": 16, "ladder_max": 8.0}),
    ("sa-s", {"n_chains": 4, "ladder_min": 0.25, "ladder_max": 1.0}),
    ("sa-s", {"sa_t0": 60.0, "sa_rc": 0.5}),
    ("sa-s", {"sa_t0": 10.0, "sa_rc": 2.0}),
    ("sa-s", {"swap_moves": 4}),
    ("ga-nfd", {}),
    ("ga-nfd", {"n_pop": 25, "p_mut": 0.6}),
    ("ga-nfd", {"n_pop": 150}),
    ("ga-nfd", {"n_pop": 5, "p_mut": 0.8}),
    ("ga-s", {"n_pop": 25}),
    ("sa-nfd", {}),
)

# offset between per-round reseeds of the legacy thread-pool portfolio; any
# large odd constant keeps island streams disjoint from the base seeds
_ROUND_SEED_STRIDE = 7919


class TruncationWarning(RuntimeWarning):
    """A wall-clock cap cut a run short of its iteration/patience budgets —
    the result is NOT seed-reproducible across machines."""


@dataclasses.dataclass(frozen=True)
class IslandSpec:
    """One island: which packer, which base seed, which overrides."""

    algorithm: str = "ga-nfd"
    seed: int = 0
    hyper: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------- island views
class _SAFleetGroup:
    """K same-problem sa-s islands advanced as ONE fleet.

    Row ``j * C + c`` is chain ``c`` of island ``j``; the bin-slot envelope
    is widened to ``prob.n`` so any migrant packing can be encoded into a
    chain slot (envelope padding never affects trajectories).

    ``n_shards`` splits the islands into contiguous sub-fleets, one block
    state per shard (``sts``), advanced concurrently on threads at every
    barrier; ``mesh`` row-shards each fleet step over a ``("prob",)`` sweep
    mesh (with one shard) or pins the sub-fleets round-robin to the mesh's
    devices (with several), each pin held in its block state.  Both are
    execution-shape knobs only: each island consumes only its own RNG
    stream, so any shard count is bit-identical to the one-fleet layout.
    `core.resume.PortfolioCheckpointer` saves the shards in the canonical
    merged layout of the reference's fleet."""

    def __init__(self, packer, prob, rngs, backend, n_shards=1, mesh=None):
        self.packer = packer
        chunks = shard_chunks(len(rngs), n_shards)
        shard_mesh = mesh if len(chunks) == 1 else None
        devices = _shard_devices(mesh, len(chunks), backend)
        self.sts = [
            packer._block_start(
                [prob] * len(c), [rngs[j] for j in c], [[] for _ in c],
                backend, n_slots=prob.n, mesh=shard_mesh,
                device=None if devices is None else devices[si % len(devices)],
            )
            for si, c in enumerate(chunks)
        ]
        self._starts = [c[0] for c in chunks]

    @property
    def st(self):
        """The lone block state of an unsharded fleet (the common case and
        the fused-dispatch requirement); a split fleet has no single state
        — address islands through :meth:`state_of`."""
        if len(self.sts) != 1:
            raise RuntimeError(
                f"fleet is split into {len(self.sts)} shards; use state_of(j)"
            )
        return self.sts[0]

    def state_of(self, j: int):
        """(block state, local row) owning island ``j``."""
        for st, lo in zip(reversed(self.sts), reversed(self._starts)):
            if j >= lo:
                return st, j - lo
        raise IndexError(j)

    def _run_shard(self, st, limit: int | None) -> None:
        if not st.done:
            self.packer._block_run(st, limit)

    def advance(self, limit: int | None) -> bool:
        live = [st for st in self.sts if not st.done]
        if not live:
            return False
        before = [st.it for st in live]
        _run_threads(lambda st: self._run_shard(st, limit), live)
        return any(st.it > b for st, b in zip(live, before))


class _FleetIsland:
    """View of one member problem of a `_SAFleetGroup`."""

    def __init__(self, group: _SAFleetGroup, j: int):
        self.group = group
        self.j = j
        self.packer = group.packer
        self.eliminated = False

    def done(self) -> bool:
        st, j = self.group.state_of(self.j)
        return st.done or self.packer._block_frozen(st, j)

    def extend(self, it_limit: int) -> None:
        st, _ = self.group.state_of(self.j)
        self.packer._block_extend(st, it_limit)

    def eliminate(self) -> None:
        st, j = self.group.state_of(self.j)
        self.packer._block_eliminate(st, j)
        self.eliminated = True

    def raw(self) -> tuple[int, int]:
        st, j = self.group.state_of(self.j)
        cost = int(st.gbest_cost[j])
        if st.hetero:
            ovf = int(st.batch.overflow_rows(
                st.g_UK[j : j + 1], np.asarray([j])
            )[0])
        else:
            ovf = 0
        return cost, ovf

    def best_solution(self) -> Solution:
        st, j = self.group.state_of(self.j)
        return decode_chain_items(
            st.probs[j], st.g_items[j], st.g_counts[j],
            st.g_kinds[j] if st.hetero else None,
        )

    def migrate_in(self, sol: Solution) -> bool:
        st, j = self.group.state_of(self.j)
        return self.packer._block_migrate(st, j, sol)

    def trace(self) -> list:
        st, j = self.group.state_of(self.j)
        return st.traces[j]

    def offset(self, t0: float) -> float:
        st, _ = self.group.state_of(self.j)
        return st.t_start - t0

    def iterations(self) -> int:
        (st, j), c = self.group.state_of(self.j), self.packer.n_chains
        return int(st.steps[j * c : (j + 1) * c].sum())

    def truncated(self) -> bool:
        """True iff the fleet stopped on the wall-clock cap — done, but
        neither frozen (patience) nor out of iteration budget."""
        if self.eliminated:
            return False
        st, _ = self.group.state_of(self.j)
        return st.done and not st.frozen and st.it < self.packer.max_iterations


class _GAGroup:
    """All GA islands, advanced in lockstep with stacked fitness calls;
    ``mesh`` row-shards each stacked call over a ``("prob",)`` sweep mesh
    (execution shape only, bit-identical)."""

    def __init__(self, pairs, mesh=None):
        self.pairs = pairs  # [(packer, run)] in island order
        self.mesh = mesh

    def advance(self, limit: int | None) -> bool:
        progressed = False
        while lockstep_generation(self.pairs, gen_limit=limit, mesh=self.mesh):
            progressed = True
        return progressed


class _GAIsland:
    def __init__(self, packer: GeneticPacker, run):
        self.packer = packer
        self.run = run
        self.eliminated = False

    def done(self) -> bool:
        # exhausted patience counts as done even before the next lockstep
        # call marks it (mirrors _ScalarIsland: no migrants for converged runs)
        return self.run.done or self.run.stale >= self.packer.patience

    def extend(self, gen_limit: int) -> None:
        self.packer._extend_run(self.run, gen_limit)

    def eliminate(self) -> None:
        self.packer._eliminate_run(self.run)
        self.eliminated = True

    def raw(self) -> tuple[int, int]:
        cost = int(self.run.best_cost)
        ovf = int(self.run.best.inventory_overflow()) if self.run.hetero else 0
        return cost, ovf

    def best_solution(self) -> Solution:
        return self.run.best

    def migrate_in(self, sol: Solution) -> bool:
        return self.packer._migrate_in(self.run, sol)

    def trace(self) -> list:
        return self.run.trace

    def offset(self, t0: float) -> float:
        return self.run.t0 - t0

    def iterations(self) -> int:
        return self.run.gen

    def truncated(self) -> bool:
        return (
            not self.eliminated
            and self.run.done
            and self.run.gen < self.packer.max_generations
            and self.run.stale < self.packer.patience
        )


class _ScalarIsland:
    """A scalar-loop or single-chain SA island (its own resumable state)."""

    def __init__(self, packer: SimulatedAnnealingPacker, st, single: bool):
        self.packer = packer
        self.st = st
        self.single = single
        self.eliminated = False

    def extend(self, it_limit: int) -> None:
        self.packer._loop_extend(self.st, it_limit)

    def eliminate(self) -> None:
        self.packer._loop_eliminate(self.st)
        self.eliminated = True

    def advance(self, limit: int | None) -> bool:
        if self.st.done:
            return False
        before = self.st.it
        run = self.packer._single_run if self.single else self.packer._scalar_run
        run(self.st, limit)
        return self.st.it > before

    def done(self) -> bool:
        return self.st.done or self.st.stale >= self.packer.patience

    def raw(self) -> tuple[int, int]:
        return int(self.st.best_cost), int(self.st.best_ovf)

    def best_solution(self) -> Solution:
        return self.st.best

    def migrate_in(self, sol: Solution) -> bool:
        hook = (
            self.packer._single_migrate if self.single
            else self.packer._scalar_migrate
        )
        return hook(self.st, sol)

    def trace(self) -> list:
        return self.st.trace

    def offset(self, t0: float) -> float:
        return self.st.t_start - t0

    def iterations(self) -> int:
        return self.st.it

    def truncated(self) -> bool:
        return (
            not self.eliminated
            and self.st.done
            and self.st.it < self.packer.max_iterations
            and self.st.stale < self.packer.patience
        )


def _merge_traces(parts: list[tuple[float, list]]) -> list:
    """Global monotone best-so-far trace across (offset, trace) parts."""
    events: list[tuple[float, float]] = []
    for offset, tr in parts:
        events.extend((offset + t, cc) for t, cc in tr)
    events.sort()
    merged: list = []
    best = None
    for t, cc in events:
        if best is None or cc < best:
            best = cc
            merged.append((t, cc))
    return merged


def _sa_fleet_key(packer: SimulatedAnnealingPacker, resolved: str) -> tuple:
    """Engine signature under which sa-s islands share one fleet: everything
    that shapes the array program except the seed (per-island RNG streams
    keep differently-seeded islands independent inside one fleet)."""
    return (
        resolved, packer.n_chains, packer.t0, packer.rc, packer.swap_moves,
        packer.p_adm_w, packer.p_adm_h, packer.intra_layer,
        packer.max_iterations, packer.patience, packer.max_seconds,
        packer.exchange_every, packer.ladder_min, packer.ladder_max,
        packer.p_kind, packer.inventory_penalty,
    )


def _family_stride(family: str, interval: int, ga_islands: int) -> int:
    """Barrier stride (iterations/generations per barrier) of one engine
    family — ``"ga"``, ``"scalar"`` (sa-nfd's sequential repack / the
    legacy backend) or
    ``"delta"`` (fleet and single-chain sa-s) — on a heterogeneous lineup;
    ``ga_islands`` scales the SA strides (see `_GA_STRIDE_DIV`)."""
    if family == "ga":
        return max(1, interval // _GA_STRIDE_DIV)
    mult = max(1, ga_islands)
    if family == "scalar":
        return max(1, interval // _SCALAR_STRIDE_DIV) * mult
    return interval * mult


def _group_stride(group, interval: int, ga_islands: int) -> int:
    """`_family_stride` of one built engine group."""
    if isinstance(group, _GAGroup):
        family = "ga"
    elif isinstance(group, _ScalarIsland) and not group.single:
        family = "scalar"
    else:
        family = "delta"
    return _family_stride(family, interval, ga_islands)


def _island_family(packer) -> str:
    """The `_family_stride` family a packer's island lands in."""
    if isinstance(packer, GeneticPacker):
        return "ga"
    if packer.perturbation == "nfd" or packer._resolve_backend() == "legacy":
        return "scalar"
    return "delta"


def _island_work(packer, family: str, stride: int) -> int:
    """Ledger units (chain-annealing-step equivalents, see `_GA_GEN_WORK`)
    one island burns per barrier."""
    if family == "ga":
        return stride * packer.n_pop * _GA_GEN_WORK
    if family == "delta" and packer.n_chains > 1:
        return stride * packer.n_chains
    return stride


def _lineup_work(packers, interval: int) -> int:
    """Total ledger work the given lineup would consume running every
    island to its configured iteration/generation budget (rounded up to
    whole barriers) — the default ledger of ``pack_portfolio(auto=True)``,
    so auto-tuning never spends more than the lineup it replaces."""
    fams = [_island_family(p) for p in packers]
    n_ga = fams.count("ga")
    fleet_keys = {
        _sa_fleet_key(p, p._resolve_backend())
        for p, f in zip(packers, fams)
        if f == "delta" and p.n_chains > 1
    }
    # group count mirrors pack_portfolio's construction: one GA lockstep
    # pack, one group per distinct fleet signature, one per scalar island
    n_groups = (
        (1 if n_ga else 0)
        + len(fleet_keys)
        + sum(1 for p, f in zip(packers, fams)
              if f == "scalar" or (f == "delta" and p.n_chains == 1))
    )
    multi = n_groups > 1
    seg = interval if interval > 0 else DEFAULT_MIGRATION_EVERY
    total = 0
    for p, f in zip(packers, fams):
        s = _family_stride(f, seg, n_ga) if (multi and interval > 0) else seg
        budget = p.max_generations if f == "ga" else p.max_iterations
        barriers = -(-int(budget) // s)  # ceil: whole-barrier accounting
        total += barriers * _island_work(p, f, s)
    return total


class _Race:
    """Successive-halving race state over the portfolio's island adapters.

    The ledger (``budget``, in `_island_work` units) is split evenly over
    ``halvings + 1`` phases; each time a phase's share is spent the worse
    half of the surviving islands is eliminated (penalized best cost,
    first island wins ties) until ``final_k`` remain, and the rest of the
    ledger is spent advancing the survivors further.  Every decision is a
    pure function of island trajectories and the static work weights, so
    races are bit-reproducible."""

    def __init__(self, work: list[int], budget: int, final_k: int):
        self.work = [int(w) for w in work]
        self.budget = int(budget)
        self.final_k = max(1, int(final_k))
        n = len(work)
        self.halvings = 0
        s = n
        while s > self.final_k:
            s = max(self.final_k, (s + 1) // 2)
            self.halvings += 1
        self.phase_budget = max(1, self.budget // (self.halvings + 1))
        self.alive = [True] * n
        self.spent = 0
        self.rung = 0
        self.rung_spent = 0
        self.eliminated: list[dict] = []

    def state(self) -> dict:
        """JSON-able snapshot payload (checkpoint codec)."""
        return {
            "budget": self.budget,
            "spent": self.spent,
            "rung": self.rung,
            "rung_spent": self.rung_spent,
            "eliminated": self.eliminated,
        }

    def restore(self, state: dict, adapters) -> None:
        """Re-enter a checkpointed race: replay the recorded eliminations
        onto the freshly restored adapters (idempotent — the engine states
        in the snapshot are already frozen/stopped) and resume the ledger."""
        self.spent = int(state["spent"])
        self.rung = int(state["rung"])
        self.rung_spent = int(state["rung_spent"])
        self.eliminated = [dict(e) for e in state["eliminated"]]
        for e in self.eliminated:
            k = int(e["island"])
            self.alive[k] = False
            adapters[k].eliminate()

    def live(self, adapters) -> list[int]:
        """Islands still racing AND still able to advance (not frozen)."""
        return [
            k for k, isl in enumerate(adapters)
            if self.alive[k] and not isl.done()
        ]

    def charge(self, live: list[int]) -> bool:
        """Burn one barrier's work for ``live``; False when the ledger
        cannot cover it (the race is over — never overspends)."""
        cost = sum(self.work[k] for k in live)
        if cost <= 0 or self.spent + cost > self.budget:
            return False
        self.spent += cost
        self.rung_spent += cost
        return True

    def maybe_halve(self, adapters, barrier: int, lam: float) -> None:
        """At a rung boundary (this phase's ledger share is spent), keep
        the best half of the surviving islands and eliminate the rest."""
        if self.rung >= self.halvings or self.rung_spent < self.phase_budget:
            return
        self.rung += 1
        self.rung_spent = 0
        racing = [k for k in range(len(adapters)) if self.alive[k]]
        keep = max(self.final_k, (len(racing) + 1) // 2)
        if keep >= len(racing):
            return
        vals = {
            k: (lambda c, o: c + lam * o)(*adapters[k].raw()) for k in racing
        }
        ranked = sorted(racing, key=lambda k: (vals[k], k))
        for k in ranked[keep:]:
            self.alive[k] = False
            adapters[k].eliminate()
            self.eliminated.append(
                {"island": k, "barrier": int(barrier), "value": float(vals[k])}
            )


def _group_label(group, i: int) -> str:
    if isinstance(group, _SAFleetGroup):
        return f"g{i}:fleet"
    if isinstance(group, _GAGroup):
        return f"g{i}:ga"
    return f"g{i}:single" if group.single else f"g{i}:scalar"


def _timed_advance(group, limit) -> tuple[bool, float]:
    """Side-lane unit of work: advance one group to its barrier limit and
    report (progressed, seconds).  Groups share no mutable state and each
    island consumes only its own RNG stream, so running these on a thread
    pool is bit-identical to the serial loop."""
    t = time.perf_counter()
    progressed = group.advance(limit)
    return progressed, time.perf_counter() - t


def _pump(gen, d_e):
    """Feed one delta-cost answer into a `_block_gen` step generator."""
    try:
        return gen.send(d_e)
    except StopIteration:
        return None


def _advance_fused(
    fleet: _SAFleetGroup, ga: _GAGroup, fleet_limit, ga_limit
) -> tuple[bool, bool]:
    """Advance the SA fleet and the GA lockstep pack *together*, answering
    one fleet step request and one stacked GA generation's fitness batch
    with a single ``binpack_portfolio_step`` call whenever both have work
    (odd cycles — fleet drained, GA still running, or several population
    sizes — take the separate fitness / delta calls).  Each engine still
    consumes only its own RNG stream in its own order, and the fused call
    returns exactly the separate calls' integers, so the trajectory is the
    unfused one.  Returns (fleet_progressed, ga_progressed)."""
    packer, st = fleet.packer, fleet.st  # fusing needs the fleet in one shard
    before = st.it
    gen = None if st.done else packer._block_gen(st, fleet_limit)
    req = next(gen, None) if gen is not None else None
    ga_progressed = False
    while True:
        advanced, batches = lockstep_begin(ga.pairs, ga_limit)
        if req is None and not advanced:
            break
        if req is not None and len(batches) == 1:
            batch = batches[0]
            W, H, Km = stack_geometry([r for _, r, _ in batch])
            old_w, old_h, new_w, new_h, old_k, new_k = req
            totals, d_e = portfolio_ops.portfolio_step(
                W, H, old_w, old_h, new_w, new_h,
                modes=st.modes0, backend=st.backend,
                kinds=Km, old_k=old_k, new_k=new_k,
                kind_tables=st.kt if old_k is not None else None,
                device=st.device, mesh=st.mesh,
            )
            lockstep_apply(batch, totals)
            batches = []
            req = _pump(gen, d_e)
        elif req is not None:
            req = _pump(gen, packer._block_eval(st, req))
        for batch in batches:
            p0, r0, _ = batch[0]
            lockstep_apply(
                batch,
                stacked_population_costs(
                    [r for _, r, _ in batch], r0.backend, p0.device,
                    mesh=ga.mesh,
                ),
            )
        if lockstep_finish(advanced):
            ga_progressed = True
    return st.it > before, ga_progressed


def pack_portfolio(
    prob: PackingProblem,
    islands: Sequence[IslandSpec] | None = None,
    n_islands: int = 4,
    algorithms: Sequence[str] = ("ga-nfd", "sa-s", "sa-nfd"),
    seed: int = 0,
    max_seconds: float = 30.0,
    migration_every: int | None = None,
    intra_layer: bool = False,
    backend: str = "auto",
    max_workers: int | None = None,
    sa_chains: int = 8,
    scheduler: str = "concurrent",
    fused: bool | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    on_checkpoint=None,
    n_shards: int = 1,
    mesh=None,
    auto: bool = False,
    race_grid=None,
    race_budget: int | None = None,
    race_final: int = 2,
    device=None,
    **hyper,
) -> PackingResult:
    """Run K differently-seeded islands as one fleet; return the best result.

    The arguments are the reference's (`repro.core.pack_portfolio`), plus
    ``device`` (``None`` means ``"cuda"`` and raises where CUDA is not
    available; pass ``"cpu"`` to run on the host); ``max_workers`` is
    deprecated and ignored, as there.  The result is
    bit-identical to the reference's for the same arguments and iteration
    budgets: cost, packing, iterations, the trace's cost sequence and the
    ``barriers`` / ``migrations`` / ``strides`` / ``race`` params.

    ``islands`` gives full control; otherwise ``n_islands`` specs cycle
    ``algorithms`` with seeds ``seed, seed+1, ...``.  ``hyper`` takes the
    Table-2 names of :func:`repro_torch.core.api.pack` and applies to every
    island (per-island ``IslandSpec.hyper`` overrides win).
    ``migration_every`` is an iteration/generation count (default 64); on
    heterogeneous lineups each engine family advances at its own static
    stride (`_family_stride`); ``0`` disables migration.  ``max_seconds``
    is an outer safety cap only: give the islands iteration budgets
    (``max_iterations`` / ``max_generations``) for reproducible runs.

    ``scheduler``: ``"concurrent"`` (default) advances the main lane (the
    SA fleet, or the fused fleet+GA pair) on the calling thread and every
    other group on a side-lane thread pool; ``"serial"`` advances groups one
    after another.  Both are bit-identical.  ``fused=None`` (auto) fuses
    the fleet's step requests and the GA's stacked fitness batches into one
    ``binpack_portfolio_step`` call per cycle when the fleet and every
    batched GA island resolved to a device backend (``torch`` or ``cuda``);
    ``True``/``False`` force it (the concurrent scheduler only).

    ``auto=True`` replaces the fixed lineup with a successive-halving race
    over ``race_grid`` (default `DEFAULT_RACE_GRID`) under a work ledger
    (``race_budget``, default: the default lineup's total work);
    ``params["race"]`` records the ledger, the eliminations and the
    survivors.

    Crash safety: with ``checkpoint_dir`` the run cuts a durable snapshot
    of every island's engine state (plus the barrier/migration counters and
    a race's ledger) every ``checkpoint_every`` barriers; ``resume=True``
    restarts from the newest *intact* snapshot and lands on the result of
    the uninterrupted run, bit for bit.  A run that would advance in one
    unbounded call (one island, or migration off) pauses at
    ``DEFAULT_MIGRATION_EVERY``-iteration barriers to cut its snapshots.
    ``max_seconds`` is not part of the snapshot's identity, so a preempted
    run may resume under a fresh wall budget.  ``on_checkpoint(step)``
    fires after each durable write.

    If the wall-clock cap cuts any island short of its budgets,
    ``params["truncated_by_wallclock"]`` is True and a `TruncationWarning`
    is emitted.  ``params["barrier_seconds"]`` (per barrier) and
    ``params["group_seconds"]`` (per engine group, a fused pair as
    ``"gI+gJ:fused"``) attribute the wall time; they are diagnostics, not
    part of the parity contract.

    Scaling past one fleet: ``n_shards`` splits the SA fleet into
    contiguous sub-fleets advanced concurrently on host threads between
    barriers, and ``mesh`` (a `launch.mesh.SweepMesh` of ``device``'s
    type) row-splits each fleet step and GA fitness call over its devices
    (one shard) or pins the sub-fleets round-robin to them (several).  Both
    are execution-shape knobs only: every shard count and mesh is
    **bit-identical** to the default, and snapshots are cut in the
    canonical merged fleet layout, so a run may resume at a different
    shard count.  Fused dispatch needs the fleet in one piece, so
    ``n_shards > 1`` turns it off (``params["fused"] is False``).  On one
    card, ``SweepMesh([cuda:0] * k)`` runs k logical shards of it: the
    row split and the pinning, not a scaling across cards.
    """
    from .api import make_packer  # late import: api imports this module lazily

    if max_workers is not None:
        warnings.warn(
            "pack_portfolio(max_workers=...) is deprecated and ignored: the "
            "portfolio is fleet-native (no thread pool); use "
            "pack_portfolio_threads for the legacy engine",
            DeprecationWarning,
            stacklevel=2,
        )
    n_shards = check_shards(n_shards, mesh, device)
    device = resolve_device(device)
    if not auto and (race_grid is not None or race_budget is not None):
        raise ValueError("race_grid/race_budget require auto=True")
    if n_islands < 1:
        raise ValueError("n_islands must be >= 1")
    default_specs = [
        IslandSpec(algorithm=algorithms[k % len(algorithms)], seed=seed + k)
        for k in range(n_islands)
    ]
    if auto:
        if islands is not None:
            raise ValueError(
                "pass auto=True (with race_grid=...) or islands=..., not both"
            )
        grid = DEFAULT_RACE_GRID if race_grid is None else list(race_grid)
        islands = [
            entry if isinstance(entry, IslandSpec)
            else IslandSpec(algorithm=entry[0], seed=seed + k,
                            hyper=dict(entry[1]))
            for k, entry in enumerate(grid)
        ]
    elif islands is None:
        islands = default_specs
    islands = list(islands)
    if not islands:
        raise ValueError("portfolio needs at least one island")
    interval = (
        DEFAULT_MIGRATION_EVERY if migration_every is None
        else int(migration_every)
    )
    if scheduler not in ("concurrent", "serial"):
        raise ValueError(
            f"unknown scheduler {scheduler!r}; options: concurrent, serial"
        )
    ck = None
    if checkpoint_dir is not None:
        ck = PortfolioCheckpointer(
            checkpoint_dir,
            portfolio_config_key(
                prob, islands, interval, intra_layer, backend, sa_chains,
                hyper,
                race=(
                    (int(race_budget) if race_budget is not None else None,
                     int(race_final))
                    if auto else None
                ),
            ),
            every=checkpoint_every, resume=resume, on_checkpoint=on_checkpoint,
        )
    hetero = prob.n_kinds > 1
    t0 = time.perf_counter()

    def packer_of(spec, overrides):
        return make_packer(
            spec.algorithm, seed=spec.seed, max_seconds=max_seconds,
            intra_layer=intra_layer, backend=backend, device=device,
            **{
                **({"n_chains": sa_chains} if spec.algorithm == "sa-s" else {}),
                **hyper,
                **overrides,
            },
        )

    # --- build islands; group sa-s fleets, GA lockstep pairs, scalar loops
    packers = [packer_of(spec, spec.hyper) for spec in islands]
    # cross-island ranking weight for the global best: the portfolio-level
    # override if given, else the strictest island's penalty
    lam = (
        float(hyper["inventory_penalty"])
        if "inventory_penalty" in hyper
        else max(float(p.inventory_penalty) for p in packers)
    )
    adapters: list = [None] * len(islands)
    groups: list = []
    ga_pairs: list = []
    fleet_members: dict[tuple, list] = {}  # fleet key -> [(k, packer)]
    for k, packer in enumerate(packers):
        resolved = packer._resolve_backend()
        if isinstance(packer, GeneticPacker):
            run = packer._start_run(
                prob, np.random.default_rng(packer.seed), None, resolved
            )
            packer._eval_init(
                run, packer._batched_costs(run, mesh=mesh) if run.batched else None
            )
            ga_pairs.append((packer, run))
            adapters[k] = _GAIsland(packer, run)
            continue
        packer._hetero = hetero
        if packer.perturbation == "nfd" or resolved == "legacy":
            isl = _ScalarIsland(packer, packer._scalar_start(prob, None), single=False)
        elif packer.n_chains == 1:
            isl = _ScalarIsland(
                packer, packer._single_start(prob, None, resolved), single=True
            )
        else:
            fleet_members.setdefault(_sa_fleet_key(packer, resolved), []).append(
                (k, packer)
            )
            continue
        groups.append(isl)
        adapters[k] = isl
    if ga_pairs:
        groups.append(_GAGroup(ga_pairs, mesh=mesh))
    for members in fleet_members.values():
        fleet = _SAFleetGroup(
            members[0][1],
            prob,
            [np.random.default_rng(p.seed) for _, p in members],
            members[0][1]._resolve_backend(),
            n_shards=n_shards,
            mesh=mesh,
        )
        groups.append(fleet)
        for j, (k, _) in enumerate(members):
            adapters[k] = _FleetIsland(fleet, j)

    # --- barriered fleet loop: advance everything, then migrate
    barrier = 0
    migrations = 0
    truncated = False
    single = len(adapters) == 1
    if ck is not None:
        restored = ck.restore_groups(groups)
        if restored is not None:
            barrier, migrations = restored
    # racing (to charge the ledger) and checkpointing (to cut snapshots)
    # pause even a single island at barriers; barrier segmentation never
    # changes trajectories
    seg = interval if interval > 0 else (
        DEFAULT_MIGRATION_EVERY if (ck is not None or auto) else 0
    )
    # per-family strides rebalance heterogeneous lineups; homogeneous
    # lineups keep the uniform stride.  Strides are part of the trajectory
    # contract; ``scheduler``/``fused`` are not (dispatch only).
    multi = len(groups) > 1
    n_ga_islands = len(ga_pairs)
    strides = [
        _group_stride(g, seg, n_ga_islands) if (multi and interval > 0)
        else seg
        for g in groups
    ]
    labels = [_group_label(g, i) for i, g in enumerate(groups)]
    # --- racing state: static work weights and the ledger
    race = None
    agroup: list[int] = []
    members_of: list[list[int]] = [[] for _ in groups]
    if auto:
        gi_of = {id(g): i for i, g in enumerate(groups)}
        ga_gi = next(
            (i for i, g in enumerate(groups) if isinstance(g, _GAGroup)), None
        )
        work: list[int] = []
        for k, isl in enumerate(adapters):
            if isinstance(isl, _FleetIsland):
                g, fam = gi_of[id(isl.group)], "delta"
            elif isinstance(isl, _GAIsland):
                g, fam = ga_gi, "ga"
            else:
                g = gi_of[id(isl)]
                fam = "scalar" if not isl.single else "delta"
            agroup.append(g)
            members_of[g].append(k)
            work.append(_island_work(isl.packer, fam, strides[g]))
        if race_budget is None:
            # equal total budget vs the lineup auto replaces: the default
            # ``n_islands`` lineup's work under the same budget knobs
            race_budget = _lineup_work(
                [packer_of(spec, {}) for spec in default_specs], interval
            )
        race = _Race(work, race_budget, race_final)
        if ck is not None and ck.race is not None:
            race.restore(ck.race, adapters)
    # the fused pair: the (only) SA fleet group + the GA lockstep pack,
    # merged into one main-thread dispatch unit when both engines resolved
    # to a device backend (forced either way via ``fused``)
    fi = next(
        (i for i, g in enumerate(groups) if isinstance(g, _SAFleetGroup)), None
    )
    gi = next(
        (i for i, g in enumerate(groups) if isinstance(g, _GAGroup)), None
    )
    device_backends = ("torch", "cuda")
    fuse = (
        scheduler == "concurrent" and fi is not None and gi is not None
        and sum(isinstance(g, _SAFleetGroup) for g in groups) == 1
        and len(groups[fi].sts) == 1  # fused dispatch needs one fleet shard
        and (
            fused if fused is not None
            else (
                groups[fi].sts[0].backend in device_backends
                and all(r.backend in device_backends and r.batched
                        for _, r in groups[gi].pairs)
            )
        )
    )
    # main-thread lane: the fused pair, else the SA fleet (device dispatch
    # window), else the first group; everything else rides the side lane
    main_idx = {fi, gi} if fuse else {fi if fi is not None else 0}
    side_idx = [i for i in range(len(groups)) if i not in main_idx]
    pool = (
        ThreadPoolExecutor(max_workers=len(side_idx))
        if scheduler == "concurrent" and side_idx
        else None
    )
    group_seconds: dict[str, float] = {lab: 0.0 for lab in labels}
    if fuse:
        fused_label = f"g{min(fi, gi)}+g{max(fi, gi)}:fused"
        group_seconds[fused_label] = 0.0
        for i in sorted(main_idx):
            group_seconds.pop(labels[i])
    barrier_seconds: list[float] = []
    try:
        # racing gates the loop itself: a budget-done survivor is revived by
        # the extension below, so only the race's live/ledger checks (or the
        # wall cap) may end an auto run
        while race is not None or any(not isl.done() for isl in adapters):
            if barrier > 0 and time.perf_counter() - t0 > max_seconds:
                truncated = True
                break
            t_bar = time.perf_counter()
            unbounded = race is None and ((single and ck is None) or seg <= 0)
            limits = [
                None if unbounded else (barrier + 1) * s for s in strides
            ]
            idle: frozenset = frozenset()
            if race is not None:
                # extend every surviving island's engine budget to this
                # barrier's limit FIRST (reallocation is just a larger
                # it_limit), then let the ledger gate the barrier
                for k, isl in enumerate(adapters):
                    if race.alive[k]:
                        isl.extend(limits[agroup[k]])
                live = race.live(adapters)
                if not live:
                    break  # every survivor frozen or wall-capped
                if not race.charge(live):
                    break  # ledger spent: the race is over
                # a group with no live member is never dispatched (its
                # states are inert, so skipping it perturbs no RNG stream)
                idle = frozenset(
                    i for i, members in enumerate(members_of)
                    if all(adapters[k].done() for k in members)
                )
            barrier += 1
            progressed = [False] * len(groups)
            if pool is not None:
                futures = {
                    i: pool.submit(_timed_advance, groups[i], limits[i])
                    for i in side_idx
                    if i not in idle
                }
            else:
                futures = {}
            t_main = time.perf_counter()
            if fuse:
                progressed[fi], progressed[gi] = _advance_fused(
                    groups[fi], groups[gi], limits[fi], limits[gi]
                )
                group_seconds[fused_label] += time.perf_counter() - t_main
            else:
                mains = sorted(main_idx) if pool is not None else [
                    i for i in range(len(groups)) if i not in futures
                ]
                for i in mains:
                    if i in idle:
                        continue
                    progressed[i], dt = _timed_advance(groups[i], limits[i])
                    group_seconds[labels[i]] += dt
            for i, fut in futures.items():
                progressed[i], dt = fut.result()
                group_seconds[labels[i]] += dt
            if not single and interval > 0:
                # deterministic migration: strict-min global best (first
                # island wins ties) lands in every OTHER live island's
                # worst warm slot
                vals = [
                    c + lam * o for c, o in (isl.raw() for isl in adapters)
                ]
                src = min(range(len(vals)), key=vals.__getitem__)
                migrant = adapters[src].best_solution()
                for k, isl in enumerate(adapters):
                    if k != src:
                        migrations += isl.migrate_in(migrant)
            if race is not None:
                race.maybe_halve(adapters, barrier, lam)
            if ck is not None and barrier % ck.every == 0:
                ck.save_groups(
                    groups, barrier, migrations,
                    race=race.state() if race is not None else None,
                )
            barrier_seconds.append(time.perf_counter() - t_bar)
            if not any(progressed):
                break  # no island can move: budgets exhausted mid-barrier
    finally:
        if pool is not None:
            pool.shutdown()

    # --- assemble the portfolio result (strict-min, first island wins ties)
    wall = time.perf_counter() - t0
    truncated = truncated or any(isl.truncated() for isl in adapters)
    if truncated:
        warnings.warn(
            f"pack_portfolio stopped on wall-clock after {barrier} "
            "barrier(s) before the islands' iteration/patience budgets; the "
            "result is NOT seed-reproducible (params['truncated_by_wallclock']"
            " is True). Give islands iteration budgets for reproducible runs.",
            TruncationWarning,
            stacklevel=2,
        )
    raws = [isl.raw() for isl in adapters]
    vals = [c + lam * o for c, o in raws]
    best_k = min(range(len(vals)), key=vals.__getitem__)
    best_sol = adapters[best_k].best_solution()
    best_cost = raws[best_k][0]
    trace = _merge_traces([(isl.offset(t0), isl.trace()) for isl in adapters])
    trace.append((wall, vals[best_k] if hetero else best_cost))
    names = "+".join(p.name for p in packers)
    return PackingResult(
        solution=best_sol,
        cost=int(best_cost),
        efficiency=best_sol.efficiency(),
        wall_time_s=wall,
        algorithm=f"portfolio[{names}]" + ("-intra" if intra_layer else ""),
        trace=trace,
        iterations=sum(isl.iterations() for isl in adapters),
        params=dict(
            islands=[
                dict(algorithm=s.algorithm, seed=s.seed, **s.hyper) for s in islands
            ],
            barriers=barrier,
            migration_every=interval,
            migrations=migrations,
            truncated_by_wallclock=truncated,
            backend=backend,
            seed=seed,
            scheduler=scheduler,
            n_shards=n_shards,
            fused=bool(fuse),
            strides=dict(zip(labels, strides)),
            barrier_seconds=barrier_seconds,
            group_seconds=group_seconds,
            **(
                dict(race=dict(
                    budget=race.budget,
                    spent=race.spent,
                    halvings=race.halvings,
                    phase_budget=race.phase_budget,
                    final_k=race.final_k,
                    work=list(race.work),
                    survivors=[
                        k for k, a in enumerate(race.alive) if a
                    ],
                    eliminated=race.eliminated,
                ))
                if race is not None else {}
            ),
        ),
    )


# ---------------------------------------------------- legacy thread portfolio
class _Island:
    """A packer plus its warm state, advanced one budgeted round at a time
    (the legacy thread-pool portfolio's unit of work)."""

    def __init__(self, prob: PackingProblem, spec: IslandSpec, packer):
        self.prob = prob
        self.spec = spec
        self.packer = packer
        self.is_ga = isinstance(packer, GeneticPacker)
        self.pop: list[Solution] | None = None  # GA warm population
        self.chains: list[Solution] | None = None  # SA warm incumbents (1/chain)

    def run_round(self, budget_s: float, round_idx: int) -> PackingResult:
        self.packer.max_seconds = budget_s
        self.packer.seed = self.spec.seed + _ROUND_SEED_STRIDE * round_idx
        if self.is_ga:
            result = self.packer.pack(self.prob, init_pop=self.pop)
            self.pop = self.packer.last_population_
        else:
            result = self.packer.pack(self.prob, init=self.chains)
            self.chains = self.packer.last_chains_
        return result

    def migrate_in(self, best: Solution, best_val: float, score) -> None:
        """The global best replaces this island's worst warm individual/chain
        (``score`` is the inventory-penalized cost on heterogeneous problems,
        the plain cost otherwise)."""
        warm = self.pop if self.is_ga else self.chains
        if not warm:
            return
        worst = max(range(len(warm)), key=lambda i: score(warm[i]))
        if score(warm[worst]) > best_val:
            warm[worst] = best.copy()


def pack_portfolio_threads(
    prob: PackingProblem,
    islands: Sequence[IslandSpec] | None = None,
    n_islands: int = 4,
    algorithms: Sequence[str] = ("ga-nfd", "sa-s", "sa-nfd"),
    seed: int = 0,
    max_seconds: float = 30.0,
    migration_every: float | None = None,
    intra_layer: bool = False,
    backend: str = "auto",
    max_workers: int | None = None,
    sa_chains: int = 8,
    device=None,
    **hyper,
) -> PackingResult:
    """The legacy thread-pool portfolio, kept as the benchmark baseline.

    K islands evolve concurrently on a thread pool under one shared
    wall-clock budget, synchronizing every ``migration_every`` *seconds*
    (default ``max_seconds / 4``) to migrate the global best.  Rounds are
    wall-clock budgeted, so results vary with machine speed and load —
    exactly the nondeterminism the fleet-native :func:`pack_portfolio`
    replaced.  ``device`` is every island's (``None`` means ``"cuda"``), so
    on ``cuda`` the islands' kernel calls come from the pool's threads.

    **Baseline only.**  This engine is kept solely as the comparison point
    for ``tools/portfolio_gate_torch.py``; it is outside the determinism,
    checkpoint/resume, and scheduler contracts and intentionally grows no
    ``scheduler``/``fused``/``checkpoint_dir`` surface.  Use
    :func:`pack_portfolio` for real runs.
    """
    from .api import make_packer  # late import: api imports nothing from here

    if islands is None:
        if n_islands < 1:
            raise ValueError("n_islands must be >= 1")
        islands = [
            IslandSpec(algorithm=algorithms[k % len(algorithms)], seed=seed + k)
            for k in range(n_islands)
        ]
    if not islands:
        raise ValueError("portfolio needs at least one island")
    device = resolve_device(device)
    pool = [
        _Island(
            prob,
            spec,
            make_packer(
                spec.algorithm,
                seed=spec.seed,
                max_seconds=max_seconds,
                intra_layer=intra_layer,
                backend=backend,
                device=device,
                **{
                    **({"n_chains": sa_chains} if spec.algorithm == "sa-s" else {}),
                    **hyper,
                    **spec.hyper,
                },
            ),
        )
        for spec in islands
    ]
    interval = migration_every if migration_every is not None else max_seconds / 4.0
    interval = max(interval, 1e-3)

    # island comparisons use the inventory-penalized cost on heterogeneous
    # problems so a feasible packing always outranks an overflowing one
    hetero = prob.n_kinds > 1
    lam = hyper.get("inventory_penalty", DEFAULT_INVENTORY_PENALTY)
    if hetero:
        def score(sol: Solution) -> float:
            return sol.cost() + lam * sol.inventory_overflow()
    else:
        def score(sol: Solution) -> float:
            return sol.cost()

    t0 = time.perf_counter()
    rounds: list[tuple[float, list[PackingResult]]] = []
    best_sol: Solution | None = None
    best_cost = 0
    best_val = 0.0
    iterations = 0
    round_idx = 0
    with ThreadPoolExecutor(max_workers=max_workers or len(pool)) as ex:
        while True:
            elapsed = time.perf_counter() - t0
            remaining = max_seconds - elapsed
            if round_idx > 0 and remaining <= 1e-3:
                break
            budget = min(interval, max(remaining, 1e-3))
            futures = [
                ex.submit(isl.run_round, budget, round_idx) for isl in pool
            ]
            results = [f.result() for f in futures]
            rounds.append((elapsed, results))
            for r in results:
                iterations += r.iterations
                val = score(r.solution)
                if best_sol is None or val < best_val:
                    best_sol, best_cost, best_val = r.solution, r.cost, val
            for isl in pool:
                isl.migrate_in(best_sol, best_val, score)
            round_idx += 1
    wall = time.perf_counter() - t0
    trace = _merge_traces(
        [(offset, r.trace) for offset, results in rounds for r in results]
    )
    trace.append((wall, best_cost))
    names = "+".join(isl.packer.name for isl in pool)
    return PackingResult(
        solution=best_sol,
        cost=int(best_cost),
        efficiency=best_sol.efficiency(),
        wall_time_s=wall,
        algorithm=f"portfolio-threads[{names}]" + ("-intra" if intra_layer else ""),
        trace=trace,
        iterations=iterations,
        params=dict(
            islands=[
                dict(algorithm=s.algorithm, seed=s.seed, **s.hyper) for s in islands
            ],
            rounds=round_idx,
            migration_every=interval,
            backend=backend,
            seed=seed,
        ),
    )
