"""Crash-safe sweeps: checkpoint/resume codecs for the solver fleet (the
port's `repro.core.resume`).

A DSE sweep (thousands of candidates x devices) is an hours-long job.
Every engine is a deterministic, iteration-budgeted state machine; this
module wires those state machines into ``checkpoint.CheckpointManager`` so
that ``pack_sweep(..., checkpoint_dir=...)`` and ``pack_portfolio(...,
checkpoint_dir=...)`` can be killed at any instant and resumed
(``resume=True``) **bit-identically**: the resumed run restarts from the
newest *valid* snapshot and lands on exactly the final best cost and
solution of the same-seed uninterrupted run.

The snapshot format is the reference's (``FORMAT``, the ``"sweep"`` /
``"portfolio"`` kinds, the JSON payload, the digests and every codec), so
a snapshot written by either package resumes in the other
(``tests/test_torch_resume.py`` holds both directions).

Serialization contract (one codec per resumable state class, field lists
pinned as ``CODEC_*`` on the classes themselves):

* numpy arrays (chain/geometry matrices, cost vectors, patience counters)
  go into the checkpoint's ``arrays.npz`` under stable tree-path keys;
* everything else — ``np.random.Generator`` bit-generator states,
  ``Solution`` packings (bins + kind lanes via ``Solution.state_dict``),
  improvement traces, scalar counters, completed-candidate results keyed by
  task digest — goes into the JSON manifest ``extra``;
* scratch buffers and start-derived constants are NOT serialized: resume
  rebuilds the run state deterministically (same seeds, same construction
  order) and overwrites the resumable fields, which also provides the
  shape/layout template the restore validates against.

Snapshots are cut only at iteration/generation barriers (between engine
steps), so per-move transients (undo logs, proposal scratch) never need to
round-trip.  Because every engine is deterministic from any barrier state,
falling back to an *older* intact checkpoint after corruption still
converges to the bit-identical final result.  Wall-clock fields (trace
timestamps, ``wall_time_s``) restart on resume and are exempt from the
parity contract.

A fleet split into shards (``n_shards > 1``) is snapshotted in ONE
canonical merged layout (`merge_block_states`), field for field the
unsharded fleet's, and restored onto any contiguous shard split
(`restore_block_shards`): a run saved at one shard count resumes at any
other, in either package.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Sequence

import numpy as np

from ..checkpoint import CheckpointManager
from .problem import PackingProblem, PackingResult, Solution

# bump when the on-disk codec layout changes: a resume across formats must
# fail loudly, never half-restore
FORMAT = 1

_ENGINE_PREFIX = "eng/"


# ------------------------------------------------------------- JSON helpers
def _jsonify(obj):
    """Recursively convert numpy scalars/arrays and tuples to JSON values."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def rng_state(rng: np.random.Generator) -> dict:
    """The full bit-generator state — JSON-able (Python ints are unbounded,
    so PCG64's 128-bit words survive a JSON round-trip exactly)."""
    return rng.bit_generator.state


def set_rng_state(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state


def _trace_state(trace) -> list:
    return [[float(t), _jsonify(c)] for t, c in trace]


def _trace_from_state(state) -> list:
    # int cost entries stay int through JSON, hetero float entries stay
    # float (json floats round-trip via repr) — the parity-pinned part of a
    # trace is its cost sequence; timestamps are wall-clock and exempt
    return [(t, c) for t, c in state]


def result_state(res: PackingResult) -> dict:
    return {
        "solution": res.solution.state_dict(),
        "cost": int(res.cost),
        "efficiency": float(res.efficiency),
        "wall_time_s": float(res.wall_time_s),
        "algorithm": res.algorithm,
        "trace": _trace_state(res.trace),
        "iterations": int(res.iterations),
        "params": _jsonify(res.params),
    }


def result_from_state(prob: PackingProblem, state: dict) -> PackingResult:
    return PackingResult(
        solution=Solution.from_state_dict(prob, state["solution"]),
        cost=int(state["cost"]),
        efficiency=float(state["efficiency"]),
        wall_time_s=float(state["wall_time_s"]),
        algorithm=state["algorithm"],
        trace=_trace_from_state(state["trace"]),
        iterations=int(state["iterations"]),
        params=state["params"],
    )


# ---------------------------------------------------------------- digests
def _digest(payload: str) -> str:
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


def task_digest(key: tuple) -> str:
    """Stable id of one sweep candidate: problem fingerprint + algorithm +
    seed + settings (``dse._task_keys`` already folds all of those in)."""
    return _digest(repr(key))


def group_digest(keys: Sequence[tuple]) -> str:
    """Stable id of one batched group (order-independent membership)."""
    return _digest(repr(sorted(task_digest(k) for k in keys)))


def sweep_config_key(keys: Sequence[tuple]) -> str:
    """Identity of a whole sweep: the multiset of its task keys.  A resumed
    call must describe the same sweep; barrier spacing deliberately does
    not participate (any segmentation replays the same trajectories)."""
    return _digest(repr((FORMAT, "sweep", sorted(task_digest(k) for k in keys))))


def portfolio_config_key(
    prob, islands, interval, intra_layer, backend, sa_chains, hyper,
    race=None,
) -> str:
    """Identity of a portfolio run.  ``max_seconds`` is deliberately
    excluded: it is an outer safety cap, and resuming a preempted run with
    a fresh (or larger) wall budget is the expected workflow.  ``race``
    (the ``(race_budget, race_final)`` tuple of a ``pack_portfolio(auto=
    True)`` run, None otherwise) is part of the identity: a race resumed
    under a different ledger would reach different eliminations."""
    spec = tuple(
        (s.algorithm, int(s.seed),
         tuple(sorted((k, repr(v)) for k, v in s.hyper.items())))
        for s in islands
    )
    key = (
        FORMAT, "portfolio", prob.fingerprint(), spec, int(interval),
        bool(intra_layer), backend, int(sa_chains),
        tuple(sorted((k, repr(v)) for k, v in hyper.items())),
    )
    if race is not None:
        key = key + (("race",) + tuple(race),)
    return _digest(repr(key))


# ----------------------------------------------------------- engine codecs
def encode_scalar_run(st) -> tuple[dict, dict]:
    """`sa._ScalarRun` -> (arrays, extra); everything is small, all JSON."""
    extra = {f: _jsonify(getattr(st, f)) for f in type(st).CODEC_SCALARS}
    for f in type(st).CODEC_SOLUTIONS:
        extra[f] = getattr(st, f).state_dict()
    extra["rng"] = rng_state(st.rng)
    extra["trace"] = _trace_state(st.trace)
    return {}, extra


def restore_scalar_run(st, extra: dict) -> None:
    """Overwrite a freshly `_scalar_start`-ed run with checkpointed state."""
    for f in type(st).CODEC_SCALARS:
        setattr(st, f, extra[f])
    st.sol = Solution.from_state_dict(st.prob, extra["sol"])
    st.best = Solution.from_state_dict(st.prob, extra["best"])
    set_rng_state(st.rng, extra["rng"])
    st.trace = _trace_from_state(extra["trace"])
    st.t_start = time.perf_counter()  # wall budget re-bases on resume


def encode_single_run(st) -> tuple[dict, dict]:
    """`sa._SingleChainRun` -> (arrays, extra); geometry rows and primitive
    usage are derived from ``sol`` on restore, not serialized."""
    return encode_scalar_run(st)  # identical layout; CODEC_* differ per class


def restore_single_run(st, extra: dict) -> None:
    restore_scalar_run(st, extra)
    st.sol.fill_geometry(st.chain_w[0], st.chain_h[0])
    if st.hetero:
        st.sol.fill_kinds(st.chain_k[0])
        st.used = st.sol.used_primitives()
    st.undo.clear()


def encode_block_state(st) -> tuple[dict, dict]:
    """`sa._BlockState` -> (arrays, extra) for one P x C fleet."""
    cls = type(st)
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if st.hetero else ())
    arrays = {f: np.asarray(getattr(st, f)) for f in fields}
    extra = {f: _jsonify(getattr(st, f)) for f in cls.CODEC_SCALARS}
    extra["hetero"] = bool(st.hetero)
    extra["n_rows"] = int(st.n_rows)
    extra["rngs"] = [rng_state(r) for r in st.rngs]
    extra["traces"] = [_trace_state(tr) for tr in st.traces]
    return arrays, extra


def restore_block_state(st, arrays: dict, extra: dict) -> None:
    """Overwrite a freshly `_block_start`-ed fleet with checkpointed state.

    The fresh state is the layout template: every restored array must match
    its shape and dtype exactly (same problems, same chain count — the
    config digest upstream should make a mismatch impossible; this is the
    backstop).
    """
    if bool(extra["hetero"]) != bool(st.hetero) or int(extra["n_rows"]) != st.n_rows:
        raise ValueError("checkpoint does not match this fleet's layout")
    cls = type(st)
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if st.hetero else ())
    for f in fields:
        cur = np.asarray(getattr(st, f))
        arr = np.asarray(arrays[f])
        if cur.shape != arr.shape or cur.dtype != arr.dtype:
            raise ValueError(
                f"checkpoint field {f!r}: {arr.shape}/{arr.dtype} does not "
                f"match fleet layout {cur.shape}/{cur.dtype}"
            )
        setattr(st, f, arr)
    if not st.hetero:
        st.pcosts = st.costs  # pcosts aliases costs on single-kind fleets
    for f in cls.CODEC_SCALARS:
        setattr(st, f, extra[f])
    for rng, state in zip(st.rngs, extra["rngs"]):
        set_rng_state(rng, state)
    st.traces = [_trace_from_state(tr) for tr in extra["traces"]]
    st.t_start = time.perf_counter()


# fields concatenated on the chain-row (R) axis; everything else in the
# block codec concatenates on the problem (P) axis
_ROW_FIELDS = frozenset({
    "items", "counts", "bw", "bh", "live", "costs", "best_pcosts",
    "stale", "steps", "pcosts", "bk", "UK",
})
# pad fill for widened trailing envelope dims (-1 = the empty-item sentinel
# of encode_chain_items; every other field pads with zeros)
_PAD_FILL = {"items": -1, "g_items": -1}


def _pad_tail(arr: np.ndarray, tail: tuple, fill) -> np.ndarray:
    """Widen an array's trailing dims to ``tail`` (leading axis untouched)."""
    shape = (arr.shape[0],) + tail
    if arr.shape == shape:
        return arr
    out = np.full(shape, fill, dtype=arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def merge_block_states(sts) -> tuple[dict, dict]:
    """Merge per-shard `_BlockState`s into ONE canonical (arrays, extra).

    The sharded sweep / portfolio lanes split a batched group into
    contiguous sub-fleets, synchronized at common iteration barriers.  This
    merges their states into a payload laid out **exactly** like
    :func:`encode_block_state` of the equivalent unsharded fleet: shard
    envelopes pad to the group envelope (max bin-slot and item-capacity
    dims — trailing empty slots never change a trajectory), rows
    concatenate in group order, ``it`` is the barrier (the max — a shard
    that froze early stops counting, but frozen rows never change, so the
    gap is inert), and ``done`` / ``frozen`` are the fleet-wide
    conjunctions.  A snapshot written at one shard count therefore
    restores at ANY other: `restore_block_state` consumes it unsharded,
    :func:`restore_block_shards` slices it back onto shards.
    """
    encoded = [encode_block_state(st) for st in sts]
    cls = type(sts[0])
    hetero = bool(sts[0].hetero)
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if hetero else ())
    arrays: dict = {}
    for f in fields:
        parts = [e[0][f] for e in encoded]
        tail = tuple(
            max(p.shape[d] for p in parts) for d in range(1, parts[0].ndim)
        )
        fill = _PAD_FILL.get(f, 0)
        arrays[f] = np.concatenate(
            [_pad_tail(p, tail, fill) for p in parts], axis=0
        )
    extra = {
        "it": max(int(e["it"]) for _, e in encoded),
        "done": all(bool(e["done"]) for _, e in encoded),
        "frozen": all(bool(e["frozen"]) for _, e in encoded),
        "hetero": hetero,
        "n_rows": sum(int(e["n_rows"]) for _, e in encoded),
        "rngs": [r for _, e in encoded for r in e["rngs"]],
        "traces": [t for _, e in encoded for t in e["traces"]],
    }
    return arrays, extra


def restore_block_shards(sts, arrays: dict, extra: dict, patience: int) -> None:
    """Slice one canonical fleet snapshot onto freshly-started shard states.

    The inverse of :func:`merge_block_states`, for any shard count (one
    included): shard ``i`` gets the canonical payload's rows / problems at
    its contiguous offsets.  Shard envelopes may be narrower than the
    canonical one — the restored shard keeps the canonical (wider) arrays,
    since trailing empty bin slots never alter trajectories (the kernels
    take any width and an empty slot costs 0).  Every shard restores
    ``it`` to the fleet barrier (frozen shards draw no RNG there, so the
    counter is inert); per-shard ``frozen`` / ``done`` are recomputed from
    the restored patience counters against ``patience`` (the packer's),
    because a sub-fleet freezes as a unit even when the full fleet was
    still live.
    """
    hetero = bool(extra["hetero"])
    if any(bool(st.hetero) != hetero for st in sts):
        raise ValueError("checkpoint does not match this fleet's layout")
    n_rows = int(extra["n_rows"])
    if n_rows != sum(st.n_rows for st in sts):
        raise ValueError(
            f"checkpoint holds {n_rows} chain rows but the shard split has "
            f"{sum(st.n_rows for st in sts)}; the group membership changed"
        )
    cls = type(sts[0])
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if hetero else ())
    n_probs = sum(st.n_probs for st in sts)
    rngs = extra["rngs"]
    traces = extra["traces"]
    if len(rngs) != n_probs or len(traces) != n_probs:
        raise ValueError("checkpoint problem count does not match")
    r0 = p0 = 0
    for st in sts:
        nr, npb = st.n_rows, st.n_probs
        for f in fields:
            arr = np.asarray(arrays[f])
            cur = np.asarray(getattr(st, f))
            if arr.dtype != cur.dtype or arr.ndim != cur.ndim:
                raise ValueError(
                    f"checkpoint field {f!r}: {arr.dtype}/{arr.ndim}d does "
                    f"not match fleet layout {cur.dtype}/{cur.ndim}d"
                )
            if any(a < c for a, c in zip(arr.shape[1:], cur.shape[1:])):
                raise ValueError(
                    f"checkpoint field {f!r}: envelope {arr.shape[1:]} is "
                    f"narrower than the shard's {cur.shape[1:]}"
                )
            lo, n = (r0, nr) if f in _ROW_FIELDS else (p0, npb)
            setattr(st, f, arr[lo:lo + n].copy())
        if not hetero:
            st.pcosts = st.costs  # pcosts aliases costs on single-kind fleets
        st.it = int(extra["it"])
        frozen = bool(np.all(np.asarray(st.stale) >= patience))
        st.frozen = frozen
        st.done = frozen or bool(extra["done"])
        for rng, state in zip(st.rngs, rngs[p0:p0 + npb]):
            set_rng_state(rng, state)
        st.traces = [_trace_from_state(tr) for tr in traces[p0:p0 + npb]]
        st.t_start = time.perf_counter()
        r0 += nr
        p0 += npb


def encode_ga_run(run) -> tuple[dict, dict]:
    """`ga._GARun` -> (arrays, extra)."""
    cls = type(run)
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if run.hetero else ())
    arrays = {f: np.asarray(getattr(run, f)) for f in fields}
    extra = {f: _jsonify(getattr(run, f)) for f in cls.CODEC_SCALARS}
    extra["hetero"] = bool(run.hetero)
    extra["rng"] = rng_state(run.rng)
    extra["pop"] = [s.state_dict() for s in run.pop]
    extra["best"] = run.best.state_dict()
    extra["trace"] = _trace_state(run.trace)
    return arrays, extra


def restore_ga_run(run, arrays: dict, extra: dict) -> None:
    """Overwrite a freshly started+evaluated `_GARun` with checkpointed
    state (the fresh run is the shape template; ``W``/``H``/``Km`` are
    refilled from the restored population)."""
    if bool(extra["hetero"]) != bool(run.hetero):
        raise ValueError("checkpoint does not match this run's problem")
    if len(extra["pop"]) != len(run.pop):
        raise ValueError("checkpoint population size does not match n_pop")
    cls = type(run)
    fields = cls.CODEC_ARRAYS + (cls.CODEC_ARRAYS_HETERO if run.hetero else ())
    for f in fields:
        cur = np.asarray(getattr(run, f))
        arr = np.asarray(arrays[f])
        if cur.shape != arr.shape:
            raise ValueError(f"checkpoint field {f!r} shape mismatch")
        setattr(run, f, arr)
    for f in cls.CODEC_SCALARS:
        setattr(run, f, extra[f])
    set_rng_state(run.rng, extra["rng"])
    run.pop = [Solution.from_state_dict(run.prob, d) for d in extra["pop"]]
    run.best = Solution.from_state_dict(run.prob, extra["best"])
    run.trace = _trace_from_state(extra["trace"])
    run.t0 = time.perf_counter()
    if run.batched:
        for i, s in enumerate(run.pop):
            s.fill_geometry(run.W[i], run.H[i])
            if run.Km is not None:
                s.fill_kinds(run.Km[i])


def encode_ga_group(runs) -> tuple[dict, list]:
    """A lockstep group of `_GARun`s -> (prefixed arrays, list of extras)."""
    arrays: dict = {}
    extras: list = []
    for i, run in enumerate(runs):
        a, e = encode_ga_run(run)
        for k, v in a.items():
            arrays[f"{i}/{k}"] = v
        extras.append(e)
    return arrays, extras


# ------------------------------------------------------------ checkpointers
class _Checkpointer:
    """Shared machinery: synchronous CheckpointManager IO, monotone step
    numbering, config validation, and the post-snapshot hook a
    fault-injection test attaches to."""

    kind = ""

    def __init__(
        self,
        directory,
        config_key: str,
        every: int = 1,
        resume: bool = False,
        keep_n: int = 3,
        on_checkpoint: Callable[[int], None] | None = None,
    ):
        # synchronous saves: a barrier snapshot must be durable before the
        # run advances past it (the kill-at-barrier contract)
        self.mgr = CheckpointManager(
            directory, keep_n=max(int(keep_n), 2), async_save=False
        )
        self.every = max(int(every), 1)
        self.on_checkpoint = on_checkpoint
        self.config_key = config_key
        self.step = 0
        self.payload: dict | None = None
        self.flat: dict = {}
        if resume:
            try:
                step, flat, extra = self.mgr.restore_latest_valid()
            except FileNotFoundError:
                return  # nothing snapshotted yet: a fresh start
            if extra.get("format") != FORMAT or extra.get("kind") != self.kind:
                raise ValueError(
                    f"checkpoint under {self.mgr.dir} is not a {self.kind} "
                    f"checkpoint of format {FORMAT}"
                )
            if extra.get("config") != config_key:
                raise ValueError(
                    f"checkpoint under {self.mgr.dir} was written by a "
                    "differently-configured run (problems/seeds/settings "
                    "changed); refusing to resume"
                )
            self.step = step
            self.payload = extra
            self.flat = flat

    def _save(self, arrays: dict, payload: dict) -> None:
        self.step += 1
        extra = {"format": FORMAT, "kind": self.kind,
                 "config": self.config_key, **payload}
        self.mgr.save(self.step, arrays, extra)
        if self.on_checkpoint is not None:
            self.on_checkpoint(self.step)


class SweepCheckpointer(_Checkpointer):
    """Checkpoint/resume for :func:`repro_torch.core.dse.pack_sweep`.

    Snapshot layout: completed-candidate results keyed by task digest in
    the JSON payload; the in-flight batched group's engine state (one
    `_BlockState`, or one `_GARun` per group member) as prefixed arrays +
    the ``engine`` payload, tagged with the group's membership digest so a
    resume only re-enters matching work.
    """

    kind = "sweep"

    def __init__(self, directory, config_key, every=256, resume=False,
                 keep_n=3, on_checkpoint=None):
        super().__init__(directory, config_key, every=every, resume=resume,
                         keep_n=keep_n, on_checkpoint=on_checkpoint)
        self.done: dict[str, dict] = {}
        self._group: str | None = None
        self._engine = None
        if self.payload is not None:
            self.done = dict(self.payload.get("done", {}))
            self._group = self.payload.get("group")
            self._engine = self.payload.get("engine")

    # ------------------------------------------------- completed candidates
    def result_for(self, key: tuple, prob: PackingProblem) -> PackingResult | None:
        state = self.done.get(task_digest(key))
        return None if state is None else result_from_state(prob, state)

    def mark_done(self, key: tuple, result: PackingResult) -> None:
        self.done[task_digest(key)] = result_state(result)

    # -------------------------------------------------- barrier snapshots
    def save_progress(self, group: str | None = None, arrays: dict | None = None,
                      engine=None) -> None:
        """One durable snapshot: all completed results + the in-flight
        group's engine state (none after a group completes)."""
        prefixed = {
            _ENGINE_PREFIX + k: v for k, v in (arrays or {}).items()
        }
        self._save(prefixed, {"done": self.done, "group": group,
                              "engine": engine})

    def _engine_arrays(self, prefix: str = "") -> dict:
        p = _ENGINE_PREFIX + prefix
        return {k[len(p):]: v for k, v in self.flat.items() if k.startswith(p)}

    def restore_block(self, gdigest: str, st) -> bool:
        """Re-enter a checkpointed SA fleet group; False when the snapshot
        holds no engine state for this group (fresh start)."""
        if self._group != gdigest or not isinstance(self._engine, dict):
            return False
        restore_block_state(st, self._engine_arrays(), self._engine)
        return True

    def restore_block_shards(self, gdigest: str, sts, patience: int) -> bool:
        """Shard-count-agnostic :meth:`restore_block`: slice the canonical
        group snapshot onto any contiguous shard split (the snapshot is
        always written merged, :func:`merge_block_states`)."""
        if self._group != gdigest or not isinstance(self._engine, dict):
            return False
        restore_block_shards(sts, self._engine_arrays(), self._engine,
                             patience)
        return True

    def restore_ga_group(self, gdigest: str, runs) -> bool:
        if self._group != gdigest or not isinstance(self._engine, list):
            return False
        if len(self._engine) != len(runs):
            raise ValueError("checkpoint group size does not match")
        for i, (run, extra) in enumerate(zip(runs, self._engine)):
            restore_ga_run(run, self._engine_arrays(f"{i}/"), extra)
        return True


class PortfolioCheckpointer(_Checkpointer):
    """Checkpoint/resume for
    :func:`repro_torch.core.portfolio.pack_portfolio`.

    Snapshot layout: one entry per engine *group* (SA fleet / GA lockstep
    pack / scalar island) in construction order, plus the barrier and
    migration counters.  ``every`` counts migration barriers between
    snapshots.
    """

    kind = "portfolio"

    GROUP_TAGS = ("fleet", "ga", "scalar", "single")

    def save_groups(self, groups, barrier: int, migrations: int,
                    race: dict | None = None) -> None:
        """``race`` is the `_Race.state()` payload of an ``auto=True`` run
        (ledger counters + the elimination log), None for plain lineups —
        it rides the JSON payload so a preempted race resumes past its
        eliminations (the config key already pins the ledger identity)."""
        arrays, metas = self._encode_groups(groups)
        payload = {"barrier": int(barrier),
                   "migrations": int(migrations), "groups": metas}
        if race is not None:
            payload["race"] = race
        self._save(arrays, payload)

    @property
    def race(self) -> dict | None:
        """The snapshotted racing state, None when starting fresh or when
        the snapshot was cut by a non-racing run."""
        return None if self.payload is None else self.payload.get("race")

    def restore_groups(self, groups) -> tuple[int, int] | None:
        """Overwrite freshly built groups with the checkpointed states;
        returns (barrier, migrations), or None when starting fresh."""
        if self.payload is None:
            return None
        metas = self.payload.get("groups")
        if not isinstance(metas, list) or len(metas) != len(groups):
            raise ValueError("checkpoint does not match this portfolio's islands")
        from .portfolio import _GAGroup, _SAFleetGroup  # late: avoid cycle

        for gi, (group, meta) in enumerate(zip(groups, metas)):
            tag, state = meta["type"], meta["state"]
            if tag != self._group_tag(group):
                raise ValueError(
                    f"checkpoint group {gi} is {tag!r}, expected "
                    f"{self._group_tag(group)!r}"
                )
            if isinstance(group, _SAFleetGroup):
                # fleet snapshots use the canonical merged layout, so a run
                # may resume at a different shard count than it saved under
                restore_block_shards(
                    group.sts, self._group_arrays(gi), state,
                    group.packer.patience,
                )
            elif isinstance(group, _GAGroup):
                runs = [run for _, run in group.pairs]
                if len(state) != len(runs):
                    raise ValueError("checkpoint GA island count mismatch")
                for i, (run, extra) in enumerate(zip(runs, state)):
                    restore_ga_run(run, self._group_arrays(gi, f"{i}/"), extra)
            elif group.single:
                restore_single_run(group.st, state)
            else:
                restore_scalar_run(group.st, state)
        return int(self.payload["barrier"]), int(self.payload["migrations"])

    def _group_arrays(self, gi: int, prefix: str = "") -> dict:
        p = f"g{gi}/{prefix}"
        return {k[len(p):]: v for k, v in self.flat.items() if k.startswith(p)}

    @staticmethod
    def _group_tag(group) -> str:
        from .portfolio import _GAGroup, _SAFleetGroup  # late: avoid cycle

        if isinstance(group, _SAFleetGroup):
            return "fleet"
        if isinstance(group, _GAGroup):
            return "ga"
        return "single" if group.single else "scalar"

    def _encode_groups(self, groups) -> tuple[dict, list]:
        from .portfolio import _GAGroup, _SAFleetGroup  # late: avoid cycle

        arrays: dict = {}
        metas: list = []
        for gi, group in enumerate(groups):
            if isinstance(group, _SAFleetGroup):
                a, e = merge_block_states(group.sts)
                for k, v in a.items():
                    arrays[f"g{gi}/{k}"] = v
                metas.append({"type": "fleet", "state": e})
            elif isinstance(group, _GAGroup):
                a, e = encode_ga_group([run for _, run in group.pairs])
                for k, v in a.items():
                    arrays[f"g{gi}/{k}"] = v
                metas.append({"type": "ga", "state": e})
            else:  # _ScalarIsland: scalar loop or single-chain delta engine
                _, e = (
                    encode_single_run(group.st) if group.single
                    else encode_scalar_run(group.st)
                )
                metas.append(
                    {"type": "single" if group.single else "scalar", "state": e}
                )
        return arrays, metas
