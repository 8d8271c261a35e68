"""Crash-safe sweeps and portfolios in the port: the counterpart of every
test in ``tests/test_resume.py``, plus snapshots that cross packages.

The contract: a checkpointed ``pack_sweep`` / ``pack_portfolio`` killed at
any barrier — including with its newest snapshot damaged afterwards —
resumes to the bit-identical final best cost, packing, iteration counts
and improvement-trace cost sequence of a same-seed uninterrupted run; and
here that run is the *reference's*.  Crashes are in-process
``SimulatedCrash`` raises from the ``on_checkpoint`` hook
(``tests/faultinject.py``).  Snapshots are the reference's format, so a
run killed in one package resumes in the other, in both directions, on
the SA fleet, the GA lockstep and the portfolio lanes.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from faultinject import (
    SimulatedCrash,
    corrupt_arrays,
    corrupt_manifest,
    crash_at,
    latest_step_dir,
    tear_arrays,
)

PORT_BACKENDS = ("python", "torch", "cuda")
# deterministic engines: iteration budgets terminate, wall/patience parked
_KW = dict(max_seconds=1e9, patience=10**9)
_SA = dict(_KW, max_iterations=600, n_chains=4)
_GA = dict(_KW, max_generations=12, n_pop=12)
_PORT = dict(_KW, migration_every=32, max_iterations=400, max_generations=10,
             sa_chains=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(pkg, seed: int, hetero: bool = False):
    """`tests/test_resume.py`'s generated problem, built in either package."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 30))
    bufs = [
        pkg.Buffer(width=int(rng.integers(1, 80)), depth=int(rng.integers(1, 40_000)),
                   layer=int(rng.integers(0, 5)))
        for _ in range(n)
    ]
    ocm = (
        pkg.OCMInventory((pkg.BRAM18, pkg.URAM288), (n * 3, 8), name=f"dev{seed}")
        if hetero else None
    )
    return pkg.PackingProblem(bufs, max_items=4, name=f"rp{seed}", ocm=ocm)


def _problems(pkg, hetero=False):
    seeds = (21, 22) if hetero else (11, 12, 13)
    return [_problem(pkg, s, hetero) for s in seeds]


def _islands(pkg):
    # one island per engine codec: GA lockstep, SA fleet, scalar loop, single-chain
    return [
        pkg.IslandSpec("ga-nfd", seed=5),
        pkg.IslandSpec("sa-s", seed=6),
        pkg.IslandSpec("sa-nfd", seed=7),
        pkg.IslandSpec("sa-s", seed=8, hyper={"n_chains": 1}),
    ]


def _sweep_record(sw):
    """Everything the parity contract covers, nothing wall-clock."""
    return [
        (r.cost, r.solution.state_dict(), r.iterations,
         [c for _, c in r.trace])
        for r in sw.results
    ]


def _portfolio_record(res):
    return (
        res.cost, res.solution.state_dict(), res.iterations,
        res.params["barriers"], res.params["migrations"],
    )


def _port_sweep(probs, algorithm, seed, backend, **kw):
    return port.pack_sweep(probs, algorithm, seed=seed, backend=backend,
                           device="cpu", **kw)


def _port_portfolio(prob, backend, islands=None, **kw):
    return port.pack_portfolio(prob, islands=islands or _islands(port),
                               backend=backend, device="cpu", **dict(_PORT, **kw))


@pytest.fixture(scope="module")
def sweep_ref():
    return _sweep_record(ref.pack_sweep(_problems(ref), "sa-s", seed=3,
                                        backend="python", **_SA))


@pytest.fixture(scope="module")
def ga_sweep_ref():
    return _sweep_record(ref.pack_sweep(_problems(ref), "ga-nfd", seed=7,
                                        backend="ref", **_GA))


@pytest.fixture(scope="module")
def portfolio_ref():
    return _portfolio_record(
        ref.pack_portfolio(_problems(ref)[0], islands=_islands(ref), backend="ref",
                           **_PORT)
    )


# ------------------------------------------------------------------ pack_sweep
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_checkpointing_is_trajectory_neutral(sweep_ref, tmp_path, backend):
    got = _port_sweep(_problems(port), "sa-s", 3, backend, checkpoint_dir=tmp_path,
                      checkpoint_every=150, **_SA)
    assert _sweep_record(got) == sweep_ref


@pytest.mark.parametrize("kill_after", [1, 2, 3])
def test_sweep_sa_killed_at_barrier_resumes_bit_identical(
    sweep_ref, tmp_path, kill_after
):
    probs = _problems(port)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "sa-s", 3, "cuda", checkpoint_dir=tmp_path,
                    checkpoint_every=150, on_checkpoint=crash_at(kill_after), **_SA)
    resumed = _port_sweep(probs, "sa-s", 3, "cuda", checkpoint_dir=tmp_path,
                          checkpoint_every=150, resume=True, **_SA)
    assert _sweep_record(resumed) == sweep_ref


@pytest.mark.parametrize("damage", [tear_arrays, corrupt_arrays, corrupt_manifest])
def test_sweep_resume_with_corrupted_latest_checkpoint(sweep_ref, tmp_path, damage):
    # killed at barrier 3, then the newest snapshot is damaged on disk: the
    # resume falls back to the older intact snapshot and STILL lands on the
    # bit-identical final result
    probs = _problems(port)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "sa-s", 3, "torch", checkpoint_dir=tmp_path,
                    checkpoint_every=150, on_checkpoint=crash_at(3), **_SA)
    damage(latest_step_dir(tmp_path))
    resumed = _port_sweep(probs, "sa-s", 3, "torch", checkpoint_dir=tmp_path,
                          checkpoint_every=150, resume=True, **_SA)
    assert _sweep_record(resumed) == sweep_ref


@pytest.mark.parametrize("kill_after", [1, 2])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sweep_ga_killed_at_barrier_resumes_bit_identical(
    ga_sweep_ref, tmp_path, kill_after, backend
):
    probs = _problems(port)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "ga-nfd", 7, backend, checkpoint_dir=tmp_path,
                    checkpoint_every=4, on_checkpoint=crash_at(kill_after), **_GA)
    resumed = _port_sweep(probs, "ga-nfd", 7, backend, checkpoint_dir=tmp_path,
                          checkpoint_every=4, resume=True, **_GA)
    assert _sweep_record(resumed) == ga_sweep_ref


def test_sweep_serial_lane_resumes_per_candidate(tmp_path):
    # sa-nfd has no batched lane: checkpoints are whole completed candidates
    kw = dict(_KW, max_iterations=250)
    want = _sweep_record(ref.pack_sweep(_problems(ref), "sa-nfd", seed=2,
                                        backend="python", **kw))
    probs = _problems(port)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "sa-nfd", 2, "python", checkpoint_dir=tmp_path,
                    on_checkpoint=crash_at(2), **kw)
    resumed = _port_sweep(probs, "sa-nfd", 2, "python", checkpoint_dir=tmp_path,
                          resume=True, **kw)
    assert _sweep_record(resumed) == want
    assert resumed.n_solved == 1  # two of three came from the snapshot
    assert resumed.cache_hits == 2


def test_sweep_completed_checkpoint_serves_everything(sweep_ref, tmp_path):
    probs = _problems(port)
    _port_sweep(probs, "sa-s", 3, "cuda", checkpoint_dir=tmp_path,
                checkpoint_every=150, **_SA)
    again = _port_sweep(probs, "sa-s", 3, "cuda", checkpoint_dir=tmp_path,
                        checkpoint_every=150, resume=True, **_SA)
    assert again.n_solved == 0
    assert _sweep_record(again) == sweep_ref


def test_sweep_resume_refuses_mismatched_config(tmp_path):
    probs = _problems(port)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "sa-s", 3, "python", checkpoint_dir=tmp_path,
                    checkpoint_every=150, on_checkpoint=crash_at(1), **_SA)
    with pytest.raises(ValueError, match="differently-configured"):
        _port_sweep(probs, "sa-s", 4, "python", checkpoint_dir=tmp_path,
                    checkpoint_every=150, resume=True, **_SA)
    with pytest.raises(ValueError, match="not a portfolio checkpoint"):
        _port_portfolio(probs[0], "python", checkpoint_dir=tmp_path, resume=True)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_hetero_crash_resume(tmp_path, backend):
    # heterogeneous OCM: kind lanes + inventory arrays ride the same codecs
    kw = dict(_KW, max_iterations=400, n_chains=4)
    want = _sweep_record(ref.pack_sweep(_problems(ref, True), "sa-s", seed=5,
                                        backend="python", **kw))
    probs = _problems(port, True)
    with pytest.raises(SimulatedCrash):
        _port_sweep(probs, "sa-s", 5, backend, checkpoint_dir=tmp_path,
                    checkpoint_every=120, on_checkpoint=crash_at(2), **kw)
    resumed = _port_sweep(probs, "sa-s", 5, backend, checkpoint_dir=tmp_path,
                          checkpoint_every=120, resume=True, **kw)
    assert _sweep_record(resumed) == want


# -------------------------------------------------------------- pack_portfolio
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_portfolio_checkpointing_is_trajectory_neutral(portfolio_ref, tmp_path, backend):
    got = _port_portfolio(_problems(port)[0], backend, checkpoint_dir=tmp_path,
                          checkpoint_every=2)
    assert _portfolio_record(got) == portfolio_ref
    assert got.params["truncated_by_wallclock"] is False
    assert got.params["fused"] is (backend != "python")


@pytest.mark.parametrize("kill_after", [1, 2, 3])
def test_portfolio_killed_at_barrier_resumes_bit_identical(
    portfolio_ref, tmp_path, kill_after
):
    prob = _problems(port)[0]
    with pytest.raises(SimulatedCrash):
        _port_portfolio(prob, "cuda", checkpoint_dir=tmp_path, checkpoint_every=2,
                        on_checkpoint=crash_at(kill_after))
    resumed = _port_portfolio(prob, "cuda", checkpoint_dir=tmp_path,
                              checkpoint_every=2, resume=True)
    assert _portfolio_record(resumed) == portfolio_ref


@pytest.mark.parametrize("damage", [tear_arrays, corrupt_manifest])
def test_portfolio_resume_with_corrupted_latest_checkpoint(
    portfolio_ref, tmp_path, damage
):
    prob = _problems(port)[0]
    with pytest.raises(SimulatedCrash):
        _port_portfolio(prob, "torch", checkpoint_dir=tmp_path, checkpoint_every=2,
                        on_checkpoint=crash_at(3))
    damage(latest_step_dir(tmp_path))
    resumed = _port_portfolio(prob, "torch", checkpoint_dir=tmp_path,
                              checkpoint_every=2, resume=True)
    assert _portfolio_record(resumed) == portfolio_ref


def test_portfolio_resume_refuses_mismatched_config(tmp_path):
    prob = _problems(port)[0]
    with pytest.raises(SimulatedCrash):
        _port_portfolio(prob, "python", checkpoint_dir=tmp_path, checkpoint_every=1,
                        on_checkpoint=crash_at(1))
    other = [port.IslandSpec("ga-nfd", seed=99)] + _islands(port)[1:]
    with pytest.raises(ValueError, match="differently-configured"):
        _port_portfolio(prob, "python", islands=other, checkpoint_dir=tmp_path,
                        checkpoint_every=1, resume=True)


def test_single_island_portfolio_checkpoint_parity(tmp_path):
    # a single-island run normally advances unbounded in ONE call; with
    # checkpointing it is segmented at synthetic barriers — trajectories
    # must not notice
    kw = dict(_PORT, migration_every=0, backend="python")
    want = _portfolio_record(ref.pack_portfolio(
        _problems(ref)[0], islands=[ref.IslandSpec("sa-s", seed=6)], **kw))
    one = [port.IslandSpec("sa-s", seed=6)]
    prob = _problems(port)[0]
    plain = _portfolio_record(port.pack_portfolio(prob, islands=one, device="cpu", **kw))
    got = port.pack_portfolio(prob, islands=one, device="cpu", checkpoint_dir=tmp_path,
                              checkpoint_every=1, **kw)
    assert plain == want
    # barrier counters differ by construction (synthetic segmentation);
    # cost/packing/iterations must not
    assert _portfolio_record(got)[:3] == want[:3]
    assert got.params["barriers"] > 1 and len(list(tmp_path.glob("step_*"))) >= 2


def test_portfolio_race_killed_at_barrier_resumes(tmp_path):
    """An ``auto=True`` race resumes past its recorded eliminations to the
    reference's uninterrupted race."""
    kw = dict(_KW, migration_every=16, max_iterations=48, max_generations=4,
              sa_chains=2, auto=True, race_final=1, backend="python",
              race_grid=[("sa-s", {}), ("ga-nfd", {"n_pop": 6}), ("sa-nfd", {}),
                         ("sa-s", {"n_chains": 1})])
    want = ref.pack_portfolio(_problems(ref)[1], seed=2, **kw)
    prob = _problems(port)[1]
    with pytest.raises(SimulatedCrash):
        port.pack_portfolio(prob, seed=2, device="cpu", checkpoint_dir=tmp_path,
                            on_checkpoint=crash_at(3), **kw)
    got = port.pack_portfolio(prob, seed=2, device="cpu", checkpoint_dir=tmp_path,
                              resume=True, **kw)
    assert _portfolio_record(got) == _portfolio_record(want)
    assert got.params["race"] == want.params["race"]
    assert got.params["race"]["eliminated"]


# -------------------------------------------- wall-clock truncation surfacing
def test_portfolio_truncation_is_recorded_and_warned():
    with pytest.warns(RuntimeWarning, match="wall-clock"):
        res = port.pack_portfolio(
            _problems(port)[0], n_islands=2, seed=1, migration_every=16,
            max_seconds=0.0, max_iterations=10**9, backend="cuda", device="cpu",
        )
    assert res.params["truncated_by_wallclock"] is True
    assert res.params["barriers"] >= 1


def test_portfolio_budget_terminated_run_is_not_marked_truncated(portfolio_ref):
    res = _port_portfolio(_problems(port)[0], "python")
    assert res.params["truncated_by_wallclock"] is False
    assert _portfolio_record(res) == portfolio_ref


def test_portfolio_sharding_still_raises(portfolio_ref, tmp_path):
    """Sharded portfolio fleets are ported: a checkpointed ``n_shards=2`` run
    equals the reference's unsharded one, a split SA fleet killed at a
    barrier resumes unsharded to the reference's result, and a mesh that is
    no sweep mesh raises before any work."""
    prob = _problems(port)[0]
    got = _port_portfolio(prob, "python", checkpoint_dir=tmp_path / "a", n_shards=2)
    assert _portfolio_record(got) == portfolio_ref
    fleet = [port.IslandSpec("sa-s", seed=s) for s in (6, 7, 8)]
    want = _portfolio_record(ref.pack_portfolio(
        _problems(ref)[0], islands=[ref.IslandSpec("sa-s", seed=s) for s in (6, 7, 8)],
        backend="python", **_PORT))
    with pytest.raises(SimulatedCrash):
        _port_portfolio(prob, "torch", islands=fleet, checkpoint_dir=tmp_path / "b",
                        checkpoint_every=2, n_shards=2, on_checkpoint=crash_at(2))
    resumed = _port_portfolio(prob, "torch", islands=fleet, checkpoint_dir=tmp_path / "b",
                              checkpoint_every=2, resume=True)
    assert _portfolio_record(resumed) == want
    with pytest.raises(ValueError, match="sweep mesh"):
        _port_portfolio(prob, "python", checkpoint_dir=tmp_path / "c", mesh=object())
    assert not (tmp_path / "c").exists()


# --------------------------------------------------- snapshots across packages
def _crash_then_resume(writer, reader, run, tmp_path, k):
    """``run(pkg, **ckpt)``: kill ``writer``'s run after snapshot ``k``,
    resume with ``reader``; returns the resumed result."""
    with pytest.raises(SimulatedCrash):
        run(writer, checkpoint_dir=tmp_path, on_checkpoint=crash_at(k))
    return run(reader, checkpoint_dir=tmp_path, resume=True)


def _kw_for(pkg, kw):
    return dict(kw, device="cpu") if pkg is port else kw


_DIRECTIONS = {"reference->port": (ref, port), "port->reference": (port, ref)}


@pytest.mark.parametrize("direction", _DIRECTIONS)
@pytest.mark.parametrize("hetero", [False, True], ids=["bram18", "hetero"])
@pytest.mark.parametrize("k", [1, 2])
def test_sweep_sa_fleet_resumes_across_packages(tmp_path, direction, hetero, k):
    # the task key holds the unresolved backend: "python" (and "auto") name
    # the same task in both packages
    kw = dict(_SA, backend="python", checkpoint_every=150)
    want = _sweep_record(ref.pack_sweep(_problems(ref, hetero), "sa-s", seed=3, **_SA,
                                        backend="python"))

    def run(pkg, **ck):
        return pkg.pack_sweep(_problems(pkg, hetero), "sa-s", seed=3,
                              **_kw_for(pkg, kw), **ck)

    got = _crash_then_resume(*_DIRECTIONS[direction], run, tmp_path, k)
    assert _sweep_record(got) == want


@pytest.mark.parametrize("direction", _DIRECTIONS)
@pytest.mark.parametrize("hetero", [False, True], ids=["bram18", "hetero"])
def test_sweep_ga_lockstep_resumes_across_packages(tmp_path, direction, hetero):
    # "auto" is the lockstep lane in both ("ref" there, "torch" here on the CPU)
    kw = dict(_GA, backend="auto", checkpoint_every=4)
    want = _sweep_record(ref.pack_sweep(_problems(ref, hetero), "ga-nfd", seed=7,
                                        backend="ref", **_GA))

    def run(pkg, **ck):
        return pkg.pack_sweep(_problems(pkg, hetero), "ga-nfd", seed=7,
                              **_kw_for(pkg, kw), **ck)

    got = _crash_then_resume(*_DIRECTIONS[direction], run, tmp_path, 2)
    assert _sweep_record(got) == want


@pytest.mark.parametrize("direction", _DIRECTIONS)
@pytest.mark.parametrize("hetero", [False, True], ids=["bram18", "hetero"])
def test_portfolio_resumes_across_packages(portfolio_ref, tmp_path, direction, hetero):
    kw = dict(_PORT, backend="auto", checkpoint_every=2)
    want = (portfolio_ref if not hetero else _portfolio_record(ref.pack_portfolio(
        _problems(ref, True)[0], islands=_islands(ref), backend="ref", **_PORT)))

    def run(pkg, **ck):
        return pkg.pack_portfolio(_problems(pkg, hetero)[0], islands=_islands(pkg),
                                  **_kw_for(pkg, kw), **ck)

    got = _crash_then_resume(*_DIRECTIONS[direction], run, tmp_path, 2)
    assert _portfolio_record(got) == want
