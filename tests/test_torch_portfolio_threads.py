"""The port's thread-pool portfolio (`pack_portfolio_threads`, `_Island`)
against the reference's.

The thread pool is wall-clock budgeted, so whole runs are compared only
by their contract (a valid packing, its name, its rounds); one island's
rounds under iteration budgets, with a migration between them, are
deterministic and equal to the reference's bit for bit.
"""
import inspect

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.portfolio import _Island as RefIsland
from repro_torch.core.portfolio import _Island as PortIsland


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(r):
    return (r.cost, [list(b) for b in r.solution.bins],
            [int(k) for k in r.solution.kinds], r.iterations,
            [c for _, c in r.trace])


@pytest.mark.parametrize("backend", ["python", "torch", "legacy"])
def test_portfolio_threads_legacy_still_works(backend):
    prob = port.get_problem("CNV-W1A1")
    r = port.pack_portfolio_threads(prob, n_islands=2, seed=0, max_seconds=0.8,
                                    backend=backend, sa_chains=3, device="cpu")
    r.solution.validate()
    assert r.algorithm.startswith("portfolio-threads[")
    assert r.params["rounds"] >= 1
    assert r.solution.cost() == r.solution.cost_full() == r.cost


def test_threads_engine_is_baseline_only():
    """Baseline only: no determinism, scheduler, or checkpoint surface, and
    the reference's parameters in the reference's order (the port adds
    ``device``, as every port entry point does)."""
    assert "baseline" in port.pack_portfolio_threads.__doc__
    params = inspect.signature(port.pack_portfolio_threads).parameters
    for absent in ("scheduler", "fused", "checkpoint_dir", "resume"):
        assert absent not in params
    want = list(inspect.signature(ref.pack_portfolio_threads).parameters)
    got = [p for p in params if p != "device"]
    assert got == want
    for name in want:
        assert params[name].default == inspect.signature(
            ref.pack_portfolio_threads).parameters[name].default


def test_portfolio_threads_hetero_runs():
    prob = port.get_problem("RN50-W1A2", device="ZU7EV")
    r = port.pack_portfolio_threads(prob, n_islands=3, seed=1, max_seconds=1.0,
                                    backend="torch", sa_chains=2, device="cpu",
                                    n_pop=8)
    r.solution.validate()
    assert r.params["rounds"] >= 1


@pytest.mark.parametrize("name,device", [("CNV-W1A1", None), ("CNV-W2A2", "U50")])
def test_island_rounds_with_migration_equal_reference(name, device):
    """Two rounds of every island kind under iteration budgets, the global
    best migrating in between (the thread pool's loop body, run serially):
    results and warm states equal the reference's."""
    pa, pb = ref.get_problem(name, device=device), port.get_problem(name, device=device)
    specs = [("ga-nfd", 0, {}), ("sa-s", 1, {"n_chains": 3}), ("sa-nfd", 2, {}),
             ("sa-s", 3, {"n_chains": 1})]
    hyper = dict(max_generations=6, n_pop=10, max_iterations=150, patience=10**9)

    def islands(pkg, Island, prob, **dev):
        return [
            Island(prob, pkg.IslandSpec(algorithm=a, seed=s),
                   pkg.make_packer(a, seed=s, max_seconds=1e9,
                                   backend="python", **hyper, **h, **dev))
            for a, s, h in specs
        ]

    ia = islands(ref, RefIsland, pa)
    ib = islands(port, PortIsland, pb, device="cpu")
    lam = ref.DEFAULT_INVENTORY_PENALTY

    def score(sol):
        return sol.cost() + lam * sol.inventory_overflow()

    for round_idx in range(2):
        ra = [isl.run_round(1e9, round_idx) for isl in ia]
        rb = [isl.run_round(1e9, round_idx) for isl in ib]
        assert [_record(r) for r in rb] == [_record(r) for r in ra]
        for isls, res in ((ia, ra), (ib, rb)):
            best = min(res, key=lambda r: score(r.solution))
            for isl in isls:
                isl.migrate_in(best.solution, score(best.solution), score)
        for a, b in zip(ia, ib):
            wa = a.pop if a.is_ga else a.chains
            wb = b.pop if b.is_ga else b.chains
            assert [s.bins for s in wb] == [s.bins for s in wa]
            assert [list(s.kinds) for s in wb] == [list(s.kinds) for s in wa]
    # the seeds the second round ran with are the reference's reseeds
    assert [isl.packer.seed for isl in ib] == [isl.packer.seed for isl in ia]
    assert np.all(np.array([isl.packer.seed for isl in ib]) > 7000)
