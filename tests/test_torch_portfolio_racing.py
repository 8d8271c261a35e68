"""`repro_torch.core.pack_portfolio(auto=True)` racing and the engines'
portfolio barrier hooks on the CPU against the reference, bit for bit.

Racing cases run the reference on ``python`` and ``ref`` and the port on
``python``, ``torch`` and ``cuda`` (see ``test_torch_portfolio.py`` for the
record compared); the hook cases drive both packages' engines through the
same calls and compare the outcomes.
"""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core.portfolio import _SAFleetGroup
from test_torch_portfolio import _check, one_torch_thread  # noqa: F401


# -------------------------------------------------------- migration hooks
def _fleet_of_two(pkg, group_cls, prob, packer):
    return group_cls(packer, prob, [np.random.default_rng(s) for s in (0, 1)],
                     "python")


@pytest.mark.parametrize("patience", [30, 10**9])
def test_fleet_migration_never_revives_frozen_island(patience):
    """A migrant lands in the worst chain slot of a live fleet island only;
    a frozen island refuses it and its rows stop changing — in both
    packages, with the same outcome."""
    from repro.core.portfolio import _SAFleetGroup as RefGroup
    from repro.core.sa import SimulatedAnnealingPacker as RefSA

    outcome = []
    for pkg, group_cls, sa_cls in ((ref, RefGroup, RefSA),
                                   (port, _SAFleetGroup, port.SimulatedAnnealingPacker)):
        prob = pkg.get_problem("CNV-W1A1")
        extra = {} if pkg is ref else dict(device="cpu")
        packer = sa_cls(perturbation="swap", backend="python", n_chains=2, seed=0,
                        max_seconds=1e9, patience=patience, max_iterations=10**6,
                        **extra)
        packer._hetero = False
        fleet = _fleet_of_two(pkg, group_cls, prob, packer)
        fleet.advance(None if patience < 10**9 else 100)
        st = fleet.st
        better = pkg.pack(prob, "sa-s", seed=9, n_chains=4, max_iterations=2000,
                          max_seconds=1e9, patience=10**9, backend="python",
                          **extra).solution
        items, stale = st.items.copy(), st.stale.copy()
        landed = [packer._block_migrate(st, j, better) for j in (0, 1)]
        if patience < 10**9:  # frozen: both islands refuse, nothing moves
            assert st.frozen and st.done and landed == [False, False]
            np.testing.assert_array_equal(st.items, items)
        np.testing.assert_array_equal(st.stale, stale)  # patience never reset
        outcome.append((landed, st.pcosts.tolist(), st.items.tolist()))
    assert outcome[0] == outcome[1]


def test_scalar_and_ga_migrate_hooks_match_reference():
    """The scalar-loop and GA hooks: strictly-better only, no stale reset,
    no trace entry, and a finished run refuses migrants — same outcome in
    both packages."""
    outcome = []
    for pkg in (ref, port):
        extra = {} if pkg is ref else dict(device="cpu")
        prob = pkg.get_problem("CNV-W1A1")
        better = pkg.pack(prob, "sa-s", seed=9, n_chains=4, max_iterations=3000,
                          max_seconds=1e9, patience=10**9, backend="python",
                          **extra).solution
        sa = pkg.SimulatedAnnealingPacker(perturbation="nfd", seed=0, max_seconds=1e9,
                                          patience=50, max_iterations=10**6, **extra)
        sa._hetero = False
        st = sa._scalar_start(prob, None)
        sa._scalar_run(st, 20)
        stale, n_trace = st.stale, len(st.trace)
        assert sa._scalar_migrate(st, better)
        assert st.cost == st.best_cost == better.cost()
        assert st.stale == stale and len(st.trace) == n_trace
        assert not sa._scalar_migrate(st, better)  # not strictly better now
        sa._scalar_run(st)  # drain until frozen (patience)
        assert st.done and not sa._scalar_migrate(st, prob.singleton_solution())
        ga = pkg.GeneticPacker(seed=0, backend="python", max_seconds=1e9,
                               patience=10**9, max_generations=10**6, **extra)
        run = ga._start_run(prob, np.random.default_rng(0), None, "python")
        ga._eval_init(run)
        worst = int(np.argmax(run.costs))
        assert ga._migrate_in(run, better)
        assert run.costs[worst] == run.best_cost == better.cost()
        ga._track_best(run)
        assert run.stale == 1  # the migrant is NOT an own improvement
        run.done = True
        assert not ga._migrate_in(run, prob.singleton_solution())
        outcome.append((st.it, st.cost, run.costs.tolist(), run.best_sel))
    assert outcome[0] == outcome[1]


# ------------------------------------------------------------------ racing
_GRIDS = {
    # two fleets (differing chain counts), a GA island and the scalar lane
    "two-fleets": [
        ("sa-s", {"n_chains": 4}),
        ("sa-s", {"n_chains": 2, "ladder_max": 8.0}),
        ("ga-nfd", {"n_pop": 10}),
        ("sa-nfd", {}),
    ],
    # one fleet and two GA islands: the device backends fuse, and
    # eliminations land inside the fused pair
    "fused-pair": [
        ("sa-s", {}),
        ("ga-nfd", {"n_pop": 10}),
        ("ga-nfd", {"n_pop": 10, "p_mut": 0.6}),
        ("sa-nfd", {}),
    ],
}


@pytest.mark.parametrize("scheduler", ["concurrent", "serial"])
@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_racing_matches_reference(grid, scheduler):
    """``auto=True`` successive halving: ledger, eliminations (island,
    barrier, value), survivors and result equal to the reference's."""
    got = _check(
        (11,),
        port_kw=dict(scheduler=scheduler),
        max_seconds=1e9, patience=10**9, auto=True,
        race_grid=tuple((a, tuple(h.items())) for a, h in _GRIDS[grid]),
        race_budget=3000, race_final=2, migration_every=32, seed=3, sa_chains=4,
    )
    race = got["cuda"].params["race"]
    assert len(race["survivors"]) == 2 and len(race["eliminated"]) == 2
    assert 0 < race["spent"] <= race["budget"] == 3000
    assert got["cuda"].params["fused"] is (grid == "fused-pair" and scheduler == "concurrent")


def test_racing_default_grid_and_budget_match_reference():
    """The default race grid and the default ledger (the default lineup's
    work under the same budgets)."""
    assert port.DEFAULT_RACE_GRID == ref.DEFAULT_RACE_GRID
    _check((12,), max_seconds=1e9,
           patience=10**9, auto=True, migration_every=32, seed=0,
           max_iterations=256, max_generations=8, sa_chains=4)
