"""The port's ``legacy`` backend against the reference's, bit for bit.

``legacy`` is the seed's from-scratch scalar evaluation (GA costs from
``cost_full()``, SA on the scalar loop), kept as the benchmark baseline.
The reference pins every other backend to its trajectory
(``tests/test_engine.py``, ``tests/test_ocm.py``); here the same cases run
through the reference's ``legacy`` and the port's ``legacy``, ``python``,
``torch`` and ``cuda`` (the kernel wrappers take their plain versions on
CPU tensors).  Records are cost, bins, kind lanes, iterations and the
trace's cost sequence; budgets are iteration counts, never wall clock.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.device import resolve_backend

PORT_BACKENDS = ("legacy", "python", "torch", "cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(r):
    return (
        r.cost,
        [list(b) for b in r.solution.bins],
        [int(k) for k in r.solution.kinds],
        r.iterations,
        [c for _, c in r.trace],
    )


def _pair(draw):
    """The same problem in both packages: ``draw(pkg)`` builds it from one
    package's classes."""
    return draw(ref), draw(port)


def _hetero(rng_seed, n=25):
    def draw(pkg):
        rng = np.random.default_rng(rng_seed)
        bufs = [
            pkg.Buffer(width=int(rng.integers(1, 80)),
                       depth=int(rng.integers(1, 20_000)),
                       layer=int(rng.integers(0, 5)))
            for _ in range(n)
        ]
        return pkg.PackingProblem(
            bufs, ocm=pkg.OCMInventory((pkg.BRAM18, pkg.URAM288), (10, 8)),
            max_items=4,
        )
    return _pair(draw)


def _bram36(rng_seed=8):
    def draw(pkg):
        rng = np.random.default_rng(rng_seed)
        bufs = [
            pkg.Buffer(int(rng.integers(1, 70)), int(rng.integers(1, 30_000)), int(i % 4))
            for i in range(25)
        ]
        return pkg.PackingProblem(bufs, ocm=pkg.OCMInventory((pkg.BRAM36,), (-1,)))
    return _pair(draw)


def _table1(name, device=None):
    return ref.get_problem(name, device=device), port.get_problem(name, device=device)


def _check(probs, make, ref_kw, backends=PORT_BACKENDS):
    """The reference's legacy run, then every port backend: equal records,
    consistent caches."""
    pa, pb = probs
    want = make(ref, "legacy", None).pack(pa)
    assert want.params["backend"] == "legacy"
    for backend in backends:
        r = make(port, backend, "cpu").pack(pb)
        assert _record(r) == _record(want), backend
        r.solution.validate()
        assert r.solution.cost() == r.solution.cost_full() == r.cost
        if backend == "legacy":
            assert r.params == want.params
    return want


def _ga(mutation="nfd", seed=7, gens=25, **kw):
    def make(pkg, backend, device):
        extra = {} if device is None else dict(device=device)
        return pkg.GeneticPacker(mutation=mutation, backend=backend, seed=seed,
                                 max_generations=gens, max_seconds=1e9,
                                 patience=10**9, **kw, **extra)
    return make


def _sa(seed=5, iters=400, **kw):
    def make(pkg, backend, device):
        extra = {} if device is None else dict(device=device)
        return pkg.SimulatedAnnealingPacker(
            perturbation="swap", backend=backend, n_chains=1, seed=seed,
            max_iterations=iters, max_seconds=1e9, patience=10**9, **kw, **extra)
    return make


# tests/test_engine.py: GA on two Table-1 problems, GA-S, SA single chain
@pytest.mark.parametrize("name", ["CNV-W1A1", "CNV-W2A2"])
def test_ga_backends_equal_reference_legacy(name):
    _check(_table1(name), _ga(), {})


def test_ga_swap_mutation_equal_reference_legacy():
    _check(_table1("CNV-W1A1"), _ga(mutation="swap", seed=11, gens=20), {})


def test_sa_swap_single_chain_equal_reference_legacy():
    want = _check(_table1("CNV-W1A1"), _sa(), {})
    assert want.iterations == 400
    assert want.params["n_chains"] == 1


def test_sa_single_chain_long_trajectory_equal_reference_legacy():
    _check(_table1("CNV-W2A2"), _sa(seed=11, iters=3000), {},
           backends=("legacy", "python"))


# tests/test_ocm.py: heterogeneous GA / SA, a BRAM36-only problem
def test_ga_hetero_equal_reference_legacy():
    _check(_hetero(3), _ga(gens=15), {})


def test_sa_single_chain_hetero_equal_reference_legacy():
    _check(_hetero(4, n=30), _sa(), {})


def test_bram36_single_kind_equal_reference_legacy():
    probs = _bram36()
    _check(probs, _ga(gens=12), {})
    _check(probs, _sa(seed=9, iters=300), {})


def test_table1_heterogeneous_device_equal_reference_legacy():
    _check(_table1("RN50-W1A2", "ZU7EV"), _ga(gens=8, n_pop=16), {})


def test_legacy_sa_runs_one_chain_as_the_reference():
    """A multi-chain request on ``legacy`` runs the scalar loop, one chain,
    as the reference's does (and reports ``legacy`` as its engine)."""
    pa, pb = _table1("CNV-W1A1")
    kw = dict(seed=2, max_iterations=300, n_chains=8, max_seconds=1e9)
    a = ref.pack(pa, "sa-s", backend="legacy", **kw)
    b = port.pack(pb, "sa-s", backend="legacy", device="cpu", **kw)
    assert _record(a) == _record(b)
    assert b.params["backend"] == "legacy" and b.params["n_chains"] == 1
    assert b.algorithm == a.algorithm == "SA-S"
    # sa-nfd's scalar loop reports the same engine name as the reference's
    c = port.pack(pb, "sa-nfd", backend="torch", device="cpu", seed=2,
                  max_iterations=100, max_seconds=1e9)
    assert c.params["backend"] == "legacy"


def test_legacy_resolves_as_itself_on_any_device():
    for dev in ("cpu", "cuda"):
        assert resolve_backend("legacy", torch.device(dev)) == "legacy"


# ------------------------------------------------ the full-scan primitives
def _random_solutions(seed, count=6):
    """Seeded NFD packings of Table-1 and heterogeneous problems, each
    with its counterpart in the other package."""
    from repro_torch.convert import solution_from_state

    out = []
    probs = [_table1("CNV-W2A2"), _table1("RN50-W1A2", "U50"), _hetero(seed)]
    for k, (pa, pb) in enumerate(probs):
        for s in range(count // len(probs)):
            sa = ref.nfd_from_scratch(pa, np.random.default_rng(seed * 100 + 10 * k + s))
            out.append((sa, solution_from_state(pb, sa.state_dict())))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_full_scans_equal_cached_and_reference(seed):
    for sa, sb in _random_solutions(seed):
        full = sb.bin_efficiencies_full()
        np.testing.assert_array_equal(full, sa.bin_efficiencies_full())
        np.testing.assert_allclose(full, sb.bin_efficiencies(), rtol=0, atol=1e-12)
        assert sb.distinct_layers_per_bin_full() == sa.distinct_layers_per_bin_full()
        assert sb.distinct_layers_per_bin_full() == pytest.approx(
            sb.distinct_layers_per_bin(), abs=1e-12)


@pytest.mark.parametrize("use_cache", [True, False])
def test_nfd_repack_use_cache_equals_reference(use_cache):
    for sa, sb in _random_solutions(3):
        for s in range(3):
            kw = dict(threshold=0.95, extra_frac=0.05, max_bins=6)
            ca = ref.nfd_repack(sa, np.random.default_rng(s), use_cache=use_cache, **kw)
            cb = port.nfd_repack(sb, np.random.default_rng(s), use_cache=use_cache, **kw)
            assert ca.bins == cb.bins
            assert list(ca.kinds) == list(cb.kinds)
            assert cb.cost() == cb.cost_full() == ca.cost_full()
            # the same RNG stream whether or not the caches are used
            cc = port.nfd_repack(sb, np.random.default_rng(s), use_cache=not use_cache, **kw)
            assert cc.bins == cb.bins


def test_sweep_on_legacy_equals_reference():
    """``pack_sweep(..., backend="legacy")`` takes the serial lane in both
    packages and gives the reference's records."""
    names = ("CNV-W1A1", "CNV-W2A2")
    for algorithm, kw in (("sa-s", dict(n_chains=4, max_iterations=200)),
                          ("ga-nfd", dict(max_generations=6, n_pop=12))):
        kw = dict(kw, seeds=[0, 1], max_seconds=1e9, patience=10**9, backend="legacy")
        a = ref.pack_sweep([ref.get_problem(n) for n in names], algorithm, **kw)
        b = port.pack_sweep([port.get_problem(n) for n in names], algorithm,
                            device="cpu", **kw)
        assert [_record(r) for r in b.results] == [_record(r) for r in a.results]
        assert all(r.params["backend"] == "legacy" for r in b.results)
