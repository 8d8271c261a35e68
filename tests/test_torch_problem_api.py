"""The port's problem-model API that the reference exports beside the cost
model (`register_ram_kind`, `OCMInventory.from_counts` / `kind_index` /
`capacity_units`, `PackingProblem.bin_mode` / `grid_gap` / `best_kind`,
`Solution.set_kind` / `invalidate` / `max_items_per_bin` / `is_valid`,
`PackingResult.time_to_within`) against the reference's, exactly equal,
ending with a `pack()` on an inventory that holds a registered custom kind.
"""
import numpy as np
import pytest
import torch

from test_torch_engines import _key

import repro.core as ref
import repro.core.problem as ref_problem
import repro_torch.core as port
import repro_torch.core.problem as port_problem

# a 9 Kib primitive: beside BRAM18 it halves the cost unit, so both kinds
# carry a weight (BRAM18 2, this one 1) and the kind lane changes costs
CUSTOM = "TEST_RAM9K"
CUSTOM_MODES = ((1, 8192), (2, 4096), (4, 2048), (9, 1024), (18, 512))


@pytest.fixture
def custom_kind():
    """One custom kind registered in BOTH packages' registries, removed from
    both afterwards."""
    kinds = (
        ref.register_ram_kind(ref.RAMKind(CUSTOM, CUSTOM_MODES, 9 * 1024)),
        port.register_ram_kind(port.RAMKind(CUSTOM, CUSTOM_MODES, 9 * 1024)),
    )
    yield kinds
    ref_problem.RAM_KINDS.pop(CUSTOM, None)
    port_problem.RAM_KINDS.pop(CUSTOM, None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_register_ram_kind_matches_reference(custom_kind):
    a, b = custom_kind
    assert port.RAM_KINDS[CUSTOM] is b and ref.RAM_KINDS[CUSTOM] is a
    assert (b.name, b.modes, b.capacity_bits) == (a.name, a.modes, a.capacity_bits)
    assert port.register_ram_kind(b) is b  # returned for chaining
    assert set(port.RAM_KINDS) == set(ref.RAM_KINDS)
    for bad in (port.RAMKind("X", (), 64), port.RAMKind("X", ((1, 64),), 0)):
        with pytest.raises(ValueError, match="needs modes and capacity"):
            port.register_ram_kind(bad)
    assert "X" not in port.RAM_KINDS


def test_registry_is_clean_without_the_fixture():
    assert CUSTOM not in port.RAM_KINDS and CUSTOM not in ref.RAM_KINDS


COUNTS = [
    dict(BRAM18=4, URAM288=2),
    dict(URAM288=2, BRAM18=4),  # keyword order fixes the kind lanes
    dict(BRAM18=624, URAM288=-1),  # one kind unbounded
    dict(BRAM36=-1),
    dict(BRAM18=8, LUTRAM64=100, BRAM36=3),
]


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_from_counts_kind_index_capacity(counts):
    a = ref.OCMInventory.from_counts("dev", **counts)
    b = port.OCMInventory.from_counts("dev", **counts)
    assert [k.name for k in b.kinds] == [k.name for k in a.kinds] == list(counts)
    assert (b.counts, b.name, b.unit_bits, b.weights) == (
        a.counts, a.name, a.unit_bits, a.weights
    )
    for name in counts:
        assert b.kind_index(name) == a.kind_index(name)
    assert b.capacity_units() == a.capacity_units()
    assert (b.capacity_units() is None) == any(v < 0 for v in counts.values())
    with pytest.raises(KeyError):
        b.kind_index("URAM9000")
    with pytest.raises(KeyError):
        port.OCMInventory.from_counts("dev", URAM9000=1)


def test_from_counts_bounded_capacity_value():
    inv = port.OCMInventory.from_counts("dev", BRAM18=4, URAM288=2)
    assert inv.kind_index("URAM288") == 1
    assert inv.capacity_units() == 4 + 2 * 16
    assert port.RAM_KINDS["URAM288"] is port.URAM288


def test_from_counts_with_custom_kind(custom_kind):
    a = ref.OCMInventory.from_counts("dev9k", BRAM18=6, **{CUSTOM: 10})
    b = port.OCMInventory.from_counts("dev9k", BRAM18=6, **{CUSTOM: 10})
    assert b.weights == a.weights == (2, 1)
    assert b.kind_index(CUSTOM) == a.kind_index(CUSTOM) == 1
    assert b.capacity_units() == a.capacity_units() == 6 * 2 + 10


def _problems(counts):
    bufs_a = ref.get_buffers("CNV-W2A2")
    bufs_b = port.get_buffers("CNV-W2A2")
    if counts is None:
        return ref.PackingProblem(bufs_a), port.PackingProblem(bufs_b)
    return (
        ref.PackingProblem(bufs_a, ocm=ref.OCMInventory.from_counts("dev", **counts)),
        port.PackingProblem(bufs_b, ocm=port.OCMInventory.from_counts("dev", **counts)),
    )


GEOMETRY_CASES = [None, *COUNTS, "custom"]


@pytest.mark.parametrize("counts", GEOMETRY_CASES, ids=str)
def test_bin_mode_grid_gap_best_kind(counts, custom_kind):
    if counts == "custom":
        counts = {"BRAM18": 6, CUSTOM: 10, "LUTRAM64": -1}
    a, b = _problems(counts)
    rng = np.random.default_rng(16)
    ws = [*rng.integers(1, 300, 200), 1, 72, 144, 2**20]
    hs = [*rng.integers(1, 200_000, 200), 1, 4096, 64, 3]
    for w, h in zip(ws, hs):
        w, h = int(w), int(h)
        for k in range(a.n_kinds):
            assert b.bin_mode(w, h, k) == a.bin_mode(w, h, k)
            assert b.grid_gap(w, h, k) == a.grid_gap(w, h, k)
        assert b.best_kind(w, h) == a.best_kind(w, h)


def _solutions(counts, seed):
    a, b = _problems(counts)
    sa = ref.nfd_from_scratch(a, np.random.default_rng(seed))
    sb = port.nfd_from_scratch(b, np.random.default_rng(seed))
    assert sb.bins == sa.bins
    return sa, sb


@pytest.mark.parametrize("counts", [None, dict(BRAM18=40, URAM288=4)], ids=str)
def test_set_kind_invalidate_max_items_is_valid(counts):
    sa, sb = _solutions(counts, seed=5)
    rng = np.random.default_rng(0)
    n_kinds = sa.problem.n_kinds
    for _ in range(20):  # set_kind, then cost
        bi, k = int(rng.integers(len(sa.bins))), int(rng.integers(n_kinds))
        sa.set_kind(bi, k)
        sb.set_kind(bi, k)
        assert sb.cost() == sa.cost() == sb.cost_full()
        np.testing.assert_array_equal(sb.kinds, sa.kinds)
    assert sb.max_items_per_bin() == sa.max_items_per_bin()
    assert sb.is_valid() and sa.is_valid()
    assert sb.is_valid(intra_layer=True) == sa.is_valid(intra_layer=True)

    # wholesale surgery on the bins, same bin count: the cache is stale
    # until `invalidate`
    for s in (sa, sb):
        s.bins[0][0], s.bins[-1][0] = s.bins[-1][0], s.bins[0][0]
        s.invalidate()
    assert sb.cost() == sa.cost() == sb.cost_full()
    # a changed bin count (one bin split in two) re-aligns the kind lane
    split = next(i for i, b in enumerate(sa.bins) if len(b) > 1)
    for s in (sa, sb):
        s.bins = [*s.bins[:split], s.bins[split][:1], *s.bins[split:]]
        s.bins[split + 1] = s.bins[split + 1][1:]
        s.invalidate()
    np.testing.assert_array_equal(sb.kinds, sa.kinds)
    assert sb.cost() == sa.cost() == sb.cost_full()
    assert sb.max_items_per_bin() == sa.max_items_per_bin()
    assert sb.is_valid() and sa.is_valid()

    # invalid packings: a lost buffer, a bin over the cardinality limit, a
    # kind outside the inventory
    for broken in ("lost", "cardinality", "kind"):
        ca, cb = sa.copy(), sb.copy()
        for s in (ca, cb):
            if broken == "lost":
                s.bins[0] = s.bins[0][1:] or [s.bins[1][0]]
            elif broken == "cardinality":
                s.bins = [[i for b in s.bins for i in b]]
            else:
                s.kinds[0] = n_kinds
            s.invalidate()
        assert cb.is_valid() is ca.is_valid() is False, broken
    many_a, many_b = sa.copy(), sb.copy()
    for s in (many_a, many_b):
        s.bins = [[i for b in s.bins[:3] for i in b], *s.bins[3:]]
        s.invalidate()
    assert many_b.max_items_per_bin() == many_a.max_items_per_bin()


def _custom_problems():
    counts = {"BRAM18": 60, CUSTOM: 40}
    return (
        ref.PackingProblem(ref.get_buffers("CNV-W1A1"),
                           ocm=ref.OCMInventory.from_counts("dev9k", **counts)),
        port.PackingProblem(port.get_buffers("CNV-W1A1"),
                            ocm=port.OCMInventory.from_counts("dev9k", **counts)),
    )


def test_time_to_within_matches_reference():
    pa, pb = _problems(None)
    a = ref.pack(pa, "ga-nfd", seed=2, max_seconds=1e9, max_generations=15, n_pop=12,
                 backend="python")
    b = port.pack(pb, "ga-nfd", seed=2, max_seconds=1e9, max_generations=15, n_pop=12,
                  backend="python", device="cpu")
    assert _key(b) == _key(a)
    # the same result on both sides: the reference's trace and wall time
    same = port.PackingResult(
        solution=b.solution, cost=a.cost, efficiency=a.efficiency,
        wall_time_s=a.wall_time_s, algorithm=a.algorithm, trace=list(a.trace),
        iterations=a.iterations, params={},
    )
    fracs = (0.0, 0.001, 0.01, 0.05, 0.2, 1.0)
    for frac in fracs:
        assert same.time_to_within(frac) == a.time_to_within(frac)
    assert same.time_to_within() == a.time_to_within()
    # a trace that never comes within reach falls back to the wall time
    far = port.PackingResult(
        solution=b.solution, cost=10, efficiency=0.0, wall_time_s=3.5,
        algorithm="x", trace=[(0.1, 50), (0.2, 40)], iterations=2, params={},
    )
    assert far.time_to_within(0.5) == 3.5
    assert far.time_to_within(3.0) == 0.2
    # the port's own run: one of its trace times, non-decreasing in frac
    times = [b.time_to_within(f) for f in fracs]
    assert all(t in {x for x, _ in b.trace} | {b.wall_time_s} for t in times)
    assert times == sorted(times, reverse=True)


@pytest.mark.parametrize("algorithm,budget", [
    ("ga-nfd", dict(max_generations=12, n_pop=12)),
    ("sa-s", dict(max_iterations=300)),
], ids=["ga-nfd", "sa-s"])
def test_pack_on_custom_kind_inventory_bit_identical(algorithm, budget, custom_kind):
    pa, pb = _custom_problems()
    assert pb.kind_weights == pa.kind_weights == (2, 1)
    kw = dict(seed=11, max_seconds=1e9, **budget)
    a = ref.pack(pa, algorithm, backend="python", **kw)
    assert _key(ref.pack(pa, algorithm, backend="ref", **kw)) == _key(a)
    for backend in ("python", "torch", "cuda"):
        b = port.pack(pb, algorithm, backend=backend, device="cpu", **kw)
        assert _key(b) == _key(a), backend
        assert b.solution.is_valid()
        assert b.solution.cost() == b.solution.cost_full() == b.cost
    assert set(np.unique(a.solution.kinds)) <= {0, 1}
