"""The kind assignment of an NFD start through its compiled entry point
(``assign_kinds`` in ``csrc/nfd_pass.c``, bound in `core/nfd_native.py`)
against `repro.core.problem.greedy_assign_kinds`, decision for decision.

`greedy_assign_kinds` must give the reference's kind lane, cost, usage and
overflow on the same packing, leave every geometry row equal to a fresh
`Solution._refresh` (the moved bins clean), and draw nothing.  Cases run
over every Table-1 accelerator on an Alveo U50 and on a ZU7EV (whose tight
inventory leaves overflow), then over hand-made inventories: a kind with no
primitives, an unbounded second kind, three kinds, and equal regrets across
bins and across target kinds.  The counter ``nfd.kinds.moves``, the
single-kind and unbounded problems the assignment leaves alone, inputs the
entry point cannot take and a host without a compiler close the file.
"""
import numpy as np
import pytest

import repro.core as ref
import repro.core.problem as ref_problem
from repro.core import baselines as ref_baselines
import repro_torch.core as port
from repro_torch import obs
from repro_torch.core import baselines, nfd, nfd_native
from repro_torch.core.problem import Solution, greedy_assign_kinds
from repro_torch.memory.tiles import tile_grid_problem

DEVICES = ["U50", "ZU7EV"]
SEEDS = [0, 2**31 + 5]


def _problems(name, device):
    """The port's and the reference's problem for one Table-1 row."""
    return port.get_problem(name, device=device), ref.get_problem(name, device=device)


def _custom(kinds, counts, buffers, max_items=4):
    """The port's and the reference's problem over the same hand-made
    inventory: ``kinds`` are ``(name, modes, capacity_bits)``, ``buffers``
    ``(width, depth, layer)``."""
    out = []
    for m in (port, ref):
        inv = m.OCMInventory(tuple(m.RAMKind(*k) for k in kinds), tuple(counts))
        out.append(m.PackingProblem([m.Buffer(*b) for b in buffers], ocm=inv,
                                    max_items=max_items))
    return tuple(out)


def _nfd_bins(prob, seed, sort_by_width):
    rng = np.random.default_rng(seed)
    order = rng.permutation(prob.n)
    if sort_by_width:
        order = order[np.argsort(prob.widths[order], kind="stable")]
    return nfd.nfd_pack_order(prob, order, rng)


def check_assign(pp, rp, bins, kinds=None):
    """Assign kinds to ``bins`` through the port and through the reference:
    equal lanes, costs, usage and overflow, clean rows equal to a fresh
    refresh, and no draw taken.  Returns the port's solution."""
    sol = Solution(pp, bins, kinds)
    expect = ref_problem.Solution(rp, bins, kinds)
    rng = np.random.default_rng(7)
    state, legacy = rng.bit_generator.state, np.random.get_state()
    assert greedy_assign_kinds(sol) is sol
    ref_problem.greedy_assign_kinds(expect)
    assert rng.bit_generator.state == state
    assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), legacy))
    assert sol.kinds.dtype == np.int64
    assert sol.kinds.tolist() == [int(k) for k in expect.kinds]
    assert not sol._any_dirty and not sol._dirty.any()
    rows = sol._geom.copy()
    assert sol.cost() == expect.cost() == sol.cost_full()
    np.testing.assert_array_equal(sol.used_primitives(), expect.used_primitives())
    assert sol.inventory_overflow() == expect.inventory_overflow()
    fresh = sol.copy()
    fresh.invalidate()
    fresh._refresh()
    np.testing.assert_array_equal(rows, fresh._geom)
    sol.validate()
    return sol


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sort_by_width", [False, True], ids=["random", "by-width"])
@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", port.ACCELERATORS)
def test_assignment_equals_reference_on_table1(name, device, sort_by_width, seed):
    pp, rp = _problems(name, device)
    check_assign(pp, rp, _nfd_bins(pp, seed, sort_by_width))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["CNV-W2A2", "RN50-W1A2"])
def test_assignment_from_a_mixed_kind_lane_equals_reference(name, device):
    """A lane that is not all kind 0 going in: every bin whose kind changes
    has its row rewritten for the new kind."""
    pp, rp = _problems(name, device)
    bins = _nfd_bins(pp, 3, True)
    kinds = np.random.default_rng(4).integers(0, 2, len(bins))
    check_assign(pp, rp, bins, kinds)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["Tincy-YOLO", "RN152-W1A2"])
def test_nfd_start_equals_reference_with_the_generator(name, device):
    pp, rp = _problems(name, device)
    ra, rb = np.random.default_rng(2**31 + 3), np.random.default_rng(2**31 + 3)
    got = nfd.nfd_from_scratch(pp, ra, sort_by_width=True)
    expect = ref.nfd_from_scratch(rp, rb, sort_by_width=True)
    assert got.bins == [list(b) for b in expect.bins]
    assert got.kinds.tolist() == [int(k) for k in expect.kinds]
    assert got.cost() == got.cost_full() == expect.cost()
    assert not got._dirty.any()
    assert ra.bit_generator.state == rb.bit_generator.state


B18 = ("BRAM18", ref.BRAM18.modes, ref.BRAM18.capacity_bits)
B36 = ("BRAM36", ref.BRAM36.modes, ref.BRAM36.capacity_bits)
U288 = ("URAM288", ref.URAM288.modes, ref.URAM288.capacity_bits)
U288B = ("URAM288B", ref.URAM288.modes, ref.URAM288.capacity_bits)  # URAM288's twin
LUT = ("LUTRAM64", ref.LUTRAM64.modes, ref.LUTRAM64.capacity_bits)


def _buffers(seed, n=40):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 80)), int(rng.integers(1, 20_000)), int(rng.integers(0, 5)))
            for _ in range(n)]


# (kinds, counts, buffers, max_items)
HAND_MADE = {
    # the reference's test_greedy_assign_kinds_relieves_overflow
    "relieves-overflow": ((B18, U288), (40, 64), [(32, 4096, i % 3) for i in range(20)], 1),
    "no-uram": ((B18, U288), (30, 0), _buffers(1), 4),
    "no-bram": ((B18, U288), (0, 12), _buffers(2), 4),
    "unbounded-uram": ((B18, U288), (20, -1), _buffers(3), 4),
    "unbounded-bram": ((B18, U288), (-1, 2), _buffers(4), 2),
    "three-kinds": ((B18, B36, U288), (25, 6, 4), _buffers(5, 60), 4),
    "three-kinds-lutram": ((LUT, B18, U288), (200, 10, 3), _buffers(6, 60), 3),
    "three-kinds-tight": ((B18, B36, U288), (3, 2, 1), _buffers(7, 30), 4),
    # identical bins: every regret equal, the lowest bin moves first
    "equal-regret-bins": ((B18, U288), (12, 64), [(36, 2048, 0)] * 16, 1),
    # twin targets: equal regrets across kinds, the earlier kind wins
    "equal-regret-kinds": ((B18, U288, U288B), (40, 3, 3), [(32, 4096, i % 3) for i in range(20)],
                           1),
    "equal-regret-kinds-full": ((B18, U288B, U288), (10, 64, 64), _buffers(8, 50), 2),
}


@pytest.mark.parametrize("packing", ["singleton", "nfd"])
@pytest.mark.parametrize("case", list(HAND_MADE))
def test_assignment_equals_reference_on_hand_made_inventories(case, packing):
    kinds, counts, buffers, max_items = HAND_MADE[case]
    pp, rp = _custom(kinds, counts, buffers, max_items)
    bins = [[i] for i in range(pp.n)] if packing == "singleton" else _nfd_bins(pp, 9, False)
    sol = check_assign(pp, rp, bins)
    if case == "relieves-overflow":
        assert sol.inventory_overflow() == 0
    if case == "equal-regret-bins":
        # 16 bins of 4 BRAM18 on 12: the first 13 leave, in bin order
        assert sol.kinds.tolist() == [1] * 13 + [0] * 3
    if case == "equal-regret-kinds":
        # 20 bins of 8 BRAM18, 3 URAM288 and 3 twins: the earlier twin fills first
        assert sol.kinds.tolist() == [1] * 3 + [2] * 3 + [0] * 14


def test_moves_counter_counts_the_reference_moves_on_a_u50_start():
    """On a U50 (two kinds, moves only onto URAM with room) no bin moves
    twice: the moves are the bins the reference leaves off their cheapest
    kind."""
    pp, rp = _problems("RN152-W1A2", "U50")
    with obs.recording() as rec:
        sol = nfd.nfd_from_scratch(pp, np.random.default_rng(2**31 + 1))
    expect = ref.nfd_from_scratch(rp, np.random.default_rng(2**31 + 1))
    expect._refresh()
    cheapest = [min(range(rp.n_kinds), key=lambda k: rp.bin_cost(int(w), int(h), k))
                for w, h in expect._geom[:, :2]]
    moved = sum(int(k) != c for k, c in zip(expect.kinds, cheapest))
    assert moved > 100
    assert rec.counters["nfd.kinds.moves"] == moved
    assert sol.kinds.tolist() == [int(k) for k in expect.kinds]
    assert rec.count("nfd.kinds") == 1


def _tile_problem():
    entries = [(f"layer_{i}/w", (64 * (i % 3 + 1), 32 * (i % 4 + 1)), 2) for i in range(12)]
    return tile_grid_problem(entries)[0]


BYPASSED = {
    "bram18": lambda: port.get_problem("RN50-W1A2"),
    "tile-grid": _tile_problem,
    "unbounded-kinds": lambda: _custom((B18, U288), (-1, -1), _buffers(10))[0],
}


@pytest.mark.parametrize("case", list(BYPASSED))
def test_single_kind_and_unbounded_problems_are_left_alone(case):
    """The early return: the solution comes back untouched, the counter
    stays 0, and the start's ``nfd.kinds`` span still opens and closes."""
    prob = BYPASSED[case]()
    with obs.recording() as rec:
        sol = nfd.nfd_from_scratch(prob, np.random.default_rng(11))
        kinds, rows, dirty = sol.kinds.copy(), sol._geom.copy(), sol._dirty.copy()
        assert greedy_assign_kinds(sol) is sol
        cold = Solution(prob, sol.bins)
        assert greedy_assign_kinds(cold) is cold and cold._dirty.all()
    np.testing.assert_array_equal(sol.kinds, kinds)
    np.testing.assert_array_equal(sol._geom, rows)
    np.testing.assert_array_equal(sol._dirty, dirty)
    assert not sol.kinds.any()
    assert rec.counters.get("nfd.kinds.moves", 0) == 0
    assert rec.count("nfd.kinds") == rec.count("nfd.scratch") == 1


@pytest.mark.parametrize("baseline", ["next_fit", "first_fit_decreasing"])
def test_baselines_take_the_same_assignment(baseline):
    pp, rp = _problems("RN50-W1A2", "ZU7EV")
    got = getattr(baselines, baseline)(pp)
    expect = getattr(ref_baselines, baseline)(rp)
    assert got.bins == [list(b) for b in expect.bins]
    assert got.kinds.tolist() == [int(k) for k in expect.kinds]
    assert got.cost() == expect.cost() and got.inventory_overflow() == expect.inventory_overflow()


def test_arrays_and_mode_tables_the_entry_point_cannot_take_are_refused(monkeypatch):
    pp, _ = _problems("CNV-W1A1", "U50")
    sol = Solution(pp, _nfd_bins(pp, 0, False))
    sol._refresh()
    nb = len(sol.bins)
    for kinds, geom in ((sol.kinds.astype(np.int32), sol._geom),
                        (sol.kinds, sol._geom[:, :5].copy()),
                        (sol.kinds[:-1], sol._geom),
                        (np.zeros(2 * nb, dtype=np.int64)[::2], sol._geom),
                        (sol.kinds, np.asfortranarray(sol._geom))):
        with pytest.raises(ValueError, match="C-contiguous int64"):
            nfd_native.assign_kinds(pp, kinds, geom)
    mode_d = pp._kind_mode_d[1].copy()
    mode_d[0] = 0
    monkeypatch.setattr(pp, "_kind_mode_d", [pp._kind_mode_d[0], mode_d])
    kinds, rows = sol.kinds.copy(), sol._geom.copy()
    with pytest.raises(ValueError, match="mode size below 1"):
        nfd_native.assign_kinds(pp, sol.kinds, sol._geom)
    np.testing.assert_array_equal(sol.kinds, kinds)
    np.testing.assert_array_equal(sol._geom, rows)


def test_assignment_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(nfd_native.NATIVE, "build_dir", tmp_path / "host")
    monkeypatch.setattr(nfd_native.NATIVE, "compilers", ("no-such-compiler-here",))
    monkeypatch.setattr(nfd_native.NATIVE, "loaded", {})
    prob = port.get_problem("RN50-W1A2", device="U50")
    with pytest.raises(RuntimeError, match="nfd.native libraries: searched no-such-compiler"):
        baselines.next_fit(prob)
    assert not (tmp_path / "host").exists()
