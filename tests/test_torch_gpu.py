"""The port's CUDA kernels K1-K5 on a card, exactly equal to their plain
PyTorch versions on the same card tensors (K1 / K2 also at the edges of
their row blocks, K3 / K4 at the edges of their lane groups), the
fitness, SA and fused ops layers staging through one pinned buffer, K5
at the edges of its grid, and
the island portfolio's fused barriers through K5 equal to the host
backend; K6 within float32 rounding of its plain version, the memory
planner on the card equal to the host backend, and the DSE sweep (SA
fleet through K3 / K4, GA lockstep through K1 / K2) equal to the host
backend, also after a crash and a resume; the packing service on the card
(SA-S through K3 / K4) equal to a host-backend service.

Imports neither JAX nor the reference package, so it runs on a GPU host
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Skips where ``torch.cuda.is_available()`` is False.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.problem import BRAM18, BRAM18_MODES, URAM288
from repro_torch.kernels.binpack_fitness import (
    binpack_fitness_cuda,
    binpack_fitness_kinds_cuda,
    binpack_fitness_kinds_ref,
    binpack_fitness_ref,
)
from repro_torch.kernels.binpack_portfolio_step import (
    portfolio_step_cuda,
    portfolio_step_kinds_cuda,
    portfolio_step_kinds_ref,
    portfolio_step_ref,
)
from repro_torch.kernels.binpack_sa_step import (
    sa_step_deltas_cuda,
    sa_step_deltas_kinds_cuda,
    sa_step_deltas_kinds_ref,
    sa_step_deltas_ref,
)
from repro_torch.kernels.packed_gather import (
    bank_matvec,
    packed_gather_cuda,
    packed_gather_ref,
)

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))


def _planes(rng, shape, device):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, 2, shape).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (w, h, k)]


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """K1-K4 built from csrc/ and launched on the card, exactly equal to the
    plain versions, each launched once per case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    for p, nb in [(1, 1), (75, 2253), (13, 300)]:
        w, h, k = _planes(rng, (p, nb), dev)
        assert torch.equal(binpack_fitness_cuda(w, h, BRAM18_MODES),
                           binpack_fitness_ref(w, h, BRAM18_MODES).sum(1))
        assert torch.equal(binpack_fitness_kinds_cuda(w, h, k, U50_TABLES),
                           binpack_fitness_kinds_ref(w, h, k, U50_TABLES).sum(1))
    for c, t in [(1, 1), (64, 4), (9, 130)]:
        old = _planes(rng, (c, t), dev)
        new = _planes(rng, (c, t), dev)
        assert torch.equal(
            sa_step_deltas_cuda(old[0], old[1], new[0], new[1], BRAM18_MODES),
            sa_step_deltas_ref(old[0], old[1], new[0], new[1], BRAM18_MODES),
        )
        args = (old[0], old[1], old[2], new[0], new[1], new[2], U50_TABLES)
        assert torch.equal(sa_step_deltas_kinds_cuda(*args), sa_step_deltas_kinds_ref(*args))
    counts = kernels.launch_counts()
    assert all(counts[f.__name__] == 3 for f in (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
        sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
    ))


@pytest.mark.gpu
def test_sa_kernels_match_plain_versions_at_lane_group_edges_on_card():
    """K3 / K4's lane-parallel body at the shapes its lane groups make
    awkward (T around 2T = 16 and 32 lanes, C around a warp and a block, a
    4 x 64 fleet as one call), the int32 extremes included: max |kernel -
    plain| = 0, one launch per case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    shapes = ([(33, t) for t in (1, 2, 4, 7, 8, 9, 15, 16, 17, 33, 130)]
              + [(c, 4) for c in (1, 31, 32, 33, 4095, 4096)]
              + [(4 * 64, 4), (4095, 17), (31, 130)])
    kernels.reset_launch_counts()
    for c, t in shapes:
        old = _planes(rng, (c, t), dev)
        new = _planes(rng, (c, t), dev)
        args = (old[0], old[1], new[0], new[1], BRAM18_MODES)
        assert int((sa_step_deltas_cuda(*args) - sa_step_deltas_ref(*args)).abs().max()) == 0
        args = (old[0], old[1], old[2], new[0], new[1], new[2], U50_TABLES)
        assert int((sa_step_deltas_kinds_cuda(*args)
                    - sa_step_deltas_kinds_ref(*args)).abs().max()) == 0
    big = torch.from_numpy(
        rng.integers(2**31 - 1000, 2**31, (4, 5, 17)).astype(np.int32)).to(dev)
    kinds = torch.from_numpy(rng.integers(0, 2, (2, 5, 17)).astype(np.int32)).to(dev)
    modes_big = ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))
    kt_big = ((1, modes_big), (5, ((2**31 - 1, 2**31 - 1),)))
    assert torch.equal(sa_step_deltas_cuda(*big, modes_big), sa_step_deltas_ref(*big, modes_big))
    args = (big[0], big[1], kinds[0], big[2], big[3], kinds[1], kt_big)
    assert torch.equal(sa_step_deltas_kinds_cuda(*args), sa_step_deltas_kinds_ref(*args))
    counts = kernels.launch_counts()
    assert counts["sa_step_deltas_cuda"] == counts["sa_step_deltas_kinds_cuda"] == len(shapes) + 1


@pytest.mark.gpu
def test_fitness_kernels_match_plain_versions_at_row_block_edges_on_card():
    """K1 / K2's row block (1024 threads, 4 slots a thread in each 4096-slot
    pass, looping past one pass) at the row lengths where its cover of a row
    changes, by population sizes around the GA's 75, the int32 extremes (the
    magic-number division, the 64-bit product path, kinds outside the
    table) included: max |kernel - plain| = 0, one launch per case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.build import FITNESS_CHUNK as chunk, FITNESS_THREADS as threads

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    edge_nb = (1, threads - 1, threads, threads + 1, chunk - 1, chunk, chunk + 1,
               2 * chunk + 1, 2253)
    shapes = [(p, nb) for p in (1, 75, 77, 300) for nb in edge_nb]
    kernels.reset_launch_counts()
    for shape in shapes:
        w, h, k = _planes(rng, shape, dev)
        assert int((binpack_fitness_cuda(w, h, BRAM18_MODES)
                    - binpack_fitness_ref(w, h, BRAM18_MODES).sum(1)).abs().max()) == 0
        assert int((binpack_fitness_kinds_cuda(w, h, k, U50_TABLES)
                    - binpack_fitness_kinds_ref(w, h, k, U50_TABLES).sum(1)).abs().max()) == 0
    for nb in (threads + 1, chunk + 1):
        w = rng.integers(2**31 - 1000, 2**31, (5, nb)).astype(np.int32)
        w[:, ::3] = rng.integers(1, 70_000, (5, (nb + 2) // 3))
        h = rng.integers(0, 2**31, (5, nb)).astype(np.int32)
        k = rng.integers(-1, 6, (5, nb)).astype(np.int32)
        w, h, k = (torch.from_numpy(x).to(dev) for x in (w, h, k))
        modes_big = ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))
        kt_big = ((1, modes_big), (5, ((2**31 - 1, 2**31 - 1),)))
        assert torch.equal(binpack_fitness_cuda(w, h, modes_big),
                           binpack_fitness_ref(w, h, modes_big).sum(1))
        assert torch.equal(binpack_fitness_kinds_cuda(w, h, k, kt_big),
                           binpack_fitness_kinds_ref(w, h, k, kt_big).sum(1))
    counts = kernels.launch_counts()
    assert counts["binpack_fitness_cuda"] == counts["binpack_fitness_kinds_cuda"] == len(shapes) + 2


@pytest.mark.gpu
def test_fitness_ops_stage_through_one_pinned_buffer_on_card(monkeypatch):
    """A fitness ops call on the card takes exactly one host buffer, pinned,
    holding every plane (one host->device copy); the totals come back equal
    to the plain version's on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import staging
    from repro_torch.kernels.binpack_fitness import population_costs

    taken = []
    inner = staging.host_buffer

    def spy(shape, dtype, device):
        buf = inner(shape, dtype, device)
        taken.append(buf)
        return buf

    monkeypatch.setattr(staging, "host_buffer", spy)
    rng = np.random.default_rng(7)
    for shape in [(75, 2253), (1, 1), (2, 75, 513)]:
        w, h, k = (x.numpy() for x in _planes(rng, shape, "cpu"))
        for kw, n_planes in (({}, 2), (dict(kinds=k, kind_tables=U50_TABLES), 3)):
            want = population_costs(w, h, backend="torch", device="cpu", **kw)
            taken.clear()
            got = population_costs(w, h, backend="cuda", device="cuda", **kw)
            assert np.array_equal(got, want) and got.shape == shape[:-1]
            assert len(taken) == 1 and taken[0].is_pinned()
            rows = int(np.prod(shape[:-1]))
            assert taken[0].numel() == n_planes * rows * shape[-1]


@pytest.mark.gpu
def test_sa_ops_stage_through_pinned_buffers_on_card(monkeypatch):
    """An SA ops call on the card takes exactly one host buffer, pinned,
    holding every plane (one host->device copy); the deltas come back equal
    to the host backend's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import staging
    from repro_torch.kernels.binpack_sa_step import sa_step_deltas

    taken = []
    inner = staging.host_buffer

    def spy(shape, dtype, device):
        buf = inner(shape, dtype, device)
        taken.append(buf)
        return buf

    monkeypatch.setattr(staging, "host_buffer", spy)
    rng = np.random.default_rng(4)
    for shape in [(64, 4), (1, 4), (4, 64, 4)]:
        old = [x.numpy() for x in _planes(rng, shape, "cpu")]
        new = [x.numpy() for x in _planes(rng, shape, "cpu")]
        for kw, n_planes in (({}, 4), (dict(old_k=old[2], new_k=new[2],
                                            kind_tables=U50_TABLES), 6)):
            taken.clear()
            got = sa_step_deltas(old[0], old[1], new[0], new[1], backend="cuda",
                                 device="cuda", **kw)
            want = sa_step_deltas(old[0], old[1], new[0], new[1], backend="python", **kw)
            assert np.array_equal(got, want) and got.shape == shape[:-1]
            assert len(taken) == 1 and taken[0].is_pinned()
            rows = int(np.prod(shape[:-1]))
            assert taken[0].numel() == n_planes * rows * shape[-1]


@pytest.mark.gpu
def test_load_from_threads_into_empty_build_dir(tmp_path, monkeypatch):
    """Several host threads loading every kernel library at once into an
    empty build directory: each source is built once, nothing is left
    half-written, and the loaded kernels launch and agree with the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from repro_torch.kernels import build as build_mod

    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build_mod, "_LIBS", {})
    n_threads = 6
    got = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def ask(i):
        barrier.wait()
        got[i] = {name: build_mod.load(name) for name in build_mod.SOURCES}

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for name in build_mod.SOURCES:
        assert len({id(g[name]) for g in got}) == 1
    built = sorted(p.name for p in (tmp_path / "kernels").iterdir())
    assert built == sorted(build_mod.library_path(n).name for n in build_mod.SOURCES)
    w, h, k = _planes(np.random.default_rng(5), (3, 40), torch.device("cuda"))
    assert torch.equal(binpack_fitness_cuda(w, h, BRAM18_MODES),
                       binpack_fitness_ref(w, h, BRAM18_MODES).sum(1))


@pytest.mark.gpu
def test_portfolio_step_matches_plain_and_separate_kernels_on_card():
    """K5 built and launched once per case: both halves equal the plain
    version and a K1/K2 launch plus a K3/K4 launch on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cases = [(150, 2253, 8, 4), (1, 1, 1, 1), (0, 7, 300, 6), (7, 300, 0, 4),
             (513, 129, 1000, 2)]
    kernels.reset_launch_counts()
    for rows, nb, c, t in cases:
        w, h, k = _planes(rng, (rows, nb), dev)
        old = _planes(rng, (c, t), dev)
        new = _planes(rng, (c, t), dev)
        step = (old[0], old[1], new[0], new[1])
        got = portfolio_step_cuda(w, h, *step, BRAM18_MODES)
        assert all(map(torch.equal, got, portfolio_step_ref(w, h, *step, BRAM18_MODES)))
        assert torch.equal(got[0], binpack_fitness_cuda(w, h, BRAM18_MODES))
        assert torch.equal(got[1], sa_step_deltas_cuda(*step, BRAM18_MODES))
        step = (old[0], old[1], old[2], new[0], new[1], new[2])
        got = portfolio_step_kinds_cuda(w, h, k, *step, U50_TABLES)
        assert all(map(torch.equal, got,
                       portfolio_step_kinds_ref(w, h, k, *step, U50_TABLES)))
        assert torch.equal(got[0], binpack_fitness_kinds_cuda(w, h, k, U50_TABLES))
        assert torch.equal(got[1], sa_step_deltas_kinds_cuda(*step, U50_TABLES))
    counts = kernels.launch_counts()
    assert counts["portfolio_step_cuda"] == counts["portfolio_step_kinds_cuda"] == len(cases)


def _full_tables(rng):
    """4 kinds of 8 modes, the most the kernels' tables hold."""
    return tuple((int(rng.integers(1, 32)),
                  tuple((int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
                        for _ in range(8))) for _ in range(4))


K5_EDGES = [
    ((3, 4097), (8, 4)),       # a row past one 4096-slot pass
    ((1, 8193), (40, 33)),     # two passes; T > 16: the lane loop runs
    ((2, 300), (5, 20)),
    ((0, 2253), (8, 4)),       # no population rows
    ((150, 2253), (0, 4)),     # no chains
    ((0, 1), (0, 1)),          # neither: no launch
    ((4, 300), (128, 4)),      # one block of chain rows, full
    ((4, 300), (129, 4)),      # and one past it
    ((1, 64), (1025, 0)),      # T = 0: one lane a row, 1024 rows a block
]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", K5_EDGES, ids=str)
def test_portfolio_step_at_grid_edges_on_card(shapes):
    """K5 at the edges of its grid, on 4 kinds of 8 modes (kinds one past
    the table cost 0), exactly equal to the plain version and to a K1/K2
    plus a K3/K4 launch; one launch per call with work, none without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    (rows, nb), (c, t) = shapes
    rng = np.random.default_rng(rows * 7 + nb + c * 3 + t)
    kt = _full_tables(rng)
    modes = kt[0][1]
    w, h, _ = _planes(rng, (rows, nb), dev)
    k = torch.from_numpy(rng.integers(0, 5, (rows, nb)).astype(np.int32)).to(dev)
    old = _planes(rng, (c, t), dev)
    new = _planes(rng, (c, t), dev)
    ok, nk = (torch.from_numpy(rng.integers(0, 5, (c, t)).astype(np.int32)).to(dev)
              for _ in range(2))
    step = (old[0], old[1], new[0], new[1])
    kernels.reset_launch_counts()
    got = portfolio_step_cuda(w, h, *step, modes)
    assert all(map(torch.equal, got, portfolio_step_ref(w, h, *step, modes)))
    assert torch.equal(got[0], binpack_fitness_cuda(w, h, modes))
    assert torch.equal(got[1], sa_step_deltas_cuda(*step, modes))
    step = (old[0], old[1], ok, new[0], new[1], nk)
    got = portfolio_step_kinds_cuda(w, h, k, *step, kt)
    assert all(map(torch.equal, got, portfolio_step_kinds_ref(w, h, k, *step, kt)))
    assert torch.equal(got[0], binpack_fitness_kinds_cuda(w, h, k, kt))
    assert torch.equal(got[1], sa_step_deltas_kinds_cuda(*step, kt))
    counts = kernels.launch_counts()
    want = int(rows + c > 0)
    assert counts["portfolio_step_cuda"] == counts["portfolio_step_kinds_cuda"] == want


@pytest.mark.gpu
def test_portfolio_step_past_2_32_on_card():
    """K5 with w * h around and past 2^32 on both halves (slot_units' 64-bit
    path), on BRAM18 and the U50 tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(32)
    planes = []
    for shape in [(3, 5000), (16, 6), (16, 6)]:
        w = rng.integers(2**15, 2**20, shape).astype(np.int32)
        w[rng.random(shape) < 0.2] = 0
        h = np.where(w > 0, rng.integers(2**15, 2**20, shape), 0).astype(np.int32)
        planes.append([torch.from_numpy(x).to(dev)
                       for x in (w, h, rng.integers(0, 2, shape).astype(np.int32))])
    (w, h, k), old, new = planes
    assert bool(((w.long() * h.long()) >= 2**32).any())
    step = (old[0], old[1], new[0], new[1])
    got = portfolio_step_cuda(w, h, *step, BRAM18_MODES)
    assert all(map(torch.equal, got, portfolio_step_ref(w, h, *step, BRAM18_MODES)))
    step = (old[0], old[1], old[2], new[0], new[1], new[2])
    got = portfolio_step_kinds_cuda(w, h, k, *step, U50_TABLES)
    assert all(map(torch.equal, got, portfolio_step_kinds_ref(w, h, k, *step, U50_TABLES)))


@pytest.mark.gpu
def test_portfolio_ops_stage_through_one_pinned_buffer_on_card(monkeypatch):
    """A fused ops call on the card takes exactly one host buffer, pinned,
    holding both halves' planes (one host->device copy), and gives the host
    backend's totals and deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import staging
    from repro_torch.kernels.binpack_portfolio_step import portfolio_step

    taken = []
    inner = staging.host_buffer

    def spy(shape, dtype, device):
        buf = inner(shape, dtype, device)
        taken.append(buf)
        return buf

    monkeypatch.setattr(staging, "host_buffer", spy)
    rng = np.random.default_rng(8)
    for pop_shape, (c, t) in [((2, 75, 2253), (8, 4)), ((1, 1, 1), (1, 1)),
                              ((1, 3, 5000), (40, 17))]:
        W, H, K = (x.numpy() for x in _planes(rng, pop_shape, "cpu"))
        old = [x.numpy() for x in _planes(rng, (c, t), "cpu")]
        new = [x.numpy() for x in _planes(rng, (c, t), "cpu")]
        geo = (W, H, old[0], old[1], new[0], new[1])
        for kw, n_planes in (({}, 2 + 4),
                             (dict(kinds=K, old_k=old[2], new_k=new[2],
                                   kind_tables=U50_TABLES), 3 + 6)):
            taken.clear()
            got = portfolio_step(*geo, backend="cuda", device="cuda", **kw)
            assert len(taken) == 1 and taken[0].is_pinned()
            want = portfolio_step(*geo, backend="python", **kw)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            rows = int(np.prod(pop_shape[:-1]))
            n_pop = 3 if kw else 2
            assert tuple(taken[0].shape) == (
                n_pop * rows * pop_shape[-1] + (n_planes - n_pop) * c * t,)


@pytest.mark.gpu
def test_fused_portfolio_on_card_matches_host_backend():
    """A fused portfolio on the card launches K5 and gives the host
    backend's result bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.core as c

    prob = c.get_problem("CNV-W1A1", device="U50")
    kw = dict(seed=0, n_islands=4, sa_chains=4, migration_every=32,
              max_generations=6, max_iterations=200, max_seconds=1e9, patience=10**9)
    kernels.reset_launch_counts()
    a = c.pack(prob, "portfolio", backend="cuda", **kw)
    assert a.params["fused"] and kernels.launch_counts()["portfolio_step_kinds_cuda"] > 0
    b = c.pack(prob, "portfolio", backend="python", **kw)
    assert a.cost == b.cost and a.iterations == b.iterations
    assert a.solution.state_dict() == b.solution.state_dict()
    assert [x for _, x in a.trace] == [x for _, x in b.trace]


def _gather_within_rounding(got, want, bank, x, seg):
    """|got - want| <= 2 * C * 2**-23 * sum_c |bank * x[seg]| + 1e-6 per row
    (float32 rounding of C products and sums, in any order)."""
    n = x.shape[0]
    s = seg.long()
    valid = (s >= 0) & (s < n)
    mag = (bank.double().abs() * x.double().abs()[s.clamp(0, n - 1)]).sum(1)
    tol = 2 * bank.shape[1] * 2.0**-23 * torch.where(valid, mag, 0) + 1e-6
    return bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.gpu
def test_packed_gather_matches_plain_version_on_card():
    """K6 launched once per case: the reference test's 20 shapes, the
    largest hymba-1.5b bank's shape, the reference benchmark's and
    out-of-range segment ids (exactly 0, as the Pallas kernel gives)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = []
    for seed in range(20):
        rng = np.random.default_rng(seed)
        r, c, n = 8 * int(rng.integers(1, 7)), 128 * int(rng.integers(1, 5)), int(rng.integers(1, 7))
        cases.append((rng.normal(size=(r, c)), rng.normal(size=(n, c)), rng.integers(0, n, r)))
    rng = np.random.default_rng(20)
    for r, c, n in [(3200, 384, 2), (2048, 1024, 4)]:
        cases.append((rng.normal(size=(r, c)), rng.normal(size=(n, c)), rng.integers(0, n, r)))
    cases.append((rng.normal(size=(8, 128)), rng.normal(size=(3, 128)),
                  np.array([3, -1, 5, 0, 1, 2, -7, 2**31 - 1])))
    kernels.reset_launch_counts()
    for bank, x, seg in cases:
        bank, x = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (bank, x))
        seg = torch.from_numpy(seg.astype(np.int32)).to(dev)
        got = packed_gather_cuda(bank, x, seg)
        want = packed_gather_ref(bank, x, seg)
        assert _gather_within_rounding(got, want, bank, x, seg)
        out = (seg < 0) | (seg >= x.shape[0])
        assert bool((got[out] == 0).all())
    assert kernels.launch_counts()["packed_gather_cuda"] == len(cases)


@pytest.mark.gpu
def test_memory_planner_on_card_matches_host_backend():
    """plan_packing on card tensors through the fitness kernel equals the
    host backend's plan; the store unpacks bit for bit and K6 reads every
    bank once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.memory import PackedParameterStore, plan_packing

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"embed": torch.randn(64, 256, generator=g, device=dev),
            "layers": {"w": torch.randn(6, 24, 40, generator=g, device=dev),
                       "b": torch.randn(6, 40, generator=g, device=dev),
                       "s": torch.randn(6, 3, 200, generator=g, device=dev)}}
    kw = dict(split_stacked=True, max_seconds=600)
    kernels.reset_launch_counts()
    plans = plan_packing(tree, backend="cuda", **kw)
    assert kernels.launch_counts()["binpack_fitness_cuda"] > 0
    host = plan_packing(tree, backend="python", **kw)
    assert [[(e.path, e.row_offset) for e in b] for b in plans[4].banks] == \
        [[(e.path, e.row_offset) for e in b] for b in host[4].banks]
    assert plans[4].packer_result.cost == host[4].packer_result.cost
    store = PackedParameterStore(tree, plans)
    assert all(b.is_cuda for b in store.banks.values())
    rebuilt = store.unpack()
    assert torch.equal(rebuilt["embed"], tree["embed"])
    assert all(torch.equal(rebuilt["layers"][k], tree["layers"][k]) for k in tree["layers"])
    kernels.reset_launch_counts()
    for (itemsize, bi), bank in store.banks.items():
        entries = plans[itemsize].banks[bi]
        seg = torch.zeros(bank.shape[0], dtype=torch.int32, device=dev)
        for i, e in enumerate(entries):
            seg[e.row_offset:e.row_offset + e.rows] = i
        x = torch.randn(len(entries), bank.shape[1], generator=g, device=dev)
        y = bank_matvec(bank, x, seg)
        assert _gather_within_rounding(y, packed_gather_ref(bank, x, seg), bank, x, seg)
    assert kernels.launch_counts()["packed_gather_cuda"] == len(store.banks)


def _sweep_record(sw):
    return [(r.cost, r.solution.state_dict(), r.iterations, [c for _, c in r.trace])
            for r in sw.results]


@pytest.mark.gpu
def test_dse_sweep_on_card_matches_host_backend():
    """`pack_sweep` on the card: the SA fleet over a BRAM18 and a U50 group
    launches K3 and K4, the GA lockstep lane K1 and K2, and every candidate
    equals the host backend's; a cached re-sweep launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.core as c

    probs = [c.get_problem(n, device=d) for n in ("CNV-W1A1", "CNV-W2A2")
             for d in (None, "U50")]
    cases = (
        ("sa-s", dict(n_chains=4, max_iterations=200),
         ("sa_step_deltas_cuda", "sa_step_deltas_kinds_cuda")),
        ("ga-nfd", dict(n_pop=12, max_generations=6),
         ("binpack_fitness_cuda", "binpack_fitness_kinds_cuda")),
    )
    for alg, kw, need in cases:
        kw = dict(kw, seeds=[0, 1, 2, 3], max_seconds=1e9, patience=10**9)
        cache: dict = {}
        kernels.reset_launch_counts()
        a = c.pack_sweep(probs, alg, backend="cuda", cache=cache, **kw)
        counts = kernels.launch_counts()
        assert a.n_groups == 2 and all(counts[n] > 0 for n in need), counts
        kernels.reset_launch_counts()
        b = c.pack_sweep(probs, alg, backend="python", **kw)
        assert not any(kernels.launch_counts().values())
        assert _sweep_record(a) == _sweep_record(b)
        again = c.pack_sweep(probs, alg, backend="cuda", cache=cache, **kw)
        assert again.n_solved == 0 and not any(kernels.launch_counts().values())


@pytest.mark.gpu
def test_dse_sweep_on_card_resumes_after_a_crash(tmp_path):
    """A `cuda` SA sweep killed after its second snapshot resumes on the
    card to the uninterrupted run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch.core as c

    class Crash(BaseException):
        pass

    def crash_after_2(step):
        if step >= 2:
            raise Crash

    probs = [c.get_problem("CNV-W1A1", device="U50"), c.get_problem("CNV-W2A2", device="U50")]
    kw = dict(seeds=[4, 5], n_chains=4, max_iterations=300, max_seconds=1e9,
              patience=10**9, backend="cuda", checkpoint_every=100)
    want = _sweep_record(c.pack_sweep(probs, "sa-s", **kw))
    with pytest.raises(Crash):
        c.pack_sweep(probs, "sa-s", checkpoint_dir=tmp_path, on_checkpoint=crash_after_2,
                     **kw)
    got = c.pack_sweep(probs, "sa-s", checkpoint_dir=tmp_path, resume=True, **kw)
    assert _sweep_record(got) == want


@pytest.mark.gpu
def test_packing_service_on_card_matches_host_backend(tmp_path):
    """A `PackingService` on the card (``backend="cuda"``) answers a mixed,
    heterogeneous set of micro-batched requests equal to a ``python``
    backend service, launching K3 and K4 and nothing else; a restart over
    its store answers every request with no solve and no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import asyncio

    import repro_torch.core as c
    from repro_torch.serve import PackingService, result_signature

    probs = [c.get_problem(n, device=d) for n in ("CNV-W1A1", "CNV-W2A2")
             for d in (None, "U50")]
    reqs = [(p, s) for p in probs for s in (0, 1)] * 2
    kw = dict(n_chains=4, max_iterations=200, max_seconds=1e9, patience=10**9,
              max_batch=4, max_wait_ms=20.0, device="cuda")

    def run(backend, **extra):
        async def go():
            async with PackingService("sa-s", backend=backend, **kw, **extra) as svc:
                out = await asyncio.gather(*(svc.pack(p, seed=s) for p, s in reqs))
                return [result_signature(r) for r in out], svc.stats()

        kernels.reset_launch_counts()
        out, stats = asyncio.run(go())
        return out, stats, kernels.launch_counts()

    got, stats, counts = run("cuda", store_dir=tmp_path)
    need = ("sa_step_deltas_cuda", "sa_step_deltas_kinds_cuda")
    assert all(counts[n] > 0 for n in need), counts
    assert not any(v for n, v in counts.items() if n not in need), counts
    assert stats["solved"] == len(reqs) // 2 and stats["batches"] < len(reqs) // 2
    want, _, host_counts = run("python")
    assert not any(host_counts.values())
    assert got == want
    warm, stats, counts = run("cuda", store_dir=tmp_path)
    assert warm == got and stats["solved"] == 0 and not any(counts.values())
    assert stats["cache_hits_store"] == len(reqs) // 2
