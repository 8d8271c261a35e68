"""Sharded fleets in the port (`n_shards`, `mesh`) on the CPU, held to the
reference's UNSHARDED results: the counterpart of every test in
``tests/test_sharded.py``, plus the merged snapshot layout against the
reference's, snapshots crossing shard counts and packages in both
directions, and the per-shard device pins.

Two mechanisms, both pure execution-shape knobs:

* ``mesh=`` — each batched kernel call is row-split over the devices of a
  `repro_torch.launch.SweepMesh` (zero-padded to a multiple of the mesh
  size, one call per device, the padding sliced off).  The reference's mesh
  tests need several jax devices and skip with fewer; the port's run here
  on ``SweepMesh([cpu] * k)``, k logical shards of the host.
* ``n_shards=`` — `pack_sweep` / `pack_portfolio` split each batched group
  into contiguous sub-fleets advanced concurrently on threads (with a mesh,
  pinned round-robin to its devices).

Every result must equal ``repro.core.pack_sweep`` / ``pack_portfolio``
run unsharded on the host: cost, packing, iterations, the trace's cost
sequence (portfolio: barriers and migrations).  Budgets are iteration
counts, never wall clock.
"""
import functools
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from faultinject import SimulatedCrash, crash_at
from repro.core.dse import shard_chunks as ref_shard_chunks
from repro_torch.core import dse as port_dse
from repro_torch.core.dse import shard_chunks
from repro_torch.kernels.probshard import mesh_size, pad_rows
from repro_torch.launch import SweepMesh, make_sweep_mesh

CPU = torch.device("cpu")
U50_TABLES = ((1, ((1, 16384), (2, 8192), (4, 4096), (9, 2048), (18, 1024),
                   (36, 512))),
              (16, ((72, 4096),)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(k: int) -> SweepMesh:
    return SweepMesh([CPU] * k)


def _problem(pkg, seed: int, hetero: bool = False):
    """`tests/test_sharded.py`'s generated problem, built in either package."""
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
    return pkg.PackingProblem(bufs, max_items=4, name=f"sh{seed}", ocm=ocm)


def _probs(pkg, seeds, hetero=False):
    return [_problem(pkg, s, hetero) for s in seeds]


def _record(sw) -> list[tuple]:
    """A sweep's (or `solve_batch`'s list of) results, nothing wall-clock."""
    return [
        (r.cost, r.solution.state_dict(), r.iterations, [cc for _, cc in r.trace])
        for r in getattr(sw, "results", sw)
    ]


def _pf_record(res) -> tuple:
    return (res.cost, res.solution.state_dict(), res.iterations,
            res.params["barriers"], res.params["migrations"])


_KW = dict(max_seconds=1e9, patience=10**9)
_SA = dict(_KW, max_iterations=400, n_chains=4)
_GA = dict(_KW, max_generations=8, n_pop=10)
_PF = dict(_KW, max_iterations=384, max_generations=6, n_pop=10, sa_chains=4)


@functools.lru_cache(maxsize=None)
def _ref_sweep(seeds, alg, seed, hetero=False, **kw):
    """The reference's unsharded sweep on its host lane (``python``: every
    reference backend gives the same integers)."""
    base = dict(_SA if alg == "sa-s" else _GA, **kw)
    return _record(ref.pack_sweep(_probs(ref, seeds, hetero), alg, seed=seed,
                                  backend="python", **base))


@functools.lru_cache(maxsize=None)
def _ref_portfolio(seed_p, seed, n_islands, algorithms, **kw):
    return _pf_record(ref.pack_portfolio(
        _problem(ref, seed_p), n_islands=n_islands, algorithms=algorithms, seed=seed,
        backend="python", **dict(_PF, **kw)))


def _port_sweep(seeds, alg, seed, hetero=False, backend="python", **kw):
    base = dict(_SA if alg == "sa-s" else _GA)
    base.update(kw)
    return port.pack_sweep(_probs(port, seeds, hetero), alg, seed=seed,
                           backend=backend, device="cpu", **base)


# ------------------------------------------------------------- shard chunking
def test_shard_chunks_contiguous_and_balanced():
    assert shard_chunks(7, 3) == [[0, 1, 2], [3, 4], [5, 6]]
    assert shard_chunks(4, 8) == [[0], [1], [2], [3]]  # capped at n
    assert shard_chunks(5, 1) == [[0, 1, 2, 3, 4]]
    for n, k in ((13, 4), (8, 8), (9, 2), (1, 3), (50, 4)):
        chunks = shard_chunks(n, k)
        assert chunks == ref_shard_chunks(n, k)
        assert [j for ch in chunks for j in ch] == list(range(n))
        sizes = [len(ch) for ch in chunks]
        assert max(sizes) - min(sizes) <= 1


def test_make_sweep_mesh_validation():
    with pytest.raises(ValueError):
        make_sweep_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        make_sweep_mesh(0)
    with pytest.raises(RuntimeError, match=r"SweepMesh\(\[dev\] \* 2\)"):
        make_sweep_mesh(2, device="cpu")  # one distinct CPU device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="SweepMesh"):
            make_sweep_mesh(1)
        with pytest.raises(RuntimeError, match="SweepMesh"):
            make_sweep_mesh()
    mesh = make_sweep_mesh(1, device="cpu")
    assert mesh.axis_names == ("prob",) and mesh.shape == {"prob": 1}
    assert mesh.devices == (CPU,) and mesh_size(mesh) == 1
    rep = _mesh(3)
    assert rep.shape["prob"] == 3 and rep.devices == (CPU,) * 3
    with pytest.raises(ValueError, match=r"1-D \('prob',\) sweep mesh"):
        mesh_size(object())
    with pytest.raises(ValueError):
        SweepMesh([])
    with pytest.raises(ValueError, match="one type"):
        SweepMesh([CPU, torch.device("cuda", 0)])
    # a CPU mesh for a cuda run raises before any work, on any host: the
    # port never moves work to a device the caller did not name
    prob = _problem(port, 1)
    with pytest.raises(ValueError, match="device type"):
        port.pack_sweep([prob], "sa-s", mesh=_mesh(2), device="cuda", **_SA)
    with pytest.raises(ValueError, match="device type"):
        port.pack_portfolio(prob, mesh=_mesh(2), **_PF)  # device=None is cuda
    from repro_torch.kernels.binpack_sa_step.ops import sa_step_deltas

    z = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="device type"):
        sa_step_deltas(z, z, z, z, backend="torch", device="cuda", mesh=_mesh(2))


# ------------------------------------------------------- kernel mesh parity
def _geometry(rng, shape, hetero):
    w = rng.integers(0, 40, size=shape).astype(np.int32)
    w[rng.random(shape) < 0.2] = 0
    h = np.where(w > 0, rng.integers(1, 9000, size=shape), 0).astype(np.int32)
    k = rng.integers(0, 2, size=shape).astype(np.int32) if hetero else None
    return w, h, k


_MESH_ROWS = sorted({(k, n) for k in (2, 3) for n in (1, k - 1, k + 1, 7)})


@pytest.mark.parametrize("hetero", [False, True], ids=["bram18", "kinds"])
@pytest.mark.parametrize("k,rows", _MESH_ROWS)
def test_kernel_mesh_parity(k, rows, hetero):
    """K1 / K2 (`population_costs`) and K3 / K4 (`sa_step_deltas`) row-split
    over a k-shard mesh equal the reference's unsharded ops, at row counts
    that leave the last block ragged (so the padding runs), 2-D and with a
    leading problem axis."""
    from repro.kernels.binpack_fitness.ops import population_costs as ref_pop
    from repro.kernels.binpack_sa_step.ops import sa_step_deltas as ref_sa
    from repro_torch.kernels.binpack_fitness.ops import population_costs
    from repro_torch.kernels.binpack_sa_step.ops import sa_step_deltas

    rng = np.random.default_rng(100 * k + rows + 7 * hetero)
    mesh = _mesh(k)
    W, H, K = _geometry(rng, (rows, 6), hetero)
    kin = dict(kinds=K, kind_tables=U50_TABLES) if hetero else {}
    want = np.asarray(ref_pop(W, H, backend="ref", **kin))
    W3, H3, K3 = _geometry(rng, (rows, 3, 5), hetero)
    kin3 = dict(kinds=K3, kind_tables=U50_TABLES) if hetero else {}
    want3 = np.asarray(ref_pop(W3, H3, backend="ref", **kin3))
    old, new = _geometry(rng, (rows, 4), hetero), _geometry(rng, (rows, 4), hetero)
    skin = dict(old_k=old[2], new_k=new[2], kind_tables=U50_TABLES) if hetero else {}
    want_d = ref_sa(old[0], old[1], new[0], new[1], backend="python", **skin)
    for backend in ("torch", "cuda"):
        got = population_costs(W, H, backend=backend, device="cpu", mesh=mesh, **kin)
        np.testing.assert_array_equal(got, want)
        got3 = population_costs(W3, H3, backend=backend, device="cpu", mesh=mesh, **kin3)
        assert got3.shape == (rows, 3)
        np.testing.assert_array_equal(got3, want3)
        d = sa_step_deltas(old[0], old[1], new[0], new[1], backend=backend,
                           device="cpu", mesh=mesh, **skin)
        np.testing.assert_array_equal(d, want_d)
    # python ignores the mesh
    d = sa_step_deltas(old[0], old[1], new[0], new[1], backend="python", mesh=mesh,
                       **skin)
    np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("hetero", [False, True], ids=["k5a", "k5b"])
@pytest.mark.parametrize("k,rows", _MESH_ROWS)
def test_portfolio_step_kernel_mesh_parity(k, rows, hetero):
    """K5a / K5b (`portfolio_step`) on a k-shard mesh: the population half
    and the step half pad independently, each device gets one fused call on
    its block of both, and both results equal the reference's unsharded
    fused step."""
    from repro.kernels.binpack_portfolio_step.ops import portfolio_step as ref_step
    from repro_torch.kernels.binpack_portfolio_step.ops import portfolio_step

    rng = np.random.default_rng(1000 * k + rows + 7 * hetero)
    mesh = _mesh(k)
    W, H, K = _geometry(rng, (rows, 4, 5), hetero)
    old, new = _geometry(rng, (rows + 1, 2), hetero), _geometry(rng, (rows + 1, 2), hetero)
    kin = (dict(kinds=K, old_k=old[2], new_k=new[2], kind_tables=U50_TABLES)
           if hetero else {})
    t0, d0 = ref_step(W, H, old[0], old[1], new[0], new[1], backend="python", **kin)
    for backend in ("torch", "cuda"):
        t1, d1 = portfolio_step(W, H, old[0], old[1], new[0], new[1], backend=backend,
                                device="cpu", mesh=mesh, **kin)
        assert t1.shape == (rows, 4) and t1.dtype == np.float64
        np.testing.assert_array_equal(t1, t0)
        np.testing.assert_array_equal(d1, d0)


def test_pad_rows_pads_with_zero_rows():
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    (p, none), n = pad_rows([a, None], 2)
    assert n == 3 and none is None and p.shape == (4, 2) and not p[3].any()
    (same,), n = pad_rows([a], 3)
    assert same is a and n == 3
    with pytest.raises(ValueError, match="row count"):
        pad_rows([a, a[:2]], 2)


# --------------------------------------------------- sweep n_shards parity
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sweep_sa_n_shards_bit_identical(n_shards):
    seeds = (11, 12, 13, 14, 15)
    shrd = _port_sweep(seeds, "sa-s", 3, n_shards=n_shards)
    assert _record(shrd) == _ref_sweep(seeds, "sa-s", 3)
    assert shrd.params["n_shards"] == n_shards


def test_sweep_sa_n_shards_hetero_bit_identical():
    seeds = (21, 22, 23)
    shrd = _port_sweep(seeds, "sa-s", 1, hetero=True, n_shards=3, backend="cuda")
    assert _record(shrd) == _ref_sweep(seeds, "sa-s", 1, hetero=True)


def test_sweep_ga_n_shards_bit_identical():
    seeds = (31, 32, 33, 34)
    shrd = _port_sweep(seeds, "ga-nfd", 2, n_shards=3, backend="torch")
    assert _record(shrd) == _ref_sweep(seeds, "ga-nfd", 2)


def test_sweep_n_shards_validation():
    for fn in (port.pack_sweep, port.solve_batch):
        with pytest.raises(ValueError, match="n_shards"):
            fn([_problem(port, 1)], "sa-s", n_shards=0, device="cpu", **_SA)


# ------------------------------------------------------- sweep mesh parity
def test_sweep_sa_mesh_bit_identical():
    seeds = (41, 42, 43)
    kw = dict(max_iterations=100, n_chains=3)
    want = _ref_sweep(seeds, "sa-s", 5, **kw)
    for backend in ("torch", "cuda"):
        assert _record(_port_sweep(seeds, "sa-s", 5, backend=backend, mesh=_mesh(2),
                                   **kw)) == want
    # mesh + n_shards > 1: sub-fleets pinned round-robin to the devices
    assert _record(_port_sweep(seeds, "sa-s", 5, mesh=_mesh(2), n_shards=2,
                               backend="torch", **kw)) == want
    batch = port.solve_batch(_probs(port, seeds), "sa-s", seed=5, backend="torch",
                             device="cpu", mesh=_mesh(3), n_shards=2, **_KW, **kw)
    assert _record(batch) == want


def test_sweep_ga_mesh_bit_identical():
    seeds = (51, 52, 53)
    want = _ref_sweep(seeds, "ga-nfd", 4, max_generations=6)
    shrd = _port_sweep(seeds, "ga-nfd", 4, mesh=_mesh(2), max_generations=6,
                       backend="torch")
    assert _record(shrd) == want
    het = (54, 55, 56)
    assert _record(_port_sweep(het, "ga-nfd", 4, hetero=True, backend="cuda",
                               mesh=_mesh(3), n_shards=2, max_generations=6)) == \
        _ref_sweep(het, "ga-nfd", 4, hetero=True, max_generations=6)


# --------------------------------------------------------- portfolio parity
@pytest.mark.parametrize("n_shards", [2, 5])
def test_portfolio_n_shards_bit_identical(n_shards):
    prob = _problem(port, 61)
    shrd = port.pack_portfolio(prob, n_islands=5, algorithms=("sa-s",), seed=3,
                               n_shards=n_shards, backend="python", device="cpu", **_PF)
    assert _pf_record(shrd) == _ref_portfolio(61, 3, 5, ("sa-s",))
    assert shrd.params["n_shards"] == n_shards


def test_portfolio_mixed_lineup_n_shards_bit_identical():
    # ga-nfd + sa-s + sa-nfd + ga-nfd
    shrd = port.pack_portfolio(_problem(port, 62), n_islands=4, seed=0, n_shards=2,
                               backend="torch", device="cpu", **_PF)
    assert _pf_record(shrd) == _ref_portfolio(62, 0, 4, ("ga-nfd", "sa-s", "sa-nfd"))


def test_portfolio_mesh_bit_identical_and_fuse_needs_one_shard():
    prob = _problem(port, 63)
    kw = dict(_KW, max_iterations=128, max_generations=5, n_pop=10, sa_chains=4,
              n_islands=4, algorithms=("sa-s", "ga-nfd"), seed=3, device="cpu")
    want = _pf_record(ref.pack_portfolio(_problem(ref, 63), backend="python",
                                         **{k: v for k, v in kw.items() if k != "device"}))
    base = port.pack_portfolio(prob, backend="torch", **kw)
    shrd = port.pack_portfolio(prob, backend="torch", mesh=_mesh(2), **kw)
    assert _pf_record(base) == _pf_record(shrd) == want
    # one fleet shard keeps fused dispatch on (one K5 call per mesh device);
    # splitting the fleet turns it off while staying bit-identical
    assert shrd.params["fused"] is True and base.params["fused"] is True
    split = port.pack_portfolio(prob, backend="cuda", mesh=_mesh(2), n_shards=2, **kw)
    assert _pf_record(split) == want
    assert split.params["fused"] is False


# ---------------------------------------- resume across shard counts
@pytest.mark.parametrize("save_shards,resume_shards", [(4, 1), (1, 4), (3, 2)])
def test_sweep_resume_across_shard_counts(tmp_path, save_shards, resume_shards):
    seeds = (71, 72, 73, 74, 75)
    want = _ref_sweep(seeds, "sa-s", 3, max_iterations=600)
    kw = dict(max_iterations=600, checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=128)
    with pytest.raises(SimulatedCrash):
        _port_sweep(seeds, "sa-s", 3, n_shards=save_shards, on_checkpoint=crash_at(2),
                    **kw)
    out = _port_sweep(seeds, "sa-s", 3, n_shards=resume_shards, resume=True, **kw)
    assert _record(out) == want


@pytest.mark.parametrize("save_shards,resume_shards", [(4, 1), (1, 4)])
def test_portfolio_resume_across_shard_counts(tmp_path, save_shards, resume_shards):
    prob = _problem(port, 81)
    kw = dict(_PF, max_iterations=512, n_islands=5, algorithms=("sa-s",), seed=3,
              backend="python", device="cpu", checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=2)
    with pytest.raises(SimulatedCrash):
        port.pack_portfolio(prob, n_shards=save_shards, on_checkpoint=crash_at(2), **kw)
    out = port.pack_portfolio(prob, n_shards=resume_shards, resume=True, **kw)
    assert _pf_record(out) == _ref_portfolio(81, 3, 5, ("sa-s",), max_iterations=512)


def _fleet_states(pkg, k):
    """A 3-problem SA fleet of either package split into ``k`` shards and
    run 64 iterations."""
    extra = dict(device="cpu") if pkg is port else {}
    packer = pkg.make_packer("sa-s", seed=0, max_seconds=1e9, patience=10**9,
                             max_iterations=64, n_chains=4, backend="python", **extra)
    packer._hetero = False
    probs = _probs(pkg, (91, 92, 93))
    rngs = [np.random.default_rng(s) for s in (1, 2, 3)]
    sts = [packer._block_start([probs[j] for j in c], [rngs[j] for j in c],
                               [[] for _ in c], "python")
           for c in shard_chunks(len(probs), k)]
    for st in sts:
        packer._block_run(st, 64)
    return sts


def test_sweep_sharded_checkpoint_matches_unsharded_layout(tmp_path):
    """The one-shard merge equals the unsharded encoding field for field
    (what keeps pre-sharding snapshots loadable)."""
    from repro_torch.core.resume import encode_block_state, merge_block_states

    (st,) = _fleet_states(port, 1)
    a0, e0 = encode_block_state(st)
    a1, e1 = merge_block_states([st])
    assert set(a0) == set(a1)
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k])
    assert {k: v for k, v in e0.items() if k not in ("rngs", "traces")} == \
           {k: v for k, v in e1.items() if k not in ("rngs", "traces")}
    assert e0["rngs"] == e1["rngs"] and e0["traces"] == e1["traces"]


# ------------------------------------------ the merged layout, both packages
@pytest.mark.parametrize("k", [1, 2, 3])
def test_merge_block_states_equals_reference(k):
    """The port's merged snapshot of a k-shard fleet equals the reference's,
    array for array, with the RNG states and the traces' cost sequences;
    slicing it back onto shards restores each shard's own state."""
    from repro.core.resume import merge_block_states as ref_merge
    from repro_torch.core.resume import merge_block_states, restore_block_shards

    a_ref, e_ref = ref_merge(_fleet_states(ref, k))
    sts = _fleet_states(port, k)
    a, e = merge_block_states(sts)
    assert set(a) == set(a_ref)
    for f in a:
        assert a[f].dtype == np.asarray(a_ref[f]).dtype, f
        np.testing.assert_array_equal(a[f], np.asarray(a_ref[f]))
    for f in ("it", "done", "frozen", "hetero", "n_rows", "rngs"):
        assert e[f] == e_ref[f], f
    assert [[c for _, c in t] for t in e["traces"]] == \
           [[c for _, c in t] for t in e_ref["traces"]]
    # restore onto another split of fresh shards, merge again: the same
    fresh = _fleet_states(port, 4 - k)
    restore_block_shards(fresh, a, e, patience=10**9)
    a2, e2 = merge_block_states(fresh)
    for f in a:
        np.testing.assert_array_equal(a2[f], a[f])
    assert e2["rngs"] == e["rngs"] and e2["it"] == e["it"]


# ------------------------------------- snapshots across packages and shards
_XSA = dict(_SA, backend="auto", max_iterations=500)


def _sweep_in(pkg, seeds, **kw):
    extra = dict(device="cpu") if pkg is port else {}
    return pkg.pack_sweep(_probs(pkg, seeds), "sa-s", seed=3, **_XSA, **extra, **kw)


@pytest.mark.parametrize("resume_shards", [1, 3])
def test_reference_sharded_sweep_snapshot_resumes_in_port(tmp_path, resume_shards):
    """A sweep cut by the reference at ``n_shards=4`` and killed after its
    second snapshot resumes in the port at 1 and 3 shards to the
    reference's uninterrupted result (``auto`` names the same task in both
    packages)."""
    seeds = (101, 102, 103, 104, 105)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=128)
    with pytest.raises(SimulatedCrash):
        _sweep_in(ref, seeds, n_shards=4, on_checkpoint=crash_at(2), **ck)
    got = _sweep_in(port, seeds, n_shards=resume_shards, resume=True, **ck)
    assert _record(got) == _ref_sweep(seeds, "sa-s", 3, max_iterations=500)


def test_port_sharded_sweep_snapshot_resumes_in_reference(tmp_path):
    seeds = (111, 112, 113, 114)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=128)
    with pytest.raises(SimulatedCrash):
        _sweep_in(port, seeds, n_shards=3, mesh=_mesh(2), on_checkpoint=crash_at(2),
                  **ck)
    got = _sweep_in(ref, seeds, n_shards=1, resume=True, **ck)
    assert _record(got) == _ref_sweep(seeds, "sa-s", 3, max_iterations=500)


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_sharded_portfolio_snapshot_crosses_packages(tmp_path, direction):
    """A 5-island SA-S portfolio killed at ``n_shards=4`` in one package
    resumes at ``n_shards=1`` in the other, equal to the reference's
    uninterrupted run."""
    writer, reader = (ref, port) if direction == "reference->port" else (port, ref)
    kw = dict(_PF, max_iterations=512, n_islands=5, algorithms=("sa-s",), seed=3,
              backend="auto", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)

    def run(pkg, **extra):
        dev = dict(device="cpu") if pkg is port else {}
        return pkg.pack_portfolio(_problem(pkg, 81), **kw, **dev, **extra)

    with pytest.raises(SimulatedCrash):
        run(writer, n_shards=4, on_checkpoint=crash_at(2))
    got = run(reader, n_shards=1, resume=True)
    assert _pf_record(got) == _ref_portfolio(81, 3, 5, ("sa-s",), max_iterations=512)


# ------------------------------------------------------- per-shard pinning
def test_shards_pin_to_mesh_devices_round_robin(monkeypatch):
    """With a mesh and ``n_shards > 1``, shard ``i``'s ops calls (SA fleet
    and GA sub-pack alike) go to ``devices[i % len]`` unsharded, from
    threads of their own, and never through a device written on the packer
    the threads share.  The two CPU devices carry indices 0 and 1, so the
    pins can be told apart.  A shortened switch interval and more shards
    than cores stress the shared packer; results stay the reference's."""
    from repro_torch.core.sa import SimulatedAnnealingPacker
    from repro_torch.kernels.binpack_fitness import ops as fops
    from repro_torch.kernels.binpack_sa_step import ops as sops

    devices = (torch.device("cpu", 0), torch.device("cpu", 1))
    mesh = SweepMesh(devices)
    local = threading.local()
    calls = []
    lock = threading.Lock()

    def tag_block(fn):
        def run(self, st, it_limit=None):
            local.shard = names.index(tuple(p.name for p in st.probs))
            try:
                return fn(self, st, it_limit)
            finally:
                local.shard = None
        return run

    def tag_drain(fn):
        def drain(pairs, gen_limit=None, mesh=None, device=None):
            local.shard = names.index(tuple(r.prob.name for _, r in pairs))
            try:
                return fn(pairs, gen_limit, mesh=mesh, device=device)
            finally:
                local.shard = None
        return drain

    def spy(fn):
        def call(*args, **kwargs):
            with lock:
                calls.append((getattr(local, "shard", None), kwargs.get("device"),
                              kwargs.get("mesh"), threading.get_ident()))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(SimulatedAnnealingPacker, "_block_run",
                        tag_block(SimulatedAnnealingPacker._block_run))
    monkeypatch.setattr(port_dse, "_lockstep_drain", tag_drain(port_dse._lockstep_drain))
    monkeypatch.setattr(sops, "sa_step_deltas", spy(sops.sa_step_deltas))
    monkeypatch.setattr(fops, "population_costs", spy(fops.population_costs))
    seeds = (121, 122, 123, 124, 125)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for alg, n_shards, kw in (("sa-s", 5, dict(max_iterations=60)),
                                  ("ga-nfd", 3, dict(max_generations=3))):
            names = [tuple(f"sh{seeds[j]}" for j in c)
                     for c in shard_chunks(len(seeds), n_shards)]
            calls.clear()
            got = _port_sweep(seeds, alg, 2, mesh=mesh, n_shards=n_shards,
                              backend="torch", **kw)
            assert _record(got) == _ref_sweep(seeds, alg, 2, **kw)
            mine = [c for c in calls if c[0] is not None]
            assert {c[0] for c in mine} == set(range(n_shards))
            for shard, device, m, _ in mine:
                assert m is None and device == devices[shard % 2], (shard, device)
            assert len({c[3] for c in mine}) > 1  # the shards ran on threads
    finally:
        sys.setswitchinterval(interval)
