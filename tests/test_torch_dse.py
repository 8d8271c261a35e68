"""`repro_torch.core.pack_sweep` / `solve_batch` on the CPU against
`repro.core.pack_sweep`, bit for bit: the counterpart of every test in
``tests/test_dse.py``.

Each case builds the same problems in both packages, runs the reference
through its host lane (``backend="python"``; the GA's lockstep lane
through ``"ref"``), and the port on ``device="cpu"`` through ``python``,
``torch`` (plain PyTorch versions) and ``cuda`` (the kernel wrappers,
which take the plain versions for CPU tensors).  All must agree on cost,
bins, kind lanes, iterations and the trace's cost sequence; wall times are
not compared.  Budgets are iteration counts, never wall clock.
"""
import functools

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.problem import (
    batch_group_key as ref_batch_group_key,
    decode_problem_batch as ref_decode,
    encode_problem_batch as ref_encode,
)
from repro_torch.core.problem import (
    batch_group_key,
    decode_problem_batch,
    encode_problem_batch,
)
from repro_torch.core.sa import SimulatedAnnealingPacker

PORT_BACKENDS = ("python", "torch", "cuda")
_SA_KW = dict(max_seconds=1e9, patience=10**9, max_iterations=250)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_problem(pkg, rng, hetero=False):
    """`tests/test_dse.py`'s generated problem, built in either package."""
    n = int(rng.integers(2, 40))
    bufs = [
        pkg.Buffer(
            width=int(rng.integers(1, 80)),
            depth=int(rng.integers(1, 40_000)),
            layer=int(rng.integers(0, 5)),
        )
        for _ in range(n)
    ]
    ocm = (
        pkg.OCMInventory(
            (pkg.BRAM18, pkg.URAM288),
            (int(rng.integers(-1, 200)), int(rng.integers(-1, 64))),
            name=f"dev{int(rng.integers(100))}",
        )
        if hetero
        else None
    )
    return pkg.PackingProblem(
        bufs, max_items=int(rng.integers(1, 6)), name=f"rp{n}", ocm=ocm,
    )


def _probs(pkg, spec):
    """Table-1 problems from ``((name, device, max_items), ...)``."""
    out = []
    for name, dev, cap in spec:
        kw = {} if cap is None else dict(max_items=cap)
        out.append(pkg.get_problem(name, device=dev, **kw))
    return out


def _record(results):
    """Everything the parity contract covers, nothing wall-clock."""
    return [
        (r.cost, r.solution.state_dict(), r.iterations,
         [c for _, c in r.trace])
        for r in results
    ]


@functools.lru_cache(maxsize=None)
def _ref_sweep(spec, algorithm, seeds, kw):
    """The reference's sweep record (and group count), computed once."""
    sw = ref.pack_sweep(_probs(ref, spec), algorithm, seeds=list(seeds), **dict(kw))
    return _record(sw.results), sw.n_groups


def _port_sweep(spec, algorithm, seeds, kw, backend):
    return port.pack_sweep(
        _probs(port, spec), algorithm, seeds=list(seeds), backend=backend,
        device="cpu", **dict(kw),
    )


def _check_sweep(spec, algorithm, seeds, ref_kw, port_kw, backend, n_groups=None):
    want, ref_groups = _ref_sweep(spec, algorithm, seeds, tuple(sorted(ref_kw.items())))
    sw = _port_sweep(spec, algorithm, seeds, tuple(sorted(port_kw.items())), backend)
    assert _record(sw.results) == want
    if n_groups is not None:
        assert sw.n_groups == ref_groups == n_groups
    for r in sw.results:
        r.solution.validate()
        assert r.solution.cost() == r.solution.cost_full() == r.cost
    return sw


# ------------------------------------------------------------- batch codecs
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("hetero", [False, True])
def test_problem_batch_round_trip(seed, hetero):
    """Seeded random fleets round-trip through the port's (NB, max_items)
    envelope codec exactly, and equal the reference's encode / decode."""
    rng_r, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    n_probs = int(rng_p.integers(1, 7))
    rng_r.integers(1, 7)
    probs = [random_problem(port, rng_p, hetero=hetero) for _ in range(n_probs)]
    rprobs = [random_problem(ref, rng_r, hetero=hetero) for _ in range(n_probs)]
    if hetero:
        assert len({batch_group_key(p) for p in probs}) == 1
    batch = encode_problem_batch(probs)
    rbatch = ref_encode(rprobs)
    assert batch.size == len(probs) == rbatch.size
    assert batch.n_max == max(p.n for p in probs) == rbatch.n_max
    for f in ("widths", "depths", "layers", "mask", "n", "max_items", "kind_counts"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(rbatch, f))
    back = decode_problem_batch(batch)
    rback = ref_decode(rbatch)
    for a, b, rb in zip(probs, back, rback):
        np.testing.assert_array_equal(a.widths, b.widths)
        np.testing.assert_array_equal(a.depths, b.depths)
        np.testing.assert_array_equal(a.layers, b.layers)
        assert a.max_items == b.max_items
        assert a.kind_tables == b.kind_tables
        assert a.kind_counts == b.kind_counts
        assert a.name == b.name
        assert (a.ocm is None) == (b.ocm is None)
        assert a.fingerprint() == b.fingerprint() == rb.fingerprint()
        assert a.bin_cost(36, 1024) == b.bin_cost(36, 1024) == rb.bin_cost(36, 1024)


def test_problem_batch_masks_and_tables():
    p1 = port.get_problem("CNV-W1A1")
    p2 = port.get_problem("CNV-W2A2", max_items=3)
    batch = encode_problem_batch([p1, p2])
    rbatch = ref_encode([ref.get_problem("CNV-W1A1"),
                         ref.get_problem("CNV-W2A2", max_items=3)])
    assert batch.cap_max == 4 == rbatch.cap_max
    np.testing.assert_array_equal(batch.n, [p1.n, p2.n])
    assert batch.mask[1, p2.n :].sum() == 0 and batch.mask[1, : p2.n].all()
    assert (batch.widths[1, p2.n :] == 0).all()
    for got, want in zip(batch.ext_tables(), rbatch.ext_tables()):
        np.testing.assert_array_equal(got, want)
    wext, dext, lext = batch.ext_tables()
    assert wext.shape == (2, batch.n_max + 1)
    assert wext[0, -1] == dext[0, -1] == 0 and lext[0, -1] == -1


def test_problem_batch_rejects_mixed_cost_models():
    p1 = port.get_problem("CNV-W1A1")
    h1 = port.get_problem("CNV-W1A1", device="U50")
    assert batch_group_key(p1) != batch_group_key(h1)
    assert ref_batch_group_key(ref.get_problem("CNV-W1A1")) != ref_batch_group_key(
        ref.get_problem("CNV-W1A1", device="U50"))
    with pytest.raises(ValueError):
        encode_problem_batch([p1, h1])
    with pytest.raises(ValueError):
        encode_problem_batch([])


def test_fingerprint_ignores_names_not_structure():
    rows = port.TABLE1_ROWS["CNV-W1A1"]
    a = port.PackingProblem(port.buffers_from_shape_rows(rows), name="one")
    b = port.PackingProblem(port.buffers_from_shape_rows(rows), name="two")
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() != port.PackingProblem(
        port.buffers_from_shape_rows(rows), max_items=3
    ).fingerprint()
    assert a.fingerprint() != port.get_problem("CNV-W1A1", device="U50").fingerprint()


@pytest.mark.parametrize("device", [None, "ZU7EV", "U50"])
def test_fingerprint_equals_reference_on_table1(device):
    """Every Table-1 accelerator on every device: the port's fingerprint is
    the reference's (int64 arrays, Python ints in the tuples), so task keys
    and checkpoint digests agree across packages."""
    names = sorted(port.TABLE1_ROWS)
    assert names == sorted(ref.TABLE1_ROWS) and len(names) == 8
    for name in names:
        p = port.get_problem(name, device=device)
        assert p.widths.dtype == p.depths.dtype == p.layers.dtype == np.int64
        assert all(type(c) is int for c in p.kind_counts)
        assert p.fingerprint() == ref.get_problem(name, device=device).fingerprint()
    for dev_p in (None, "ZU7EV", "U50"):
        if dev_p != device:
            assert (port.get_problem(names[0], device=device).fingerprint()
                    != port.get_problem(names[0], device=dev_p).fingerprint())


def test_task_key_equals_reference():
    """The sweep's task identity (hence dedup, cache and checkpoint digests)
    is the reference's for the same arguments."""
    kw = dict(n_chains=8, max_iterations=100)
    for backend in ("auto", "python"):
        for name in ("CNV-W1A1", "RN50-W1A2"):
            a = port.task_key(port.get_problem(name, device="U50"), "SA-S", 3,
                              True, backend, 5.0, kw)
            b = ref.task_key(ref.get_problem(name, device="U50"), "SA-S", 3,
                             True, backend, 5.0, kw)
            assert a == b
    assert port.dse.normalize_hyper("sa-s", {}) == {"n_chains": 8}
    assert port.dse.normalize_hyper("ga-nfd", {}) == {}


# ------------------------------------------------- fleet-vs-reference parity
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_singleton_bit_identical_to_pack(backend):
    """A one-candidate port sweep IS the reference's pack(), bit for bit."""
    spec = (("CNV-W1A1", None, None),)
    kw = dict(_SA_KW, n_chains=4)
    sw = _check_sweep(spec, "sa-s", (7,), dict(kw, backend="python"), kw, backend,
                      n_groups=1)
    want = ref.pack(ref.get_problem("CNV-W1A1"), "sa-s", seed=7, backend="python", **kw)
    r = sw.results[0]
    assert r.cost == want.cost
    assert r.solution.bins == want.solution.bins
    assert [cc for _, cc in r.trace] == [cc for _, cc in want.trace]
    assert r.iterations == want.iterations
    assert r.params["seed"] == 7
    assert r.params["backend"] == backend


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_fleet_matches_reference_per_problem(backend):
    """Mixed sizes + max_items in one batch: every candidate reproduces the
    reference's trajectory (per-problem RNG streams)."""
    spec = (("CNV-W1A1", None, None), ("CNV-W2A2", None, 3), ("Tincy-YOLO", None, None))
    kw = dict(_SA_KW, n_chains=3)
    _check_sweep(spec, "sa-s", (3, 4, 5), dict(kw, backend="python"), kw, backend,
                 n_groups=1)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_hetero_fleet_mixed_devices(backend):
    """ZU7EV and U50 share kind tables but not counts: one group, exact
    per-problem inventory penalties, parity incl. kind lanes."""
    spec = (("CNV-W1A1", "ZU7EV", None), ("CNV-W2A2", "U50", None))
    kw = dict(_SA_KW, n_chains=3)
    sw = _check_sweep(spec, "sa-s", (1, 2), dict(kw, backend="python"), kw, backend,
                      n_groups=1)
    assert all(r.params["p_kind"] == 0.15 for r in sw.results)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_mixed_cost_models_split_groups(backend):
    spec = (("CNV-W1A1", None, None), ("CNV-W1A1", "U50", None), ("CNV-W2A2", None, None))
    kw = dict(_SA_KW, n_chains=3)
    _check_sweep(spec, "sa-s", (0, 1, 2), dict(kw, backend="python"), kw, backend,
                 n_groups=2)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_intra_layer_and_freezing_parity(backend):
    """Patience small enough to freeze problems early: frozen problems stop
    consuming RNG exactly where the reference's stop."""
    spec = (("CNV-W1A1", None, None), ("CNV-W2A2", None, None))
    kw = dict(max_seconds=1e9, patience=40, max_iterations=400, n_chains=3,
              intra_layer=True)
    sw = _check_sweep(spec, "sa-s", (0, 8), dict(kw, backend="python"), kw, backend)
    for r in sw.results:
        r.solution.validate(intra_layer=True)
        assert r.iterations < 400 * 3  # froze before the budget


@pytest.mark.parametrize("device", [None, "U50"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_ga_lockstep_matches_reference(backend, device):
    """The lockstep GA lane (``torch``/``cuda``, the reference's ``ref``)
    stacks every problem's generation fitness into one (P, n_pop, NB) call
    without forking any trajectory; on ``python`` the port takes the serial
    lane, as the reference's ``python`` does, with the same results."""
    spec = (("CNV-W1A1", device, None), ("CNV-W2A2", device, None),
            ("CNV-W1A1", device, 3))
    kw = dict(max_seconds=1e9, patience=10**9, max_generations=8, n_pop=12)
    ref_backend = "python" if backend == "python" else "ref"
    n_groups = 3 if backend == "python" else 1
    _check_sweep(spec, "ga-nfd", (5, 6, 7), dict(kw, backend=ref_backend), kw, backend,
                 n_groups=n_groups)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_ga_s_lockstep_matches_reference(backend):
    spec = (("CNV-W1A1", "ZU7EV", None), ("Tincy-YOLO", "ZU7EV", None))
    kw = dict(max_seconds=1e9, patience=10**9, max_generations=6, n_pop=10)
    ref_backend = "python" if backend == "python" else "ref"
    _check_sweep(spec, "ga-s", (1, 2), dict(kw, backend=ref_backend), kw, backend)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_serial_fallback_lanes(backend):
    """sa-nfd (scalar-only), single-chain sa-s and the heuristics run the
    serial lane and still match the reference exactly."""
    spec = (("CNV-W1A1", None, None), ("CNV-W2A2", "ZU7EV", None))
    for algo, kw in (
        ("sa-nfd", dict(max_seconds=1e9, patience=10**9, max_iterations=60)),
        ("sa-s", dict(max_seconds=1e9, patience=10**9, max_iterations=60, n_chains=1)),
        ("nfd", {}),
        ("ffd", {}),
    ):
        _check_sweep(spec, algo, (1, 2), dict(kw, backend="python"), kw, backend,
                     n_groups=2)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_solve_batch_matches_reference(backend):
    """`solve_batch`: no dedup (a renamed duplicate is solved again), one
    result per position, each the reference's."""
    kw = dict(_SA_KW, n_chains=3)
    names = ("CNV-W1A1", "CNV-W2A2", "CNV-W1A1")
    want = ref.solve_batch([ref.get_problem(n) for n in names], "sa-s",
                           seeds=[1, 2, 1], backend="python", **kw)
    got = port.solve_batch([port.get_problem(n) for n in names], "sa-s",
                           seeds=[1, 2, 1], backend=backend, device="cpu", **kw)
    assert _record(got) == _record(want)
    assert got[0] is not got[2] and _record([got[0]]) == _record([got[2]])
    kw = dict(max_seconds=1e9, patience=10**9, max_generations=5, n_pop=8)
    want = ref.solve_batch([ref.get_problem(n, device="U50") for n in names[:2]],
                           "ga-nfd", seed=4, backend="ref", **kw)
    got = port.solve_batch([port.get_problem(n, device="U50") for n in names[:2]],
                           "ga-nfd", seed=4, backend=backend, device="cpu", **kw)
    assert _record(got) == _record(want)


# ----------------------------------------------------------- dedup + caching
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_dedup_and_cache(backend):
    kw = dict(_SA_KW, n_chains=3, backend=backend, device="cpu")
    prob = port.get_problem("CNV-W1A1")
    clone = port.PackingProblem(port.get_buffers("CNV-W1A1"), name="renamed-dup")
    other = port.get_problem("CNV-W2A2")
    cache: dict = {}
    sw = port.pack_sweep([prob, clone, other], "sa-s", seed=0, cache=cache, **kw)
    # the renamed duplicate is served by fingerprint dedup, not solved
    assert sw.n_solved == 2 and sw.cache_hits == 1
    assert sw.results[0] is sw.results[1]
    assert len(cache) == 2
    assert sw.params == dict(solved=2, dedup_hits=1, cache_hits=0, n_shards=1)
    want = ref.pack_sweep(
        [ref.get_problem("CNV-W1A1"),
         ref.PackingProblem(ref.get_buffers("CNV-W1A1"), name="renamed-dup"),
         ref.get_problem("CNV-W2A2")],
        "sa-s", seed=0, n_chains=3, backend="python", **_SA_KW)
    assert _record(sw.results) == _record(want.results)
    assert sw.params == want.params and sw.fresh == want.fresh
    # a second sweep over a superset is served entirely from the cache
    sw2 = port.pack_sweep([prob, other, clone], "sa-s", seed=0, cache=cache, **kw)
    assert sw2.n_solved == 0 and sw2.cache_hits == 3
    assert sw2.results[0].cost == sw.results[0].cost
    assert sw2.params == dict(solved=0, cache_hits=2, dedup_hits=1, n_shards=1)
    assert (sw2.params["solved"] + sw2.params["cache_hits"]
            + sw2.params["dedup_hits"]) == sw2.size
    # different seed or budget = different task = fresh solve
    sw3 = port.pack_sweep([prob], "sa-s", seed=1, cache=cache, **kw)
    assert sw3.n_solved == 1


def test_sweep_seed_validation_and_empty():
    prob = port.get_problem("CNV-W1A1")
    with pytest.raises(ValueError):
        port.pack_sweep([], "sa-s", device="cpu")
    with pytest.raises(ValueError):
        port.pack_sweep([prob], "sa-s", seeds=[1, 2], device="cpu")
    with pytest.raises(ValueError):
        port.solve_batch([], "sa-s", device="cpu")
    with pytest.raises(ValueError):
        port.solve_batch([prob], "sa-s", seeds=[1, 2], device="cpu")
    with pytest.raises(ValueError):
        port.pack_sweep([prob], "sa-s", n_shards=0, device="cpu")
    # sub-fleet sharding is an execution-shape knob: n_shards=2 answers as
    # n_shards=1; a mesh must be a 1-D ('prob',) sweep mesh
    probs = [prob, port.get_problem("CNV-W2A2")]
    kw = dict(n_chains=2, max_iterations=40, max_seconds=1e9, patience=10**9,
              device="cpu")
    one = port.pack_sweep(probs, "sa-s", **kw)
    two = port.pack_sweep(probs, "sa-s", n_shards=2, **kw)
    assert _record(two.results) == _record(one.results)
    assert two.params["n_shards"] == 2
    batch = port.solve_batch(probs, "sa-s", n_shards=2, **kw)
    assert _record(batch) == _record(one.results)
    for fn in (port.pack_sweep, port.solve_batch):
        with pytest.raises(ValueError, match=r"1-D \('prob',\) sweep mesh"):
            fn([prob], "sa-s", mesh=object(), device="cpu")


def test_sweep_default_device_is_cuda():
    """The entry point runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.pack_sweep([port.get_problem("CNV-W1A1")], "nfd")


# ------------------------------------------------------------- sweep report
def test_sweep_report_and_pareto():
    probs = [port.get_problem("CNV-W1A1"), port.get_problem("CNV-W2A2")]
    sw = port.pack_sweep(probs, "nfd", seed=0, device="cpu")
    want = ref.pack_sweep([ref.get_problem("CNV-W1A1"), ref.get_problem("CNV-W2A2")],
                          "nfd", seed=0)
    assert sw.size == 2
    assert sw.candidates_per_sec > 0
    np.testing.assert_array_equal(sw.costs(), want.costs())
    pareto = sw.pareto_indices()
    assert pareto == want.pareto_indices()
    assert pareto  # the front is never empty
    cost, eff = sw.costs(), [r.efficiency for r in sw.results]
    for i in range(sw.size):
        if i not in pareto:
            assert any(cost[j] <= cost[i] and eff[j] >= eff[i] for j in pareto)
    text = sw.table()
    assert "CNV-W1A1" in text and "pareto" in text and "solve" in text
    assert sw.summary() in text
    # the rows are the reference's, wall time aside
    assert text.splitlines()[:-1] == want.table().splitlines()[:-1]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_equal_budget_costs_match_serial(backend):
    """At equal iteration budgets the batched sweep's per-problem costs
    equal the serial loop's (they are the same trajectories), and the
    reference's."""
    spec = tuple((name, dev, None) for name in ("CNV-W1A1", "CNV-W2A2")
                 for dev in (None, "ZU7EV"))
    kw = dict(_SA_KW, n_chains=3)
    sw = _check_sweep(spec, "sa-s", (0, 0, 0, 0), dict(kw, backend="python"), kw,
                      backend, n_groups=2)
    serial = [port.pack(p, "sa-s", seed=0, backend=backend, device="cpu", **kw)
              for p in _probs(port, spec)]
    assert [r.cost for r in sw.results] == [r.cost for r in serial]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_sweep_frozen_problem_not_revived_by_exchange(backend):
    """The fleet exchange tick skips frozen problems: with ``patience <
    exchange_every`` a problem can freeze between exchange ticks while a
    fleet-mate stays live; iterations (and thus trajectories) must match
    the reference's exactly."""
    spec = (("CNV-W1A1", None, None), ("RN101-W1A2", None, None))
    kw = dict(max_seconds=1e9, patience=60, max_iterations=20_000,
              exchange_every=70, n_chains=3)
    sw = _check_sweep(spec, "sa-s", (0, 1), dict(kw, backend="python"), kw, backend)
    assert sw.results[0].iterations != sw.results[1].iterations


# ------------------------------------------------- block engine direct access
def _block_record(blocks):
    return [
        (b.best_cost, b.best.state_dict(), b.iterations, [c for _, c in b.trace],
         [s.state_dict() for s in b.chains], b.incumbent, b.uphill)
        for b in blocks
    ]


@pytest.mark.parametrize("device", [None, "U50"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_anneal_block_warm_starts(backend, device):
    """The fleet engine with P = 3 problems takes per-problem warm-start
    chain lists; both passes equal the reference's block engine, chains
    and incumbent included."""
    names = ("CNV-W1A1", "CNV-W2A2", "Tincy-YOLO")
    kw = dict(perturbation="swap", n_chains=3, max_seconds=1e9,
              patience=10**9, max_iterations=150)

    def run(pkg, packer, b):
        probs = [pkg.get_problem(n, device=device) for n in names]
        packer._hetero = probs[0].n_kinds > 1
        rngs = [np.random.default_rng(s) for s in (0, 1, 2)]
        first = packer._anneal_block(probs, rngs, [[], [], []], b)
        inits = [blk.chains for blk in first]
        rngs = [np.random.default_rng(s) for s in (3, 4, 5)]
        second = packer._anneal_block(probs, rngs, inits, b)
        return first, second

    rpk = ref.SimulatedAnnealingPacker(backend="python", **kw)
    want = [_block_record(x) for x in run(ref, rpk, "python")]
    ppk = SimulatedAnnealingPacker(backend=backend, device="cpu", **kw)
    first, second = run(port, ppk, backend)
    assert [_block_record(first), _block_record(second)] == want
    for blk, prev in zip(second, first):
        blk.best.validate()
        if device is None:
            # the run's best never loses to the warm chains it started from
            # (on U50 the ranking is the penalized cost, not the raw one)
            assert blk.best_cost <= min(s.cost() for s in prev.chains)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 2), (7, 3), (4, 9), (48, 5), (3, 0)])
def test_shard_chunks_equal_reference(n, k):
    """The contiguous balanced split the sharded lanes (a later slice) and
    the reference's canonical snapshot layout build on."""
    from repro.core.dse import shard_chunks as ref_shard_chunks

    got = port.dse.shard_chunks(n, k)
    assert got == ref_shard_chunks(n, k)
    assert [i for c in got for i in c] == list(range(n))
