"""The reference's property suite (``tests/test_core_property.py``) held
against the port: every hypothesis draw goes through both packages, and
the port must give the reference's result exactly, beside the invariants
the reference checks.

The strategies are the reference suite's, copied here; each draws plain
numbers and builds the problem in either package.  The last property is
the engines': random problems through `pack` for all four algorithms at
iteration budgets, the port's ``torch`` and ``python`` backends against the
reference's ``python`` in cost, bins, kind lanes, iterations and trace.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="optional dependency: hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as port

PACKAGES = (ref, port)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- strategies
@st.composite
def problems(draw):
    """``tests/test_core_property.py:13``'s problems, as plain numbers."""
    n = draw(st.integers(2, 60))
    widths = draw(st.lists(st.integers(1, 80), min_size=n, max_size=n))
    depths = draw(st.lists(st.integers(1, 40_000), min_size=n, max_size=n))
    layers = draw(st.lists(st.integers(0, 5), min_size=n, max_size=n))
    max_items = draw(st.integers(1, 6))
    return dict(bufs=list(zip(widths, depths, layers)), max_items=max_items)


@st.composite
def kind_tables_strategy(draw):
    """1-3 RAM kinds, each with a random mode set and an integer weight
    (``tests/test_core_property.py:85``)."""
    n_kinds = draw(st.integers(1, 3))
    tables = []
    for _ in range(n_kinds):
        n_modes = draw(st.integers(1, 6))
        modes = tuple(
            (draw(st.integers(1, 96)), draw(st.integers(1, 40_000)))
            for _ in range(n_modes)
        )
        tables.append((draw(st.integers(1, 32)), modes))
    return tuple(tables)


@st.composite
def problem_fleets(draw):
    """Randomly sized fleets sharing one cost model, single- or two-kind
    (``tests/test_core_property.py:154``)."""
    hetero = draw(st.booleans())
    fleet = []
    for _ in range(draw(st.integers(1, 5))):
        n = draw(st.integers(1, 25))
        bufs = [
            (draw(st.integers(1, 80)), draw(st.integers(1, 40_000)),
             draw(st.integers(0, 4)))
            for _ in range(n)
        ]
        counts = (
            (draw(st.integers(-1, 500)), draw(st.integers(-1, 64)))
            if hetero else None
        )
        fleet.append(dict(bufs=bufs, max_items=draw(st.integers(1, 6)),
                          counts=counts))
    return fleet


@st.composite
def engine_cases(draw):
    """The engine fuzz: 2-40 buffers, ``max_items`` 1-6, homogeneous or a
    BRAM18 + URAM288 inventory, intra-layer on or off, one of the four
    algorithms at an iteration budget."""
    n = draw(st.integers(2, 40))
    bufs = [
        (draw(st.integers(1, 80)), draw(st.integers(1, 40_000)),
         draw(st.integers(0, 5)))
        for _ in range(n)
    ]
    counts = (
        (draw(st.integers(-1, 3 * n)), draw(st.integers(-1, 16)))
        if draw(st.booleans()) else None
    )
    algorithm = draw(st.sampled_from(["ga-nfd", "ga-s", "sa-nfd", "sa-s"]))
    if algorithm.startswith("ga"):
        budget = dict(n_pop=draw(st.integers(2, 10)),
                      max_generations=draw(st.integers(1, 6)))
    else:
        budget = dict(max_iterations=draw(st.integers(1, 120)))
        if algorithm == "sa-s":
            budget["n_chains"] = draw(st.sampled_from([1, 2, 4]))
    return dict(
        prob=dict(bufs=bufs, max_items=draw(st.integers(1, 6)), counts=counts),
        algorithm=algorithm, intra_layer=draw(st.booleans()),
        seed=draw(st.integers(0, 10_000)), budget=budget,
    )


def build(pkg, spec):
    """One drawn problem in ``pkg`` (``ref`` or ``port``)."""
    bufs = [pkg.Buffer(width=w, depth=d, layer=l) for w, d, l in spec["bufs"]]
    counts = spec.get("counts")
    ocm = (
        pkg.OCMInventory((pkg.BRAM18, pkg.URAM288), counts)
        if counts is not None else None
    )
    return pkg.PackingProblem(bufs, max_items=spec["max_items"], ocm=ocm)


def layout(sol):
    return [list(b) for b in sol.bins], [int(k) for k in sol.kinds]


# ------------------------------------------------------ heuristics, moves
@settings(max_examples=40, deadline=None)
@given(problems(), st.integers(0, 10_000))
def test_nfd_from_scratch_valid(spec, seed):
    sols = [
        pkg.nfd_from_scratch(build(pkg, spec), np.random.default_rng(seed),
                             p_adm_h=0.2)
        for pkg in PACKAGES
    ]
    want, got = sols
    got.validate()
    assert layout(got) == layout(want)
    assert got.cost() == want.cost()
    assert got.problem.lower_bound() == want.problem.lower_bound() <= got.cost()
    assert 0.0 < got.efficiency() == want.efficiency() <= 1.0


@settings(max_examples=40, deadline=None)
@given(problems(), st.integers(0, 10_000))
def test_nfd_repack_preserves_validity(spec, seed):
    rngs = [np.random.default_rng(seed) for _ in PACKAGES]
    sols = [build(pkg, spec).singleton_solution() for pkg in PACKAGES]
    for _ in range(4):
        sols = [
            pkg.nfd_repack(sol, rng, threshold=0.9, extra_frac=0.1, p_adm_h=0.3)
            for pkg, sol, rng in zip(PACKAGES, sols, rngs)
        ]
        sols[1].validate()
        assert layout(sols[1]) == layout(sols[0])
        assert sols[1].cost() == sols[0].cost()


@settings(max_examples=40, deadline=None)
@given(problems(), st.integers(0, 10_000))
def test_buffer_swap_preserves_validity(spec, seed):
    rngs = [np.random.default_rng(seed) for _ in PACKAGES]
    sols = [pkg.nfd_from_scratch(build(pkg, spec), rng)
            for pkg, rng in zip(PACKAGES, rngs)]
    for _ in range(4):
        sols = [pkg.buffer_swap(sol, rng, n_moves=3)
                for pkg, sol, rng in zip(PACKAGES, sols, rngs)]
        sols[1].validate()
        assert layout(sols[1]) == layout(sols[0])
        assert sols[1].cost() == sols[0].cost()


# ------------------------------------------------------------ cost model
@settings(max_examples=30, deadline=None)
@given(problems())
def test_singleton_cost_additive(spec):
    want, prob = (build(pkg, spec) for pkg in PACKAGES)
    per = [prob.bin_cost(int(prob.widths[i]), int(prob.depths[i]))
           for i in range(prob.n)]
    assert per == [want.bin_cost(int(want.widths[i]), int(want.depths[i]))
                   for i in range(want.n)]
    assert prob.singleton_solution().cost() == sum(per)
    assert want.singleton_solution().cost() == sum(per)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 80), st.integers(1, 30_000), st.integers(1, 30_000))
def test_same_width_stack_subadditive_per_mode(w, h1, h2):
    """Within any fixed aspect mode, stacking same-width buffers never costs
    more than separate bins; across modes it may (the reference's w=37,
    h1=1, h2=2048), which is why NFD admits a buffer only when the grid gap
    shrinks."""
    costs = []
    for pkg in PACKAGES:
        prob = pkg.PackingProblem([pkg.Buffer(w, h1, 0), pkg.Buffer(w, h2, 0)])
        costs.append((prob.bin_cost(w, h1 + h2), prob.bin_cost(w, h1),
                      prob.bin_cost(w, h2)))
    assert costs[0] == costs[1]
    assert port.BRAM18_MODES == ref.BRAM18_MODES
    for mw, md in port.BRAM18_MODES:
        per_mode = (-(-w // mw)) * (-(-h1 // md)) + (-(-w // mw)) * (-(-h2 // md))
        assert costs[1][0] <= per_mode


@settings(max_examples=30, deadline=None)
@given(kind_tables_strategy(), st.integers(0, 10_000))
def test_random_mode_sets_backends_agree(kind_tables, seed):
    """On random RAM mode sets, weights and empty slots, the port's plain
    versions (K1 / K2's and K3 / K4's, and the kernel wrappers on CPU
    tensors, which take them), its numpy evaluators and the scalar loop
    equal the reference's ``ref`` (jnp) and ``python`` evaluators."""
    import jax.numpy as jnp

    from repro.kernels.binpack_fitness.ref import (
        binpack_fitness_kinds_ref as ref_kinds, binpack_fitness_ref as ref_plain)
    from repro.kernels.binpack_sa_step.ops import (
        _bin_costs_kinds_numpy as ref_kinds_numpy, _bin_costs_numpy as ref_numpy)
    from repro.kernels.binpack_sa_step.ref import (
        sa_step_deltas_kinds_ref as ref_deltas_kinds)
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda, binpack_fitness_kinds_ref,
        binpack_fitness_ref)
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas_kinds_cuda, sa_step_deltas_kinds_ref)
    from repro_torch.kernels.binpack_sa_step.ops import (
        _bin_costs_kinds_numpy, _bin_costs_numpy)

    rng = np.random.default_rng(seed)
    p, nb = int(rng.integers(1, 5)), int(rng.integers(1, 40))
    w = rng.integers(0, 100, (p, nb)).astype(np.int32)
    h = np.where(w > 0, rng.integers(1, 60_000, (p, nb)), 0).astype(np.int32)
    k = rng.integers(0, len(kind_tables), (p, nb)).astype(np.int32)
    # the scalar min-over-modes loop, the seed's formulation
    legacy = np.zeros((p, nb), dtype=np.int64)
    for i in range(p):
        for j in range(nb):
            if w[i, j] > 0:
                weight, modes = kind_tables[int(k[i, j])]
                legacy[i, j] = weight * min(
                    -(-int(w[i, j]) // mw) * -(-int(h[i, j]) // md)
                    for mw, md in modes
                )
    tw, th, tk = (torch.from_numpy(a) for a in (w, h, k))
    jw, jh, jk = (jnp.asarray(a) for a in (w, h, k))
    for got in (
        _bin_costs_kinds_numpy(w, h, k, kind_tables),
        ref_kinds_numpy(w, h, k, kind_tables),
        np.asarray(ref_kinds(jw, jh, jk, kind_tables)),
        binpack_fitness_kinds_ref(tw, th, tk, kind_tables).numpy(),
    ):
        np.testing.assert_array_equal(got, legacy)
    np.testing.assert_array_equal(
        binpack_fitness_kinds_cuda(tw, th, tk, kind_tables).numpy(), legacy.sum(1))
    # one kind alone: the homogeneous plain versions and evaluators
    modes = kind_tables[0][1]
    plain = _bin_costs_numpy(w, h, modes)
    np.testing.assert_array_equal(plain, ref_numpy(w, h, modes))
    np.testing.assert_array_equal(plain, np.asarray(ref_plain(jw, jh, modes)))
    np.testing.assert_array_equal(plain, binpack_fitness_ref(tw, th, modes).numpy())
    np.testing.assert_array_equal(
        binpack_fitness_cuda(tw, th, modes).numpy(), plain.sum(1))
    # the SA step's delta: the same planes as "before", a shuffled copy as
    # "after"
    perm = rng.permutation(nb)
    nw, nh, nk = w[:, perm], h[:, perm], rng.integers(
        0, len(kind_tables), (p, nb)).astype(np.int32)
    want = np.asarray(ref_deltas_kinds(jw, jh, jk, jnp.asarray(nw), jnp.asarray(nh),
                                       jnp.asarray(nk), kind_tables))
    tn = [torch.from_numpy(np.ascontiguousarray(a)) for a in (nw, nh, nk)]
    for fn in (sa_step_deltas_kinds_ref, sa_step_deltas_kinds_cuda):
        np.testing.assert_array_equal(fn(tw, th, tk, *tn, kind_tables).numpy(), want)


# ------------------------------------------------------- data, the codec
@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(8, 512), min_size=1, max_size=60), st.integers(1, 8))
def test_sequence_packing_invariants(doc_lengths, card):
    from repro.data import pack_documents as ref_pack_documents
    from repro_torch.data import pack_documents

    seq_len = 512
    seqs = pack_documents(doc_lengths, seq_len, max_docs_per_seq=card, device="cpu")
    assert seqs == ref_pack_documents(doc_lengths, seq_len, max_docs_per_seq=card)
    placed = sorted(i for s in seqs for i in s)
    assert placed == list(range(len(doc_lengths)))
    for s in seqs:
        assert sum(doc_lengths[i] for i in s) <= seq_len
        assert len(s) <= card


def crossed(batch, pkg):
    """``batch`` as the other package's `ProblemBatch` (``pkg``'s), its RAM
    kinds rebuilt there."""
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    fields["ram_kinds"] = tuple(
        pkg.RAMKind(k.name, tuple(k.modes), k.capacity_bits)
        for k in batch.ram_kinds
    )
    return pkg.ProblemBatch(**fields)


@settings(max_examples=40, deadline=None)
@given(problem_fleets())
def test_problem_batch_codec_round_trip(fleet):
    """The problem-batch codec round-trips arbitrary fleets in either
    package, the two encodings are equal, and a batch encoded in one package
    decodes in the other to the same problems (geometry, layers,
    cardinality, kinds, counts, fingerprints)."""
    fleets = [[build(pkg, spec) for spec in fleet] for pkg in PACKAGES]
    batches = [pkg.encode_problem_batch(f) for pkg, f in zip(PACKAGES, fleets)]
    for f in ("widths", "depths", "layers", "mask", "n", "max_items", "kind_counts"):
        np.testing.assert_array_equal(getattr(batches[1], f), getattr(batches[0], f))
    assert batches[1].kind_tables == batches[0].kind_tables
    assert batches[1].size == len(fleet)
    assert batches[1].n_max == max(len(spec["bufs"]) for spec in fleet)
    for pkg, batch, other in ((port, batches[1], port), (ref, batches[0], port),
                              (port, batches[1], ref)):
        back = other.decode_problem_batch(
            batch if pkg is other else crossed(batch, other))
        for a, b, c in zip(fleets[0], fleets[1], back):
            np.testing.assert_array_equal(a.widths, c.widths)
            np.testing.assert_array_equal(a.depths, c.depths)
            np.testing.assert_array_equal(a.layers, c.layers)
            assert a.max_items == b.max_items == c.max_items
            assert a.kind_tables == b.kind_tables == c.kind_tables
            assert a.kind_counts == b.kind_counts == c.kind_counts
            assert a.fingerprint() == b.fingerprint() == c.fingerprint()


# ---------------------------------------------------------------- engines
def record(r):
    return (r.cost, *layout(r.solution), r.iterations, [c for _, c in r.trace])


@settings(max_examples=150, deadline=None)
@given(engine_cases())
def test_pack_equals_reference_on_random_problems(case):
    kw = dict(seed=case["seed"], intra_layer=case["intra_layer"],
              max_seconds=1e9, **case["budget"])
    want = ref.pack(build(ref, case["prob"]), case["algorithm"],
                    backend="python", **kw)
    for backend in ("torch", "python"):
        r = port.pack(build(port, case["prob"]), case["algorithm"],
                      backend=backend, device="cpu", **kw)
        assert record(r) == record(want), backend
        r.solution.validate()
        assert r.solution.cost() == r.solution.cost_full() == r.cost
