"""The port's problem model, heuristics and state conversion against the
reference, exactly equal: Table-1 problems on every OCM device, the cost
evaluators, the one-shot packers, the chain / batch codecs, and
`repro_torch.convert`."""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.problem import encode_chain_items as ref_encode_chain_items
from repro_torch.convert import problem_from_arrays, solution_from_state
from repro_torch.core.problem import (
    decode_chain_items,
    encode_chain_geometry,
    encode_chain_items,
    encode_chain_kinds,
)

DEVICES = [None, *ref.OCM_DEVICES]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ref.ACCELERATORS)
def test_table1_problem_and_costs_match(name, device):
    a = ref.get_problem(name, device=device)
    b = port.get_problem(name, device=device)
    assert (b.n, b.name, b.max_items, b.n_kinds) == (a.n, a.name, a.max_items, a.n_kinds)
    for attr in ("widths", "depths", "layers"):
        np.testing.assert_array_equal(getattr(b, attr), getattr(a, attr))
    assert b.kind_tables == a.kind_tables
    assert (b.kind_counts, b.kind_weights) == (a.kind_counts, a.kind_weights)
    assert (b.total_bits, b.baseline_cost(), b.lower_bound()) == (
        a.total_bits, a.baseline_cost(), a.lower_bound()
    )
    rng = np.random.default_rng(len(name))
    w = rng.integers(0, 200, 500)
    h = rng.integers(0, 300_000, 500)
    k = rng.integers(0, a.n_kinds, 500)
    np.testing.assert_array_equal(b.bin_cost_many(w, h), a.bin_cost_many(w, h))
    np.testing.assert_array_equal(b.bin_cost_many(w, h, k), a.bin_cost_many(w, h, k))
    np.testing.assert_array_equal(
        b.bin_primitives_many(w, h, k), a.bin_primitives_many(w, h, k)
    )
    for wi, hi, ki in zip(w[:100], h[:100], k[:100]):
        args = (int(wi), int(hi), int(ki))
        assert b._cost_mode_gap(*args) == a._cost_mode_gap(*args)


def test_table1_buffer_counts():
    expected = {
        "CNV-W1A1": 43, "CNV-W2A2": 28, "Tincy-YOLO": 137,
        "DoReFaNet": 320, "ReBNet": 552, "RN50-W1A2": 896, "RN152-W1A2": 2253,
    }
    for name, n in expected.items():
        assert port.get_problem(name).n == n
    assert port.TABLE1_ROWS == ref.TABLE1_ROWS
    assert port.PAPER_TABLE2 == ref.PAPER_TABLE2
    for name in ref.ACCELERATORS:
        assert port.hyperparams(name) == ref.hyperparams(name)


@pytest.mark.parametrize("device", [None, "U50"])
@pytest.mark.parametrize("algorithm", ["nfd", "ffd", "next-fit", "baseline"])
@pytest.mark.parametrize("name", ["CNV-W1A1", "Tincy-YOLO", "ReBNet", "RN50-W1A2"])
def test_heuristics_match(name, algorithm, device):
    a = ref.pack(ref.get_problem(name, device=device), algorithm, seed=3)
    b = port.pack(port.get_problem(name, device=device), algorithm, seed=3, device="cpu")
    assert b.solution.bins == a.solution.bins
    np.testing.assert_array_equal(b.solution.kinds, a.solution.kinds)
    assert (b.cost, b.efficiency, b.algorithm) == (a.cost, a.efficiency, a.algorithm)
    b.solution.validate()


@pytest.mark.parametrize("intra_layer", [False, True])
def test_nfd_repack_and_swaps_match(intra_layer):
    """Mutation operators consume the same RNG stream and give the same
    packings (and costs) as the reference's."""
    pa, pb = ref.get_problem("RN50-W1A2", device="ZU7EV"), port.get_problem(
        "RN50-W1A2", device="ZU7EV"
    )
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    sa = ref.nfd_from_scratch(pa, ra, intra_layer=intra_layer, sort_by_width=True)
    sb = port.nfd_from_scratch(pb, rb, intra_layer=intra_layer, sort_by_width=True)
    for step in range(10):
        if step % 3 == 0:
            sa, sb = ref.nfd_repack(sa, ra, intra_layer=intra_layer), port.nfd_repack(
                sb, rb, intra_layer=intra_layer
            )
        elif step % 3 == 1:
            sa = ref.buffer_swap(sa, ra, n_moves=4, intra_layer=intra_layer, p_kind=0.3)
            sb = port.buffer_swap(sb, rb, n_moves=4, intra_layer=intra_layer, p_kind=0.3)
        else:
            sa, sb = ref.kind_reassign(sa, ra, 3), port.kind_reassign(sb, rb, 3)
        assert sb.bins == sa.bins
        np.testing.assert_array_equal(sb.kinds, sa.kinds)
        assert (sb.cost(), sb.inventory_overflow()) == (sa.cost(), sa.inventory_overflow())
        assert sb.cost() == sb.cost_full()
    assert rb.random() == ra.random()


@pytest.mark.parametrize("device", [None, "U50"])
def test_convert_round_trip(device):
    """A reference problem and packing carried over as plain data: the port
    rebuilds the same problem and computes the same costs."""
    pa = ref.get_problem("RN50-W1A2", device=device)
    kinds = counts = None
    if device is not None:
        kinds = [k.name for k in pa.ram_kinds]
        counts = list(pa.kind_counts)
    pb = problem_from_arrays(
        pa.widths.tolist(), pa.depths.tolist(), pa.layers.tolist(), kinds, counts,
        max_items=pa.max_items, name=pa.name, ocm_name=device or "",
    )
    assert pb.kind_tables == pa.kind_tables
    sol_a = ref.pack(pa, "ga-nfd", seed=2, max_generations=5, n_pop=8,
                     backend="python").solution
    state = sol_a.state_dict()
    sol_b = solution_from_state(pb, state)
    sol_b.validate()
    assert sol_b.state_dict() == state
    assert (sol_b.cost(), sol_b.inventory_overflow(), sol_b.efficiency()) == (
        sol_a.cost(), sol_a.inventory_overflow(), sol_a.efficiency()
    )
    np.testing.assert_array_equal(sol_b.bin_efficiencies(), sol_a.bin_efficiencies())
    np.testing.assert_array_equal(sol_b.used_primitives(), sol_a.used_primitives())
    assert port.get_problem("RN50-W1A2", device=device).kind_tables == pb.kind_tables
    with pytest.raises(ValueError):
        problem_from_arrays([1], [2], [0], ["BRAM18"], None)


def test_chain_and_batch_codecs_match():
    pa, pb = ref.get_problem("CNV-W2A2", device="U50"), port.get_problem(
        "CNV-W2A2", device="U50"
    )
    sols_a = [ref.nfd_from_scratch(pa, np.random.default_rng(s)) for s in range(4)]
    sols_b = [port.nfd_from_scratch(pb, np.random.default_rng(s)) for s in range(4)]
    items_a, counts_a = ref_encode_chain_items(sols_a, pa.max_items)
    items_b, counts_b = encode_chain_items(sols_b, pb.max_items)
    np.testing.assert_array_equal(items_b, items_a)
    np.testing.assert_array_equal(counts_b, counts_a)
    w, h, nb = encode_chain_geometry(sols_b, items_b.shape[1])
    k = encode_chain_kinds(sols_b, items_b.shape[1])
    for i, s in enumerate(sols_b):
        back = decode_chain_items(pb, items_b[i], counts_b[i], k[i])
        assert back.bins == s.bins and back.cost() == s.cost()
        assert int(nb[i]) == len(s.bins)
        ws, hs = s.scan_bin_geometry(range(len(s.bins)))
        assert w[i, : len(ws)].tolist() == ws and h[i, : len(hs)].tolist() == hs
    batch_a = ref.encode_problem_batch([pa, ref.get_problem("CNV-W1A1", device="U50")])
    batch_b = port.encode_problem_batch([pb, port.get_problem("CNV-W1A1", device="U50")])
    for attr in ("widths", "depths", "layers", "mask", "n", "max_items", "kind_counts"):
        np.testing.assert_array_equal(getattr(batch_b, attr), getattr(batch_a, attr))
    assert batch_b.kind_tables == batch_a.kind_tables
    with pytest.raises(ValueError):
        port.encode_problem_batch([pb, port.get_problem("CNV-W1A1")])
