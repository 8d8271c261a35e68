"""The port's memory planner (`repro_torch.memory`) against the reference's
(`repro.memory`): tile math, problems and flattening on every architecture
at full width (shapes only), identical plans on every port backend, and
packed stores whose banks are bit-equal to the reference's.

Plans are compared with a wall budget (``max_seconds=600``) that the GA
never reaches: both packers stop on patience, so the plan is a function of
the tree alone."""
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as configs
from repro.kernels.packed_gather import packed_gather_ref as jnp_packed_gather_ref
from repro.launch.specs import param_specs
from repro.memory import PackedParameterStore as RefStore
from repro.memory import plan_packing as ref_plan_packing
from repro.memory import planner as ref_planner
from repro.memory import tiles as ref_tiles
from repro.models import model as M
from repro_torch.convert import params_from_arrays
from repro_torch.kernels.packed_gather import bank_matvec
from repro_torch.memory import PackedParameterStore, plan_packing, tile_efficiency
from repro_torch.memory import planner, tiles

ROOT = Path(__file__).resolve().parents[1]
MAX_SECONDS = 600.0
SMOKE_ARCHS = ("hymba-1.5b", "qwen2-0.5b", "whisper-medium")
FULL_ARCHS = ("hymba-1.5b", "qwen3-0.6b")


def meta_tree(specs):
    """Port meta tensors with the shapes and dtypes of ``param_specs``."""
    if isinstance(specs, dict):
        return {k: meta_tree(v) for k, v in specs.items()}
    return torch.empty(specs.shape, dtype=getattr(torch, str(specs.dtype)), device="meta")


@functools.lru_cache(maxsize=None)
def full_specs(arch):
    return param_specs(configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def smoke_params(arch):
    """The reference's smoke-config weights as numpy (``jax.device_get``)."""
    cfg = configs.get_smoke_config(arch)
    return jax.device_get(M.init_params(cfg, jax.random.PRNGKey(0)))


def tree_of(kind, arch):
    """(reference tree, port tree) for a smoke config's weights or a
    full-width config's shapes."""
    if kind == "smoke":
        ref = smoke_params(arch)
        return ref, params_from_arrays(ref, device="cpu")
    ref = full_specs(arch)
    return ref, meta_tree(ref)


@functools.lru_cache(maxsize=None)
def ref_plans(kind, arch, max_items=4):
    ref, _ = tree_of(kind, arch)
    return ref_plan_packing(ref, max_items=max_items, max_seconds=MAX_SECONDS,
                            split_stacked=True)


def plan_key(plans):
    out = {}
    for itemsize, p in plans.items():
        r = p.packer_result
        out[itemsize] = dict(
            banks=[[(e.path, e.row_offset, e.rows, e.cols, tuple(e.shape)) for e in b]
                   for b in p.banks],
            bank_shapes=p.bank_shapes, unpacked=list(p.unpacked),
            before=p.padded_bytes_before, after=p.padded_bytes_after,
            logical=p.logical_bytes, saved=p.saved_bytes,
            eff=(p.efficiency_before(), p.efficiency_after()),
            packer=None if r is None else (r.cost, r.iterations, len(r.solution.bins)),
        )
    return out


def assert_patience_stop(plans):
    for p in plans.values():
        r = p.packer_result
        if r is not None:
            assert r.wall_time_s < MAX_SECONDS
            assert r.iterations < 100_000  # the GA's default generation budget


# ------------------------------------------------------------ tile math
def test_tile_padding_math():
    assert tiles.padded_bytes((1, 100), 4) == 8 * 128 * 4
    assert tiles.padded_bytes((8, 128), 4) == 8 * 128 * 4
    assert tiles.padded_bytes((9, 129), 4) == 16 * 256 * 4
    assert tiles.padded_bytes((3, 5), 2) == 16 * 128 * 2
    assert tiles.padded_bytes((3, 5), 1) == 32 * 128
    assert tiles.fold_2d((3, 4, 5)) == (12, 5)
    assert tiles.fold_2d(()) == (1, 1)
    assert tiles.fold_2d((7,)) == (1, 7)
    assert tile_efficiency((8, 128), 4) == 1.0
    assert tile_efficiency((1, 128), 4) == pytest.approx(1 / 8)
    assert tiles.LANES == ref_tiles.LANES and tiles.TILE_ROWS == ref_tiles.TILE_ROWS
    for path in ("layers/attn/q/kernel#7", "enc/layer_3/w", "embed", "a#b/layer_x/c"):
        assert tiles._layer_of(path) == ref_tiles._layer_of(path)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_shapes_match_reference_at_full_width(arch):
    """Flattening, tile math and the tile-grid problem over the whole
    full-width tree (split per layer), from port meta tensors against the
    reference's ``param_specs``."""
    ref, port = tree_of("full", arch)
    for split in (False, True):
        want = ref_planner._flatten_params(ref, split_stacked=split)
        got = planner._flatten_params(port, split_stacked=split)
        assert got == want
    for path, shape, itemsize in got:
        assert tiles.fold_2d(shape) == ref_tiles.fold_2d(shape)
        assert tiles.padded_bytes(shape, itemsize) == ref_tiles.padded_bytes(shape, itemsize)
        assert tiles.logical_bytes(shape, itemsize) == ref_tiles.logical_bytes(shape, itemsize)
        assert tile_efficiency(shape, itemsize) == ref_planner.tile_efficiency(shape, itemsize)
    prob, paths = tiles.tile_grid_problem(got, max_items=3)
    rprob, rpaths = ref_tiles.tile_grid_problem(want, max_items=3)
    assert paths == rpaths
    assert [(b.width, b.depth, b.layer, b.name) for b in prob.buffers] == [
        (b.width, b.depth, b.layer, b.name) for b in rprob.buffers
    ]
    assert tuple(prob.bram.modes) == tuple(rprob.bram.modes)
    assert prob.bram.capacity_bits == rprob.bram.capacity_bits
    assert (prob.max_items, prob.name) == (rprob.max_items, rprob.name)
    assert prob.baseline_cost() == rprob.baseline_cost()


def test_flatten_sorts_keys_and_names_list_items():
    """The reference's flatten order (sorted keys, ``layer_{i}`` for list
    items), whatever the insertion order."""
    a = np.zeros((2, 3), np.float32)
    tree = {"z": a, "layers": {"w": np.zeros((4, 1, 9), np.float32)},
            "b": [a, {"y": a, "x": np.zeros(5, np.float16)}]}
    port = params_from_arrays(tree, device="cpu")
    for split in (False, True):
        assert planner._flatten_params(port, split_stacked=split) == \
            ref_planner._flatten_params(tree, split_stacked=split)
    with pytest.raises(ValueError, match="one packing problem per dtype"):
        tiles.tile_grid_problem(planner._flatten_params(port))


# ------------------------------------------------------------ plans
PLAN_CASES = [("smoke", a) for a in SMOKE_ARCHS] + [("full", a) for a in FULL_ARCHS]


@pytest.mark.parametrize("backend", ["python", "torch", "cuda"])
@pytest.mark.parametrize("kind,arch", PLAN_CASES)
def test_plan_matches_reference(kind, arch, backend):
    """Banks, unpacked paths, bytes, packer cost and generation count equal
    the reference's on every port backend, both stopping on patience."""
    _, port = tree_of(kind, arch)
    want = ref_plans(kind, arch)
    got = plan_packing(port, max_seconds=MAX_SECONDS, split_stacked=True,
                       backend=backend, device="cpu")
    assert_patience_stop(want)
    assert_patience_stop(got)
    assert plan_key(got) == plan_key(want)
    assert got[4].packer_result.params["backend"] == backend


def test_plan_without_enough_candidates_packs_nothing():
    tree = {"w": torch.zeros(8, 128), "b": torch.zeros(3)}
    for p in (plan_packing(tree, device="cpu"), ref_plan_packing(
            {k: v.numpy() for k, v in tree.items()})):
        assert p[4].banks == [] and p[4].unpacked == ["b", "w"]
        assert p[4].padded_bytes_after == p[4].padded_bytes_before


def test_packing_never_increases_bytes():
    _, port = tree_of("smoke", "granite-moe-1b-a400m")
    for plan in plan_packing(port, max_seconds=MAX_SECONDS, split_stacked=True,
                             device="cpu").values():
        assert plan.padded_bytes_after <= plan.padded_bytes_before
        assert 0 < plan.efficiency_before() <= plan.efficiency_after() <= 1.0


def test_bank_cardinality():
    _, port = tree_of("smoke", "hymba-1.5b")
    plans = plan_packing(port, max_items=3, max_seconds=MAX_SECONDS,
                         split_stacked=True, device="cpu")
    assert plan_key(plans) == plan_key(ref_plans("smoke", "hymba-1.5b", max_items=3))
    for plan in plans.values():
        assert plan.banks
        for bank in plan.banks:
            assert len(bank) <= 3


# ------------------------------------------------------------ stores
def bank_segments(bank_entries, rows):
    """(R,) int32 segment ids of one bank: entry i's rows are i, the
    padding rows 0."""
    seg = np.zeros(rows, np.int32)
    for i, e in enumerate(bank_entries):
        seg[e.row_offset:e.row_offset + e.rows] = i
    return seg


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_store_matches_reference(arch):
    """Banks bit-equal to the reference's; every view, the unpacked tree,
    physical bytes and stats equal; the banks read through K6's CPU path
    within float32 rounding of the reference's jnp oracle."""
    ref, port = tree_of("smoke", arch)
    rstore = RefStore(ref, ref_plans("smoke", arch))
    store = PackedParameterStore(port, plan_packing(
        port, max_seconds=MAX_SECONDS, split_stacked=True, device="cpu"))
    assert store.banks.keys() == rstore.banks.keys()
    for k, bank in store.banks.items():
        assert bank.dtype == torch.float32
        np.testing.assert_array_equal(bank.numpy(), np.asarray(rstore.banks[k]))
    assert store.entries.keys() == rstore.entries.keys()
    assert store.plain.keys() == rstore.plain.keys()
    for path in list(store.entries) + list(store.plain):
        np.testing.assert_array_equal(store.view(path).numpy(),
                                      np.asarray(rstore.view(path)))
    got = dict(planner.leaves_with_paths(store.unpack()))
    want = dict(planner.leaves_with_paths(jax.device_get(rstore.unpack())))
    orig = dict(planner.leaves_with_paths(port))
    assert got.keys() == want.keys() == orig.keys()
    for p in got:
        assert torch.equal(got[p], orig[p])
        np.testing.assert_array_equal(got[p].numpy(), want[p])
    assert store.physical_bytes() == rstore.physical_bytes()
    assert store.stats() == rstore.stats()

    rng = np.random.default_rng(3)
    for (itemsize, bi), bank in store.banks.items():
        entries = store.plans[itemsize].banks[bi]
        seg = bank_segments(entries, bank.shape[0])
        x = rng.normal(size=(len(entries), bank.shape[1])).astype(np.float32)
        y = bank_matvec(bank, torch.from_numpy(x), torch.from_numpy(seg), backend="cuda")
        y_ref = np.asarray(jnp_packed_gather_ref(
            rstore.banks[(itemsize, bi)], jax.numpy.asarray(x), jax.numpy.asarray(seg)))
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
        for i, e in enumerate(entries):
            block = store.view(e.path).reshape(e.rows, e.cols)
            np.testing.assert_allclose(
                y[e.row_offset:e.row_offset + e.rows].numpy(),
                (block.double() @ torch.from_numpy(x[i, :e.cols]).double()).numpy(),
                rtol=1e-5, atol=1e-5)



def test_view_aliases_bank_and_store_keeps_leaves():
    """A packed view is a torch view of its bank (writing it writes the
    bank); plain tensors are the leaves themselves."""
    _, port = tree_of("smoke", "qwen2-0.5b")
    store = PackedParameterStore(port, plan_packing(
        port, max_seconds=MAX_SECONDS, split_stacked=True, device="cpu"))
    path, (itemsize, bi, e) = next(iter(store.entries.items()))
    v = store.view(path)
    assert v.shape == e.shape
    assert v.untyped_storage().data_ptr() == store.banks[(itemsize, bi)].untyped_storage().data_ptr()
    v.fill_(7.0)
    assert bool((store.banks[(itemsize, bi)][e.row_offset:e.row_offset + e.rows, :e.cols] == 7).all())
    orig = dict(planner.leaves_with_paths(port))
    assert all(store.plain[p] is orig[p] for p in store.plain)


def test_store_raises_on_mixed_dtypes_in_a_bank():
    tree = {"a": torch.zeros(1, 16, dtype=torch.float16), "b": torch.zeros(1, 16, dtype=torch.bfloat16)}
    plans = plan_packing(tree, device="cpu")
    assert len(plans[2].banks) == 1
    with pytest.raises(TypeError, match="bank 0"):
        PackedParameterStore(tree, plans)


def test_params_from_arrays_keeps_structure_values_and_dtypes():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "l": [np.ones(2, np.int32), (np.zeros(1, np.float16),)], "n": None}
    got = params_from_arrays(tree, device="cpu")
    assert got["a"].dtype == torch.float32 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert got["l"][0].dtype == torch.int32 and isinstance(got["l"][1], tuple)
    assert got["l"][1][0].dtype == torch.float16 and got["n"] is None


# ------------------------------------------------------------ chip_smoke
def test_chip_smoke_hymba_shapes_match_param_specs():
    """``chip_smoke.py`` carries hymba-1.5b's full-width parameter shapes as
    a literal (there is no JAX on the card's machine) and the reference's
    plan of them: both must equal the reference's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = [(p, tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in planner.leaves_with_paths(full_specs("hymba-1.5b"))]
    got = [(p, tuple(s), "float32") for p, s in mod.HYMBA_1_5B_SHAPES]
    assert got == want
    tree = mod.shape_tree(mod.HYMBA_1_5B_SHAPES, lambda shape: torch.empty(shape, device="meta"))
    assert planner._flatten_params(tree, split_stacked=True) == \
        ref_planner._flatten_params(full_specs("hymba-1.5b"), split_stacked=True)
    plan = ref_plans("full", "hymba-1.5b")[4]
    assert mod.HYMBA_REFERENCE_PLAN == dict(
        packed=sum(len(b) for b in plan.banks), banks=len(plan.banks),
        cost=plan.packer_result.cost, generations=plan.packer_result.iterations)
