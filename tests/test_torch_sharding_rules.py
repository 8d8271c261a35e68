"""The port's partition-spec tables (`repro_torch.sharding.rules`) against
the reference's, leaf for leaf.

For every arch and both production meshes ((16, 16) ("data", "model")
and (2, 16, 16) ("pod", "data", "model")), every leaf of the parameter,
optimizer-state, batch and cache trees gets the same spec from both
packages.  The reference's rules run on a ``jax.sharding.AbstractMesh``
over its ``eval_shape`` trees; the port's on the mesh's axis sizes over
its meta trees.  `to_placements` is then checked on a fake production
mesh: each spec becomes the DTensor placements that name the same axes.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

import repro.launch.specs as ref_specs
import repro.sharding.rules as ref_rules
import repro_torch.launch.specs as port_specs
import repro_torch.sharding.rules as port_rules
from repro.configs import ARCHS, get_config, shape_cells
from repro.models.config import SHAPES
from repro_torch.configs import get_config as port_config

MESHES = {
    "pod1": ((16, 16), ("data", "model")),
    "pod2": ((2, 16, 16), ("pod", "data", "model")),
}


def _norm(spec) -> tuple:
    """Entries as tuples of axis names (None for replicated), trailing
    replicated dims dropped: the form both packages' specs compare in."""
    out = [None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): _norm(leaf)
        for path, leaf in flat
    }


def _port_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: _norm(tree)}


@pytest.fixture(scope="module")
def ref_params():
    return {arch: ref_specs.param_specs(get_config(arch)) for arch in ARCHS}


@pytest.mark.parametrize("pods", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, pods, ref_params):
    sizes, names = MESHES[pods]
    amesh = AbstractMesh(sizes, names)
    axes = dict(zip(names, sizes))
    cfg, pcfg = get_config(arch), port_config(arch)
    rp = ref_params[arch]
    pp = port_specs.param_specs(pcfg)
    want = _ref_leaves(ref_rules.param_partition_specs(cfg, amesh, rp))
    got = _port_leaves(port_rules.param_partition_specs(pcfg, axes, pp))
    assert got == want
    ro = ref_specs.opt_specs(rp)
    po = port_specs.opt_specs(pp)
    want = _ref_leaves(ref_rules.opt_partition_specs(cfg, amesh, ro))
    got = _port_leaves(port_rules.opt_partition_specs(pcfg, axes, po))
    assert got == want
    assert port_rules.dp_axes(axes) == ref_rules.dp_axes(amesh)


@pytest.mark.parametrize("pods", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, pods):
    sizes, names = MESHES[pods]
    amesh = AbstractMesh(sizes, names)
    axes = dict(zip(names, sizes))
    cfg, pcfg = get_config(arch), port_config(arch)
    for shape_name in shape_cells(arch):
        shape = SHAPES[shape_name]
        ri = ref_specs.input_specs(cfg, shape_name)
        pi = port_specs.input_specs(pcfg, shape_name)
        if shape.kind in ("train", "prefill"):
            want = _ref_leaves(ref_rules.batch_partition_specs(cfg, amesh, ri["batch"]))
            got = _port_leaves(port_rules.batch_partition_specs(pcfg, axes, pi["batch"]))
            assert got == want, shape_name
        if shape.kind in ("prefill", "decode"):
            rc = ref_specs.cache_specs(cfg, shape)
            pc = port_specs.cache_specs(pcfg, shape)
            want = _ref_leaves(ref_rules.cache_partition_specs(cfg, amesh, rc))
            got = _port_leaves(port_rules.cache_partition_specs(pcfg, axes, pc))
            assert got == want, shape_name
        if shape.kind == "decode":
            tok = {"t": ri["token"]}
            want = _ref_leaves(ref_rules.batch_partition_specs(cfg, amesh, tok))
            got = _port_leaves(port_rules.batch_partition_specs(
                pcfg, axes, {"t": pi["token"]}))
            assert got == want, shape_name


def test_placements_name_the_spec_axes():
    """On a fake production mesh, each spec's placements shard tensor dim
    d over exactly the mesh axes its entry names."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        cfg = port_config("qwen3-14b")
        specs = port_rules.param_partition_specs(cfg, mesh, port_specs.param_specs(cfg))
        pl = port_rules.to_placements(mesh, specs)
        assert pl["embed"] == [Replicate(), Replicate(), Shard(0)]
        assert pl["layers"]["attn"]["q"]["kernel"] == [Replicate(), Replicate(), Shard(2)]
        assert pl["final_norm"]["scale"] == [Replicate()] * 3
        batch = port_rules.batch_partition_specs(
            cfg, mesh, port_specs.input_specs(cfg, "train_4k")["batch"])
        assert port_rules.to_placements(mesh, batch)["tokens"] == [Shard(0), Shard(0), Replicate()]
        cache = port_rules.cache_partition_specs(
            cfg, mesh, port_specs.cache_specs(cfg, SHAPES["long_500k"]))
        # a single long sequence: the cache's sequence over data and model
        assert port_rules.to_placements(mesh, cache)["k"] == [Replicate(), Shard(2), Shard(2)]
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def test_prob_axis_rule_is_stated_once():
    """The sweep axis stays `kernels.probshard.row_shard`'s rule: the tables
    have no second one."""
    assert not hasattr(port_rules, "prob_axis_spec")
    import repro_torch.kernels.probshard as probshard

    assert callable(probshard.row_shard)
