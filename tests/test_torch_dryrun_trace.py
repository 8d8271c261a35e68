"""The port's production-mesh dry run traced on fake meshes
(`repro_torch.launch.dryrun`): smoke configs trace ``ok`` on a small fake
mesh and on the fake 16 x 16 production mesh (full configurations are
traced on the card's machine, not here).  A cell's record and the report:
`test_torch_dryrun_report.py`."""
import dataclasses

import pytest

import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import SHAPES


@pytest.fixture
def fresh_world():
    """Whatever process group a test makes is torn down after it."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _cut(shape_name):
    """A smoke cell's shape: the cell's kind at a batch the 16-way data
    axis divides and a short sequence."""
    return dataclasses.replace(SHAPES[shape_name], seq_len=64, global_batch=32)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (16, 16)])
def test_smoke_configs_trace_ok_on_fake_meshes(mesh_shape, fresh_world):
    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh(mesh_shape, ("data", "model"), device="cpu")
    archs = ("qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-1.3b")
    for arch in archs:
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            counter, memory = dryrun.trace_step(
                get_smoke_config(arch), _cut(shape_name), mesh, "cpu")
            assert counter.cost.flops > 0 and counter.n_ops > 0, (arch, shape_name)
            assert memory["argument_bytes"] > 0 and memory["temp_bytes"] > 0
            if mesh_shape == (16, 16) and shape_name == "train_4k":
                # the gradient's data-parallel reduction crosses ranks
                assert counter.cost.coll_bytes > 0
