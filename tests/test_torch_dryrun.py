"""The port's production-mesh dry run (`repro_torch.launch.specs`,
`launch.dryrun`, `launch.report`) against the reference's.

* the stand-in inputs, parameters, optimizer state and caches have the
  reference's ``eval_shape`` shapes and dtypes, leaf for leaf, for every
  (arch x shape) cell;
* parameter counts and the analytic model FLOPs equal the reference's
  exactly (the reference's run in a child process: importing its dry run
  forces 512 host devices on the process's JAX);
* (`test_torch_dryrun_trace.py`: smoke configs traced on fake meshes, a
  cell's record and the report.)
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import repro.launch.specs as ref_specs
import repro_torch.launch.dryrun as dryrun
import repro_torch.launch.specs as port_specs
from repro.configs import ARCHS, get_config, shape_cells
from repro.models.config import SHAPES
from repro_torch.configs import get_config as port_config

ROOT = Path(__file__).resolve().parents[1]


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
        for path, leaf in flat
    }


def _port_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    assert tree.device.type == "meta"
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference_eval_shape(arch):
    for serving in (False, True):
        cfg = get_config(arch)
        pcfg = port_config(arch)
        if serving:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
            pcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
        rp, pp = ref_specs.param_specs(cfg), port_specs.param_specs(pcfg)
        assert _port_leaves(pp) == _ref_leaves(rp)
        assert _port_leaves(port_specs.opt_specs(pp)) == _ref_leaves(ref_specs.opt_specs(rp))
        for shape_name in shape_cells(arch):
            shape = SHAPES[shape_name]
            want = _ref_leaves(ref_specs.input_specs(cfg, shape_name))
            assert _port_leaves(port_specs.input_specs(pcfg, shape_name)) == want
            if shape.kind != "train":
                want = _ref_leaves(ref_specs.cache_specs(cfg, shape))
                assert _port_leaves(port_specs.cache_specs(pcfg, shape)) == want
    assert (port_specs.WHISPER_DECODER_TRAIN_LEN, port_specs.WHISPER_DECODER_PROMPT) == (
        ref_specs.WHISPER_DECODER_TRAIN_LEN, ref_specs.WHISPER_DECODER_PROMPT)


_REF_COUNTS = """
import json, math
import jax
from repro.configs import ARCHS, get_config, shape_cells
from repro.launch.dryrun import _model_flops
from repro.launch.specs import param_specs
from repro.models.config import SHAPES
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    n_total = int(sum(math.prod(x.shape) for x in jax.tree.leaves(param_specs(cfg))))
    expert = (cfg.n_layers * cfg.n_experts * (3 if cfg.mlp_gated else 2)
              * cfg.d_model * cfg.d_ff if cfg.n_experts else 0)
    active_expert = (cfg.n_layers * cfg.top_k * (3 if cfg.mlp_gated else 2)
                     * cfg.d_model * cfg.d_ff * cfg.capacity_factor if cfg.n_experts else 0)
    n_active = n_total - expert + active_expert
    for shape in shape_cells(arch):
        out[arch + "/" + shape] = [n_total, int(n_active),
                                   _model_flops(cfg, SHAPES[shape], n_total, n_active)]
print(json.dumps(out))
"""


def test_param_counts_and_model_flops_equal_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_COUNTS], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(want) == 32
    for key, (n_total, n_active, mf) in want.items():
        arch, shape = key.split("/")
        cfg = port_config(arch)
        got_total, got_active = dryrun.param_counts(cfg)
        assert (got_total, int(got_active)) == (n_total, n_active), key
        assert dryrun._model_flops(cfg, SHAPES[shape], got_total, got_active) == mf, key
