"""A dry-run cell's record and the report (`repro_torch.launch.dryrun`,
`launch.report`): a smoke config's cell on both production meshes, a
failing cell recorded with its operation, the report read back, and
results in ``experiments/dryrun_torch/`` only (the reference's
``experiments/dryrun/`` is never created)."""
import dataclasses
import json
from pathlib import Path

import pytest

import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]


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


def test_cell_record_and_report(tmp_path, monkeypatch, capsys, fresh_world):
    """`run_cell` on a smoke config (both production meshes, so the world
    is rebuilt between them) writes an ``ok`` record with the reference's
    keys; a failing cell is recorded with its operation; the report reads
    them back; nothing lands in ``experiments/dryrun/``."""
    ref_dir = ROOT / "experiments" / "dryrun"
    existed = ref_dir.exists()
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", {"train_4k": _cut("train_4k"),
                                           "decode_32k": _cut("decode_32k")})
    for multi_pod in (False, True):
        r = dryrun.run_cell("qwen3-0.6b", "train_4k", multi_pod, force=True, device="cpu")
        assert r["status"] == "ok", r.get("error")
        assert r["n_devices"] == (512 if multi_pod else 256)
        for key in ("flops_per_device", "bytes_per_device", "collective_operand_bytes",
                    "collectives_by_op", "roofline", "memory", "n_params",
                    "model_flops_global", "useful_flops_ratio"):
            assert key in r
        assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert r["roofline"]["compute_s"] > 0 and r["roofline"]["memory_s"] > 0
    # a cached record is read back, not traced again
    again = dryrun.run_cell("qwen3-0.6b", "train_4k", False, device="cpu")
    assert again == json.loads(dryrun.cell_path("qwen3-0.6b", "train_4k", False).read_text())

    def broken(*a, **k):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    bad = dryrun.run_cell("qwen3-0.6b", "decode_32k", False, force=True, device="cpu")
    assert bad["status"] == "error" and "no sharding rule" in bad["error"]
    assert "op" in bad and "placements" in bad

    from repro_torch.launch import report

    report.main(["--dir", str(tmp_path / "dryrun_torch")])
    out = capsys.readouterr().out
    assert "1/2 cells ok (pods=1)" in out and "FAIL" in out
    report.main([])
    assert "cells ok" in capsys.readouterr().out
    assert dryrun.OUT_DIR.name == "dryrun_torch"
    assert ref_dir.exists() == existed
