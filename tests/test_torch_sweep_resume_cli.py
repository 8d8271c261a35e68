"""The port's preemptible sweep CLI (``tools/sweep_resume_torch.py``) as a
real process: SIGKILLed right after its second durable snapshot, then
resumed, its parity record must equal an uninterrupted run's and the
reference CLI's (``tools/sweep_resume.py``) for the same arguments; and the
port's examples (``examples/*_torch.py``) on the CPU at a cut budget, each
raising where CUDA is absent unless given ``--device cpu``."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
BUDGETS = {
    "sa-s": ["--max-iterations", "600", "--checkpoint-every", "100"],
    "ga-nfd": ["--max-generations", "8", "--checkpoint-every", "2"],
}


def _run(script, *args, timeout=240):
    return subprocess.run(
        [sys.executable, str(ROOT / script), *args], env=ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("algorithm", ["sa-s", "ga-nfd"])
def test_killed_and_resumed_cli_equals_uninterrupted_and_reference(tmp_path, algorithm):
    common = ["--mode", "sweep", "--problems", "CNV-W1A1,CNV-W2A2",
              "--algorithm", algorithm, *BUDGETS[algorithm]]
    port = [*common, "--device", "cpu"]
    full = _run("tools/sweep_resume_torch.py", *port, "--dir", str(tmp_path / "full"),
                "--out", str(tmp_path / "full.json"))
    assert full.returncode == 0, full.stderr
    killed = _run("tools/sweep_resume_torch.py", *port, "--dir", str(tmp_path / "ck"),
                  "--die-at-checkpoint", "2")
    assert killed.returncode == -signal.SIGKILL, (killed.returncode, killed.stderr)
    assert not (tmp_path / "resumed.json").exists()
    resumed = _run("tools/sweep_resume_torch.py", *port, "--dir", str(tmp_path / "ck"),
                   "--resume", "--out", str(tmp_path / "resumed.json"))
    assert resumed.returncode == 0, resumed.stderr
    ref = _run("tools/sweep_resume.py", *common, "--dir", str(tmp_path / "ref"),
               "--out", str(tmp_path / "ref.json"))
    assert ref.returncode == 0, ref.stderr
    records = {name: json.loads((tmp_path / f"{name}.json").read_text())
               for name in ("full", "resumed", "ref")}
    assert records["resumed"] == records["full"] == records["ref"]
    assert records["full"]["algorithm"] == algorithm
    assert len(records["full"]["candidates"]) == 2


def test_cli_portfolio_mode_and_backends_agree(tmp_path):
    """Portfolio mode, and the sweep on each of the port's backends, give
    one record per mode."""
    args = ["--problems", "CNV-W1A1", "--max-iterations", "200", "--max-generations", "3",
            "--device", "cpu"]
    outs = []
    for mode, backend in (("sweep", "python"), ("sweep", "torch"), ("sweep", "cuda"),
                          ("portfolio", "python"), ("portfolio", "auto")):
        out = tmp_path / f"{mode}-{backend}.json"
        run = _run("tools/sweep_resume_torch.py", *args, "--mode", mode, "--backend",
                   backend, "--dir", str(tmp_path / f"ck-{mode}-{backend}"),
                   "--out", str(out))
        assert run.returncode == 0, run.stderr
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1] == outs[2]
    assert outs[3] == outs[4] and outs[3]["mode"] == "portfolio"


def test_cli_raises_without_cuda_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = _run("tools/sweep_resume_torch.py", "--dir", str(tmp_path / "ck"),
               "--max-iterations", "20")
    assert run.returncode != 0 and "CUDA is not available" in run.stderr


@pytest.mark.parametrize("script, args, expect", [
    ("examples/quickstart_torch.py", ["--max-generations", "3"], "GA-NFD: cost="),
    ("examples/dse_loop_torch.py", ["--max-iterations", "60"], "re-sweep: sweep[sa-s]"),
    ("examples/train_lm_torch.py",
     ["--steps", "2", "--batch", "2", "--seq", "64", "--d-model", "64", "--layers", "2"],
     "done at step 2"),
])
def test_examples_run_on_the_cpu_and_raise_without_cuda(tmp_path, script, args, expect):
    extra = ["--ckpt-dir", str(tmp_path / "ck")] if "train_lm" in script else []
    run = _run(script, *args, *extra, "--device", "cpu")
    assert run.returncode == 0, run.stderr
    assert expect in run.stdout
    if not torch.cuda.is_available():
        run = _run(script, *args, *extra)
        assert run.returncode != 0 and "CUDA is not available" in run.stderr
