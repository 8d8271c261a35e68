"""What the harness and its reference load, and how the harness refuses to
run without a card."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PB).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in tops and "torch" not in tops


def _fresh(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_reference_loads_nothing_of_the_program():
    p = _fresh("import sys, json\n"
               "import perfbench.reference.search, perfbench.reference.problem\n"
               "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"repro_torch", "torch"})


def test_a_run_loads_no_jax():
    """A whole (small, CPU) run of every cell in one fresh process, then the
    harness's own look at ``sys.modules``."""
    p = _fresh(
        "import json, sys, time\n"
        "from perfbench import bench\n"
        "from perfbench.test_perfbench_faults import shrink\n"
        "for c in [w['name'] for w in bench.load_manifest()['workloads']]:\n"
        "    r = bench.run_cell(c, 3, 0.2, True, 'cpu', time.perf_counter(),\n"
        "                       traffic_override=shrink, log=lambda m: None)\n"
        "    assert r['correct'], c\n"
        "print(json.dumps(bench.forbidden_modules()))")
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


def _run_py(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "bram18.pack-ga", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    import torch

    if not torch.cuda.is_available():
        p = _run_py(ROOT)
        assert p.returncode != 0 and not p.stdout.strip()
        assert "CUDA" in p.stderr
    # a checkout that holds only the benchmark's own files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.gpu
def test_a_cell_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "bram18.sweep-sa", "--seed",
         str(2**31 + 7), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
