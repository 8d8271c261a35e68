"""The port stands alone: it imports neither JAX nor the reference package,
runs on the CPU only when asked to, and gives no CUDA tensor to a plain
version."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro(\.|\s+import\b))",
    re.MULTILINE,
)


def test_port_sources_import_no_jax_and_no_reference():
    # the card-only test and the service's traffic CLI run where there is
    # no JAX, so they are held to the same rule
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
        ROOT / "tools" / "serve_traffic_torch.py",
    ]
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in FORBIDDEN.finditer(f.read_text())
    ]
    assert offenders == []
    # the pattern does catch what it must, and spares the port's own name
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import pack")
    assert FORBIDDEN.search("    import repro")
    assert not FORBIDDEN.search("from repro_torch.core import pack")
    assert not FORBIDDEN.search("import repro_torch")


def test_cpu_pack_loads_neither_jax_nor_reference(tmp_path):
    """`pack`, and the packing service (micro-batched solves, its result
    store, the traffic helpers) on top of it, import nothing of JAX or the
    reference."""
    code = (
        "import asyncio, sys\n"
        "import repro_torch.core as c\n"
        "import repro_torch.serve as s\n"
        "p = c.get_problem('CNV-W1A1', device='ZU7EV')\n"
        "r = c.pack(p, 'ga-nfd', device='cpu', max_generations=3, max_seconds=1e9)\n"
        "r = c.pack(p, 'sa-s', device='cpu', n_chains=2, max_iterations=20, max_seconds=1e9)\n"
        "r.solution.validate()\n"
        "async def serve():\n"
        f"    async with s.PackingService('sa-s', store_dir={str(tmp_path)!r}, device='cpu',\n"
        "                                n_chains=2, max_iterations=20, max_seconds=1e9) as svc:\n"
        "        w = s.make_workload(6, 2, rate_hz=1e4)\n"
        "        await s.run_traffic(svc, [p, c.get_problem('CNV-W2A2')], w)\n"
        "        return svc.stats()\n"
        "st = asyncio.run(serve())\n"
        "assert st['solved'] >= 1 and st['store']['entries'] == st['solved'], st\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_portfolio_loads_neither_jax_nor_reference():
    """The island portfolio (fused barriers on the torch backend, the
    numpy backend, racing) imports nothing of JAX or the reference."""
    code = (
        "import sys\n"
        "import repro_torch.core as c\n"
        "p = c.get_problem('CNV-W1A1', device='ZU7EV')\n"
        "kw = dict(device='cpu', n_islands=4, sa_chains=2, migration_every=16,\n"
        "          max_generations=3, max_iterations=40, max_seconds=1e9)\n"
        "r = c.pack(p, 'portfolio', **kw)\n"
        "assert r.params['fused'], r.params\n"
        "r.solution.validate()\n"
        "r = c.pack(p, 'portfolio', backend='python', auto=True, **kw)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_sweep_and_resume_load_neither_jax_nor_reference(tmp_path):
    """The DSE sweep, its checkpoints (the port's own tree flattening and
    bf16 codec, no JAX) and a resumed portfolio import nothing of JAX or
    the reference."""
    code = (
        "import sys, torch\n"
        "import repro_torch.core as c\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        f"ck = {str(tmp_path)!r}\n"
        "p = [c.get_problem('CNV-W1A1'), c.get_problem('CNV-W2A2', device='U50')]\n"
        "kw = dict(device='cpu', max_seconds=1e9, seeds=[0, 1])\n"
        "c.pack_sweep(p, 'sa-s', n_chains=2, max_iterations=40, checkpoint_dir=ck + '/s',\n"
        "             checkpoint_every=10, **kw)\n"
        "c.pack_sweep(p, 'ga-nfd', n_pop=6, max_generations=3, **kw)\n"
        "c.pack(p[0], 'portfolio', device='cpu', max_generations=2, max_iterations=20,\n"
        "       max_seconds=1e9, checkpoint_dir=ck + '/p')\n"
        "m = CheckpointManager(ck + '/m', async_save=False)\n"
        "m.save(1, {'x': torch.ones(2, dtype=torch.bfloat16)})\n"
        "assert m.restore({'x': torch.zeros(2, dtype=torch.bfloat16)})[1]['x'].dtype == torch.bfloat16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_memory_planner_loads_neither_jax_nor_reference():
    """The memory planner, its store and K6's CPU path import nothing of
    JAX or the reference."""
    code = (
        "import sys\n"
        "import torch\n"
        "from repro_torch.memory import PackedParameterStore, plan_packing\n"
        "from repro_torch.kernels.packed_gather import bank_matvec\n"
        "g = torch.Generator().manual_seed(0)\n"
        "tree = {'embed': torch.randn(64, 256, generator=g),\n"
        "        'layers': {'w': torch.randn(3, 24, 40, generator=g),\n"
        "                   'b': torch.randn(3, 40, generator=g)}}\n"
        "plans = plan_packing(tree, split_stacked=True, max_seconds=600, device='cpu')\n"
        "store = PackedParameterStore(tree, plans)\n"
        "assert plans[4].banks\n"
        "for bank in store.banks.values():\n"
        "    y = bank_matvec(bank, torch.ones(1, bank.shape[1]),\n"
        "                    torch.zeros(bank.shape[0], dtype=torch.int32))\n"
        "    assert torch.allclose(y, bank.sum(1), atol=1e-4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_never_falls_back():
    import numpy as np

    import repro_torch.core as c
    from repro_torch.convert import params_from_arrays
    from repro_torch.device import resolve_backend, resolve_device
    from repro_torch.memory import plan_packing

    prob = c.get_problem("CNV-W1A1")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for call in (
            lambda: c.pack(prob),
            lambda: c.pack(prob, "nfd"),
            lambda: c.make_packer("sa-s"),
            lambda: c.pack(prob, "portfolio"),
            lambda: c.pack_portfolio(prob),
            lambda: resolve_device("cuda:0"),
            lambda: plan_packing({"a": torch.zeros(1, 3), "b": torch.zeros(2)}),
            lambda: params_from_arrays({"a": np.zeros(3)}),
        ):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    cpu = torch.device("cpu")
    assert resolve_backend("auto", cpu) == "torch"
    assert resolve_backend("auto", torch.device("cuda")) == "cuda"
    assert resolve_backend("cuda", cpu) == "cuda"
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        resolve_backend("pallas", cpu)


def test_kernels_build_nothing_at_import():
    """Importing the port never touches nvcc or the build directory."""
    code = (
        "import repro_torch.core, repro_torch.kernels.binpack_fitness, "
        "repro_torch.kernels.binpack_sa_step, "
        "repro_torch.kernels.binpack_portfolio_step, repro_torch.memory, "
        "repro_torch.kernels.packed_gather, repro_torch.convert\n"
        "from repro_torch.kernels import build\n"
        "assert build._LIBS == {}\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
