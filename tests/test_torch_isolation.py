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
    # the card-only test, the port's CLIs and its examples run where there
    # is no JAX, so they are held to the same rule
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
        ROOT / "tools" / "serve_traffic_torch.py",
        ROOT / "tools" / "sweep_resume_torch.py",
        ROOT / "tools" / "portfolio_gate_torch.py",
        ROOT / "tools" / "cold_threads_torch.py",
        ROOT / "examples" / "serve_packed_torch.py",
        ROOT / "examples" / "quickstart_torch.py",
        ROOT / "examples" / "dse_loop_torch.py",
        ROOT / "examples" / "train_lm_torch.py",
    ]
    assert len(files) > 10
    assert all(f.is_file() for f in files)
    for sub in ("data", "models", "configs", "optim", "runtime"):
        assert (ROOT / "src" / "repro_torch" / sub / "__init__.py") in files
    for name in ("adamw.py",):
        assert (ROOT / "src" / "repro_torch" / "optim" / name) in files
    for name in ("steps.py", "loop.py"):
        assert (ROOT / "src" / "repro_torch" / "runtime" / name) in files
    for name in ("train.py", "decode_demo.py", "specs.py", "dryrun.py",
                 "op_analysis.py", "report.py"):
        assert (ROOT / "src" / "repro_torch" / "launch" / name) in files
    for name in ("__init__.py", "rules.py"):
        assert (ROOT / "src" / "repro_torch" / "sharding" / name) in files
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
    """`pack`, a sharded sweep on a sweep mesh, and the packing service
    (micro-batched solves, its result store, the traffic helpers) on top of
    it, import nothing of JAX or the reference."""
    code = (
        "import asyncio, sys, torch\n"
        "import repro_torch.core as c\n"
        "import repro_torch.serve as s\n"
        "from repro_torch.launch import SweepMesh\n"
        "p = c.get_problem('CNV-W1A1', device='ZU7EV')\n"
        "r = c.pack(p, 'ga-nfd', device='cpu', max_generations=3, max_seconds=1e9)\n"
        "r = c.pack(p, 'sa-s', device='cpu', n_chains=2, max_iterations=20, max_seconds=1e9)\n"
        "r.solution.validate()\n"
        "mesh = SweepMesh([torch.device('cpu')] * 2)\n"
        "sw = c.pack_sweep([p, c.get_problem('CNV-W2A2', device='ZU7EV')], 'sa-s',\n"
        "                  device='cpu', n_shards=2, mesh=mesh, n_chains=2,\n"
        "                  max_iterations=20, max_seconds=1e9)\n"
        "assert sw.params['n_shards'] == 2 and len(sw.results) == 2\n"
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


def test_cpu_lm_serving_loads_neither_jax_nor_reference():
    """The data pipeline, the configs, the model and ``decode_demo --packed``
    (the planner, the store, the served tree) import nothing of JAX or the
    reference."""
    code = (
        "import sys\n"
        "from repro_torch.data import DataConfig, SyntheticTokenPipeline\n"
        "from repro_torch.launch import decode_demo\n"
        "import repro_torch.configs as cf\n"
        "b = SyntheticTokenPipeline(DataConfig(seq_len=64, global_batch=2), device='cpu').next_batch()\n"
        "assert b['tokens'].shape == (2, 64)\n"
        "assert cf.get_config('qwen3-0.6b').param_count() > 5e8\n"
        "gen = decode_demo.main(['--arch', 'hymba-1.5b', '--batch', '2', '--prompt-len', '8',\n"
        "                        '--gen-len', '3', '--packed', '--device', 'cpu'])\n"
        "assert gen.shape == (2, 3)\n"
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
    assert out.stdout.strip().endswith("ok")


def test_cpu_lm_training_loads_neither_jax_nor_reference(tmp_path):
    """The training launcher (loss, autograd, AdamW, the loop and its
    checkpoints, a resume) and the port's resume CLI import nothing of JAX
    or the reference."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        f"args = ['--steps', '2', '--batch', '2', '--seq', '32', '--ckpt-every', '1',\n"
        f"        '--ckpt-dir', {str(tmp_path / 'ck')!r}, '--device', 'cpu']\n"
        "assert len(train.main(args)) == 2\n"
        "assert len(train.main(args[:1] + ['3'] + args[2:] + ['--resume'])) == 1\n"
        "sys.path.insert(0, 'tools')\n"
        "import sweep_resume_torch as sr\n"
        f"assert sr.main(['--dir', {str(tmp_path / 'sw')!r}, '--device', 'cpu',\n"
        "                '--max-iterations', '40']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    import numpy as np

    import repro_torch.core as c
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_arrays
    from repro_torch.launch import train
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init
    from repro_torch.device import resolve_backend, resolve_device
    from repro_torch.memory import plan_packing

    prob = c.get_problem("CNV-W1A1")
    cfg = get_smoke_config("qwen3-0.6b")
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
            lambda: adamw_init(TM.init_params(cfg)),
            lambda: train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)]),
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
        "assert build.KERNELS.loaded == {}\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_cpu_baselines_and_dryrun_load_neither_jax_nor_reference(tmp_path):
    """The ``legacy`` backend, the thread-pool portfolio and its gate, and
    the production-mesh dry run (specs, sharding rules, cost model, a
    smoke cell on a fake mesh, the report) import nothing of JAX or the
    reference."""
    code = (
        "import importlib.util, sys, dataclasses\n"
        "import repro_torch.core as c\n"
        "p = c.get_problem('CNV-W1A1')\n"
        "r = c.pack(p, 'ga-nfd', backend='legacy', device='cpu', max_generations=2,\n"
        "           max_seconds=1e9)\n"
        "assert r.params['backend'] == 'legacy'\n"
        "r = c.pack_portfolio_threads(p, n_islands=2, max_seconds=0.3, backend='torch',\n"
        "                             sa_chains=2, device='cpu')\n"
        f"spec = importlib.util.spec_from_file_location('g', {str(ROOT / 'tools' / 'portfolio_gate_torch.py')!r})\n"
        "g = importlib.util.module_from_spec(spec); spec.loader.exec_module(g)\n"
        "assert g.parse_args([]).backend == 'cuda'\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch import dryrun, report, specs, op_analysis\n"
        "from repro_torch.launch.mesh import make_fake_mesh\n"
        "from repro_torch.models.config import SHAPES\n"
        "import repro_torch.sharding as sh\n"
        "mesh = make_fake_mesh((2, 2), ('data', 'model'), device='cpu')\n"
        "shape = dataclasses.replace(SHAPES['train_4k'], seq_len=32, global_batch=4)\n"
        "counter, mem = dryrun.trace_step(get_smoke_config('qwen3-0.6b'), shape, mesh, 'cpu')\n"
        "assert counter.cost.flops > 0\n"
        f"report.main(['--dir', {str(tmp_path)!r}])\n"
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
    assert out.stdout.strip().splitlines()[-1] == "ok"
