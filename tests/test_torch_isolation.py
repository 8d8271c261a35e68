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
    # the card-only test runs where there is no JAX, so it is held to the same rule
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
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


def test_cpu_pack_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.core as c\n"
        "p = c.get_problem('CNV-W1A1', device='ZU7EV')\n"
        "r = c.pack(p, 'ga-nfd', device='cpu', max_generations=3, max_seconds=1e9)\n"
        "r = c.pack(p, 'sa-s', device='cpu', n_chains=2, max_iterations=20, max_seconds=1e9)\n"
        "r.solution.validate()\n"
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
    import repro_torch.core as c
    from repro_torch.device import resolve_backend, resolve_device

    prob = c.get_problem("CNV-W1A1")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for call in (
            lambda: c.pack(prob),
            lambda: c.pack(prob, "nfd"),
            lambda: c.make_packer("sa-s"),
            lambda: resolve_device("cuda:0"),
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
        "repro_torch.kernels.binpack_sa_step\n"
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
