"""The port's CUDA kernels K1-K4 on a card, exactly equal to their plain
PyTorch versions on the same card tensors.

Imports neither JAX nor the reference package, so it runs on a GPU host
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Skips where ``torch.cuda.is_available()`` is False.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.problem import BRAM18, BRAM18_MODES, URAM288
from repro_torch.kernels.binpack_fitness import (
    binpack_fitness_cuda,
    binpack_fitness_kinds_cuda,
    binpack_fitness_kinds_ref,
    binpack_fitness_ref,
)
from repro_torch.kernels.binpack_sa_step import (
    sa_step_deltas_cuda,
    sa_step_deltas_kinds_cuda,
    sa_step_deltas_kinds_ref,
    sa_step_deltas_ref,
)

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))


def _planes(rng, shape, device):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, 2, shape).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (w, h, k)]


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """K1-K4 built from csrc/ and launched on the card, exactly equal to the
    plain versions, each launched once per case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    for p, nb in [(1, 1), (75, 2253), (13, 300)]:
        w, h, k = _planes(rng, (p, nb), dev)
        assert torch.equal(binpack_fitness_cuda(w, h, BRAM18_MODES),
                           binpack_fitness_ref(w, h, BRAM18_MODES).sum(1))
        assert torch.equal(binpack_fitness_kinds_cuda(w, h, k, U50_TABLES),
                           binpack_fitness_kinds_ref(w, h, k, U50_TABLES).sum(1))
    for c, t in [(1, 1), (64, 4), (9, 130)]:
        old = _planes(rng, (c, t), dev)
        new = _planes(rng, (c, t), dev)
        assert torch.equal(
            sa_step_deltas_cuda(old[0], old[1], new[0], new[1], BRAM18_MODES),
            sa_step_deltas_ref(old[0], old[1], new[0], new[1], BRAM18_MODES),
        )
        args = (old[0], old[1], old[2], new[0], new[1], new[2], U50_TABLES)
        assert torch.equal(sa_step_deltas_kinds_cuda(*args), sa_step_deltas_kinds_ref(*args))
    assert all(n == 3 for n in kernels.launch_counts().values())
