"""`repro_torch.core.pack` on the CPU against `repro.core.pack`, bit for bit:
the SA engines (scalar loop, single-chain and multi-chain delta engines).
Same contract and helpers as ``test_torch_engines.py``."""
import pytest

from test_torch_engines import check_against_reference, one_torch_thread  # noqa: F401

import repro.core as ref

CASES = [
    ("sa-nfd", dict(max_iterations=300)),
    ("sa-s", dict(max_iterations=300)),
    ("sa-s", dict(max_iterations=300, n_chains=5)),
]


@pytest.mark.parametrize("device", [None, "ZU7EV"])
@pytest.mark.parametrize("name", ["CNV-W1A1", "RN50-W1A2"])
@pytest.mark.parametrize("algorithm,budget", CASES, ids=["sa-nfd", "sa-s-x1", "sa-s-x5"])
def test_pack_bit_identical_to_reference(algorithm, budget, name, device):
    kw = dict(ref.hyperparams(name), seed=7, max_seconds=1e9, **budget)
    # the scalar loop (sa-nfd) ignores the backend: one reference run
    ref_backends = ("python",) if algorithm == "sa-nfd" else ("ref", "python")
    check_against_reference(algorithm, name, device, ref_backends, kw)
