"""`repro_torch.core.pack` on the CPU against `repro.core.pack`, bit for bit
(the GA engines here; the SA engines in ``test_torch_engines_sa.py``).

Every case runs the reference through its jnp backend (``"ref"``, the one
the reference's batched engines use off-TPU) and its host backend
(``"python"``), and the port through ``torch`` (plain PyTorch versions),
``cuda`` (the kernel wrappers, which take the plain versions for CPU
tensors) and ``python``.  All must agree on cost, bins, kind lanes,
iterations and the trace's cost sequence; wall times, trace times and
``params["backend"]`` are not compared.  Budgets are iteration counts,
never wall clock.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port

CASES = [
    ("ga-nfd", dict(max_generations=20)),
    ("ga-s", dict(max_generations=20)),
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(r):
    return (
        r.cost,
        [list(b) for b in r.solution.bins],
        [int(k) for k in r.solution.kinds],
        r.iterations,
        [c for _, c in r.trace],
        r.algorithm,
    )


def check_against_reference(algorithm, name, device, ref_backends, kw):
    """Every reference backend agrees; every port backend equals them."""
    ref_prob = ref.get_problem(name, device=device)
    expect = [_key(ref.pack(ref_prob, algorithm, backend=b, **kw)) for b in ref_backends]
    assert all(e == expect[0] for e in expect), ref_backends
    for backend in ("torch", "cuda", "python"):
        r = port.pack(port.get_problem(name, device=device), algorithm,
                      backend=backend, device="cpu", **kw)
        assert _key(r) == expect[0], backend
        r.solution.validate()
        assert r.solution.cost() == r.solution.cost_full() == r.cost
        if algorithm != "sa-nfd":  # the scalar loop takes no backend
            assert r.params["backend"] == backend


@pytest.mark.parametrize("device", [None, "ZU7EV"])
@pytest.mark.parametrize("name", ["CNV-W1A1", "RN50-W1A2"])
@pytest.mark.parametrize("algorithm,budget", CASES, ids=["ga-nfd", "ga-s"])
def test_pack_bit_identical_to_reference(algorithm, budget, name, device):
    # a small population: the point is parity, not quality
    kw = dict(ref.hyperparams(name), seed=7, max_seconds=1e9, n_pop=16, **budget)
    check_against_reference(algorithm, name, device, ("ref", "python"), kw)


def test_auto_backend_on_cpu_is_torch():
    prob = port.get_problem("CNV-W1A1")
    for algorithm, budget in (("ga-nfd", dict(max_generations=3)),
                              ("sa-s", dict(max_iterations=50, n_chains=2))):
        r = port.pack(prob, algorithm, device="cpu", max_seconds=1e9, **budget)
        assert r.params["backend"] == "torch"


def test_warm_starts_match_reference():
    """Warm-started GA (population) and multi-chain SA (chains) follow the
    reference's trajectories when handed the same packings."""
    from repro_torch.convert import solution_from_state

    pa, pb = ref.get_problem("CNV-W2A2"), port.get_problem("CNV-W2A2")
    init_a = [ref.nfd_from_scratch(pa, np.random.default_rng(s)) for s in range(3)]
    init_b = [solution_from_state(pb, s.state_dict()) for s in init_a]
    a = ref.make_packer("ga-s", seed=4, backend="python", n_pop=8,
                        max_generations=10, max_seconds=1e9).pack(pa, init_pop=init_a)
    b = port.make_packer("ga-s", seed=4, backend="torch", n_pop=8, device="cpu",
                         max_generations=10, max_seconds=1e9).pack(pb, init_pop=init_b)
    assert _key(a) == _key(b)
    a = ref.make_packer("sa-s", seed=4, backend="python", n_chains=3,
                        max_iterations=150, max_seconds=1e9).pack(pa, init_a)
    b = port.make_packer("sa-s", seed=4, backend="cuda", n_chains=3, device="cpu",
                         max_iterations=150, max_seconds=1e9).pack(pb, init_b)
    assert _key(a) == _key(b)


def test_portfolio_and_legacy_wait_for_later_slices():
    prob = port.get_problem("CNV-W1A1")
    with pytest.raises(NotImplementedError, match="portfolio"):
        port.pack(prob, "portfolio", device="cpu")
    with pytest.raises(ValueError, match="legacy"):
        port.pack(prob, "ga-nfd", backend="legacy", device="cpu")
    assert "portfolio" not in port.ALGORITHMS
