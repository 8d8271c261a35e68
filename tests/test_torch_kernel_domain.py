"""The kernels' input domain, ``w, h >= 0`` (int32), as the engines use it.

K1-K5 cost an empty slot (``w == 0``) as 0 and are exact for every
non-negative int32 geometry; a negative height is outside their domain
(the CUDA bodies and the plain versions may disagree there, and no device
check guards it).  This test records every plane the GA, SA and portfolio
engines hand to the ops layers on the CPU, on RN152-W1A2 and on its U50
inventory at a small budget, and holds each to the domain: widths and
heights in ``0 .. 2**31 - 1``, kinds inside the problem's table, and a
zero height only in an empty slot.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro_torch.kernels.binpack_fitness import ops as fops
from repro_torch.kernels.binpack_portfolio_step import ops as pops
from repro_torch.kernels.binpack_sa_step import ops as sops

_I32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(w, h, k, n_kinds):
    w, h = np.asarray(w), np.asarray(h)
    assert w.shape == h.shape
    assert w.min(initial=0) >= 0 and h.min(initial=0) >= 0
    assert w.max(initial=0) <= _I32_MAX and h.max(initial=0) <= _I32_MAX
    assert not np.any((w > 0) & (h == 0)), "a live slot of height 0"
    if k is not None:
        k = np.asarray(k)
        assert k.shape == w.shape
        assert k.min(initial=0) >= 0 and k.max(initial=0) < n_kinds


@pytest.mark.parametrize("device", [None, "U50"])
def test_engine_geometry_stays_in_kernel_domain(device, monkeypatch):
    prob = port.get_problem("RN152-W1A2", device=device)
    seen = {"population_costs": 0, "sa_step_deltas": 0, "portfolio_step": 0}

    def recording(mod, name, check):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            check(*a, **kw)
            seen[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    def fitness_args(widths, heights, modes=None, backend="cuda", kinds=None,
                     kind_tables=None, device="cuda", mesh=None):
        _check(widths, heights, kinds, prob.n_kinds)

    def sa_args(old_w, old_h, new_w, new_h, modes=None, backend="cuda",
                old_k=None, new_k=None, kind_tables=None, device="cuda", mesh=None):
        _check(old_w, old_h, old_k, prob.n_kinds)
        _check(new_w, new_h, new_k, prob.n_kinds)

    def fused_args(W, H, old_w, old_h, new_w, new_h, modes=None, backend="cuda",
                   kinds=None, old_k=None, new_k=None, kind_tables=None,
                   device="cuda", mesh=None):
        fitness_args(W, H, kinds=kinds)
        sa_args(old_w, old_h, new_w, new_h, old_k=old_k, new_k=new_k)

    recording(fops, "population_costs", fitness_args)
    recording(sops, "sa_step_deltas", sa_args)
    recording(pops, "portfolio_step", fused_args)

    kw = dict(backend="cuda", device="cpu", max_seconds=1e9, seed=3)
    port.pack(prob, "ga-nfd", n_pop=8, max_generations=3, **kw)
    port.pack(prob, "sa-s", n_chains=4, max_iterations=120, **kw)
    port.pack(prob, "sa-s", max_iterations=120, **kw)
    r = port.pack(prob, "portfolio", n_islands=4, max_generations=3,
                  max_iterations=64, sa_chains=4, **kw)
    assert r.params["fused"] is True
    assert all(n > 0 for n in seen.values()), seen


def test_domain_is_stated_for_every_wrapper_and_ops_layer():
    import importlib

    for pkg in ("binpack_fitness", "binpack_sa_step", "binpack_portfolio_step"):
        for part in ("kernel", "ops"):
            mod = importlib.import_module(f"repro_torch.kernels.{pkg}.{part}")
            assert "Domain: ``w, h >= 0``" in mod.__doc__, mod.__name__
