"""The port's fitness kernels K1 / K2 against the reference Pallas kernels
(interpret mode) and the reference's ``ref.py`` oracles, exactly equal,
plus the checks every K1-K4 wrapper makes (K3 / K4 parity is in
``test_torch_kernels_sa.py``).

On this host the CUDA wrappers take their plain PyTorch versions (the
tensors lie on the CPU); ``test_torch_gpu.py`` holds the kernels themselves
against the plain versions on a card.  Inputs are seeded numpy, handed to
both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problem import BRAM18, BRAM18_MODES, URAM288
from repro.kernels.binpack_fitness.kernel import (
    binpack_fitness_kinds_pallas,
    binpack_fitness_pallas,
)
from repro.kernels.binpack_fitness.ops import population_costs as ref_population_costs
from repro.kernels.binpack_fitness.ref import (
    binpack_fitness_kinds_ref as jnp_fitness_kinds,
    binpack_fitness_ref as jnp_fitness,
)
from repro_torch import kernels
from repro_torch.kernels.binpack_fitness import (
    binpack_fitness_cuda,
    binpack_fitness_kinds_cuda,
    binpack_fitness_kinds_ref,
    binpack_fitness_ref,
    population_costs,
)
from repro_torch.kernels.binpack_sa_step import (
    sa_step_deltas_cuda,
    sa_step_deltas_kinds_cuda,
    sa_step_deltas_kinds_ref,
    sa_step_deltas_ref,
)
from repro_torch.kernels.build import MAX_KINDS, MAX_MODES

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _planes(rng, shape, n_kinds=1):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, n_kinds, shape).astype(np.int32)
    return w, h, k


def _random_kind_tables(rng):
    """Seeded random RAM mode tables, as in tests/test_kernels.py."""
    tables = []
    for _ in range(int(rng.integers(1, 4))):
        modes = tuple(
            (int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
            for _ in range(int(rng.integers(1, 6)))
        )
        tables.append((int(rng.integers(1, 32)), modes))
    return tuple(tables)


# ------------------------------------------------------------- K1 / K2
@pytest.mark.parametrize("p,nb", [(1, 1), (3, 37), (8, 128), (13, 300), (75, 1000)])
def test_fitness_plain_matches_pallas(p, nb):
    rng = np.random.default_rng(p * 1000 + nb)
    w, h, _ = _planes(rng, (p, nb))
    pallas = np.asarray(binpack_fitness_pallas(jnp.asarray(w), jnp.asarray(h), BRAM18_MODES, True))
    oracle = np.asarray(jnp_fitness(jnp.asarray(w), jnp.asarray(h), BRAM18_MODES))
    plain = binpack_fitness_ref(_t(w), _t(h), BRAM18_MODES)
    assert plain.dtype == torch.int64
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(plain.numpy(), oracle)
    totals = binpack_fitness_cuda(_t(w), _t(h), BRAM18_MODES)
    np.testing.assert_array_equal(totals.numpy(), pallas.sum(1))
    ref_totals = np.asarray(ref_population_costs(jnp.asarray(w), jnp.asarray(h), backend="ref"))
    for backend in ("torch", "cuda"):
        np.testing.assert_array_equal(
            population_costs(w, h, backend=backend, device="cpu"), ref_totals
        )


@pytest.mark.parametrize("seed", range(8))
def test_random_mode_sets_plain_matches_pallas(seed):
    """Random mode tables and unit weights (K1 on kind 0's table, K2 on all
    of them) against the Pallas kernels and the jnp oracles."""
    rng = np.random.default_rng(seed)
    kt = _random_kind_tables(rng)
    p, nb = int(rng.integers(1, 6)), int(rng.integers(1, 150))
    w, h, k = _planes(rng, (p, nb), n_kinds=len(kt))
    modes = kt[0][1]
    np.testing.assert_array_equal(
        binpack_fitness_ref(_t(w), _t(h), modes).numpy(),
        np.asarray(binpack_fitness_pallas(jnp.asarray(w), jnp.asarray(h), modes, True)),
    )
    pallas = np.asarray(binpack_fitness_kinds_pallas(
        jnp.asarray(w), jnp.asarray(h), jnp.asarray(k), kt, True
    ))
    oracle = np.asarray(jnp_fitness_kinds(jnp.asarray(w), jnp.asarray(h), jnp.asarray(k), kt))
    plain = binpack_fitness_kinds_ref(_t(w), _t(h), _t(k), kt).numpy()
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)
    np.testing.assert_array_equal(
        binpack_fitness_kinds_cuda(_t(w), _t(h), _t(k), kt).numpy(), pallas.sum(1)
    )


@pytest.mark.parametrize("p,nb", [(1, 1), (5, 129), (75, 600)])
def test_fitness_kinds_u50_tables(p, nb):
    rng = np.random.default_rng(nb)
    w, h, k = _planes(rng, (p, nb), n_kinds=2)
    pallas = np.asarray(binpack_fitness_kinds_pallas(
        jnp.asarray(w), jnp.asarray(h), jnp.asarray(k), U50_TABLES, True
    ))
    np.testing.assert_array_equal(
        binpack_fitness_kinds_ref(_t(w), _t(h), _t(k), U50_TABLES).numpy(), pallas
    )
    ref_totals = np.asarray(ref_population_costs(
        jnp.asarray(w), jnp.asarray(h), backend="ref",
        kinds=jnp.asarray(k), kind_tables=U50_TABLES,
    ))
    for backend in ("torch", "cuda"):
        np.testing.assert_array_equal(
            population_costs(w, h, backend=backend, kinds=k,
                             kind_tables=U50_TABLES, device="cpu"),
            ref_totals,
        )


@pytest.mark.parametrize("hetero", [False, True])
def test_population_costs_problem_axis(hetero):
    """(NP, P, NB) inputs reshape to one call and equal the reference's 3-D
    totals and the per-problem slices."""
    rng = np.random.default_rng(5)
    w, h, k = _planes(rng, (3, 5, 129), n_kinds=2)
    kw = dict(kinds=k, kind_tables=U50_TABLES) if hetero else {}
    jkw = dict(kinds=jnp.asarray(k), kind_tables=U50_TABLES) if hetero else {}
    ref = np.asarray(ref_population_costs(jnp.asarray(w), jnp.asarray(h), backend="ref", **jkw))
    for backend in ("torch", "cuda"):
        got = population_costs(w, h, backend=backend, device="cpu", **kw)
        assert got.shape == (3, 5)
        np.testing.assert_array_equal(got, ref)
        for i in range(3):
            one = dict(kinds=k[i], kind_tables=U50_TABLES) if hetero else {}
            np.testing.assert_array_equal(
                population_costs(w[i], h[i], backend=backend, device="cpu", **one), got[i]
            )


# ------------------------------------------------------------- wrappers
def test_wrappers_check_inputs():
    w = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        binpack_fitness_cuda(w.to(torch.int64), w, BRAM18_MODES)
    with pytest.raises(ValueError):
        binpack_fitness_cuda(w, torch.zeros((2, 4), dtype=torch.int32), BRAM18_MODES)
    with pytest.raises(ValueError):
        binpack_fitness_cuda(w.t(), w.t(), BRAM18_MODES)  # not contiguous
    with pytest.raises(ValueError):
        sa_step_deltas_cuda(w, w, w, w[None], BRAM18_MODES)  # rank mismatch
    with pytest.raises(ValueError):  # neither cpu nor cuda: no plain path
        meta = torch.empty((2, 3), dtype=torch.int32, device="meta")
        binpack_fitness_cuda(meta, meta, BRAM18_MODES)
    with pytest.raises(ValueError):  # mode table beyond the kernel struct
        binpack_fitness_cuda(w, w, ((1, 1),) * (MAX_MODES + 1))
    with pytest.raises(ValueError):
        binpack_fitness_kinds_cuda(w, w, w, ((1, BRAM18_MODES),) * (MAX_KINDS + 1))
    with pytest.raises(ValueError):  # a zero mode would divide by zero
        sa_step_deltas_cuda(w, w, w, w, ((0, 512),))


def test_cpu_wrappers_take_plain_versions_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    w, h, k = _planes(rng, (4, 9), n_kinds=2)
    binpack_fitness_cuda(_t(w), _t(h), BRAM18_MODES)
    binpack_fitness_kinds_cuda(_t(w), _t(h), _t(k), U50_TABLES)
    sa_step_deltas_cuda(_t(w), _t(h), _t(w), _t(h), BRAM18_MODES)
    sa_step_deltas_kinds_cuda(_t(w), _t(h), _t(k), _t(w), _t(h), _t(k), U50_TABLES)
    assert kernels.launch_counts() == {
        "binpack_fitness_cuda": 0,
        "binpack_fitness_kinds_cuda": 0,
        "sa_step_deltas_cuda": 0,
        "sa_step_deltas_kinds_cuda": 0,
    }

