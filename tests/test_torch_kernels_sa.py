"""The port's SA-step kernels K3 / K4 (plain versions and CPU wrapper path)
and its host Metropolis rule against the reference Pallas kernels
(interpret mode), the reference's ``ref.py`` oracle and numpy ops, exactly
equal.  The fitness kernels K1 / K2 and the card test are in
``test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problem import BRAM18, BRAM18_MODES, URAM288
from repro.kernels.binpack_sa_step.kernel import (
    sa_step_deltas_kinds_pallas,
    sa_step_deltas_pallas,
)
from repro.kernels.binpack_sa_step.ops import (
    metropolis_mask as ref_metropolis_mask,
    sa_step_deltas as ref_sa_step_deltas,
)
from repro_torch.kernels.binpack_sa_step import (
    metropolis_mask,
    sa_step_deltas,
    sa_step_deltas_cuda,
    sa_step_deltas_kinds_cuda,
    sa_step_deltas_kinds_ref,
    sa_step_deltas_ref,
)

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


# ------------------------------------------------------------- K3 / K4
@pytest.mark.parametrize("c,t", [(1, 1), (3, 4), (16, 8), (9, 130), (64, 4)])
def test_sa_deltas_plain_matches_pallas(c, t):
    rng = np.random.default_rng(c * 100 + t)
    ow, oh, _ = _planes(rng, (c, t))
    nw, nh, _ = _planes(rng, (c, t))
    j = [jnp.asarray(x) for x in (ow, oh, nw, nh)]
    pallas = np.asarray(sa_step_deltas_pallas(*j, BRAM18_MODES, True))
    oracle = np.asarray(ref_sa_step_deltas(ow, oh, nw, nh, backend="ref"))
    plain = sa_step_deltas_ref(_t(ow), _t(oh), _t(nw), _t(nh), BRAM18_MODES)
    assert plain.dtype == torch.int64
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(plain.numpy(), oracle)
    np.testing.assert_array_equal(
        sa_step_deltas_cuda(_t(ow), _t(oh), _t(nw), _t(nh), BRAM18_MODES).numpy(), pallas
    )
    for backend in ("python", "torch", "cuda"):
        got = sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("seed", range(8))
def test_sa_deltas_kinds_random_tables(seed):
    rng = np.random.default_rng(50 + seed)
    kt = U50_TABLES if seed == 0 else _random_kind_tables(rng)
    c, t = int(rng.integers(1, 70)), int(rng.integers(1, 9))
    ow, oh, ok = _planes(rng, (c, t), n_kinds=len(kt))
    nw, nh, nk = _planes(rng, (c, t), n_kinds=len(kt))
    if seed % 2:  # kind flips: geometry fixed, kinds changed
        nw, nh = ow.copy(), oh.copy()
    j = [jnp.asarray(x) for x in (ow, oh, ok, nw, nh, nk)]
    pallas = np.asarray(sa_step_deltas_kinds_pallas(*j, kt, True))
    oracle = np.asarray(ref_sa_step_deltas(
        ow, oh, nw, nh, backend="ref", old_k=ok, new_k=nk, kind_tables=kt
    ))
    planes = [_t(x) for x in (ow, oh, ok, nw, nh, nk)]
    np.testing.assert_array_equal(sa_step_deltas_kinds_ref(*planes, kt).numpy(), pallas)
    np.testing.assert_array_equal(oracle, pallas)
    np.testing.assert_array_equal(sa_step_deltas_kinds_cuda(*planes, kt).numpy(), pallas)
    for backend in ("python", "torch", "cuda"):
        np.testing.assert_array_equal(
            sa_step_deltas(ow, oh, nw, nh, backend=backend, old_k=ok, new_k=nk,
                           kind_tables=kt, device="cpu"),
            pallas,
        )


@pytest.mark.parametrize("hetero", [False, True])
def test_sa_deltas_problem_axis(hetero):
    rng = np.random.default_rng(9)
    ow, oh, ok = _planes(rng, (4, 6, 4), n_kinds=2)
    nw, nh, nk = _planes(rng, (4, 6, 4), n_kinds=2)
    kw = dict(old_k=ok, new_k=nk, kind_tables=U50_TABLES) if hetero else {}
    ref = ref_sa_step_deltas(ow, oh, nw, nh, backend="python", **kw)
    for backend in ("python", "torch", "cuda"):
        got = sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu", **kw)
        assert got.shape == (4, 6)
        np.testing.assert_array_equal(got, ref)


def test_metropolis_mask_matches_reference():
    rng = np.random.default_rng(3)
    d = rng.integers(-50, 50, 1000)
    temps = np.concatenate([rng.random(990) * 40.0, np.zeros(10)])
    u = rng.random(1000)
    np.testing.assert_array_equal(
        metropolis_mask(d, temps, u), ref_metropolis_mask(d, temps, u)
    )
