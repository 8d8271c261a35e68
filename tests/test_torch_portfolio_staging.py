"""The fused portfolio step's staged call path on the CPU: one host buffer
for both halves' planes (``staging.stage_groups``: two plane widths, one
copy), one ``(rows + C,)`` int64 result fetched with one ``.cpu()``, the
``cuda`` backend (whose wrappers take the plain version for CPU tensors)
equal to ``python``, to the reference package's fused step and to the
separate fitness and SA-delta calls, and K5's launch geometry with its
limit check.  The card-side checks (the
kernel at its edges, a pinned buffer per call) are in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.binpack_portfolio_step.ops import portfolio_step as ref_portfolio_step
from repro_torch.core.problem import BRAM18, URAM288
from repro_torch.kernels import build, staging
from repro_torch.kernels.binpack_fitness import population_costs
from repro_torch.kernels.binpack_portfolio_step import kernel as k5
from repro_torch.kernels.binpack_portfolio_step import ops as pops
from repro_torch.kernels.binpack_sa_step import sa_step_deltas

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))


def _planes(rng, shape, n_kinds=1):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, n_kinds, shape).astype(np.int32)
    return w, h, k


def _case(seed, pop_shape, step_shape, hetero):
    rng = np.random.default_rng(seed)
    W, H, K = _planes(rng, pop_shape, n_kinds=2)
    ow, oh, ok = _planes(rng, step_shape, n_kinds=2)
    nw, nh, nk = _planes(rng, step_shape, n_kinds=2)
    if hetero:
        return (W, H, ow, oh, nw, nh), dict(kinds=K, old_k=ok, new_k=nk,
                                            kind_tables=U50_TABLES)
    return (W, H, ow, oh, nw, nh), dict(modes=BRAM18.modes)


def test_stage_groups_gives_exact_views_back_to_back():
    rng = np.random.default_rng(0)
    pop = [rng.integers(-5, 70_000, (3, 5, 7)) for _ in range(2)]  # int64, cast
    step = [rng.integers(0, 99, (4, 3)).astype(np.int32) for _ in range(4)]
    a, b = staging.stage_groups((pop, step), "cpu")
    assert a.shape == (2, 15, 7) and b.shape == (4, 4, 3)
    assert a.dtype == b.dtype == torch.int32
    assert a.is_contiguous() and b.is_contiguous() and not a.is_pinned()
    for got, want in zip((*a.unbind(0), *b.unbind(0)), (*pop, *step)):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    # one storage, the groups and the planes in it back to back, in order
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    planes = (*a.unbind(0), *b.unbind(0))
    offsets = [p.data_ptr() - planes[0].data_ptr() for p in planes]
    assert offsets == [0, 15 * 7 * 4, 2 * 15 * 7 * 4,
                       *(2 * 15 * 7 * 4 + i * 4 * 3 * 4 for i in range(1, 4))]


def test_stage_groups_empty_groups_and_single_group():
    a, b = staging.stage_groups(((np.zeros((0, 9)),) * 3, (np.ones((2, 0)),) * 2), "cpu")
    assert a.shape == (3, 0, 9) and b.shape == (2, 2, 0)
    x = np.arange(24).reshape(2, 3, 4)
    (only,) = staging.stage_groups(((x, -x),), "cpu")
    assert torch.equal(only, staging.stage((x, -x), "cpu"))


def test_stage_groups_rejects_mixed_shapes_within_a_group():
    with pytest.raises(ValueError, match="one shape"):
        staging.stage_groups(((np.zeros((4, 3)), np.zeros((4, 3))),
                              (np.zeros((2, 5)), np.zeros((1, 5)))), "cpu")
    with pytest.raises(ValueError, match="at least one axis"):
        staging.stage_groups(((np.int32(3),),), "cpu")


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_one_copy_each_way_per_fused_call(monkeypatch, backend, hetero):
    """A fused call takes one host buffer, moves it with one ``.to`` to the
    device, hands every plane to the wrapper as a view of that one storage,
    and fetches both halves with one ``.cpu()``."""
    geo, kw = _case(3, (2, 75, 300), (8, 4), hetero)
    want = pops.portfolio_step(*geo, backend="python", **kw)
    buffers, moves, fetches, seen = [], [], [], []
    inner_buffer, inner_to, inner_cpu = staging.host_buffer, torch.Tensor.to, torch.Tensor.cpu

    def buffer_spy(shape, dtype, device):
        buffers.append(shape)
        return inner_buffer(shape, dtype, device)

    def to_spy(self, *args, **kwargs):
        target = kwargs.get("device", args[0] if args else None)
        if isinstance(target, (torch.device, str)):  # a copy, not a cast
            moves.append(target)
        return inner_to(self, *args, **kwargs)

    def cpu_spy(self, *args, **kwargs):
        fetches.append(tuple(self.shape))
        return inner_cpu(self, *args, **kwargs)

    name = {("cuda", False): "portfolio_step_joined_cuda",
            ("cuda", True): "portfolio_step_kinds_joined_cuda",
            ("torch", False): "portfolio_step_ref",
            ("torch", True): "portfolio_step_kinds_ref"}[backend, hetero]
    inner_fn = getattr(pops, name)

    def fn_spy(*args, **kwargs):
        seen.append([a for a in args if isinstance(a, torch.Tensor)])
        return inner_fn(*args, **kwargs)

    monkeypatch.setattr(staging, "host_buffer", buffer_spy)
    monkeypatch.setattr(torch.Tensor, "to", to_spy)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu_spy)
    monkeypatch.setattr(pops, name, fn_spy)
    got = pops.portfolio_step(*geo, backend=backend, device="cpu", **kw)
    monkeypatch.undo()
    assert len(buffers) == 1 and len(moves) == 1 and fetches == [(150 + 8,)]
    n_planes = 3 + 6 if hetero else 2 + 4
    assert buffers[0] == ((3 if hetero else 2) * 150 * 300 + (6 if hetero else 4) * 8 * 4,)
    assert len(seen) == 1 and len(seen[0]) == n_planes
    assert len({p.untyped_storage().data_ptr() for p in seen[0]}) == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


SHAPES = [
    ((2, 75, 300), (8, 4)),      # the portfolio's (islands, n_pop, NB) + fleet step
    ((1, 1, 1), (1, 1)),
    ((1, 3, 5000), (20, 17)),    # a row past one 4096-slot pass; T > 16
    ((3, 5, 37), (0, 4)),        # no chains
    ((0, 75, 30), (30, 6)),      # no population rows
    ((0, 4, 9), (0, 2)),         # neither
]


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("shapes", SHAPES, ids=str)
def test_cuda_backend_on_cpu_equals_python_and_separate_calls(shapes, hetero):
    """Every backend of the port equals the reference package's fused step
    (its host backend, and its jnp oracle where both halves have rows) at
    K5's shapes, and the port's separate fitness and SA-delta calls."""
    geo, kw = _case(sum(shapes[0]) + sum(shapes[1]), *shapes, hetero)
    W, H, ow, oh, nw, nh = geo
    want_t, want_d = ref_portfolio_step(*geo, backend="python", **kw)
    if W.size and ow.size:
        oracle_t, oracle_d = ref_portfolio_step(*geo, backend="ref", **kw)
        np.testing.assert_array_equal(oracle_t, want_t)
        np.testing.assert_array_equal(oracle_d, want_d)
    if hetero:
        fit = dict(kinds=kw["kinds"], kind_tables=U50_TABLES)
        step = dict(old_k=kw["old_k"], new_k=kw["new_k"], kind_tables=U50_TABLES)
    else:
        fit = step = dict(modes=BRAM18.modes)
    for backend in ("python", "cuda", "torch"):
        t, d = pops.portfolio_step(*geo, backend=backend, device="cpu", **kw)
        assert t.dtype == np.float64 and t.shape == shapes[0][:-1]
        assert d.dtype == np.int64 and d.shape == shapes[1][:-1]
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(d, want_d)
        if W.size and ow.size and backend != "python":
            np.testing.assert_array_equal(
                t, population_costs(W, H, backend=backend, device="cpu", **fit))
            np.testing.assert_array_equal(
                d, sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu", **step))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def test_wrappers_return_views_of_one_tensor_and_take_out():
    """Each wrapper's ``(totals, deltas)`` are the two halves of one
    ``(rows + C,)`` int64 tensor, which its joined function returns whole
    (the one output the ops layer takes out with one copy); kind 0 at
    weight 1 gives K5a's result."""
    geo, kw = _case(9, (1, 6, 40), (5, 4), False)
    W, H, ow, oh, nw, nh = (_t(x.reshape(-1, x.shape[-1])) for x in geo)
    totals, deltas = k5.portfolio_step_cuda(W, H, ow, oh, nw, nh, BRAM18.modes)
    assert totals.shape == (6,) and deltas.shape == (5,)
    assert totals.untyped_storage().data_ptr() == deltas.untyped_storage().data_ptr()
    assert deltas.data_ptr() - totals.data_ptr() == 6 * 8
    both = k5.portfolio_step_joined_cuda(W, H, ow, oh, nw, nh, BRAM18.modes)
    assert both.dtype == torch.int64 and torch.equal(both, torch.cat((totals, deltas)))
    k = torch.zeros_like(W)
    ok = torch.zeros_like(ow)
    t3, d3 = k5.portfolio_step_kinds_cuda(W, H, k, ow, oh, ok, nw, nh, ok, U50_TABLES)
    assert torch.equal(t3, totals) and torch.equal(d3, deltas)  # kind 0 is BRAM18, weight 1
    assert torch.equal(
        k5.portfolio_step_kinds_joined_cuda(W, H, k, ow, oh, ok, nw, nh, ok, U50_TABLES), both)


@pytest.mark.parametrize("t,lanes", [(0, 1), (1, 2), (2, 4), (3, 8), (4, 8), (8, 16),
                                     (9, 32), (16, 32), (17, 32), (130, 32)])
def test_chain_rows_per_block(t, lanes):
    """A chain row of T slots takes min(32, next power of two >= 2T) lanes
    of a 1024-thread block (one lane for T = 0)."""
    assert 1 << build.sa_lanes_log2(t) == lanes
    assert build.portfolio_chain_rows(t) == build.PORTFOLIO_THREADS // lanes


def test_grid_geometry_and_limit(monkeypatch):
    assert build.PORTFOLIO_THREADS == build.FITNESS_THREADS == 1024
    assert build.LIBRARY_CONSTANTS["portfolio_threads"] == build.PORTFOLIO_THREADS
    assert build.LIBRARY_CONSTANTS["portfolio_max_lanes"] == build.SA_MAX_LANES == 32
    assert set(build._CHECKED["binpack_portfolio_step"]) == {
        "fitness_tables_bytes", "portfolio_threads", "portfolio_max_lanes"}
    assert k5.grid_blocks(150, 8, 4) == 151  # the main path: one block of chains
    assert k5.grid_blocks(150, 128, 4) == 151 and k5.grid_blocks(150, 129, 4) == 152
    assert k5.grid_blocks(0, 0, 4) == 0 and k5.grid_blocks(3, 0, 4) == 3
    assert k5.grid_blocks(0, 1025, 0) == 2 and k5.grid_blocks(2, 33, 17) == 4
    assert k5.grid_blocks(2**31 - 2, 1, 4) == 2**31 - 1
    with pytest.raises(ValueError, match="past the grid"):
        k5.grid_blocks(2**31 - 1, 1, 4)
    # the wrappers check it before anything runs, on every device
    monkeypatch.setattr(k5, "_MAX_BLOCKS", 3)
    geo, _ = _case(1, (1, 3, 8), (1, 4), False)
    W, H, ow, oh, nw, nh = (_t(x.reshape(-1, x.shape[-1])) for x in geo)
    with pytest.raises(ValueError, match="past the grid"):
        k5.portfolio_step_cuda(W, H, ow, oh, nw, nh, BRAM18.modes)
    assert k5.grid_blocks(2, 1, 4) == 3
