"""The fitness ops layer with its staged copy (one host buffer for all of a
call's planes, one copy in, one ``.cpu()`` back), on the CPU: the ``torch``
and ``cuda`` backends (the latter takes the plain version on a CPU device)
equal to the reference's ``repro.kernels.binpack_fitness`` jnp oracle at the
shapes that bound K1 / K2's row blocks (NB around the block's 1024 threads
and its 4096-slot pass, the main path's 2253; P of 1, 75, 77, 300), with and
without kinds, and along the ``(NP, P, NB)`` problem axis with ragged NB;
``staging.stage`` runs once per call and the planes handed to the kernel
wrapper are views of one storage.  The card-side checks (kernel against
plain version at these shapes, a pinned staging buffer) are in
``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problem import BRAM18, URAM288
from repro.kernels.binpack_fitness.ops import population_costs as ref_population_costs
from repro_torch.kernels.binpack_fitness import ops as fops
from repro_torch.kernels.build import FITNESS_CHUNK, FITNESS_THREADS

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))
# the row lengths where K1 / K2's row block (1024 threads, 4 slots a thread
# in each 4096-slot pass) changes how it covers a row, and the main path's NB
EDGE_NB = (1, FITNESS_THREADS - 1, FITNESS_THREADS, FITNESS_THREADS + 1,
           FITNESS_CHUNK - 1, FITNESS_CHUNK, FITNESS_CHUNK + 1, 2 * FITNESS_CHUNK + 1, 2253)


def _planes(rng, shape, n_kinds=2):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, n_kinds, shape).astype(np.int32)
    return w, h, k


def _check(shape, hetero, seed):
    rng = np.random.default_rng(seed)
    w, h, k = _planes(rng, shape)
    kw = dict(kinds=k, kind_tables=U50_TABLES) if hetero else {}
    jkw = dict(kinds=jnp.asarray(k), kind_tables=U50_TABLES) if hetero else {}
    oracle = np.asarray(ref_population_costs(jnp.asarray(w), jnp.asarray(h), backend="ref", **jkw))
    assert oracle.shape == shape[:-1]
    for backend in ("torch", "cuda"):
        got = fops.population_costs(w, h, backend=backend, device="cpu", **kw)
        assert got.dtype == np.int64 and got.shape == shape[:-1]
        np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("nb", EDGE_NB)
def test_staged_totals_match_oracle_across_row_lengths(nb, hetero):
    _check((3, nb), hetero, seed=1000 + nb)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("p", [1, 75, 77, 300])
def test_staged_totals_match_oracle_across_population_sizes(p, hetero):
    _check((p, 600), hetero, seed=2000 + p)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("shape", [(2, 75, 2253), (3, 5, 513), (4, 7, 1)])
def test_staged_totals_problem_axis(shape, hetero):
    _check(shape, hetero, seed=sum(shape))


@pytest.mark.parametrize("hetero", [False, True])
def test_ragged_problem_axis_equals_per_problem_calls(hetero):
    """Problems of different widths, zero-padded to one (NP, P, NB) block
    (as `stack_geometry` pads them), total as each problem alone."""
    rng = np.random.default_rng(7)
    widths = (513, 1, 300)
    nb = max(widths)
    W = np.zeros((3, 5, nb), np.int32)
    H, K = np.zeros_like(W), np.zeros_like(W)
    alone = []
    for i, n in enumerate(widths):
        w, h, k = _planes(rng, (5, n))
        W[i, :, :n], H[i, :, :n], K[i, :, :n] = w, h, k
        kw = dict(kinds=k, kind_tables=U50_TABLES) if hetero else {}
        alone.append(fops.population_costs(w, h, backend="torch", device="cpu", **kw))
    kw = dict(kinds=K, kind_tables=U50_TABLES) if hetero else {}
    for backend in ("torch", "cuda"):
        got = fops.population_costs(W, H, backend=backend, device="cpu", **kw)
        np.testing.assert_array_equal(got, np.stack(alone))


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_one_stage_per_call_and_planes_of_one_storage(monkeypatch, backend, hetero):
    """`staging.stage` runs once per call, and every plane the kernel
    wrapper (or the plain version) receives lies in that one storage, so
    the call makes one host->device copy on a CUDA device."""
    stages, seen = [], []
    inner_stage = fops.stage

    def stage_spy(arrays, device):
        out = inner_stage(arrays, device)
        stages.append(out)
        return out

    names = {("cuda", False): "binpack_fitness_cuda", ("cuda", True): "binpack_fitness_kinds_cuda",
             ("torch", False): "binpack_fitness_ref", ("torch", True): "binpack_fitness_kinds_ref"}
    name = names[backend, hetero]
    inner = getattr(fops, name)

    def spy(*args):
        seen.append([a for a in args if isinstance(a, torch.Tensor)])
        return inner(*args)

    monkeypatch.setattr(fops, "stage", stage_spy)
    monkeypatch.setattr(fops, name, spy)
    rng = np.random.default_rng(5)
    w, h, k = _planes(rng, (2, 75, 513))
    kw = dict(kinds=k, kind_tables=U50_TABLES) if hetero else {}
    got = fops.population_costs(w, h, backend=backend, device="cpu", **kw)
    assert got.shape == (2, 75)
    assert len(stages) == 1 and len(seen) == 1
    planes = seen[0]
    assert len(planes) == (3 if hetero else 2)
    assert len({p.untyped_storage().data_ptr() for p in planes}) == 1
    assert planes[0].untyped_storage().data_ptr() == stages[0].untyped_storage().data_ptr()
    assert all(p.is_contiguous() and p.shape == (150, 513) and p.dtype == torch.int32
               for p in planes)
    # the planes are the buffer's consecutive (R, NB) slices: w, h (, k)
    base = planes[0].data_ptr()
    assert [p.data_ptr() - base for p in planes] == [i * 150 * 513 * 4 for i in range(len(planes))]
    np.testing.assert_array_equal(planes[0].numpy(), w.reshape(150, 513))
    np.testing.assert_array_equal(planes[1].numpy(), h.reshape(150, 513))


def test_planes_of_other_shapes_are_refused():
    """A kind plane that would broadcast into the buffer is refused, as the
    wrapper's shape check refused it before the copies were staged."""
    w = np.ones((4, 3), np.int32)
    with pytest.raises(ValueError, match="one shape"):
        fops.population_costs(w, w, backend="cuda", kinds=np.zeros((1, 3), np.int32),
                              kind_tables=U50_TABLES, device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        fops.population_costs(w, np.ones((4, 2), np.int32), backend="torch", device="cpu")
