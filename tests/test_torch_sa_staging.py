"""The SA delta-cost ops layer with its staged copies (one host buffer for
all of a step's planes, one copy each way), on the CPU: the ``torch`` and
``cuda`` backends (the latter takes the plain version on a CPU device)
bit-identical to the ``python`` backend and to the reference's
``repro.kernels.binpack_sa_step`` jnp oracle, at the edge shapes of the
lane-parallel kernel (T around the lane-group widths 2T = 16 / 32, C around a
warp); and the planes handed to the kernel wrapper are views of one storage.
The card-side checks (kernel against plain version at these shapes, pinned
staging buffers) are in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.problem import BRAM18, URAM288
from repro.kernels.binpack_sa_step.ops import sa_step_deltas as ref_sa_step_deltas
from repro_torch.kernels import launch_counts, staging
from repro_torch.kernels.binpack_sa_step import kernel as sa_kernel
from repro_torch.kernels.binpack_sa_step import ops as sa_ops

U50_TABLES = ((1, BRAM18.modes), (16, URAM288.modes))


def _planes(rng, shape, n_kinds=1):
    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, n_kinds, shape).astype(np.int32)
    return w, h, k


def _check(shape, hetero, seed):
    rng = np.random.default_rng(seed)
    ow, oh, ok = _planes(rng, shape, n_kinds=2)
    nw, nh, nk = _planes(rng, shape, n_kinds=2)
    kw = dict(old_k=ok, new_k=nk, kind_tables=U50_TABLES) if hetero else {}
    oracle = np.asarray(ref_sa_step_deltas(ow, oh, nw, nh, backend="ref", **kw))
    python = sa_ops.sa_step_deltas(ow, oh, nw, nh, backend="python", **kw)
    assert oracle.shape == shape[:-1]
    np.testing.assert_array_equal(python, oracle)
    for backend in ("torch", "cuda"):
        got = sa_ops.sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu", **kw)
        assert got.dtype == np.int64 and got.shape == shape[:-1]
        np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("t", [1, 4, 15, 16, 17, 130])
def test_staged_deltas_match_oracle_across_slot_counts(t, hetero):
    _check((33, t), hetero, seed=1000 + t)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("c", [1, 31, 33, 4096])
def test_staged_deltas_match_oracle_across_chain_counts(c, hetero):
    _check((c, 4), hetero, seed=2000 + c)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("shape", [(4, 64, 4), (3, 31, 17)])
def test_staged_deltas_problem_axis(shape, hetero):
    _check(shape, hetero, seed=sum(shape))


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_planes_reach_the_wrapper_as_views_of_one_storage(monkeypatch, backend, hetero):
    """One staged buffer per call: every plane the kernel wrapper (or the
    plain version) receives lies in one storage, so the call makes one
    host->device copy on a CUDA device."""
    seen = []
    names = {("cuda", False): "sa_step_deltas_cuda", ("cuda", True): "sa_step_deltas_kinds_cuda",
             ("torch", False): "sa_step_deltas_ref", ("torch", True): "sa_step_deltas_kinds_ref"}
    name = names[backend, hetero]
    inner = getattr(sa_ops, name)

    def spy(*args):
        seen.append([a for a in args if isinstance(a, torch.Tensor)])
        return inner(*args)

    monkeypatch.setattr(sa_ops, name, spy)
    rng = np.random.default_rng(5)
    ow, oh, ok = _planes(rng, (2, 64, 4), n_kinds=2)
    nw, nh, nk = _planes(rng, (2, 64, 4), n_kinds=2)
    kw = dict(old_k=ok, new_k=nk, kind_tables=U50_TABLES) if hetero else {}
    got = sa_ops.sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu", **kw)
    np.testing.assert_array_equal(
        got, sa_ops.sa_step_deltas(ow, oh, nw, nh, backend="python", **kw))
    assert len(seen) == 1
    planes = seen[0]
    assert len(planes) == (6 if hetero else 4)
    assert len({p.untyped_storage().data_ptr() for p in planes}) == 1
    assert all(p.is_contiguous() and p.shape == (128, 4) and p.dtype == torch.int32
               for p in planes)
    # the planes are the buffer's consecutive (R, T) slices, in argument order
    base = planes[0].data_ptr()
    assert [p.data_ptr() - base for p in planes] == [i * 128 * 4 * 4 for i in range(len(planes))]


def test_stage_and_fetch_on_cpu():
    """``stage`` lays the planes back to back in one ordinary (unpinned)
    buffer on a CPU device, and the ops layer hands the deltas back as a
    host int64 numpy array of the planes' leading shape."""
    a = np.arange(12, dtype=np.int64).reshape(2, 3, 2)
    b = -a
    dev = staging.stage((a, b), "cpu")
    assert dev.shape == (2, 6, 2) and dev.dtype == torch.int32
    assert not dev.is_pinned()  # a CPU device takes an ordinary buffer
    np.testing.assert_array_equal(dev[0].numpy(), a.reshape(6, 2))
    np.testing.assert_array_equal(dev[1].numpy(), b.reshape(6, 2))
    assert not staging.host_buffer((3,), torch.int32, torch.device("cpu")).is_pinned()
    w = np.array([[[10, 0]], [[3, 4]]], dtype=np.int32)
    h = np.array([[[512, 0]], [[1024, 9]]], dtype=np.int32)
    got = sa_ops.sa_step_deltas(w, h, w + 1, h, backend="torch", device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.int64 and got.shape == (2, 1)
    np.testing.assert_array_equal(
        got, sa_ops.sa_step_deltas(w, h, w + 1, h, backend="python"))


def test_stage_rejects_planes_of_different_shapes():
    """A plane that would broadcast into the buffer is refused, as separate
    copies were refused by the wrapper's shape check."""
    with pytest.raises(ValueError, match="one shape"):
        staging.stage((np.zeros((4, 3)), np.zeros((1, 3))), "cpu")
    with pytest.raises(ValueError, match="one shape"):
        sa_ops.sa_step_deltas(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros((4, 2)),
                              np.zeros((4, 3)), backend="torch", device="cpu")


def test_wrappers_check_kind_tables_on_every_device():
    """The wrappers build the by-value table argument on every call,
    before they pick the path, so a table the kernel could not take is
    refused on the CPU too; lists are accepted as tuples are."""
    rng = np.random.default_rng(6)
    planes = [torch.from_numpy(x) for x in (*_planes(rng, (8, 4), 2), *_planes(rng, (8, 4), 2))]
    ow, oh, ok, nw, nh, nk = planes
    before = launch_counts()
    listed = [[1, [list(m) for m in BRAM18.modes]], [16, [list(m) for m in URAM288.modes]]]
    torch.testing.assert_close(
        sa_kernel.sa_step_deltas_kinds_cuda(ow, oh, ok, nw, nh, nk, listed),
        sa_kernel.sa_step_deltas_kinds_cuda(ow, oh, ok, nw, nh, nk, U50_TABLES), rtol=0, atol=0)
    with pytest.raises(ValueError):
        sa_kernel.sa_step_deltas_kinds_cuda(ow, oh, ok, nw, nh, nk, ((1, ((0, 5),)),))
    with pytest.raises(ValueError):
        sa_kernel.sa_step_deltas_cuda(ow, oh, nw, nh, ((0, 5),))
    # the CPU path counts no launch
    assert launch_counts() == before
