"""The port's fused portfolio step K5 (plain version, CPU wrapper path and
ops layer) against the reference's ``portfolio_step`` on every reference
backend (``python``, ``ref``, and ``pallas`` in interpret mode) and against
the port's own separate fitness and SA-delta calls, exactly equal.

On this host the CUDA wrappers take their plain PyTorch versions (the
tensors lie on the CPU); ``test_torch_gpu.py`` holds the kernel itself
against the plain version on a card.  Inputs are seeded numpy, handed to
both packages.
"""
import numpy as np
import pytest
import torch

from repro.core.problem import BRAM18, URAM288
from repro.kernels.binpack_portfolio_step.ops import (
    portfolio_step as ref_portfolio_step,
)
from repro_torch.kernels.binpack_fitness import population_costs
from repro_torch.kernels.binpack_portfolio_step import (
    portfolio_step,
    portfolio_step_cuda,
    portfolio_step_kinds_cuda,
    portfolio_step_kinds_ref,
    portfolio_step_ref,
)
from repro_torch.kernels.binpack_sa_step import sa_step_deltas

BRAM18_MODES = BRAM18.modes
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
    tables = []
    for _ in range(int(rng.integers(1, 4))):
        modes = tuple(
            (int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
            for _ in range(int(rng.integers(1, 6)))
        )
        tables.append((int(rng.integers(1, 32)), modes))
    return tuple(tables)


def _case(seed, hetero):
    """Seeded inputs of both halves: an (A, P, NB) stacked population and
    an (R, T) SA step, with kind lanes and tables when ``hetero``."""
    rng = np.random.default_rng(seed)
    kt = U50_TABLES if seed % 3 == 0 else _random_kind_tables(rng)
    n_kinds = len(kt) if hetero else 1
    a, p, nb = int(rng.integers(1, 4)), int(rng.integers(1, 9)), int(rng.integers(1, 140))
    r, t = int(rng.integers(1, 40)), int(rng.integers(1, 9))
    W, H, K = _planes(rng, (a, p, nb), n_kinds)
    ow, oh, ok = _planes(rng, (r, t), n_kinds)
    nw, nh, nk = _planes(rng, (r, t), n_kinds)
    geo = (W, H, ow, oh, nw, nh)
    if hetero:
        return geo, dict(kinds=K, old_k=ok, new_k=nk, kind_tables=kt)
    return geo, dict(modes=kt[0][1])


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_portfolio_step_matches_reference_backends(seed, hetero):
    """Port (python, torch, cuda on the CPU) == reference (python, ref,
    pallas in interpret mode), on both halves, with the leading (A, P)
    axis of the stacked populations."""
    geo, kw = _case(seed, hetero)
    want_t, want_d = ref_portfolio_step(*geo, backend="python", **kw)
    for backend in ("ref", "pallas"):
        t, d = ref_portfolio_step(*geo, backend=backend, interpret=True, **kw)
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(d, want_d)
    for backend in ("python", "torch", "cuda"):
        t, d = portfolio_step(*geo, backend=backend, device="cpu", **kw)
        assert t.dtype == np.float64 and t.shape == geo[0].shape[:-1]
        assert d.dtype == np.int64 and d.shape == geo[2].shape[:1]
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("hetero", [False, True])
def test_portfolio_step_equals_separate_calls(hetero):
    """The fused call returns exactly the port's separate K1/K2 totals and
    K3/K4 deltas on the same inputs (what a fused barrier replaces)."""
    geo, kw = _case(11, hetero)
    W, H, ow, oh, nw, nh = geo
    if hetero:
        fit = dict(kinds=kw["kinds"], kind_tables=kw["kind_tables"])
        step = dict(old_k=kw["old_k"], new_k=kw["new_k"], kind_tables=kw["kind_tables"])
    else:
        fit = step = dict(modes=kw["modes"])
    for backend in ("torch", "cuda"):
        t, d = portfolio_step(*geo, backend=backend, device="cpu", **kw)
        np.testing.assert_array_equal(
            t, population_costs(W, H, backend=backend, device="cpu", **fit)
        )
        np.testing.assert_array_equal(
            d, sa_step_deltas(ow, oh, nw, nh, backend=backend, device="cpu", **step)
        )


@pytest.mark.parametrize("hetero", [False, True])
def test_portfolio_step_plain_and_wrapper_on_2d_planes(hetero):
    """The plain version and the CPU wrapper path: (rows,) and (C,) int64,
    equal to each other and to the ops layer."""
    geo, kw = _case(5, hetero)
    W, H, ow, oh, nw, nh = geo
    nb = W.shape[-1]
    pop = [_t(W.reshape(-1, nb)), _t(H.reshape(-1, nb))]
    if hetero:
        pop.append(_t(kw["kinds"].reshape(-1, nb)))
        step = [_t(x) for x in (ow, oh, kw["old_k"], nw, nh, kw["new_k"])]
        tables = kw["kind_tables"]
        plain = portfolio_step_kinds_ref(*pop, *step, tables)
        wrapped = portfolio_step_kinds_cuda(*pop, *step, tables)
    else:
        step = [_t(x) for x in (ow, oh, nw, nh)]
        plain = portfolio_step_ref(*pop, *step, kw["modes"])
        wrapped = portfolio_step_cuda(*pop, *step, kw["modes"])
    t, d = portfolio_step(*geo, backend="python", **kw)
    for got in (plain, wrapped):
        assert got[0].dtype == got[1].dtype == torch.int64
        np.testing.assert_array_equal(got[0].numpy(), t.reshape(-1))
        np.testing.assert_array_equal(got[1].numpy(), d)


def test_portfolio_step_int32_extremes():
    """Near-int32-max geometry and modes stay exact on every port backend."""
    rng = np.random.default_rng(3)
    big = (2**31 - 1000, 2**31)
    modes = ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))
    W = rng.integers(*big, (2, 3, 40)).astype(np.int32)
    H = rng.integers(*big, (2, 3, 40)).astype(np.int32)
    step = [rng.integers(*big, (5, 4)).astype(np.int32) for _ in range(4)]
    want = portfolio_step(W, H, *step, modes=modes, backend="python")
    for backend in ("torch", "cuda"):
        got = portfolio_step(W, H, *step, modes=modes, backend=backend, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("missing", ["kinds", "old_k", "new_k", "kind_tables"])
def test_portfolio_step_rejects_partial_kind_lanes(missing):
    """kinds/old_k/new_k/kind_tables are all-or-none, as in the reference."""
    geo, kw = _case(6, True)
    partial = {k: v for k, v in kw.items() if k != missing}
    for backend in ("python", "torch", "cuda"):
        with pytest.raises(ValueError, match="together"):
            portfolio_step(*geo, backend=backend, device="cpu", **partial)
    with pytest.raises(ValueError, match="together"):
        ref_portfolio_step(*geo, backend="python", **partial)


def test_portfolio_step_wrapper_checks():
    rng = np.random.default_rng(0)
    w, h, _ = _planes(rng, (3, 8))
    with pytest.raises(ValueError, match="backend"):
        portfolio_step(w, h, w, h, w, h, backend="pallas", device="cpu")
    with pytest.raises(TypeError):  # int64 planes are refused, not converted
        portfolio_step_cuda(_t(w).long(), _t(h).long(), _t(w), _t(h), _t(w), _t(h),
                            BRAM18_MODES)
    with pytest.raises(ValueError):  # halves of different shapes within one half
        portfolio_step_cuda(_t(w), _t(h[:2]), _t(w), _t(h), _t(w), _t(h), BRAM18_MODES)


def test_launch_counts_are_exact_across_threads():
    """The portfolio's host lanes bump the counters concurrently; the locked
    increment loses none, even with more threads than cores and a thread
    switch forced every microsecond."""
    import os
    import sys
    import threading

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.build import count_launch

    wrapper = portfolio_step_cuda
    reset_launch_counts()
    n_threads, n_bumps = (os.cpu_count() or 1) + 4, 5_000

    def bump():
        for _ in range(n_bumps):
            count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["portfolio_step_cuda"] == n_threads * n_bumps
    reset_launch_counts()


def test_load_builds_each_library_once_across_threads(tmp_path, monkeypatch):
    """The portfolio's host lanes may ask for a library nobody has built
    yet at the same moment: each source is compiled by one nvcc and every
    thread gets the one loaded library.  A stand-in compiler (which records
    each call) and a stand-in ``ctypes.CDLL`` replace the card's toolchain."""
    import sys
    import threading

    from repro_torch.kernels import build as build_mod

    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "time.sleep(0.2)\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "open(out, 'w').write('library')\n"
    )
    fake.chmod(0o755)

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn):
            def entry():  # what the loader checks: each library's constants
                return build_mod.LIBRARY_CONSTANTS.get(fn, 0)
            setattr(self, fn, entry)
            return entry

    monkeypatch.setattr(build_mod.KERNELS, "build_dir", tmp_path / "kernels")
    monkeypatch.setattr(build_mod.KERNELS, "loaded", {})
    monkeypatch.setattr(build_mod.KERNELS, "compilers", (str(fake),))
    monkeypatch.setattr(build_mod.ctypes, "CDLL", FakeLib)

    n_threads = 8
    got = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def ask(i):
        barrier.wait()
        order = build_mod.SOURCES[i % 3:] + build_mod.SOURCES[: i % 3]
        got[i] = {name: build_mod.load(name) for name in order}

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    compiled = sorted(log.read_text().split())
    assert compiled == sorted(
        str(build_mod.CSRC / f"{n}.cu") for n in build_mod.SOURCES
    )
    for name in build_mod.SOURCES:
        assert len({id(g[name]) for g in got}) == 1
        assert build_mod.KERNELS.path(build_mod.CSRC / f"{name}.cu").read_text() == "library"
    assert not list((tmp_path / "kernels").glob("*.tmp"))
