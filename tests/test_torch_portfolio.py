"""`repro_torch.core.pack_portfolio` on the CPU against
`repro.core.pack_portfolio`, bit for bit.

Every case runs the reference through its host backend (``"python"``) and
its jnp backend (``"ref"``, which auto-fuses the fleet and GA barriers
under the concurrent scheduler), and the port through ``python``,
``torch`` (plain PyTorch versions; auto-fuses) and ``cuda`` (the kernel
wrappers, which take the plain versions for CPU tensors; auto-fuses).
All must agree on the record the reference's own parity tests take: cost,
``solution.state_dict()``, iterations, the trace's cost sequence, and the
``barriers`` / ``migrations`` / ``strides`` params (racing adds the
ledger, the eliminations and the survivors).  Wall times are not compared.
Budgets are iteration counts, never wall clock.  Racing and the
migration hooks are in ``test_torch_portfolio_racing.py``.
"""
import functools
import inspect
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.launch import SweepMesh

# iteration-budgeted: machine speed never enters, runs are bit-reproducible
_KW = dict(
    max_seconds=1e9, patience=10**9, sa_chains=4, migration_every=32,
    max_iterations=160, max_generations=5,
)

# the reference's bench lineup matrix (tests/test_portfolio_concurrent.py)
_LINEUPS = {
    "sa-fleet": ("sa-s",),
    "mixed": ("ga-nfd", "sa-s", "sa-nfd"),
    "ga-heavy": ("ga-nfd", "ga-nfd", "ga-nfd", "sa-s"),
    "scalar-heavy": ("sa-nfd", "sa-nfd", "sa-nfd", "sa-s"),
}
PORT_BACKENDS = ("python", "torch", "cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(pkg, seed, hetero: bool = False):
    """The reference tests' generated problem (``seed`` an int), or a
    Table-1 problem (``seed`` its name), built in either package."""
    core = pkg
    if isinstance(seed, str):
        return core.get_problem(seed)
    rng = np.random.default_rng(seed)
    bufs = [
        core.Buffer(width=int(rng.integers(1, 80)),
                    depth=int(rng.integers(1, 40_000)),
                    layer=int(rng.integers(0, 5)))
        for _ in range(int(rng.integers(14, 28)))
    ]
    ocm = (
        core.OCMInventory((core.BRAM18, core.URAM288), (len(bufs) * 3, 8),
                          name=f"dev{seed}")
        if hetero else None
    )
    return core.PackingProblem(bufs, max_items=4, name=f"cp{seed}", ocm=ocm)


def _record(res):
    """Everything the parity contract covers, nothing wall-clock."""
    out = (
        res.cost, res.solution.state_dict(), res.iterations,
        [c for _, c in res.trace], res.params["barriers"],
        res.params["migrations"], res.params["strides"],
    )
    race = res.params.get("race")
    if race is not None:
        out += (
            race["budget"], race["spent"], race["work"], race["halvings"],
            tuple(race["survivors"]),
            tuple((e["island"], e["barrier"], e["value"]) for e in race["eliminated"]),
        )
    return out


@functools.lru_cache(maxsize=None)
def _reference(problem: tuple, kw: tuple, backend: str):
    """The reference's record for one case (cached: the port's scheduler
    variants are held against the same reference run)."""
    r = ref.pack_portfolio(_problem(ref, *problem), backend=backend, **dict(kw))
    return _record(r)


def _check(problem, port_kw=(), **kw):
    """Reference (python, ref) and port (python, torch, cuda) on the same
    problem (``_problem``'s arguments) and arguments: every record equal.
    Returns the port results."""
    case = (problem, tuple(sorted(kw.items())))
    want = _reference(*case, "python")
    assert _reference(*case, "ref") == want
    got = {}
    for backend in PORT_BACKENDS:
        r = port.pack_portfolio(_problem(port, *problem), backend=backend,
                                device="cpu", **kw, **dict(port_kw))
        assert _record(r) == want, backend
        r.solution.validate()
        assert r.solution.cost() == r.solution.cost_full() == r.cost
        got[backend] = r
    return got


def _lineup_kw(name, **kw):
    lineup = _LINEUPS[name]
    return dict(_KW, n_islands=len(lineup) + 1, algorithms=lineup, **kw)


# ------------------------------------------------------- lineups, schedulers
@pytest.mark.parametrize("scheduler", ["concurrent", "serial"])
@pytest.mark.parametrize("name", sorted(_LINEUPS))
def test_lineup_matches_reference(name, scheduler):
    got = _check((21,), port_kw=dict(scheduler=scheduler), **_lineup_kw(name))
    # auto-fuse engages exactly where the fleet and the GA both run on a
    # device backend under the concurrent scheduler
    has_pair = name in ("mixed", "ga-heavy")
    for backend, r in got.items():
        assert r.params["scheduler"] == scheduler
        assert r.params["fused"] is (
            has_pair and scheduler == "concurrent" and backend != "python"
        )


@pytest.mark.parametrize("scheduler", ["concurrent", "serial"])
def test_hetero_ocm_matches_reference(scheduler):
    """Kind lanes and the inventory-penalized migration comparisons, with
    the fused K5 kinds variant on the device backends."""
    _check((22, True), port_kw=dict(scheduler=scheduler), **_lineup_kw("mixed"))


def test_cnv_w1a1_default_lineup_matches_reference():
    hp = port.hyperparams("CNV-W1A1")
    assert hp == ref.hyperparams("CNV-W1A1")
    _check(("CNV-W1A1",), **dict(_KW, n_islands=4, max_iterations=128,
                                 max_generations=4, **hp))


# ------------------------------------------------------------ fused dispatch
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_fused_forced_matches_serial(backend):
    """Forcing fused dispatch on every backend (python included) leaves
    the trajectory of the serial loop and of the reference."""
    kw = _lineup_kw("mixed")
    want = _reference((24,), tuple(sorted(kw.items())), "python")
    runs = [
        port.pack_portfolio(_problem(port, 24), backend=backend, device="cpu",
                            scheduler=scheduler, fused=fused, **kw)
        for scheduler, fused in (("serial", None), ("concurrent", True),
                                 ("concurrent", False))
    ]
    serial, fused, unfused = runs
    assert _record(serial) == _record(fused) == _record(unfused) == want
    assert serial.params["fused"] is False and unfused.params["fused"] is False
    assert fused.params["fused"] is True
    assert any(k.endswith(":fused") for k in fused.params["group_seconds"])


def test_fused_stays_off_on_python_backend():
    """Auto-fuse requires the fleet and the GA on a device backend: the
    port's host backend keeps it off unless forced, like the reference's."""
    prob = _problem(port, 26)
    r = port.pack_portfolio(prob, backend="python", device="cpu",
                            **_lineup_kw("mixed"))
    assert r.params["fused"] is False
    assert set(r.params["group_seconds"]) == set(r.params["strides"])


def test_fused_barriers_run_through_portfolio_step(monkeypatch):
    """A fused run answers its shared cycles with `portfolio_step` and its
    odd cycles (fleet drained, GA still running) with the separate calls."""
    from repro_torch.kernels.binpack_fitness import ops as fops
    from repro_torch.kernels.binpack_portfolio_step import ops as pops
    from repro_torch.kernels.binpack_sa_step import ops as sops

    calls = {"portfolio_step": 0, "population_costs": 0, "sa_step_deltas": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(pops, "portfolio_step")
    counting(fops, "population_costs")
    counting(sops, "sa_step_deltas")
    # the fleet's budget runs out long before the GA's
    kw = _lineup_kw("mixed", max_iterations=64, max_generations=12)
    r = port.pack_portfolio(_problem(port, 25), backend="cuda", device="cpu", **kw)
    assert r.params["fused"] is True
    assert calls["portfolio_step"] > 0
    assert calls["population_costs"] > 0  # GA-only cycles and the initial evaluation


# --------------------------------------------------- single-island parity
@pytest.mark.parametrize(
    "algorithm,hyper,budget",
    [
        ("ga-nfd", {}, dict(max_generations=12)),
        ("sa-nfd", {}, dict(max_iterations=150)),
        ("sa-s", {"n_chains": 1}, dict(max_iterations=300)),
        ("sa-s", {"n_chains": 4}, dict(max_iterations=300)),
    ],
)
def test_single_island_matches_pack(algorithm, hyper, budget):
    """A one-island portfolio is the standalone ``pack`` run, in the port as
    in the reference (and equal to the reference's)."""
    kw = dict(max_seconds=1e9, patience=10**9, **budget)
    spec = dict(islands=[port.IslandSpec(algorithm, seed=5, hyper=hyper)])
    ref_spec = dict(islands=[ref.IslandSpec(algorithm, seed=5, hyper=hyper)])
    want = ref.pack_portfolio(ref.get_problem("CNV-W1A1"), backend="python",
                              **ref_spec, **kw)
    for backend in PORT_BACKENDS:
        prob = port.get_problem("CNV-W1A1")
        r = port.pack_portfolio(prob, backend=backend, device="cpu", **spec, **kw)
        alone = port.pack(prob, algorithm, seed=5, backend=backend, device="cpu",
                          **hyper, **kw)
        assert r.cost == alone.cost == want.cost, backend
        assert r.iterations == alone.iterations == want.iterations
        assert r.solution.state_dict() == alone.solution.state_dict()
        assert r.solution.state_dict() == want.solution.state_dict()
        # the portfolio's trace is the island's improvements (a GA run's
        # closing entry repeats its best) plus the portfolio's closing entry
        improvements = sorted({c for _, c in alone.trace}, reverse=True)
        assert [c for _, c in r.trace][:-1] == improvements
        assert _record(r) == _record(want)


# ------------------------------------------------------ migration disabled
def test_migration_disabled_sums_standalone_runs():
    prob = port.get_problem("CNV-W1A1")
    kw = dict(max_iterations=200, max_generations=8, max_seconds=1e9,
              patience=10**9, backend="cuda", device="cpu")
    specs = [port.IslandSpec("ga-nfd", seed=0), port.IslandSpec("sa-s", seed=1)]
    r = port.pack_portfolio(prob, islands=specs, sa_chains=3, migration_every=0, **kw)
    ga = port.pack(prob, "ga-nfd", seed=0, **kw)
    sa = port.pack(prob, "sa-s", seed=1, n_chains=3, **kw)
    assert r.cost == min(ga.cost, sa.cost)
    assert r.iterations == ga.iterations + sa.iterations
    assert r.params["migrations"] == 0


# -------------------------------------------------------------------- API
def test_pack_routes_portfolio():
    assert "portfolio" in port.ALGORITHMS
    kw = dict(n_islands=2, sa_chains=3, max_iterations=200, max_generations=6,
              max_seconds=1e9, patience=10**9, seed=0)
    want = ref.pack(ref.get_problem("CNV-W1A1"), "portfolio", backend="python", **kw)
    for backend in PORT_BACKENDS:
        prob = port.get_problem("CNV-W1A1")
        r = port.pack(prob, "portfolio", backend=backend, device="cpu", **kw)
        direct = port.pack_portfolio(prob, backend=backend, device="cpu", **kw)
        assert _record(r) == _record(direct) == _record(want)
        assert r.algorithm == want.algorithm


@pytest.mark.parametrize(
    "kw",
    [
        dict(checkpoint_dir="ckpt"),
        dict(resume=True),
        dict(on_checkpoint=print),
        dict(n_shards=2),
        dict(mesh=object()),
    ],
    ids=["checkpoint_dir", "resume", "on_checkpoint", "n_shards", "mesh"],
)
def test_later_slices_raise_not_implemented(kw, tmp_path):
    """Every argument of the reference is ported: a checkpointed run cuts
    its snapshots and gives the plain run's result (``tests/test_torch_
    resume.py``), ``resume`` / ``on_checkpoint`` without a directory change
    nothing, as in the reference, and so do ``n_shards`` and a sweep mesh
    (``tests/test_torch_sharded.py``); a mesh that is no ``("prob",)``
    sweep mesh raises before any work."""
    prob = port.get_problem("CNV-W1A1")
    budget = dict(device="cpu", max_generations=2, max_iterations=20, max_seconds=1e9)
    if "mesh" in kw:
        with pytest.raises(ValueError, match="sweep mesh"):
            port.pack_portfolio(prob, checkpoint_dir=str(tmp_path / "ckpt"), **kw)
        assert not (tmp_path / "ckpt").exists()
        kw = dict(mesh=SweepMesh([torch.device("cpu")] * 2))
    if "checkpoint_dir" in kw:
        kw = dict(checkpoint_dir=str(tmp_path / "ckpt"))
    got = port.pack_portfolio(prob, **budget, **kw)
    want = port.pack_portfolio(prob, **budget)
    assert (got.cost, got.solution.state_dict(), got.iterations) == (
        want.cost, want.solution.state_dict(), want.iterations)
    assert (tmp_path / "ckpt").exists() == ("checkpoint_dir" in kw)
    if "checkpoint_dir" in kw:
        assert list((tmp_path / "ckpt").glob("step_*/manifest.json"))


def test_argument_checks_match_reference():
    prob = port.get_problem("CNV-W1A1")
    kw = dict(device="cpu", max_generations=2, max_iterations=20, max_seconds=1e9)
    with pytest.raises(ValueError, match="scheduler"):
        port.pack_portfolio(prob, scheduler="threads", **kw)
    with pytest.raises(ValueError, match="auto=True"):
        port.pack_portfolio(prob, race_grid=[("sa-s", {})], **kw)
    with pytest.raises(ValueError, match="not both"):
        port.pack_portfolio(prob, auto=True, islands=[port.IslandSpec("sa-s")], **kw)
    with pytest.raises(ValueError, match="n_shards"):
        port.pack_portfolio(prob, n_shards=0, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.pack_portfolio(prob)


def test_max_workers_deprecated():
    """``max_workers`` warns as the reference's does (``tests/test_portfolio
    .py::test_max_workers_deprecated``) and is ignored, not handed to the
    islands: the result equals the call without it."""
    kw = dict(_KW, n_islands=1, seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = ref.pack_portfolio(ref.get_problem("CNV-W1A1"), backend="python",
                                  max_workers=2, **kw)
    ref_msgs = [str(w.message) for w in caught
                if issubclass(w.category, DeprecationWarning)]
    assert ref_msgs
    prob = port.get_problem("CNV-W1A1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = port.pack_portfolio(prob, device="cpu", max_workers=2, **kw)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]
    assert msgs == ref_msgs
    assert all(w.filename == __file__ for w in caught
               if issubclass(w.category, DeprecationWarning))
    r.solution.validate()
    plain = port.pack_portfolio(prob, device="cpu", **kw)
    assert _record(r) == _record(plain) == _record(want)
    clock = ("barrier_seconds", "group_seconds")  # wall time, not parity
    assert ({k: v for k, v in r.params.items() if k not in clock}
            == {k: v for k, v in plain.params.items() if k not in clock})
    # the reference's parameters, in its order and with its defaults (the
    # port adds ``device``), so positional calls mean the same
    want = inspect.signature(ref.pack_portfolio).parameters
    got = inspect.signature(port.pack_portfolio).parameters
    assert [p for p in got if p != "device"] == list(want)
    assert all(got[n].default == want[n].default for n in want)


def test_wallclock_truncation_warns_as_reference():
    """A wall-clock stop is flagged and warned about with the reference's
    text (the test settings turn that text into an error unless caught)."""
    prob = port.get_problem("CNV-W1A1")
    with pytest.warns(port.TruncationWarning, match="NOT seed-reproducible"):
        r = port.pack_portfolio(prob, device="cpu", backend="python", max_seconds=0.0,
                                sa_chains=2, max_iterations=10**6)
    assert r.params["truncated_by_wallclock"] is True
    assert issubclass(port.TruncationWarning, RuntimeWarning)
