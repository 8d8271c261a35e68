"""The SA fleet step through the compiled host loop (`core/sa_native.py`,
``csrc/sa_step.c``) against the reference's numpy body, bit for bit.

Two twins advance in lockstep, the port's `_block_gen` (the helper) and the
reference's (`repro.core.sa`, the numpy body), started from equal problems
and generators and both answered by the port's `_block_eval`: at every step
request the planes, every state array with its dtype (the generators' own
rebound locals over the state's fields) and every generator's whole state
(buffered 32-bit half set by an ``rng.integers`` first) must be equal, and
the helper's usage change and penalty delta must equal the reference's
formula on the planes; at the end the state written back.  The cases run
every Table-1 accelerator on BRAM18 and on an Alveo U50 x ``intra_layer`` x
``swap_moves`` 1-3, one problem and fleets of three, with an exchange and
compaction every 4 steps, two-kind inventories under a float and an integer
penalty weight.  Then whole packs, a sweep, a resumed sweep and a portfolio
are held to `repro.core`'s, states the helper cannot take and a host without
a compiler are refused, and the first use from four threads is checked.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.sa import SimulatedAnnealingPacker as RefPacker
from repro_torch.core import sa_native
from repro_torch.core.sa import SimulatedAnnealingPacker

ROOT = Path(__file__).resolve().parents[1]
DEVICES = [None, "U50"]  # table1.bram18 and table1.u50
STATE = ("items", "counts", "bw", "bh", "live", "bk", "costs", "pcosts", "best_pcosts",
         "stale", "UK", "steps", "up_prop", "up_acc", "gbest_pcost", "gbest_cost",
         "g_items", "g_counts", "g_live", "g_kinds", "g_UK", "tslots", "entry_ok", "it")


def _rng(seed):
    """A generator with its buffered 32-bit half set."""
    rng = np.random.default_rng(seed)
    rng.integers(1000)
    assert rng.bit_generator.state["has_uint32"] == 1
    return rng


def _twins(names, device, intra_layer, swap_moves, seed, steps, n_chains=3, probs=None,
           **kw):
    """The port's packer and fleet state and the reference's, equal;
    ``probs(pkg)`` builds the fleet's problems in either package."""
    kw = dict(perturbation="swap", n_chains=n_chains, intra_layer=intra_layer,
              swap_moves=swap_moves, exchange_every=4, max_iterations=steps,
              max_seconds=1e9, patience=10**9, backend="python", **kw,
              **{k: v for k, v in port.hyperparams(names[0]).items()
                 if k in ("p_adm_w", "p_adm_h")})
    probs = probs or (lambda pkg: [pkg.get_problem(n, device=device) for n in names])
    packer, ref_packer = SimulatedAnnealingPacker(device="cpu", **kw), RefPacker(**kw)
    st, twin = (
        pk._block_start(ps, [_rng(seed + j) for j in range(len(ps))], [[] for _ in ps],
                        "python")
        for pk, ps in ((packer, probs(port)), (ref_packer, probs(ref))))
    return packer, ref_packer, st, twin


def _send(gen, d_e):
    try:
        return gen.send(d_e)
    except StopIteration:
        return None


def _expected_penalty(st, req, lam):
    """The reference's dUK and penalty delta for the planes (`_block_gen`'s
    numpy formula), on the state's usage before the commit."""
    old_w, old_h, new_w, new_h, old_k, new_k = req
    prob = st.probs[0]
    po = prob.bin_primitives_many(old_w, old_h, old_k)
    pn = prob.bin_primitives_many(new_w, new_h, new_k)
    duk = np.stack([((new_k == k) * pn).sum(1) - ((old_k == k) * po).sum(1)
                    for k in range(st.n_kinds)], axis=1)
    pen = lam * (st.batch.overflow_rows(st.UK + duk, st.pi)
                  - st.batch.overflow_rows(st.UK, st.pi))
    return duk, pen


def _live(st, gen):
    """A running generator's state: its rebound locals over ``st``'s
    fields (which every array updated in place is)."""
    return {**vars(st), **gen.gi_frame.f_locals}


def _states_equal(a, b):
    for name in STATE:
        x, y = a[name], b[name]
        if x is None:
            assert y is None, name
            continue
        assert type(x) is type(y) and np.asarray(x).dtype == np.asarray(y).dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _drain(packer, ref_packer, st, twin):
    """Run the reference's generator over ``twin`` to its end, answered by
    the port's `_block_eval`."""
    gen = ref_packer._block_gen(twin)
    req = next(gen, None)
    while req is not None:
        req = _send(gen, packer._block_eval(st, req))


def run_lockstep(packer, ref_packer, st, twin):
    """Advance ``st`` through the port's generator and ``twin`` through the
    reference's to the end of the budget, checking every step; returns the
    steps."""
    gen_a = packer._block_gen(st)
    req_a = next(gen_a, None)
    gen_b = ref_packer._block_gen(twin)
    req_b = next(gen_b, None)
    nat = gen_a.gi_frame.f_locals["nat"]
    assert isinstance(nat, sa_native.FleetStep)
    n = 0
    while req_a is not None:
        assert req_b is not None
        for x, y in zip(req_a, req_b):
            if x is None:
                assert y is None
            else:
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
        _states_equal(_live(st, gen_a), _live(twin, gen_b))
        assert [r.bit_generator.state for r in st.rngs] == [
            r.bit_generator.state for r in twin.rngs]
        if nat.bounded:
            duk, pen = _expected_penalty(st, req_a, packer.inventory_penalty)
            np.testing.assert_array_equal(nat._keep["duk"], duk)
            assert nat.pen.dtype == pen.dtype and nat.pen.tobytes() == pen.tobytes()
        d_e = packer._block_eval(st, req_b)
        req_a, req_b = _send(gen_a, d_e), _send(gen_b, d_e)
        n += 1
    assert req_b is None
    _states_equal(vars(st), vars(twin))
    assert [r.bit_generator.state for r in st.rngs] == [
        r.bit_generator.state for r in twin.rngs]
    assert [[c for _, c in t] for t in st.traces] == [[c for _, c in t] for t in twin.traces]
    assert (st.done, st.frozen) == (twin.done, twin.frozen)
    return n


@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
@pytest.mark.parametrize("name", port.ACCELERATORS)
def test_step_equals_numpy_body_on_table1(name, device):
    """One problem: ``intra_layer`` x ``swap_moves`` 1-3, 40 steps each."""
    k = port.ACCELERATORS.index(name)
    for intra_layer in (False, True):
        for swap_moves in (1, 2, 3):
            twins = _twins([name], device, intra_layer, swap_moves,
                           2**31 + 7 * k + swap_moves, 40)
            assert run_lockstep(*twins) == 40


FLEETS = [port.ACCELERATORS[0:3], port.ACCELERATORS[3:6], port.ACCELERATORS[5:8]]


@pytest.mark.parametrize("intra_layer", [False, True], ids=["any-layer", "intra-layer"])
@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
def test_fleet_of_three_equals_numpy_body(device, intra_layer):
    """Fleets of three problems on 2-D tables, ``swap_moves`` 1-3."""
    for swap_moves, names in zip((1, 2, 3), FLEETS):
        twins = _twins(list(names), device, intra_layer, swap_moves, 11, 60)
        assert twins[2].wtab.ndim == 2
        assert run_lockstep(*twins) == 60


def _inventory(counts):
    """DoReFaNet and CNV-W1A1 on two RAM kinds with these counts."""
    def probs(pkg):
        ocm = pkg.OCMInventory((pkg.BRAM18, pkg.URAM288), counts, name="inv")
        return [pkg.PackingProblem(pkg.get_buffers(n), ocm=ocm, name=n)
                for n in ("DoReFaNet", "CNV-W1A1")]
    return probs


@pytest.mark.parametrize("counts,lam", [((40, 2), 0.1), ((-1, -1), 32.0), ((-1, 3), 32.0)],
                         ids=["tight", "unbounded", "one-bounded"])
def test_inventories_equal_numpy_body(counts, lam):
    """Two RAM kinds on an inventory that overflows (the penalty moves, at a
    weight whose products round), on one with no bounds (no penalty delta,
    float64 penalized costs) and on one with a bound on one kind."""
    packer, ref_packer, st, twin = _twins(["DoReFaNet"], None, False, 2, 17, 80, n_chains=4,
                                          probs=_inventory(counts), inventory_penalty=lam)
    assert st.hetero and st.any_bounded == (counts != (-1, -1))
    assert run_lockstep(packer, ref_packer, st, twin) == 80
    if counts == (40, 2):
        assert (st.pcosts != st.costs).all()


@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
def test_first_of_tied_chains_is_the_best_copied(device):
    """Chains tied on the least cost, below the problem's best: the one
    copied is the first of them, as numpy's argmin takes it."""
    packer, ref_packer, st, twin = _twins(["CNV-W2A2"], device, False, 1, 23, 1, n_chains=6)
    for x in (st, twin):
        x.stale[1:] = packer.patience  # only chain 0 moves
        x.costs[0], x.costs[1:] = 10**6, 50
        x.gbest_pcost[:] = 10**9
    assert not np.array_equal(st.items[1], st.items[5])
    assert run_lockstep(packer, ref_packer, st, twin) == 1
    assert st.gbest_cost[0] == 50
    np.testing.assert_array_equal(st.g_items[0], st.items[1])


def test_frozen_problems_and_a_run_cut_at_barriers():
    """Patience freezes a fleet's problems one by one (they stop drawing);
    barriers every 7 steps rebuild the helper's pointers, equal to one
    uninterrupted run of the reference."""
    packer, ref_packer, st, twin = _twins(["CNV-W2A2", "CNV-W1A1", "Tincy-YOLO"], "U50",
                                          False, 2, 5, 400)
    packer.patience = ref_packer.patience = 25
    while not st.done:
        packer._block_run(st, st.it + 7)
    _drain(packer, ref_packer, st, twin)
    assert st.frozen and twin.frozen and st.it == twin.it < 400
    _states_equal(vars(st), vars(twin))
    assert [r.bit_generator.state for r in st.rngs] == [
        r.bit_generator.state for r in twin.rngs]


def _key(r):
    return (r.cost, [list(b) for b in r.solution.bins], [int(k) for k in r.solution.kinds],
            r.iterations, [c for _, c in r.trace], r.params.get("uphill_proposed"),
            r.params.get("uphill_accepted"))


@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
@pytest.mark.parametrize("name,n_chains", [("DoReFaNet", 8), ("CNV-W1A1", 64)])
def test_pack_equals_reference_seed_for_seed(name, n_chains, device):
    kw = dict(ref.hyperparams(name), seed=2**31 + 3, n_chains=n_chains, max_iterations=150,
              max_seconds=1e9, exchange_every=16)
    expect = _key(ref.pack(ref.get_problem(name, device=device), "sa-s", backend="python",
                           **kw))
    got = port.pack(port.get_problem(name, device=device), "sa-s", backend="cuda",
                    device="cpu", **kw)
    assert _key(got) == expect


def _sweep_record(sw):
    return [(r.cost, r.solution.state_dict(), r.iterations, [c for _, c in r.trace],
             r.params.get("uphill_proposed"), r.params.get("uphill_accepted"))
            for r in sw.results]


SWEEP = [("CNV-W1A1", None), ("CNV-W2A2", None), ("Tincy-YOLO", None), ("CNV-W1A1", "U50"),
         ("DoReFaNet", "U50")]
SWEEP_KW = dict(seeds=[0, 2**31 + 1, 2, 3, 4], n_chains=4, max_iterations=200,
                max_seconds=1e9, patience=10**9)


def test_sweep_equals_reference():
    want = ref.pack_sweep([ref.get_problem(n, device=d) for n, d in SWEEP], "sa-s",
                          **SWEEP_KW)
    got = port.pack_sweep([port.get_problem(n, device=d) for n, d in SWEEP], "sa-s",
                          backend="torch", device="cpu", **SWEEP_KW)
    assert _sweep_record(got) == _sweep_record(want)


def test_resumed_sweep_equals_uninterrupted(tmp_path):
    probs = [port.get_problem(n, device=d) for n, d in SWEEP]
    kw = dict(SWEEP_KW, backend="torch", device="cpu")
    whole = port.pack_sweep(probs, "sa-s", **kw)

    class Killed(BaseException):
        pass

    def hook(step):
        if step >= 2:
            raise Killed

    with pytest.raises(Killed):
        port.pack_sweep(probs, "sa-s", checkpoint_dir=str(tmp_path), checkpoint_every=60,
                        on_checkpoint=hook, **kw)
    resumed = port.pack_sweep(probs, "sa-s", checkpoint_dir=str(tmp_path),
                              checkpoint_every=60, resume=True, **kw)
    assert _sweep_record(resumed) == _sweep_record(whole)


def test_portfolio_with_sa_islands_equals_reference():
    kw = dict(n_islands=4, algorithms=("sa-s", "ga-nfd"), sa_chains=4, max_iterations=128,
              migration_every=32,
              max_generations=4, max_seconds=1e9, patience=10**9, seed=9)
    want = ref.pack_portfolio(ref.get_problem("Tincy-YOLO", device="U50"), backend="python",
                              **kw)
    got = port.pack_portfolio(port.get_problem("Tincy-YOLO", device="U50"), backend="cuda",
                              device="cpu", **kw)
    assert got.params["fused"] is True
    assert (got.cost, got.solution.state_dict(), got.iterations) == (
        want.cost, want.solution.state_dict(), want.iterations)
    assert [c for _, c in got.trace] == [c for _, c in want.trace]


def _no_compiler(monkeypatch, tmp_path):
    """An empty build directory and a compiler search that finds nothing."""
    monkeypatch.setattr(sa_native.NATIVE, "build_dir", tmp_path / "host")
    monkeypatch.setattr(sa_native.NATIVE, "compilers", ("no-such-compiler-here",))
    monkeypatch.setattr(sa_native.NATIVE, "loaded", {})


@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
def test_pack_raises_without_a_compiler(monkeypatch, tmp_path, device):
    _no_compiler(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="sa.native libraries: searched no-such-compiler"):
        port.pack(port.get_problem("Tincy-YOLO", device=device), "sa-s", n_chains=6,
                  max_iterations=120, max_seconds=1e9, seed=4, backend="python",
                  device="cpu", exchange_every=8)
    assert not (tmp_path / "host").exists()


def test_an_integer_penalty_runs_the_helper_equal_to_reference():
    """An ``int`` inventory penalty makes the penalized costs int64 on a
    multi-kind fleet: the helper takes them, step for step equal to the
    reference on an inventory that overflows, and whole packs @U50 too."""
    packer, ref_packer, st, twin = _twins(["DoReFaNet"], None, False, 2, 29, 80, n_chains=4,
                                          probs=_inventory((40, 2)), inventory_penalty=3)
    assert st.pcosts.dtype == twin.pcosts.dtype == np.int64
    assert run_lockstep(packer, ref_packer, st, twin) == 80
    assert (st.pcosts != st.costs).all()
    kw = dict(n_chains=4, max_iterations=80, max_seconds=1e9, seed=1, backend="python",
              inventory_penalty=3)
    got = port.pack(port.get_problem("CNV-W1A1", device="U50"), "sa-s", device="cpu", **kw)
    expect = ref.pack(ref.get_problem("CNV-W1A1", device="U50"), "sa-s", **kw)
    assert _key(got) == _key(expect)


@pytest.mark.parametrize("spoil,match", [
    ("item-id", "out of range"), ("count", "out of range"), ("live", "out of range"),
    ("strided", "bw"), ("read-only", "costs")],
    ids=["item-id", "count", "live", "strided", "read-only"])
def test_a_state_the_helper_cannot_take_is_refused(spoil, match):
    """Values the C code indexes by, out of range, or an array it cannot
    point at: `fleet_step` raises, naming what it refused."""
    packer, _, st, _ = _twins(["CNV-W1A1"], "U50", False, 2, 3, 10)
    assert isinstance(sa_native.fleet_step(st, packer), sa_native.FleetStep)
    if spoil == "item-id":
        st.items[0, 0, 0] = st.wtab.shape[-1]
    elif spoil == "count":
        st.counts[1, 0] = st.items.shape[2] + 1
    elif spoil == "live":
        st.live[2] = st.items.shape[1] + 1
    elif spoil == "strided":
        st.bw = np.asfortranarray(st.bw)
    else:
        st.costs.flags.writeable = False
    with pytest.raises(ValueError, match=match):
        sa_native.fleet_step(st, packer)


def test_compiler_search_finds_nothing_without_one(monkeypatch, tmp_path):
    _no_compiler(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="searched no-such-compiler-here"):
        sa_native.library()
    assert not (tmp_path / "host").exists()


FIRST_USE = r"""
import sys, threading
from pathlib import Path
sys.setswitchinterval(1e-6)
import repro.core as ref
import repro_torch.core as c
from repro_torch import obs
from repro_torch.core import sa_native

sa_native.NATIVE.build_dir = Path(sys.argv[1])
prob = c.get_problem("CNV-W2A2", device="U50")
kw = dict(n_chains=4, max_iterations=50, max_seconds=1e9, backend="python")
gate = threading.Barrier(4)
out = [None] * 4


def run(k):
    gate.wait()
    out[k] = c.pack(prob, "sa-s", seed=k, device="cpu", **kw).solution.state_dict()


with obs.recording() as rec:
    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
rprob = ref.get_problem("CNV-W2A2", device="U50")
expect = [ref.pack(rprob, "sa-s", seed=k, **kw).solution.state_dict() for k in range(4)]
assert out == expect
print(rec.count("sa.native.load"), rec.count("sa.native.build"),
      len(list(sa_native.NATIVE.build_dir.iterdir())))
"""


def test_first_use_from_four_threads_builds_and_loads_once(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", FIRST_USE, str(tmp_path / "host")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["1", "1", "1"]
