"""The full NFD pass through the compiled host loop (`core/nfd_native.py`,
``csrc/nfd_pass.c``) against the Python loop and the reference, bit for bit.

The helper must give the Python loop's bins, the rows `Solution._refresh`
computes for them, and the generator's whole state afterwards, buffered
32-bit half included (``has_uint32`` is set by an ``rng.integers`` before
each pass).  Cases run over every Table-1 accelerator, on BRAM18 and on an
Alveo U50's inventory, and over the admission rule's knobs; then
`nfd_from_scratch` and whole GA-NFD / SA-S packs are held to
`repro.core`'s, inputs the pass cannot take and a host without a compiler
are refused, and the first use from four threads is checked.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import nfd, nfd_native
from repro_torch.core.problem import Solution

ROOT = Path(__file__).resolve().parents[1]
DEVICES = [None, "U50"]  # table1.bram18 and table1.u50


def _problem(name, device, max_items=4):
    ocm = port.get_ocm(device) if device else None
    return port.PackingProblem(port.get_buffers(name), ocm=ocm, max_items=max_items,
                               name=name)


def _rng(seed):
    """A generator with its buffered 32-bit half set."""
    rng = np.random.default_rng(seed)
    rng.integers(1000)
    assert rng.bit_generator.state["has_uint32"] == 1
    return rng


def _order(prob, rng, sort_by_width, intra_layer):
    order = rng.permutation(prob.n)
    if sort_by_width:
        order = order[np.argsort(prob.widths[order], kind="stable")]
    if intra_layer:
        order = order[np.argsort(prob.layers[order], kind="stable")]
    return order


def check_pass(prob, seed, sort_by_width, intra_layer, p_adm_w, p_adm_h):
    """One pass through the helper and through the Python loop from equal
    generators: equal bins, rows, cost and generator state."""
    ra, rb = _rng(seed), _rng(seed)
    oa = _order(prob, ra, sort_by_width, intra_layer)
    ob = _order(prob, rb, sort_by_width, intra_layer)
    bins, geom = nfd_native.pack_order(prob, oa, ra, p_adm_w, p_adm_h, intra_layer)
    expect = nfd.nfd_pack_order(prob, ob, rb, p_adm_w=p_adm_w, p_adm_h=p_adm_h,
                                intra_layer=intra_layer)
    assert bins == expect
    assert all(type(i) is int for b in bins for i in b)
    assert ra.bit_generator.state == rb.bit_generator.state
    sol = Solution(prob, expect)
    sol._refresh()
    assert geom.dtype == np.int64 and geom.shape == (len(bins), 6)
    np.testing.assert_array_equal(geom, sol._geom)
    native = Solution._with_geometry(prob, bins, geom, np.zeros(len(bins), dtype=bool))
    assert native.cost() == sol.cost_full() == sol.cost()
    native.validate(intra_layer=intra_layer)
    return bins


@pytest.mark.parametrize("intra_layer", [False, True], ids=["any-layer", "intra-layer"])
@pytest.mark.parametrize("sort_by_width", [False, True], ids=["random", "by-width"])
@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
@pytest.mark.parametrize("name", port.ACCELERATORS)
def test_pass_equals_python_loop_on_table1(name, device, sort_by_width, intra_layer):
    hp = port.hyperparams(name)
    check_pass(_problem(name, device), 2**31 + 11, sort_by_width, intra_layer,
               hp["p_adm_w"], hp["p_adm_h"])


@pytest.mark.parametrize("max_items", [1, 2, 3, 4])
@pytest.mark.parametrize("p_adm_h", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("p_adm_w", [0.0, 0.3])
@pytest.mark.parametrize("name,device,intra_layer,sort_by_width",
                         [("DoReFaNet", None, False, True), ("RN50-W1A2", "U50", True, False)],
                         ids=["dorefanet-bram18", "rn50-u50"])
def test_pass_equals_python_loop_over_admission_knobs(name, device, intra_layer,
                                                      sort_by_width, p_adm_w, p_adm_h,
                                                      max_items):
    bins = check_pass(_problem(name, device, max_items), 5, sort_by_width, intra_layer,
                      p_adm_w, p_adm_h)
    assert max(len(b) for b in bins) <= max_items


@pytest.mark.parametrize("intra_layer", [False, True], ids=["any-layer", "intra-layer"])
@pytest.mark.parametrize("sort_by_width", [False, True], ids=["random", "by-width"])
@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
@pytest.mark.parametrize("name", port.ACCELERATORS)
def test_nfd_from_scratch_equals_reference(name, device, sort_by_width, intra_layer):
    hp = port.hyperparams(name)
    kw = dict(p_adm_w=hp["p_adm_w"], p_adm_h=hp["p_adm_h"], intra_layer=intra_layer,
              sort_by_width=sort_by_width)
    ra, rb = _rng(3), _rng(3)
    got = nfd.nfd_from_scratch(port.get_problem(name, device=device), ra, **kw)
    expect = ref.nfd_from_scratch(ref.get_problem(name, device=device), rb, **kw)
    assert got.bins == [list(b) for b in expect.bins]
    assert got.kinds.tolist() == [int(k) for k in expect.kinds]
    assert got.cost() == got.cost_full() == expect.cost()
    assert ra.bit_generator.state == rb.bit_generator.state


def _key(r):
    return (r.cost, [list(b) for b in r.solution.bins], [int(k) for k in r.solution.kinds],
            r.iterations, [c for _, c in r.trace])


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
@pytest.mark.parametrize("algorithm,kw", [
    ("ga-nfd", dict(n_pop=12, max_generations=8)),
    ("sa-s", dict(n_chains=6, max_iterations=120)),
], ids=["ga-nfd", "sa-s"])
def test_pack_equals_reference_seed_for_seed(algorithm, kw, device, seed):
    name = "RN50-W1A2"
    kw = dict(ref.hyperparams(name), seed=seed, max_seconds=1e9, **kw)
    expect = _key(ref.pack(ref.get_problem(name, device=device), algorithm,
                           backend="python", **kw))
    got = port.pack(port.get_problem(name, device=device), algorithm, backend="torch",
                    device="cpu", **kw)
    assert _key(got) == expect


def _no_compiler(monkeypatch, tmp_path):
    """An empty build directory and a compiler search that finds nothing."""
    monkeypatch.setattr(nfd_native.NATIVE, "build_dir", tmp_path / "host")
    monkeypatch.setattr(nfd_native.NATIVE, "compilers", ("no-such-compiler-here",))
    monkeypatch.setattr(nfd_native.NATIVE, "loaded", {})


@pytest.mark.parametrize("device", DEVICES, ids=["bram18", "u50"])
def test_pack_raises_without_a_compiler(monkeypatch, tmp_path, device):
    _no_compiler(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nfd.native libraries: searched no-such-compiler"):
        port.pack(port.get_problem("RN50-W1A2", device=device), "ga-nfd", n_pop=12,
                  max_generations=8, max_seconds=1e9, seed=8, backend="torch", device="cpu")
    assert not (tmp_path / "host").exists()


def test_order_outside_the_problem_is_refused():
    prob = port.get_problem("CNV-W1A1")
    for order in (np.array([0, prob.n]), np.array([-1, 0]), np.zeros((2, 2))):
        with pytest.raises(ValueError, match="indices into"):
            nfd_native.pack_order(prob, order, _rng(0), 0.0, 0.1, False)


def test_a_generator_or_mode_table_the_pass_cannot_take_is_refused(monkeypatch):
    """A generator that is not a numpy ``Generator``, or a mode of size 0
    (the Python loop would divide by it): refused, the generator untouched."""
    prob = port.get_problem("CNV-W1A1")
    order = np.arange(prob.n)
    with pytest.raises(TypeError, match="numpy Generator"):
        nfd_native.pack_order(prob, order, np.random.RandomState(0), 0.0, 0.1, False)
    mode_w = prob._kind_mode_w[0].copy()
    mode_w[-1] = 0
    monkeypatch.setattr(prob, "_kind_mode_w", [mode_w] + prob._kind_mode_w[1:])
    rng = _rng(0)
    state = rng.bit_generator.state
    with pytest.raises(ValueError, match="mode size below 1"):
        nfd_native.pack_order(prob, order, rng, 0.0, 0.1, False)
    assert rng.bit_generator.state == state


def test_compiler_search_finds_nothing_without_one(monkeypatch, tmp_path):
    _no_compiler(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="searched no-such-compiler-here"):
        nfd_native.library()
    assert not (tmp_path / "host").exists()


FIRST_USE = r"""
import sys, threading
from pathlib import Path
sys.setswitchinterval(1e-6)
import numpy as np
import repro.core as ref
import repro_torch.core as c
from repro_torch import obs
from repro_torch.core import nfd, nfd_native

nfd_native.NATIVE.build_dir = Path(sys.argv[1])
prob = c.get_problem("CNV-W2A2")
gate = threading.Barrier(4)
out = [None] * 4


def run(k):
    gate.wait()
    out[k] = nfd.nfd_from_scratch(prob, np.random.default_rng(k)).bins


with obs.recording() as rec:
    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
rprob = ref.get_problem("CNV-W2A2")
expect = [[list(b) for b in ref.nfd_from_scratch(rprob, np.random.default_rng(k)).bins]
          for k in range(4)]
assert out == expect
print(rec.count("nfd.native.load"), rec.count("nfd.native.build"),
      len(list(nfd_native.NATIVE.build_dir.iterdir())))
"""


def test_first_use_from_four_threads_builds_and_loads_once(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", FIRST_USE, str(tmp_path / "host")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["1", "1", "1"]
