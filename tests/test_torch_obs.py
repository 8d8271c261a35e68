"""The port's span and counter recorder (`repro_torch.obs`), on the CPU:
off by default and free of records while off, nesting (parents, entry ids,
self time), one stack a thread, the bounded buffer, the launch counters,
results bit-identical with recording on and off, every span the engines and
the ops layer name, and the shared clock with ``torch.profiler``."""
import collections
import sys
import threading
import time

import numpy as np
import pytest

import repro_torch.core as rc
from repro_torch import kernels, obs
from repro_torch.kernels import build
from repro_torch.kernels.binpack_fitness.kernel import binpack_fitness_cuda

# the spans the engines, the NFD pass and the ops layer place; `kernels.load`
# and `kernels.build` run only where a library is loaded (their own test)
ENGINE_SPANS = {
    "api.pack", "dse.sweep",
    "ga.start", "ga.eval", "ga.mutation", "ga.apply", "ga.best", "ga.selection", "ga.finish",
    "sa.start", "sa.encode", "sa.propose", "sa.gather", "sa.accept", "sa.finish",
    "nfd.scratch", "nfd.kinds", "nfd.repack",
    "ops.call", "ops.alloc", "ops.fill", "ops.copy", "ops.launch", "ops.wait",
}


@pytest.fixture(autouse=True)
def recorder():
    """Each test sets the recorder's state itself: a reader loaded earlier
    in the same worker may have turned it on."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_off_records_nothing_and_launches_still_count():
    assert not obs.enabled()
    tok = obs.begin("api.pack", entry=True)
    assert tok is None
    obs.end(tok)
    assert obs.span("x") is obs.span("y")  # the shared no-op while off
    with obs.span("x"):
        pass
    p = rc.get_problem("CNV-W1A1")
    rc.pack(p, "ga-nfd", seed=0, max_generations=2, max_seconds=1e9, patience=10**9,
            backend="cuda", device="cpu")
    assert obs.snapshot().records == []
    kernels.reset_launch_counts()
    for _ in range(3):
        build.count_launch(binpack_fitness_cuda)
    counts = kernels.launch_counts()
    assert counts["binpack_fitness_cuda"] == 3
    assert sum(counts.values()) == 3 and obs.counter("launch.binpack_fitness_cuda") == 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_nesting_parents_entry_ids_and_self_time(monkeypatch):
    # begin reads the clock once, end once, in this order
    monkeypatch.setattr(obs, "_perf_ns", FakeClock([0, 1, 2, 5, 6, 7, 10, 12, 20, 21, 22, 30]))
    obs.enable(anchor=(0, 1_000_000_000))
    a = obs.begin("api.pack", entry=True)
    b = obs.begin("ga.start")
    c = obs.begin("nfd.scratch")
    obs.end(c)
    obs.end(b)
    d = obs.begin("ga.mutation", entry=True)  # nested: keeps the outer entry id
    obs.end(d)
    obs.end(a)
    e = obs.begin("api.pack", entry=True)
    leaked = obs.begin("ga.eval")  # never closed: dropped with its parent's end
    assert leaked is not None
    f = obs.begin("nfd.repack")
    assert f is not None
    obs.end(e)
    snap = obs.snapshot()
    assert [r.name for r in snap.records] == ["nfd.scratch", "ga.start", "ga.mutation",
                                              "api.pack", "api.pack"]
    rc_, rb, rd, ra, re_ = snap.records
    assert ra.parent == 0 and rb.parent == ra.sid and rc_.parent == rb.sid
    assert ra.entry > 0 and rd.parent == ra.sid and rb.entry == rc_.entry == rd.entry == ra.entry
    assert re_.entry > ra.entry and re_.parent == 0
    assert (ra.start_ns, ra.end_ns, rc_.start_ns, rc_.end_ns) == (0, 12, 2, 5)
    # self time: api.pack 12 - (ga.start 5 + ga.mutation 3); ga.start 5 - 3
    assert snap.self_s["ga.start"] == pytest.approx(2e-9)
    assert snap.self_s["nfd.scratch"] == pytest.approx(3e-9)
    assert snap.self_s["api.pack"] == pytest.approx(4e-9 + 10e-9)
    assert snap.count("api.pack") == 2 and snap.seconds("api.pack") == pytest.approx(22e-9)
    assert snap.spans["nfd.scratch"] == [(2e-9, 3e-9, threading.get_ident())]
    # the stack is empty again: the next span has no parent
    monkeypatch.setattr(obs, "_perf_ns", FakeClock([40, 41]))
    g = obs.begin("ga.best")
    obs.end(g)
    assert obs.snapshot().records[-1].parent == 0
    assert obs.unix_ns(41) == 1_000_000_041 and obs.perf_ns(1_000_000_041) == 41


def test_two_threads_record_at_once_each_on_its_own_stack():
    n_threads, n_spans = 6, 400
    barrier = threading.Barrier(n_threads)
    obs.enable()

    def work(i):
        barrier.wait()
        for _ in range(n_spans):
            outer = obs.begin(f"outer{i}", entry=True)
            inner = obs.begin(f"inner{i}")
            obs.end(inner)
            obs.end(outer)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = obs.snapshot()
    by_sid = {r.sid: r for r in snap.records}
    assert len(snap.records) == 2 * n_threads * n_spans
    for r in snap.records:
        i = r.name[5:]
        if r.name.startswith("inner"):
            parent = by_sid[r.parent]
            assert parent.name == f"outer{i}" and parent.thread == r.thread
            assert parent.entry == r.entry
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        else:
            assert r.parent == 0
    assert len({r.entry for r in snap.records}) == n_threads * n_spans
    assert len({r.thread for r in snap.records}) == n_threads


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    obs.reset_counters(["obs.dropped"])
    monkeypatch.setattr(obs, "CAPACITY", 5)
    monkeypatch.setattr(obs, "_buf", collections.deque(maxlen=5))
    obs.enable()
    for i in range(8):
        obs.end(obs.begin(f"s{i}"))
    snap = obs.snapshot()
    assert [r.name for r in snap.records] == [f"s{i}" for i in range(3, 8)]
    assert obs.counter("obs.dropped") == 3 and snap.dropped == 3
    obs.reset_counters(["obs.dropped"])


def _ga():
    p = rc.get_problem("CNV-W1A1")
    return rc.pack(p, "ga-nfd", seed=7, max_generations=4, max_seconds=1e9, patience=10**9,
                   backend="cuda", device="cpu")


def _sa():
    p = rc.get_problem("CNV-W1A1", device="U50")
    return rc.pack(p, "sa-s", seed=8, n_chains=4, max_iterations=40, max_seconds=1e9,
                   patience=10**9, backend="cuda", device="cpu")


def _sweep():
    probs = [rc.get_problem("CNV-W1A1"), rc.get_problem("CNV-W2A2")]
    return rc.pack_sweep(probs, "sa-s", seeds=[3, 4], n_chains=4, max_iterations=30,
                         max_seconds=1e9, patience=10**9, backend="cuda", device="cpu")


def _answer(res):
    """Everything a result says but its wall times."""
    if isinstance(res, rc.SweepResult):
        return [_answer(r) for r in res.results]
    sol = res.solution
    return (res.cost, [c for _, c in res.trace], res.iterations,
            [list(b) for b in sol.bins], [int(k) for k in sol.kinds],
            {k: v for k, v in res.params.items()})


@pytest.mark.parametrize("run", [_ga, _sa, _sweep], ids=["ga-nfd", "sa-s-x4-u50", "sweep"])
def test_results_are_bit_identical_with_recording_on_and_off(run):
    off = _answer(run())
    with obs.recording() as rec:
        on = _answer(run())
    assert on == off
    assert rec.records and rec.count("api.pack") + rec.count("dse.sweep") == 1
    assert not obs.enabled()  # left as it was found


def test_every_engine_and_ops_span_is_emitted():
    with obs.recording() as rec:
        _ga(), _sa(), _sweep()
    assert ENGINE_SPANS <= set(rec.spans), ENGINE_SPANS - set(rec.spans)
    # one ops call a generation (and the initial evaluation) / SA step, each
    # with one of every part
    calls = rec.count("ops.call")
    assert calls == 4 + 1 + 40 + 30
    for part in ("ops.alloc", "ops.fill", "ops.copy", "ops.launch", "ops.wait"):
        assert rec.count(part) == calls
    assert rec.count("ga.selection") == 4 and rec.count("sa.propose") == 70
    assert rec.count("nfd.kinds") == rec.count("nfd.scratch")
    # every span lies inside its parent, on its thread, under one entry id
    by_sid = {r.sid: r for r in rec.records}
    for r in rec.records:
        if r.parent in by_sid:
            p = by_sid[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns and p.entry == r.entry
    assert len({r.entry for r in rec.records}) == 3
    assert all(v >= -1e-9 for v in rec.self_s.values())


def test_kernel_load_and_build_are_spans(tmp_path, monkeypatch):
    """``kernels.load`` (a library's first load) around ``kernels.build``
    (nvcc), with a stand-in compiler and ``ctypes.CDLL``."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('library')\n")
    fake.chmod(0o755)

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn):
            def entry():
                return build.LIBRARY_CONSTANTS.get(fn, 0)
            setattr(self, fn, entry)
            return entry

    monkeypatch.setattr(build.KERNELS, "build_dir", tmp_path / "kernels")
    monkeypatch.setattr(build.KERNELS, "loaded", {})
    monkeypatch.setattr(build.KERNELS, "compilers", (str(fake),))
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    with obs.recording() as rec:
        build.load("packed_gather")
        build.load("packed_gather")  # loaded: no span
    assert rec.count("kernels.load") == 1 and rec.count("kernels.build") == 1
    load, = (r for r in rec.records if r.name == "kernels.load")
    nvcc, = (r for r in rec.records if r.name == "kernels.build")
    assert nvcc.parent == load.sid


def test_spans_map_onto_the_profilers_clock():
    """A span recorded inside a CPU ``record_function`` range falls inside
    that range once mapped through the recorder's anchor and the
    profiler's own ``trace_start_ns()``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("around"):
            time.sleep(0.003)
            tok = obs.begin("inside")
            time.sleep(0.005)
            obs.end(tok)
            time.sleep(0.003)
    start_ns = int(prof.profiler.kineto_results.trace_start_ns())
    (ev,) = [e for e in prof.events() if e.name == "around"]
    lo = start_ns + int(ev.time_range.start * 1000)
    hi = start_ns + int(ev.time_range.end * 1000)
    (rec,) = obs.snapshot().records
    a, b = obs.unix_ns(rec.start_ns), obs.unix_ns(rec.end_ns)
    assert lo <= a < b <= hi, (lo - a, hi - b)


def test_recording_keeps_what_was_recorded_before_and_counts_its_own_launches():
    obs.enable()
    obs.end(obs.begin("before"))
    with obs.recording() as rec:
        obs.end(obs.begin("during"))
        build.count_launch(binpack_fitness_cuda)
    assert obs.enabled()  # it was on, and stays on
    assert [r.name for r in rec.records] == ["during"]
    assert rec.counters == {"launch.binpack_fitness_cuda": 1}
    assert [r.name for r in obs.snapshot().records] == ["before", "during"]
    kernels.reset_launch_counts()
    assert np.isclose(rec.seconds("during"), rec.self_s["during"])


def test_the_recorder_imports_only_the_standard_library():
    import ast

    tree = ast.parse(open(obs.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module != "__future__"}
    assert names and names <= sys.stdlib_module_names, names - sys.stdlib_module_names
    assert not any(isinstance(n, ast.ImportFrom) and n.level for n in ast.walk(tree))
