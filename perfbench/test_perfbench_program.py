"""The readers of the program's own spans (`perfbench/program.py`): each
against values worked out by hand on a synthetic run (records, harness
spans and a device trace made up here), and a small traced run of every
cell on the CPU, in which each host-side reader returns a number and the
older per-layer readers still report."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import bench, program
from perfbench.test_perfbench_faults import shrink
from repro_torch import obs

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = bench.load_manifest()
NEW = ["ops_fill_us_per_call.pack", "ops_wait_us_per_call.pack", "nfd_ms_per_packing",
       "kinds_ms_per_packing", "repack_ms_per_gen", "sa_propose_us_per_step",
       "idle_unnamed_pct", "warmup_s.setup"]
HOST, OTHER = 1, 2
U0 = 1_000_000_000_000 + 20_000_000_000  # the profiler's trace start, Unix ns
ANCHOR = (0, 1_000_000_000_000)  # perf_counter 0 ns is Unix 1000 s


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test works its runs out afresh (``conftest.py`` turns the
    recorder off after it)."""
    program._cache.clear()
    yield
    program._cache.clear()


def _records():
    """``(name, start_s, end_s, thread, sid, parent)``: a set-up call (and
    one from before the run), a first-half pack, and a traced-half pack."""
    rows = [
        # before the run: not set-up
        ("api.pack", 0.1, 0.3, HOST, 1, 0),
        # set-up: the warm-up call
        ("api.pack", 1.0, 2.0, HOST, 2, 0),
        ("kernels.load", 1.1, 1.3, HOST, 3, 2),
        ("kernels.build", 1.15, 1.25, HOST, 4, 3),
        ("nfd.scratch", 1.4, 1.45, HOST, 5, 2),
        # first half: inside the harness's api.pack span [10, 14]
        ("api.pack", 10.001, 13.999, HOST, 10, 0),
        ("ga.start", 10.1, 11.0, HOST, 11, 10),
        ("nfd.scratch", 10.2, 10.6, HOST, 12, 11),
        ("nfd.kinds", 10.5, 10.6, HOST, 13, 12),
        ("nfd.scratch", 10.6, 10.9, HOST, 14, 11),
        ("nfd.kinds", 10.8, 10.9, HOST, 15, 14),
        ("ga.mutation", 11.0, 12.0, HOST, 16, 10),
        ("nfd.repack", 11.1, 11.3, HOST, 17, 16),
        ("nfd.repack", 11.4, 11.5, HOST, 18, 16),
        ("ops.call", 12.0, 12.5, HOST, 19, 10),
        ("ops.alloc", 12.0, 12.05, HOST, 20, 19),
        ("ops.fill", 12.05, 12.15, HOST, 21, 19),
        ("ops.copy", 12.15, 12.2, HOST, 22, 19),
        ("ops.launch", 12.2, 12.3, HOST, 23, 19),
        ("ops.wait", 12.3, 12.49, HOST, 24, 19),
        ("ga.selection", 12.5, 12.6, HOST, 25, 10),
        ("sa.propose", 12.6, 12.7, HOST, 26, 10),
        ("ops.call", 13.0, 13.2, HOST, 27, 10),
        ("ops.alloc", 13.0, 13.01, HOST, 28, 27),
        ("ops.fill", 13.01, 13.03, HOST, 29, 27),
        ("ops.wait", 13.1, 13.19, HOST, 30, 27),
        ("ga.selection", 13.2, 13.25, HOST, 31, 10),
        # traced half [20, 30]: none of it is first-half work
        ("api.pack", 20.5, 29.0, HOST, 100, 0),
        ("ga.mutation", 21.0, 23.0, HOST, 101, 100),
        ("nfd.repack", 21.5, 22.5, HOST, 102, 101),
        ("nfd.scratch", 21.6, 22.4, HOST, 103, 102),
        ("ops.call", 23.0, 24.0, HOST, 104, 100),
        ("ops.launch", 23.2, 23.3, HOST, 105, 104),
        ("ops.wait", 23.5, 24.0, HOST, 106, 104),
        ("ga.selection", 24.0, 25.0, HOST, 107, 100),
        ("sa.propose", 25.0, 25.5, OTHER, 108, 0),  # another thread: not the host's
    ]
    return [obs.Span(sid, name, round(s * 1e9), round(e * 1e9), parent, thread, 1)
            for name, s, e, thread, sid, parent in rows]


def _event(name, start_s, end_s, cid, device):
    return SimpleNamespace(name=name, id=cid, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start_s * 1e6, end=end_s * 1e6))


def _trace(kineto=True, offset=20.0, correlated=True):
    """Seconds from the trace's start (the recorder's clock less 20 s):
    device stamps (0, 0.2), (3.6, 3.8), (9.9, 10.0), issued by runtime calls
    at 0.0, 3.25 and 9.85 (the kernel's device stamp has drifted late)."""
    ops = [("Memcpy HtoD", 0.0, 0.2), ("void fitness_rows_kernel<false>(int)", 3.6, 3.8),
           ("Memcpy DtoH", 9.9, 10.0)]
    calls = [("cudaMemcpyAsync", 0.0), ("cudaLaunchKernel", 3.25), ("cudaMemcpyAsync", 9.85)]
    events = [_event("void spin_kernel(long)", 0.0001, 0.0002, 1, "CUDA"),
              _event("cudaLaunchKernel", 0.00005, 0.00006, 1, "CPU")]
    for i, ((name, a, b), (call, c)) in enumerate(zip(ops, calls)):
        events += [_event(name, a, b, 10 + i, "CUDA"),
                   _event(call, c, c + 0.00001, 10 + i if correlated else 20 + i, "CPU")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: U0)), events=lambda: events)
    return SimpleNamespace(t0=20.0, t1=30.0, window_s=10.0, offset=offset, ops=ops,
                           prof=prof if kineto else SimpleNamespace())


def _run(monkeypatch, trace=None, recs=None):
    stub = SimpleNamespace(anchor=lambda: ANCHOR, reset=lambda: None, enable=lambda: None,
                           counter=lambda name: 0, Snapshot=obs.Snapshot, perf_ns=obs.perf_ns,
                           snapshot=lambda: SimpleNamespace(
                               records=_records() if recs is None else recs))
    monkeypatch.setattr(program, "obs", stub)
    return bench.Run({}, spans={"api.pack": [(10.0, 4.0, HOST)]}, trace=trace, setup_s=9.5)


def _read(name, run):
    return bench.reader(name).read(run)


def test_host_readers_read_the_first_half_alone(monkeypatch):
    run = _run(monkeypatch, trace=_trace())
    # (alloc 0.05 + 0.01 + fill 0.10 + 0.02) / 2 calls; wait (0.19 + 0.09) / 2
    assert _read("ops_fill_us_per_call.pack", run) == pytest.approx(90_000.0)
    assert _read("ops_wait_us_per_call.pack", run) == pytest.approx(140_000.0)
    # the warm-up's 0.05 s pass and the traced half's 0.8 s pass are out
    assert _read("nfd_ms_per_packing", run) == pytest.approx(350.0)
    assert _read("kinds_ms_per_packing", run) == pytest.approx(100.0)
    assert _read("repack_ms_per_gen", run) == pytest.approx(150.0)
    # the traced half's 0.5 s proposal is out
    assert _read("sa_propose_us_per_step", run) == pytest.approx(100_000.0)
    # the warm-up call, not the call from before the run began
    assert _read("warmup_s.setup", run) == pytest.approx(1.0)


# the idle split on the device's own stamps: gaps [20.2, 23.6] and
# [23.8, 29.9]; the first runs across two leaf spans (nfd.scratch inside
# nfd.repack) and ops.launch
RAW = {None: 0.3 + 0.9, "api.pack": 0.5 + 4.0, "ga.mutation": 1.0, "nfd.repack": 0.2,
       "nfd.scratch": 0.8, "ops.call": 0.4, "ops.launch": 0.1, "ops.wait": 0.1 + 0.2,
       "ga.selection": 1.0}


def _check_split(split, want):
    assert set(split["by"]) == set(want)
    for k, v in want.items():
        assert split["by"][k] == pytest.approx(v, abs=1e-9), k
    assert split["total"] == pytest.approx(9.5)


def test_idle_is_split_by_overlap_on_the_launch_calls_clock(monkeypatch):
    """Each device operation at its runtime call's host time: gaps [20.2,
    23.25], [23.45, 29.85], [29.95, 30]."""
    run = _run(monkeypatch, trace=_trace(offset=20.0 - 12e-6))
    split = program.idle_split(run)
    assert split["how"] == "kineto, re-based on launch calls"
    _check_split(split, {None: 0.3 + 0.85 + 0.05, "api.pack": 0.5 + 4.0, "ga.mutation": 1.0,
                         "nfd.repack": 0.2, "nfd.scratch": 0.8, "ops.call": 0.2 + 0.05,
                         "ops.launch": 0.05, "ops.wait": 0.5, "ga.selection": 1.0})
    assert _read("idle_unnamed_pct", run) == pytest.approx(100 * 5.7 / 9.5)
    check = program.clock_check(run)
    assert check["kineto_minus_spin_us"] == pytest.approx(12.0, abs=1e-3)
    assert check["spin_start_after_call_us"] == pytest.approx(50.0, abs=1e-3)
    # the spin's call 50 us after the trace began: 12 us - 50 us after the mark
    assert check["spin_call_after_mark_us"] == pytest.approx(-38.0, abs=1e-3)
    assert (check["kernels"], check["launch_spans"]) == (1, 1)
    assert (check["calls_outside_span"], check["before_span"], check["raw_before_span"]) == (0, 0, 0)
    assert check["min_call_lead_us"] == pytest.approx(0.05e6)
    assert check["min_lead_us"] == pytest.approx(0.05e6)
    assert check["min_raw_lead_us"] == pytest.approx(0.4e6)


def test_without_launch_calls_the_device_stamps_are_used(monkeypatch):
    run = _run(monkeypatch, trace=_trace(correlated=False))
    split = program.idle_split(run)
    assert split["how"] == "kineto, device stamps"
    _check_split(split, RAW)


def test_without_the_profilers_stamp_the_spin_offset_is_used(monkeypatch, capsys):
    run = _run(monkeypatch, trace=_trace(kineto=False, offset=20.0))
    split = program.idle_split(run)
    assert split["how"] == "spin"
    _check_split(split, RAW)
    assert _read("idle_unnamed_pct", run) == pytest.approx(100 * 5.7 / 9.5)
    assert "spin-mark offset" in capsys.readouterr().err


def test_the_clock_check_sees_drifting_device_stamps(monkeypatch):
    """Two K1 launches 5 s apart whose device stamps drift -720 ppm from
    their launch calls: the raw stamp of the second starts before its span,
    the re-based one does not."""
    events = []
    for i, (call, raw) in enumerate(((1.0, 1.0001), (6.0, 5.9965))):
        events += [_event("void fitness_rows_kernel<false>(int)", raw, raw + 0.0001, 10 + i, "CUDA"),
                   _event("cudaLaunchKernel", call, call + 0.00001, 10 + i, "CPU")]
    trace = _trace()
    trace.prof.events = lambda: events
    trace.ops = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                 for e in events if e.device_type.endswith("CUDA")]
    recs = [obs.Span(1, "api.pack", 20_500_000_000, 29_000_000_000, 0, HOST, 1),
            obs.Span(2, "ops.launch", 20_999_500_000, 21_000_500_000, 1, HOST, 1),
            obs.Span(3, "ops.launch", 25_999_500_000, 26_000_500_000, 1, HOST, 1)]
    check = program.clock_check(_run(monkeypatch, trace=trace, recs=recs))
    assert check["drift_ppm"] == pytest.approx(-720.0)
    assert (check["kernels"], check["calls_outside_span"]) == (2, 0)
    assert (check["raw_before_span"], check["before_span"]) == (1, 0)
    assert check["min_raw_lead_us"] == pytest.approx(-3000.0)
    assert check["min_lead_us"] == pytest.approx(500.0)


def test_a_program_without_spans_gives_no_numbers(monkeypatch):
    run = _run(monkeypatch, trace=_trace(), recs=[])
    for name in NEW:
        assert _read(name, run) is None, name
    monkeypatch.setattr(program, "obs", None)  # a program with no recorder at all
    program._cache.clear()
    for name in NEW:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_a_small_traced_run_reports_the_program_metrics(cell):
    r = bench.run_cell(cell, 2**31 + 29, 0.4, True, "cpu", time.perf_counter(),
                       manifest=MANIFEST, traffic_override=shrink, log=lambda m: None)
    assert r["correct"] is True
    listed = [m for m in MANIFEST["per_layer"] if bench.applies(m, cell)]
    host = {m["name"] for m in listed if m["source"] != "device_trace"}
    assert host <= set(r["metrics"]), host - set(r["metrics"])
    new_here = host & set(NEW)
    assert new_here and all(r["metrics"][n]["value"] > 0 for n in new_here)
    assert json.dumps(r)  # the result line stays one JSON object


def test_importing_the_module_alone_records_nothing():
    """Only a loaded reader turns the recorder on: collecting these tests
    (which imports the module) leaves every other test unrecorded."""
    code = ("from perfbench import program; from repro_torch import obs; "
            "assert program.obs is obs and not obs.enabled(); "
            "from perfbench import bench; bench.reader('nfd_ms_per_packing'); "
            "assert obs.enabled()")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH")))))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True)
