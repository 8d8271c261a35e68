"""`repro_torch.serve.traffic` and ``tools/serve_traffic_torch.py`` on the
CPU, against `repro.serve.traffic`.

The corpus and the arrival schedule are drawn from numpy's
``default_rng`` in the reference's order, so one seed gives the
reference's problems (equal fingerprints) and schedule; ``run_traffic`` /
``verify_parity`` drive and check a port service; and the CLI's kill lane
(SIGKILL after K responses, then a restart over the same store that must
be served warm and bit-identical) runs once as real processes.
"""
import asyncio
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core as ref
import repro.serve as ref_serve
import repro_torch.core as port
from repro_torch.serve import (
    Arrival,
    PackingService,
    make_problems,
    make_workload,
    result_signature,
    run_traffic,
    verify_parity,
)

ROOT = Path(__file__).resolve().parents[1]
_KW = dict(max_seconds=1e9, patience=10**9, max_iterations=40, n_chains=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem_record(p):
    ocm = None if p.ocm is None else (p.ocm.name, tuple(p.ocm.counts),
                                      tuple(k.name for k in p.ocm.kinds))
    return (p.fingerprint(), p.name, p.max_items, p.n, ocm)


@pytest.mark.parametrize("seed", [0, 3, 11, 21])
@pytest.mark.parametrize("hetero", [False, True])
def test_make_problems_equal_the_references(seed, hetero):
    mine = make_problems(6, seed=seed, hetero=hetero, max_buffers=24)
    theirs = ref_serve.make_problems(6, seed=seed, hetero=hetero, max_buffers=24)
    assert [_problem_record(p) for p in mine] == [_problem_record(p) for p in theirs]


@pytest.mark.parametrize("kw", [
    dict(n_requests=64, n_problems=24, seed=0),
    dict(n_requests=24, n_problems=4, rate_hz=500.0, seed=0),
    dict(n_requests=40, n_problems=7, rate_hz=50.0, zipf_a=0.8, n_seeds=3, seed=5),
    dict(n_requests=1, n_problems=1, seed=9),
])
def test_make_workload_equals_the_references(kw):
    kw = dict(kw)
    n, k = kw.pop("n_requests"), kw.pop("n_problems")
    mine = make_workload(n, k, **kw)
    theirs = ref_serve.make_workload(n, k, **kw)
    assert [(a.at_s, a.prob_idx, a.seed) for a in mine] == [
        (a.at_s, a.prob_idx, a.seed) for a in theirs]
    assert all(isinstance(a, Arrival) for a in mine)


def test_result_signature_equals_the_references():
    p = make_problems(1, seed=4, hetero=True, max_buffers=16)[0]
    q = ref_serve.make_problems(1, seed=4, hetero=True, max_buffers=16)[0]
    mine = port.pack(p, "sa-s", seed=1, device="cpu", **_KW)
    theirs = ref.pack(q, "sa-s", seed=1, backend="python", **_KW)
    assert result_signature(mine) == ref_serve.result_signature(theirs)


def test_run_traffic_and_verify_parity_on_a_small_run():
    """A Zipf / Poisson run through a port service: every record answered,
    every deadline-th request carrying its deadline, parity holding over
    the service's state and over explicit responses, and a wrong response
    caught."""
    problems = make_problems(3, seed=2, hetero=True, max_buffers=12)
    workload = make_workload(12, 3, rate_hz=2000.0, seed=1)

    async def go():
        async with PackingService("sa-s", device="cpu", backend="cuda", max_batch=3,
                                  **_KW) as svc:
            out = await run_traffic(svc, problems, workload, concurrency=4,
                                    deadline_ms=1.0, deadline_every=4)
            unique = sorted({(a.prob_idx, a.seed) for a in workload})
            served = {t: svc._results[svc.task_key(problems[t[0]], t[1])]
                      for t in unique}
            return out, svc.stats(), verify_parity(svc, problems, workload), served, svc

    out, stats, parity, served, svc = asyncio.run(go())
    assert [r["i"] for r in out["records"]] == list(range(len(workload)))
    assert [r["deadline_ms"] for r in out["records"]] == [
        1.0 if i % 4 == 0 else None for i in range(len(workload))]
    assert out["latency"]["count"] == len(workload) and out["rps"] > 0
    assert stats["requests"] == len(workload)
    assert parity == {"parity": True, "tasks": len(served), "mismatches": []}
    assert verify_parity(svc, problems, workload, responses=served)["parity"]
    # the replay on another backend than the service's holds it too
    assert verify_parity(svc, problems, workload, backend="python") == parity
    (first, *_), wrong = sorted(served), dict(served)
    wrong[first] = port.pack(problems[first[0]], "sa-s", seed=first[1] + 7,
                             device="cpu", **_KW)
    bad = verify_parity(svc, problems, workload, responses=wrong)
    assert not bad["parity"] and bad["mismatches"] == [
        {"prob_idx": first[0], "seed": first[1], "error": "signature mismatch"}]
    # the replays ran the service's settings through the reference too
    q = ref_serve.make_problems(3, seed=2, hetero=True, max_buffers=12)[first[0]]
    want = ref.pack(q, "sa-s", seed=first[1], backend="python", **_KW)
    assert result_signature(served[first]) == ref_serve.result_signature(want)


def _cli(*args, timeout=150):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "serve_traffic_torch.py"), *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )


def test_kill_lane_on_the_cpu(tmp_path):
    """SIGKILL after 8 responses, then a restart over the same store that
    serves the survivors warm and bit-identical to standalone pack()."""
    store = str(tmp_path / "store")
    killed = _cli("--device", "cpu", "--smoke", "--store", store, "--die-after", "8")
    assert killed.returncode == -signal.SIGKILL, killed.stderr
    assert any((tmp_path / "store").glob("entry_*"))
    warm = _cli("--device", "cpu", "--smoke", "--store", store, "--expect-warm",
                "--verify", "--verify-backend", "python")
    assert warm.returncode == 0, warm.stdout + warm.stderr
    assert "parity OK over" in warm.stdout
    assert "(replayed on backend python)" in warm.stdout
    if not torch.cuda.is_available():
        # the default device is cuda: without it the CLI fails, loudly
        default = _cli("--smoke", "--store", str(tmp_path / "other"))
        assert default.returncode != 0
        assert "CUDA is not available" in default.stderr
