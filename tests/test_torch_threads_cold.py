"""Thread-safe first use of the port's threaded entry points.

Every entry point that runs engine code on worker threads
(`pack_portfolio_threads`' island pool, `pack_portfolio`'s side lane,
`pack_sweep` / `solve_batch` shard threads, `PackingService`'s worker lane,
`CheckpointManager`'s writer thread)
must find every module of the port it needs already loaded by the
caller's ``import repro_torch.core`` / ``import repro_torch.serve``.  A
worker thread that imports a module of the port for the first time can
take two packages' module locks in the opposite order to another thread
and die with ``_frozen_importlib._DeadlockError``.

The first test cannot pass by luck: it records the thread of every
``repro_torch`` module loaded after the imports, through a ``sys.meta_path``
finder, and fails if any was loaded off the main thread.  The second
runs the failing call of the fault, in six fresh processes at once with the
interpreter's switch interval at 1 us, each as its first call into the port.
The third runs ``tools/cold_threads_torch.py`` (``chip_smoke.py`` phase 6h's
child) on the CPU and holds its records to the same calls on ``python``.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COLD_TOOL = ROOT / "tools" / "cold_threads_torch.py"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

RECORD = r"""
import asyncio, sys, tempfile, threading
import torch
import repro_torch.core as c
import repro_torch.serve as s
from repro_torch.checkpoint import CheckpointManager

torch.set_num_threads(1)
loads = []


class Recorder:
    # a meta-path finder is asked only for modules not yet in sys.modules
    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] == "repro_torch":
            loads.append((name, threading.current_thread().name))
        return None


sys.meta_path.insert(0, Recorder)
main = threading.main_thread().name
p = c.get_problem("CNV-W1A1")
hp = c.get_problem("CNV-W1A1", device="ZU7EV")
cpu = dict(backend="torch", device="cpu")

r = c.pack_portfolio_threads(p, n_islands=3, max_seconds=0.3, sa_chains=2, **cpu)
r.solution.validate()
budgets = dict(max_generations=2, max_iterations=32, max_seconds=1e9)
for fused in (None, False):  # fused: the scalar SA-NFD island on the side
    # lane; unfused: the GA islands there too
    for prob in (p, hp):
        r = c.pack_portfolio(prob, n_islands=4, sa_chains=2, migration_every=16,
                             scheduler="concurrent", fused=fused, **budgets, **cpu)
        r.solution.validate()
        assert r.params["fused"] is (fused is None), r.params["fused"]
fleet = [c.get_problem(n, device=d) for n in ("CNV-W1A1", "CNV-W2A2")
         for d in (None, "ZU7EV", "U50", "U250")]
for alg, kw in (("sa-s", dict(n_chains=2, max_iterations=20)),
                ("ga-nfd", dict(n_pop=6, max_generations=2))):
    for ck in (None, tempfile.mkdtemp()):  # checkpointed: the resume lane
        sw = c.pack_sweep(fleet, alg, n_shards=4, max_seconds=1e9, patience=10**9,
                          checkpoint_dir=ck, checkpoint_every=8, **kw, **cpu)
        assert sw.params["n_shards"] == 4 and len(sw.results) == 8
m = CheckpointManager(tempfile.mkdtemp())  # its writer thread
m.save(1, {"x": torch.ones(2, dtype=torch.bfloat16)})
m.wait()


async def serve(alg, kw):
    async with s.PackingService(alg, max_seconds=1e9, **kw, **cpu) as svc:
        await asyncio.gather(*(svc.pack(q) for q in fleet))
        return svc.stats()


for alg, kw in (("sa-s", dict(n_chains=2, max_iterations=20)),
                ("ga-nfd", dict(n_pop=6, max_generations=2))):
    assert asyncio.run(serve(alg, kw))["solved"] == 8
off_main = sorted({(m, t) for m, t in loads if t != main})
assert not off_main, off_main
print("ok", len(loads))
"""

FIRST_CALL = r"""
import sys
sys.setswitchinterval(1e-6)
import torch
import repro_torch.core as c
torch.set_num_threads(1)
r = c.pack_portfolio_threads(c.get_problem("CNV-W1A1"), n_islands=2, max_seconds=0.3,
                             backend="torch", sa_chains=2, device="cpu")
r.solution.validate()
print("ok")
"""


def test_threaded_entry_points_load_no_module_off_the_main_thread():
    out = subprocess.run(
        [sys.executable, "-c", RECORD], env=ENV, capture_output=True,
        text=True, timeout=150,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[0] == "ok"


def test_cold_thread_portfolio_in_six_processes_at_once():
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", FIRST_CALL], env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=150)
            results.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(rc, se[-2000:]) for rc, so, se in results
              if rc != 0 or so.strip() != "ok"]
    assert not failed, failed


def test_cold_child_records_equal_python():
    import repro_torch.core as rc

    spec = importlib.util.spec_from_file_location("cold_threads_torch", COLD_TOOL)
    cold = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cold)
    out = subprocess.run(
        [sys.executable, str(COLD_TOOL), "--device", "cpu"],
        env=ENV, capture_output=True, text=True, timeout=150,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = cold.python_records(rc, "cpu")
    finally:
        torch.set_num_threads(n)
    assert set(want) == {"sweep"} | {cold.portfolio_label(d, f)
                                     for d in cold.PORTFOLIO_DEVICES for f in (None, False)}
    for label, rec in want.items():
        assert got[label] == rec, label
    assert len(got["sweep"]) == len(cold.SWEEP_POSITIONS)
    assert got["threads_rounds"] >= 1
    # on the CPU the wrappers take their plain versions: nothing launches
    assert not any(got["launches"]["total"].values())
