#!/usr/bin/env python
"""Cold first use of the port's threaded entry points, in a fresh process.

    python tools/cold_threads_torch.py                 # cuda: the kernels
    python tools/cold_threads_torch.py --device cpu    # their plain versions

The interpreter's switch interval is set to 1 us before anything of the
port is imported.  Then ``repro_torch.core`` is imported and the first
calls into the port are these three, each running engine code on worker
threads, all on ``backend="cuda"``:

(a) `pack_portfolio_threads` on CNV-W1A1, 4 islands (GA-NFD, 8-chain
    SA-S, SA-NFD, GA-NFD) on the pool's threads for 1 s: K1 and K3
    launched from several threads at their first use;
(b) `pack_sweep` over 8 positions of ``chip_smoke.py`` phase 6a's fleet
    (CNV-W1A1, CNV-W2A2, Tincy-YOLO and DoReFaNet, BRAM18 and @U50, seed
    0), SA-S x8 at an iteration budget, at ``n_shards=4`` on a sweep mesh
    of the device twice: K3 / K4 from the shard threads;
(c) `pack_portfolio(scheduler="concurrent")` on CNV-W1A1 and @U50 with a
    lineup that puts a single-chain SA-S island and an SA-NFD island on
    the side lane (unfused, the GA islands too), fused and unfused: K5 from
    the calling thread beside K1-K4 from the side lane's.

Prints one JSON line: each call's seconds and launch counts, (a)'s cost,
and the records of (b) and (c), which must equal the same calls on
``backend="python"`` (`python_records` computes those; fused or not and
sharded or not never change a record).  Exits non-zero if a call raises or
a result does not validate.  ``chip_smoke.py`` phase 6h runs it 4 times
at once on the card; ``tests/test_torch_threads_cold.py`` runs it on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

THREADS = dict(n_islands=4, sa_chains=8, max_seconds=1.0)
SWEEP_POSITIONS = tuple((name, dev) for dev in (None, "U50")
                        for name in ("CNV-W1A1", "CNV-W2A2", "Tincy-YOLO", "DoReFaNet"))
SWEEP = dict(n_chains=8, max_iterations=32, max_seconds=1e9, patience=10**9)
SWEEP_SHARDS = 4
PORTFOLIO_DEVICES = (None, "U50")
PORTFOLIO = dict(sa_chains=8, migration_every=32, max_generations=8,
                 max_iterations=256, max_seconds=1e9, patience=10**9)


def sweep_case(rc):
    """(b)'s problems and keyword arguments, backend and sharding aside."""
    return ([rc.get_problem(name, device=dev) for name, dev in SWEEP_POSITIONS],
            dict(SWEEP, seed=0))


def portfolio_case(rc, dev):
    """(c)'s problem and keyword arguments on ``dev``: the fused pair (GA
    islands + the SA-S fleet) or the fleet alone on the calling thread, a
    single-chain SA-S island and an SA-NFD island on the side lane."""
    islands = [rc.IslandSpec("ga-nfd", seed=0), rc.IslandSpec("sa-s", seed=1),
               rc.IslandSpec("sa-s", seed=2, hyper={"n_chains": 1}),
               rc.IslandSpec("sa-nfd", seed=3), rc.IslandSpec("ga-nfd", seed=4)]
    return (rc.get_problem("CNV-W1A1", device=dev),
            dict(PORTFOLIO, islands=islands, **rc.hyperparams("CNV-W1A1")))


def record(r, portfolio=False):
    """What parity covers, as JSON: cost, bins, kind lanes, iterations,
    the trace's costs; a portfolio's barriers, migrations and strides."""
    r.solution.validate()
    if r.solution.cost() != r.solution.cost_full() or r.cost != r.solution.cost():
        raise AssertionError(f"{r.algorithm}: cost bookkeeping disagrees")
    rec = [r.cost, [list(b) for b in r.solution.bins],
           [int(k) for k in r.solution.kinds], r.iterations, [c for _, c in r.trace]]
    if portfolio:
        rec += [r.params["barriers"], r.params["migrations"], r.params["strides"]]
    return json.loads(json.dumps(rec))


def portfolio_label(dev, fused):
    return f"CNV-W1A1{'@' + dev if dev else ''} fused={fused}"


def python_records(rc, device) -> dict:
    """(b) and (c) on ``backend="python"``, unsharded: the records the
    child's must equal."""
    probs, kw = sweep_case(rc)
    sw = rc.pack_sweep(probs, "sa-s", backend="python", device=device, **kw)
    out = {"sweep": [record(r) for r in sw.results]}
    for dev in PORTFOLIO_DEVICES:
        prob, kw = portfolio_case(rc, dev)
        rec = record(rc.pack_portfolio(prob, backend="python", device=device, **kw),
                     portfolio=True)
        for fused in (None, False):
            out[portfolio_label(dev, fused)] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.setswitchinterval(1e-6)

    import repro_torch.core as rc

    out = {"seconds": {}, "launches": {}}
    t = time.perf_counter()
    r = rc.pack_portfolio_threads(rc.get_problem("CNV-W1A1"), backend="cuda",
                                  device=args.device, **THREADS)
    out["seconds"]["threads"] = time.perf_counter() - t
    record(r)
    out["threads_cost"], out["threads_rounds"] = r.cost, r.params["rounds"]

    from repro_torch import kernels
    from repro_torch.launch import SweepMesh

    def counted(label, since):
        now = kernels.launch_counts()
        out["launches"][label] = {k: v - since.get(k, 0) for k, v in now.items()}
        return now

    seen = counted("threads", {})
    probs, kw = sweep_case(rc)
    mesh = SweepMesh([args.device] * 2)
    t = time.perf_counter()
    sw = rc.pack_sweep(probs, "sa-s", backend="cuda", device=args.device,
                       n_shards=SWEEP_SHARDS, mesh=mesh, **kw)
    out["seconds"]["sweep"] = time.perf_counter() - t
    if sw.params["n_shards"] != SWEEP_SHARDS:
        raise AssertionError(f"sweep ran at n_shards={sw.params['n_shards']}")
    out["sweep"] = [record(x) for x in sw.results]
    seen = counted("sweep", seen)
    for dev in PORTFOLIO_DEVICES:
        for fused in (None, False):
            prob, kw = portfolio_case(rc, dev)
            label = portfolio_label(dev, fused)
            t = time.perf_counter()
            r = rc.pack_portfolio(prob, backend="cuda", device=args.device,
                                  scheduler="concurrent", fused=fused, **kw)
            out["seconds"][label] = time.perf_counter() - t
            if r.params["fused"] is not (fused is None):
                raise AssertionError(f"{label}: params['fused'] is {r.params['fused']}")
            out[label] = record(r, portfolio=True)
            seen = counted(label, seen)
    out["launches"]["total"] = kernels.launch_counts()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
