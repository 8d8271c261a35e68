#!/usr/bin/env python
"""Portfolio-throughput smoke gate for the port — the counterpart of
``tools/portfolio_gate.py``, over ``repro_torch.core``.

Times the MIXED island lineup on a short wall budget, fleet-native
`pack_portfolio` vs the `pack_portfolio_threads` baseline, and fails if
the fleet's aggregate iteration throughput drops below a soft threshold
of the baseline's (``--threshold 0`` makes the ratio a measurement only):

    python tools/portfolio_gate_torch.py                      # cuda, 0.7x @ 1.5s
    python tools/portfolio_gate_torch.py --device cpu --backend torch

``--backend`` takes the port's ``auto | python | torch | cuda | legacy``
(default ``cuda``: on a CUDA device the fleet's fused barriers launch K5,
the threads baseline's islands K1-K4 from the pool's threads) and
``--device`` where they run (default ``cuda``; ``cpu`` on a host without
CUDA).  Quality is asserted only as a sanity bound (the fleet must beat
the singleton packing).

The gate also runs a racing smoke (``--skip-racing`` to disable): a tiny
deterministic ``pack_portfolio(auto=True)`` race on the same backend, run
twice, must be bit-identical (cost, iterations, packing, ledger,
eliminations) and must respect its ledger.

Set ``PORTFOLIO_GATE_SKIP=1`` to skip the gate entirely; it exits 0
without running anything.
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MIXED = ("ga-nfd", "sa-s", "sa-nfd")
RACE_BUDGET = 4096


def _throughput(res) -> float:
    return res.iterations / max(res.wall_time_s, 1e-9)


def racing_smoke(c, prob, seed: int, backend: str, device) -> dict:
    """A deterministic auto-race run twice: its two records and whether
    they are equal and within the ledger."""
    kw = dict(
        auto=True, seed=seed, backend=backend, device=device, max_seconds=1e9,
        patience=10**9, migration_every=32, race_budget=RACE_BUDGET,
        race_grid=[
            ("sa-s", {"n_chains": 4}),
            ("sa-s", {"n_chains": 4, "ladder_max": 8.0}),
            ("ga-nfd", {"n_pop": 10}),
            ("sa-nfd", {}),
        ],
    )

    def record(res):
        race = res.params["race"]
        return (res.cost, res.iterations, res.solution.state_dict(),
                race["spent"], tuple(race["survivors"]),
                tuple((e["island"], e["barrier"]) for e in race["eliminated"]))

    a, b = record(c.pack_portfolio(prob, **kw)), record(c.pack_portfolio(prob, **kw))
    return dict(first=a, second=b, equal=a == b,
                ok=a == b and 0 < a[3] <= RACE_BUDGET)


def run_gate(args) -> dict:
    """Both portfolios on the MIXED lineup and, unless skipped, the racing
    smoke; returns the numbers the report prints."""
    import repro_torch.core as c

    prob = c.get_problem(args.accelerator)
    hp = c.hyperparams(args.accelerator)
    kw = dict(n_islands=args.islands, algorithms=MIXED, seed=args.seed,
              max_seconds=args.budget, sa_chains=8, backend=args.backend,
              device=args.device, **hp)
    with warnings.catch_warnings():
        # wall-budgeted on purpose: the truncation RuntimeWarning is expected
        warnings.simplefilter("ignore", RuntimeWarning)
        rt = c.pack_portfolio_threads(prob, **kw)
        rf = c.pack_portfolio(prob, **kw)
    tput_t, tput_f = _throughput(rt), _throughput(rf)
    out = dict(
        threads=rt, fleet=rf, tput_threads=tput_t, tput_fleet=tput_f,
        ratio=tput_f / max(tput_t, 1e-9),
        singleton=prob.singleton_solution().cost(), race=None,
    )
    if not args.skip_racing:
        out["race"] = racing_smoke(c, prob, args.seed, args.backend, args.device)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accelerator", default="CNV-W1A1")
    ap.add_argument("--budget", type=float, default=1.5,
                    help="wall seconds per engine (default 1.5)")
    ap.add_argument("--threshold", type=float, default=0.7,
                    help="min fleet/threads throughput ratio (default 0.7)")
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="cuda",
                    help="auto | python | torch | cuda | legacy (default cuda)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default cuda; cpu on a host)")
    ap.add_argument("--skip-racing", action="store_true",
                    help="skip the deterministic auto-race smoke")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if os.environ.get("PORTFOLIO_GATE_SKIP") == "1":
        print("portfolio gate: skipped (PORTFOLIO_GATE_SKIP=1)")
        return 0
    g = run_gate(args)
    rt, rf = g["threads"], g["fleet"]
    print(f"portfolio gate [{args.accelerator} mixed x{args.islands} "
          f"@{args.budget}s, backend {args.backend}, device {args.device}]:")
    print(f"  threads : {rt.iterations:>9d} iters  {g['tput_threads']:>10.0f}/s  "
          f"cost {rt.cost}  rounds {rt.params['rounds']}")
    print(f"  fleet   : {rf.iterations:>9d} iters  {g['tput_fleet']:>10.0f}/s  "
          f"cost {rf.cost}  (scheduler={rf.params['scheduler']}, "
          f"fused={rf.params['fused']})")
    print(f"  ratio   : {g['ratio']:.2f}x  (soft threshold {args.threshold:.2f}x)")
    if rf.cost >= g["singleton"]:
        print(f"FAIL: fleet cost {rf.cost} did not beat the singleton "
              f"baseline {g['singleton']}")
        return 1
    if g["ratio"] < args.threshold:
        print(f"FAIL: fleet throughput {g['ratio']:.2f}x threads is below the "
              f"{args.threshold:.2f}x gate")
        return 1
    race = g["race"]
    if race is not None:
        a = race["first"]
        print(f"  racing  : cost {a[0]}  spent {a[3]}/{RACE_BUDGET}  "
              f"survivors {list(a[4])}  bit-equal {race['equal']}")
        if not race["ok"]:
            print("FAIL: racing smoke — run-to-run mismatch or ledger overdraw")
            return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
