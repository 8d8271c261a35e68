#!/usr/bin/env python
"""Synthetic traffic driver for the port's packing service — CLI + kill lane.

Drives an in-process :class:`repro_torch.serve.PackingService` with a
seeded Poisson/Zipf workload (see ``repro_torch.serve.traffic``),
optionally SIGKILLs itself mid-run, and verifies warm-restart behavior
over a persistent store dir.  The counterpart of ``tools/serve_traffic.py``
with the same flags, plus ``--device`` (default ``cuda``: solves launch
the CUDA kernels) and ``--backend`` defaulting to ``auto``:

    # cold run against a fresh store, then die hard after 8 responses
    python tools/serve_traffic_torch.py --store /tmp/pack_store --smoke --die-after 8

    # restart over the same store: prior results MUST be served warm and
    # every response MUST bit-match standalone pack()
    python tools/serve_traffic_torch.py --store /tmp/pack_store --smoke \
        --expect-warm --verify --out /tmp/serve.json

    # a third pass is fully warm: no solver work at all
    python tools/serve_traffic_torch.py --store /tmp/pack_store --smoke \
        --expect-no-solves --verify

On a host without CUDA pass ``--device cpu``.  The workload is a pure
function of ``--seed``/``--requests``/``--problems``, so every invocation
above replays identical traffic — which is what makes "restart serves
prior results bit-identically" a checkable claim.  Exit code is non-zero
on any failed expectation; ``--die-after`` exits via SIGKILL (shell
reports 137), the honest crash the store must survive.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# deterministic engines: iteration budgets drive termination, the wall cap
# and patience are parked out of reach
_HUGE_SECONDS = 1e9
_HUGE_PATIENCE = 10**9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True, help="persistent store dir")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload + budgets (CI-scale)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--problems", type=int, default=None,
                    help="corpus size (Zipf popularity ranks)")
    ap.add_argument("--rate-hz", type=float, default=500.0,
                    help="Poisson arrival rate")
    ap.add_argument("--zipf-a", type=float, default=1.2)
    ap.add_argument("--concurrency", type=int, default=16,
                    help="max in-flight clients")
    ap.add_argument("--n-seeds", type=int, default=2,
                    help="per-request seed pool size")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload + corpus RNG seed")
    ap.add_argument("--hetero", action="store_true",
                    help="heterogeneous corpus (OCM inventories)")
    ap.add_argument("--algorithm", default="sa-s")
    ap.add_argument("--device", default="cuda",
                    help="device the solves run on (cuda, cpu)")
    ap.add_argument("--backend", default="auto",
                    help="auto (the kernels on cuda), python, torch, cuda")
    ap.add_argument("--max-iterations", type=int, default=None)
    ap.add_argument("--n-chains", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="give every --deadline-every'th request a deadline")
    ap.add_argument("--deadline-every", type=int, default=0)
    ap.add_argument("--die-after", type=int, default=0, metavar="K",
                    help="SIGKILL this process after K responses "
                         "(0 = run to completion)")
    ap.add_argument("--expect-warm", action="store_true",
                    help="fail unless >=1 response came from the store")
    ap.add_argument("--expect-no-solves", action="store_true",
                    help="fail unless zero solver work ran (fully warm)")
    ap.add_argument("--verify", action="store_true",
                    help="bit-compare every unique task against "
                         "standalone pack()")
    ap.add_argument("--verify-backend", default=None,
                    help="backend of --verify's replay (default: --backend); "
                         "python holds the kernels' answers to the host code")
    ap.add_argument("--out", default=None, help="write JSON record here")
    args = ap.parse_args(argv)

    n_requests = args.requests or (24 if args.smoke else 200)
    n_problems = args.problems or (4 if args.smoke else 12)
    max_iterations = args.max_iterations or (60 if args.smoke else 250)

    from repro_torch.serve import (
        PackingService,
        make_problems,
        make_workload,
        run_traffic,
        verify_parity,
    )

    problems = make_problems(n_problems, seed=args.seed, hetero=args.hetero)
    workload = make_workload(
        n_requests, n_problems, rate_hz=args.rate_hz, zipf_a=args.zipf_a,
        n_seeds=args.n_seeds, seed=args.seed,
    )

    on_response = None
    if args.die_after:
        served = [0]

        def on_response(rec):
            served[0] += 1
            if served[0] >= args.die_after:
                os.kill(os.getpid(), signal.SIGKILL)

    async def drive():
        async with PackingService(
            args.algorithm,
            store_dir=args.store,
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            max_queue=max(args.concurrency, 16),
            backend=args.backend,
            device=args.device,
            max_seconds=_HUGE_SECONDS,
            patience=_HUGE_PATIENCE,
            max_iterations=max_iterations,
            n_chains=args.n_chains,
        ) as svc:
            out = await run_traffic(
                svc, problems, workload,
                concurrency=args.concurrency,
                deadline_ms=args.deadline_ms,
                deadline_every=args.deadline_every,
                on_response=on_response,
            )
            stats = svc.stats()
            parity = (
                verify_parity(svc, problems, workload,
                              backend=args.verify_backend) if args.verify
                else None
            )
            return out, stats, parity

    out, stats, parity = asyncio.run(drive())

    record = {
        "requests": n_requests,
        "problems": n_problems,
        "rps": out["rps"],
        "latency": out["latency"],
        "stats": stats,
        "parity": parity,
        "verify_backend": args.verify_backend or args.backend,
    }
    print(json.dumps({k: record[k] for k in ("rps", "latency")}, indent=2))
    print(f"served {stats['requests']} requests: {stats['solved']} solved, "
          f"{stats['cache_hits_store']} store hits, "
          f"{stats['cache_hits_mem']} memory hits, "
          f"{stats['coalesced']} coalesced")
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2))

    failures = []
    if args.expect_warm and stats["cache_hits_store"] < 1:
        failures.append("expected >=1 store hit, got 0")
    if args.expect_no_solves and stats["solved"] != 0:
        failures.append(f"expected 0 solves, got {stats['solved']}")
    if parity is not None and not parity["parity"]:
        failures.append(f"bit-parity FAILED: {parity['mismatches']}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures and args.verify:
        print(f"parity OK over {parity['tasks']} unique tasks "
              f"(replayed on backend {record['verify_backend']})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
