#!/usr/bin/env python
"""Preemptible sweep/portfolio runner with crash injection for the port —
the counterpart of ``tools/sweep_resume.py``, over ``repro_torch.core``.

Run a checkpointed sweep or portfolio over Table-1 problems, optionally
SIGKILL the process right after the Nth durable snapshot, then resume and
compare against an uninterrupted run.  The flags are the reference CLI's,
plus ``--device`` (default ``cuda``: the engines launch the CUDA kernels,
K3 / K4 for ``sa-s``, K1 / K2 for ``ga-nfd``, K5 in portfolio mode), and
``--backend`` takes the port's ``python | torch | cuda | auto`` (default
``auto``).  Snapshots are the reference's format, and the parity record is
the reference CLI's, equal to its record for the same arguments:

    # uninterrupted run
    python tools/sweep_resume_torch.py --mode sweep --problems CNV-W1A1,CNV-W2A2 \
        --dir ck_ref --out ref.json

    # crashed run: a real SIGKILL after checkpoint 2 (exit code -9)
    python tools/sweep_resume_torch.py --mode sweep --problems CNV-W1A1,CNV-W2A2 \
        --dir ck --die-at-checkpoint 2

    # resume from the newest intact snapshot, then diff the parity records
    python tools/sweep_resume_torch.py --mode sweep --problems CNV-W1A1,CNV-W2A2 \
        --dir ck --resume --out resumed.json
    python - /tmp/ref.json /tmp/resumed.json <<'PY'
    import json, sys
    a, b = (json.load(open(p)) for p in sys.argv[1:3])
    assert a == b, "resumed run is not bit-identical to the reference"
    PY

The parity record holds everything the bit-exact restart contract covers —
final best cost, packing (bins + kind lanes), iteration counts, and (for
sweeps) per-candidate improvement-trace cost sequences.  Wall-clock values
(and the portfolio's wall-time-ordered merged trace) are exempt and never
recorded; see docs/DESIGN.md section 12.  On a host without CUDA pass
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# deterministic engines: iteration budgets drive termination, the wall cap
# and patience are parked out of reach (DESIGN.md section 12)
_HUGE_SECONDS = 1e9
_HUGE_PATIENCE = 10**9


def _die_at(n: int):
    """SIGKILL ourselves right after the Nth durable checkpoint write."""

    def hook(step: int) -> None:
        if step >= n:
            os.kill(os.getpid(), signal.SIGKILL)

    return hook


def _solution_record(res) -> dict:
    return {
        "cost": int(res.cost),
        "bins": [[int(i) for i in b] for b in res.solution.bins],
        "kinds": [int(k) for k in res.solution.kinds],
        "iterations": int(res.iterations),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("sweep", "portfolio"), default="sweep")
    ap.add_argument("--problems", default="CNV-W1A1,CNV-W2A2",
                    help="comma-separated Table-1 problem names "
                         "(portfolio mode uses the first)")
    ap.add_argument("--dir", required=True, help="checkpoint directory")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest intact checkpoint")
    ap.add_argument("--die-at-checkpoint", type=int, default=0, metavar="N",
                    help="SIGKILL this process right after the Nth "
                         "checkpoint write (0 = run to completion)")
    ap.add_argument("--out", default=None,
                    help="write the parity record (JSON) here")
    ap.add_argument("--algorithm", default="sa-s",
                    help="sweep algorithm (sweep mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=("python", "torch", "cuda", "auto"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-iterations", type=int, default=2000)
    ap.add_argument("--max-generations", type=int, default=30)
    ap.add_argument("--n-chains", type=int, default=4)
    ap.add_argument("--n-islands", type=int, default=3)
    ap.add_argument("--migration-every", type=int, default=64)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="iterations/generations (sweep) or barriers "
                         "(portfolio) between snapshots")
    args = ap.parse_args(argv)

    from repro_torch.core import get_problem, pack_portfolio, pack_sweep

    problems = [get_problem(n.strip()) for n in args.problems.split(",")]
    hook = _die_at(args.die_at_checkpoint) if args.die_at_checkpoint else None

    if args.mode == "sweep":
        sweep = pack_sweep(
            problems,
            args.algorithm,
            seed=args.seed,
            max_seconds=_HUGE_SECONDS,
            backend=args.backend,
            checkpoint_dir=args.dir,
            checkpoint_every=args.checkpoint_every or 500,
            resume=args.resume,
            on_checkpoint=hook,
            device=args.device,
            max_iterations=args.max_iterations,
            max_generations=args.max_generations,
            n_chains=args.n_chains,
            patience=_HUGE_PATIENCE,
        )
        record = {
            "mode": "sweep",
            "algorithm": args.algorithm,
            "candidates": [
                dict(_solution_record(r),
                     trace_costs=[c for _, c in r.trace])
                for r in sweep.results
            ],
        }
        print(sweep.summary())
    else:
        res = pack_portfolio(
            problems[0],
            n_islands=args.n_islands,
            seed=args.seed,
            max_seconds=_HUGE_SECONDS,
            migration_every=args.migration_every,
            backend=args.backend,
            checkpoint_dir=args.dir,
            checkpoint_every=args.checkpoint_every or 1,
            resume=args.resume,
            on_checkpoint=hook,
            device=args.device,
            max_iterations=args.max_iterations,
            max_generations=args.max_generations,
            patience=_HUGE_PATIENCE,
        )
        record = dict(
            _solution_record(res),
            mode="portfolio",
            barriers=int(res.params["barriers"]),
            migrations=int(res.params["migrations"]),
        )
        print(f"{res.algorithm}: cost={res.cost} "
              f"barriers={res.params['barriers']}")

    from repro_torch.kernels import launch_counts

    print(f"kernel launches {json.dumps(launch_counts())}")
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2))
        print(f"parity record -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
