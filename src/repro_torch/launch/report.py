"""Summarize dry-run results: per-cell roofline terms, deltas vs a baseline
snapshot, and the aggregate score table (the port of
``repro.launch.report``, over ``experiments/dryrun_torch/``).

  PYTHONPATH=src python -m repro_torch.launch.report
  PYTHONPATH=src python -m repro_torch.launch.report --baseline <dir>
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def load(directory: Path) -> dict:
    out = {}
    for f in directory.glob("*.json"):
        r = json.loads(f.read_text())
        out[(r.get("arch"), r.get("shape"), r.get("multi_pod"))] = r
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ROOT / "experiments" / "dryrun_torch"))
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--pods", type=int, default=1)
    args = ap.parse_args(argv)

    cur = load(Path(args.dir))
    base = load(Path(args.baseline)) if args.baseline else {}
    mp = args.pods == 2
    rows = sorted(k for k in cur if k[2] == mp)
    print(f"{'arch':22s} {'shape':12s} {'bound_s':>10s} {'dom':>10s} "
          f"{'frac%':>6s} {'vs-baseline':>11s}")
    n_ok = 0
    for key in rows:
        r = cur[key]
        if r.get("status") != "ok":
            print(f"{key[0]:22s} {key[1]:12s} {'FAIL':>10s}")
            continue
        n_ok += 1
        t = r["roofline"]
        frac = 100 * t["compute_s"] / t["bound_s"] if t["bound_s"] else 0
        delta = ""
        b = base.get(key)
        if b and b.get("status") == "ok":
            delta = f"x{b['roofline']['bound_s'] / t['bound_s']:.1f}"
        print(f"{key[0]:22s} {key[1]:12s} {t['bound_s']:>10.3e} "
              f"{t['dominant'].replace('_s', ''):>10s} {frac:>6.1f} {delta:>11s}")
    print(f"{n_ok}/{len(rows)} cells ok (pods={args.pods})")


if __name__ == "__main__":
    main()
