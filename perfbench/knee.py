"""Find the highest request rate the service sustains, once, by a sweep.

    python3 perfbench/knee.py --config table1.u50 --traffic serve-sa --rates 2,4,8 --seconds 20

Runs an open-loop traffic mix on a configuration at each rate for
``--seconds`` (the driver, schedule and service of a benchmark run) and
prints, a line a rate: the requests offered and answered, the answers a
second, the median and 95th-percentile latency from the due time, and the
median latency of the last third of the requests over that of the first
third.  A rate is sustained where every request is answered and that ratio
stays under 2: the backlog does not grow through the window.  A serving
cell's rate is set from the highest sustained rate and recorded, with this
sweep, in its traffic file and in PERF.md.  Not run by the benchmark's
runs.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import bench, drivers
    from perfbench.stats import nearest_rank

    config = bench.load_json(bench.HERE / "configs" / f"{args.config}.json")
    traffic = bench.load_json(bench.HERE / "traffic" / f"{args.traffic}.json")
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        t = dict(traffic, rate_hz=rate)
        d = drivers.load("serve")(config, t, args.seed, args.device)
        d.setup()
        rec = d.window(args.seconds)
        lat = [x for x in rec["latencies_s"] if x is not None]
        third = max(len(lat) // 3, 1)
        by_due = [x for _, x in sorted(zip([a.due_s for a in d.arrivals], rec["latencies_s"]))
                  if x is not None]
        growth = (statistics.median(by_due[-third:]) / statistics.median(by_due[:third])
                  if len(by_due) >= 3 else float("nan"))
        row = dict(rate_hz=rate, offered=rec["requests"], answered=len(lat),
                   answered_per_s=len(lat) / rec["window_s"],
                   p50_ms=nearest_rank(lat, 0.5) * 1e3 if lat else None,
                   p95_ms=nearest_rank(lat, 0.95) * 1e3 if lat else None,
                   last_over_first=growth,
                   occupancy=rec["service_stats"]["batch_occupancy"]["mean"],
                   sustained=rec["missing"] == 0 and growth < 2.0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r["rate_hz"] for r in rows if r["sustained"]]
    print(json.dumps(dict(knee_hz=max(ok) if ok else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
