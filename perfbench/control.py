"""The control of the correctness check: it has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 30

The configuration states no precision (the search is integer arithmetic),
so the control breaks one guarantee that it does state.  Per seed this runs
the cell's window on the card as a benchmark run does and checks the
program's answers; then it puts the plain reference in the program's place
(each answer replaced by the reference's replay of the same search) with
one buffer moved into a bin that already holds ``max_items`` (or, where no
bin is full, left out), and checks those.  One JSON line a seed: the
program's numbers and the control's, each beside its limit.  Not run by
the benchmark's runs.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Answer:
    """A replayed answer in the shape the check reads from the program."""

    def __init__(self, want: dict):
        self.cost = want["cost"]
        self.solution = type("S", (), {})()
        self.solution.bins, self.solution.kinds = want["bins"], want["kinds"]
        self.trace = [(0.0, c) for c in want["trace"]]
        self.iterations = want["iterations"]
        self.params = {}
        if "uphill" in want:
            self.params["uphill_proposed"], self.params["uphill_accepted"] = want["uphill"]


def break_guarantee(bins: list, max_items: int) -> list:
    """One buffer moved into a full bin, or left out where none is full."""
    bins = [list(b) for b in bins]
    src = next(i for i, b in enumerate(bins) if len(b) < max_items or len(bins) == 1)
    full = [i for i, b in enumerate(bins) if len(b) >= max_items and i != src]
    item = bins[src].pop()
    if full:
        bins[full[0]].append(item)
    return bins


def control_solves(config: dict, traffic: dict, solves) -> list:
    from perfbench.reference import search
    from perfbench.reference.problem import problem_from_config

    out = []
    for sv in solves:
        prob = problem_from_config(config, sv.accelerator)
        want = search.SEARCHES[traffic["algorithm"]](prob, sv.seed, **sv.settings)
        want["bins"] = break_guarantee(want["bins"], config["max_items"])
        if len(want["bins"]) < len(want["kinds"]):
            want["kinds"] = want["kinds"][: len(want["bins"])]
        out.append(copy.copy(sv))
        out[-1].result = _Answer(want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replays", type=int, default=4,
                    help="answers a seed that the control replays and breaks")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import bench, check, drivers

    _, config, traffic = bench.cell_parts(bench.load_manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        d = drivers.load(traffic["entry"])(config, traffic, seed, args.device)
        d.setup()
        rec = d.window(args.seconds)
        prog = check.check(config, traffic, d.solves, seed, missing=rec.get("missing", 0))
        t = time.perf_counter()
        picked = check.sample(d.solves, args.replays, seed,
                              lambda a: sum(n for n, _ in config["accelerators"][a]))
        ctrl = check.check(config, traffic, control_solves(config, traffic, picked), seed)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, attempted=rec["attempted"],
            program=dict(correct=check.passed(prog["values"]), **prog["values"]),
            control=dict(correct=check.passed(ctrl["values"]), **ctrl["values"],
                         answers=len(picked), seconds=time.perf_counter() - t),
            limits=check.LIMITS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
