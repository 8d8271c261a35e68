#!/usr/bin/env python
"""What one span costs the host, with the port's recorder off and on.

    python tools/obs_cost_torch.py

Times a span site as the program places it (``tok = obs.begin(name)`` ...
``obs.end(tok)``) over 200000 sites against the same loop without them, 9
times each: off, on, and on nested under an entry span.  Prints one JSON
line of nanoseconds a span (the median, and every repetition).  Multiply by
the spans a pack records (`obs.recording`) for its share of the pack.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import obs  # noqa: E402

N = 200_000


def sites(n):
    for _ in range(n):
        tok = obs.begin("ops.fill")
        obs.end(tok)


def nested(n):
    outer = obs.begin("api.pack", entry=True)
    sites(n)
    obs.end(outer)


def empty(n):
    for _ in range(n):
        tok = None
        tok = tok


def timed(fn) -> float:
    t = time.perf_counter()
    fn(N)
    return time.perf_counter() - t


def main() -> None:
    out = {}
    for label, on, fn in (("off", False, sites), ("on", True, sites), ("on_nested", True, nested)):
        runs = []
        for _ in range(9):
            obs.reset()
            (obs.enable if on else obs.disable)()
            base = timed(empty)
            runs.append((timed(fn) - base) / N * 1e9)
        obs.disable()
        obs.reset()
        out[label + "_ns_per_span"] = statistics.median(runs)
        out[label + "_runs_ns"] = [round(x, 1) for x in runs]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
