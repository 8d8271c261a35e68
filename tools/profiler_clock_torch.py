#!/usr/bin/env python
"""How `torch.profiler`'s stamps sit on the port's span clock, on the card.

    python tools/profiler_clock_torch.py

First the Unix clock against the performance counter over 5 s.  Then two
profiled loops of 400 K1 fitness calls at RN152's shape (75 x 2253), 20 ms
of host work between calls as in the GA loop, with the port's recorder on:
one with CUDA activity alone (as `perfbench/trace.py` records), one with
CPU activity too.  For each, every K1 device stamp is put on the recorder's
clock through the profiler's ``trace_start_ns()`` and an anchor taken when
the recorder was turned on, at the trace's start, or a line through the
trace's start and end anchors, and held against the begin of the
``ops.launch`` span that launched it: the lead's least, median and most,
how many are negative, and its slope over the loop (us a s: the device
stamps' drift); the same for the host stamp of the runtime call that
launched each (``runtime_lead_us_*``, matched by correlation id).  The spin kernel, launched at a read of the clock as the
harness does, gives the spin-mark offset beside the profiler's.  Prints one
JSON line a part; exits 3 without CUDA.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.kernels.binpack_fitness import ops as fops  # noqa: E402


def spin(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def slope(xs, ys):
    return float(np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)[0])


def profiled_loop(activities, label: str, n: int = 400) -> dict:
    from torch.profiler import profile

    rng = np.random.default_rng(0)
    w = rng.integers(0, 100, (75, 2253)).astype(np.int32)
    h = rng.integers(1, 5000, (75, 2253)).astype(np.int32)
    fops.population_costs(w, h, device="cuda")
    torch.cuda.synchronize()
    obs.reset()
    obs.enable()
    a_enable = obs.anchor()
    spin(2.0)  # the anchor ages, as through a run's set-up
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        a_start = obs.anchor_now()
        mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(n):
            spin(0.02)
            fops.population_costs(w, h, device="cuda")
        torch.cuda.synchronize()
        a_end = obs.anchor_now()
    obs.disable()
    t0 = int(prof.profiler.kineto_results.trace_start_ns())
    events = prof.events()
    kern_ids = {e.id for e in events if "fitness_rows_kernel" in e.name}
    stamps = [(e.name, t0 + int(e.time_range.start * 1000)) for e in events]
    kern = sorted(t for name, t in stamps if "fitness_rows_kernel" in name)
    # the runtime calls that launched them (the same correlation id): host stamps
    calls = sorted(t0 + int(e.time_range.start * 1000) for e in events
                   if e.name.startswith("cu") and e.id in kern_ids
                   and "CUDA" not in str(getattr(e, "device_type", "")))
    mark_dev = min((t for name, t in stamps if "spin_kernel" in name), default=None)
    spans = sorted(r.start_ns for r in obs.snapshot().records if r.name == "ops.launch")

    def line(u):  # through the start and end anchors
        f = (u - a_start[1]) / (a_end[1] - a_start[1])
        return a_start[0] + (u - a_start[1]) - f * ((a_end[1] - a_start[1]) - (a_end[0] - a_start[0]))

    out = dict(label=label, kernels=len(kern), runtime_calls=len(calls), spans=len(spans),
               unix_minus_perf_ppm=((a_end[1] - a_start[1]) - (a_end[0] - a_start[0]))
               / (a_end[0] - a_start[0]) * 1e6)
    if mark_dev is not None:
        spin_offset = mark - mark_dev  # perf = Unix stamp + offset
        out["kineto_minus_spin_us"] = ((a_start[0] - a_start[1]) - spin_offset) / 1e3
    for what, ts in (("lead_us", kern), ("runtime_lead_us", calls)):
        m = min(len(ts), len(spans))
        if m < 2:
            continue
        when = [(s - spans[0]) / 1e9 for s in spans[:m]]
        for name, to_perf in (("enable", lambda u: a_enable[0] + u - a_enable[1]),
                              ("start", lambda u: a_start[0] + u - a_start[1]), ("line", line)):
            lead = [(to_perf(k) - s) / 1e3 for k, s in zip(ts[:m], spans[:m])]
            out[f"{what}_{name}"] = dict(min=min(lead), median=float(np.median(lead)),
                                         max=max(lead), negative=sum(x < 0 for x in lead),
                                         slope_us_per_s=slope(when, lead))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_clock_torch: needs a CUDA card", file=sys.stderr)
        return 3
    from torch.profiler import ProfilerActivity

    pairs = []
    for _ in range(11):
        pairs.append(obs.anchor_now())
        time.sleep(0.5)
    (p0, u0), (p1, u1) = pairs[0], pairs[-1]
    print(json.dumps(dict(unix_minus_perf_ppm_5s=((u1 - u0) - (p1 - p0)) / (p1 - p0) * 1e6)),
          flush=True)
    for acts, label in (([ProfilerActivity.CUDA], "cuda"),
                        ([ProfilerActivity.CPU, ProfilerActivity.CUDA], "cpu+cuda")):
        print(json.dumps(profiled_loop(acts, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
