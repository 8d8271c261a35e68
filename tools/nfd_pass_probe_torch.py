"""Probe the full NFD pass's compiled host loop (``core/nfd_native.py``) on
this host, and what Python's garbage collector takes around it.

    python tools/nfd_pass_probe_torch.py [--device cuda|cpu]

Prints one JSON line:

* ``load_s`` — the helper's first use (its build by ``cc`` if
  ``build/host/`` holds no library for the source);
* ``equal`` — for RN152-W1A2 on BRAM18 and on an Alveo U50, twelve full
  passes (`nfd.nfd_from_scratch`, the helper) and the Python loop
  (`nfd.nfd_pack_order`) over the same orders from equal generators give
  equal bins, kinds, costs and generator states;
* ``pass_ms`` — the mean of 60 passes each way, nothing kept alive;
* ``start`` — a GA start (75 passes, kept alive) three times with the
  collector as it is, then three times after ``gc.freeze()``, each with the
  collector's own time (``gc.callbacks``) and its collections by generation;
* ``ga_pack`` — one GA-NFD pack at the benchmark's setting (RN152-W1A2,
  Table-2 row, 100 generations) and the collector's time inside it, run
  before the freeze.

Needs no card with ``--device cpu``; times are the host's.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

import repro_torch.core as c  # noqa: E402
from repro_torch.core.problem import Solution, greedy_assign_kinds  # noqa: E402
from repro_torch.core import nfd, nfd_native  # noqa: E402

NAME = "RN152-W1A2"


class Collector:
    """The collector's time and collections by generation, while armed."""

    def __init__(self):
        self.s, self.n, self._t = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t
            self.n[info["generation"]] += 1

    def reset(self):
        self.s, self.n = 0.0, [0, 0, 0]


def python_loop(prob, rng, sort_by_width):
    """`nfd.nfd_from_scratch` with the Python loop packing its order."""
    order = rng.permutation(prob.n)
    if sort_by_width:
        order = order[np.argsort(prob.widths[order], kind="stable")]
    return greedy_assign_kinds(Solution(prob, nfd.nfd_pack_order(prob, order, rng)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = {}
    t = time.perf_counter()
    nfd_native.library()
    out["load_s"] = time.perf_counter() - t
    hp = c.hyperparams(NAME)
    out["equal"], out["pass_ms"] = {}, {}
    for dev in (None, "U50"):
        prob = c.get_problem(NAME, device=dev)
        ok = True
        for seed in range(6):
            for sbw in (False, True):
                ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
                a = nfd.nfd_from_scratch(prob, ra, sort_by_width=sbw)
                b = python_loop(prob, rb, sbw)
                ok &= (a.bins == b.bins and a.kinds.tolist() == b.kinds.tolist()
                       and a.cost() == b.cost() == a.cost_full()
                       and ra.bit_generator.state == rb.bit_generator.state)
        out["equal"][str(dev)] = bool(ok)
        rng = np.random.default_rng(1)

        def passes(start):
            t = time.perf_counter()
            for k in range(60):
                start(prob, rng, k % 2 == 0)
            return (time.perf_counter() - t) / 60 * 1e3

        out["pass_ms"][str(dev)] = {
            "native": passes(lambda p, r, s: nfd.nfd_from_scratch(p, r, sort_by_width=s)),
            "python": passes(python_loop)}
    col = Collector()
    t = time.perf_counter()
    c.pack(c.get_problem(NAME), "ga-nfd", seed=5, max_generations=100, max_seconds=1e9,
           device=args.device, **hp)
    out["ga_pack"] = {"s": time.perf_counter() - t, "gc_s": col.s, "gc_n": col.n}
    prob, rng, out["start"] = c.get_problem(NAME), np.random.default_rng(3), []
    for frozen in (False, True):
        if frozen:
            gc.freeze()
        for _ in range(3):
            col.reset()
            keep, t = [], time.perf_counter()
            for k in range(75):
                keep.append(nfd.nfd_from_scratch(prob, rng, sort_by_width=(k % 2 == 0)))
            out["start"].append({"frozen": frozen, "ms": (time.perf_counter() - t) * 1e3,
                                 "gc_ms": col.s * 1e3, "gc_n": col.n})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
