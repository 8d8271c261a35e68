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
* ``kinds`` — on RN152-W1A2 @U50 over 64 starts' packings, the mean
  milliseconds a start of the kind assignment's numpy body, its two halves
  apart (``table_ms``: the per-bin cost table; ``loop_ms``: the move loop),
  and of the compiled entry point (``native_ms``, `nfd_native.assign_kinds`),
  with the moves a start and whether both gave equal kinds;
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


def numpy_table(prob, geom):
    """The numpy body's first half: each bin's unit cost and primitives on
    every kind, one `_cost_mode_gap` a bin and kind."""
    nb, nk = len(geom), prob.n_kinds
    wc = np.empty((nb, nk), dtype=np.int64)
    prim = np.empty((nb, nk), dtype=np.int64)
    for bi in range(nb):
        w, h = int(geom[bi, 0]), int(geom[bi, 1])
        for k in range(nk):
            cost = prob._cost_mode_gap(w, h, k)
            wc[bi, k] = cost[0]
            prim[bi, k] = cost[3]
    return wc, prim


def numpy_moves(prob, wc, prim):
    """The numpy body's second half: cheapest kinds, then the move loop.
    Returns the kinds and the moves made."""
    nb, nk = wc.shape
    kinds = np.argmin(wc, axis=1).astype(np.int64)
    counts = prob._kind_counts_arr
    used = np.zeros(nk, dtype=np.int64)
    ar = np.arange(nb)
    np.add.at(used, kinds, prim[ar, kinds])
    moves = 0
    for _ in range(nb + 1):
        over = (counts >= 0) & (used > counts)
        if not over.any():
            break
        cur_wc = wc[ar, kinds]
        cur_prim = prim[ar, kinds]
        movable = over[kinds] & (cur_prim > 0)
        best = None
        for j in range(nk):
            cand = movable & (kinds != j)
            if counts[j] >= 0:
                cand &= used[j] + prim[:, j] <= counts[j]
            if not cand.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                regret = np.where(cand, (wc[:, j] - cur_wc) / cur_prim, np.inf)
            bi = int(np.argmin(regret))
            if best is None or regret[bi] < best[0]:
                best = (float(regret[bi]), bi, j)
        if best is None:
            break
        _, bi, j = best
        used[kinds[bi]] -= prim[bi, kinds[bi]]
        kinds[bi] = j
        used[j] += prim[bi, j]
        moves += 1
    return kinds, moves


def kinds_probe(n_starts=64):
    """The ``kinds`` entry: the packings of an SA start's chains (random
    orders, the Table-2 row's admission rule)."""
    prob, hp = c.get_problem(NAME, device="U50"), c.hyperparams(NAME)
    rng = np.random.default_rng(4)
    packs = [nfd_native.pack_order(prob, rng.permutation(prob.n), rng, hp["p_adm_w"],
                                   hp["p_adm_h"], False) for _ in range(n_starts)]
    table_s = loop_s = native_s = 0.0
    moves, equal = 0, True
    for _, geom in packs:
        t0 = time.perf_counter()
        wc, prim = numpy_table(prob, geom)
        t1 = time.perf_counter()
        kinds, m = numpy_moves(prob, wc, prim)
        t2 = time.perf_counter()
        lane, rows = np.zeros(len(geom), dtype=np.int64), geom.copy()
        t3 = time.perf_counter()
        native_moves = nfd_native.assign_kinds(prob, lane, rows)
        t4 = time.perf_counter()
        table_s, loop_s, native_s = table_s + t1 - t0, loop_s + t2 - t1, native_s + t4 - t3
        moves += m
        equal &= bool(np.array_equal(lane, kinds)) and native_moves == m
    return {"starts": n_starts, "bins": float(np.mean([len(g) for _, g in packs])),
            "moves": moves / n_starts, "table_ms": table_s / n_starts * 1e3,
            "loop_ms": loop_s / n_starts * 1e3, "native_ms": native_s / n_starts * 1e3,
            "equal": equal}


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
    out["kinds"] = kinds_probe()
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
