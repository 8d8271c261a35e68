"""The packing problem in plain Python and NumPy: buffers from a
configuration file, the RAM cost model, and a judge of packings.

Kroes et al., "Evolutionary Bin Packing for Memory-Efficient Dataflow
Inference Acceleration on FPGA" (GECCO 2020): a Table-1 row
``(N_PE, (N_SIMD, D, W))`` is one layer of ``N_PE`` buffers, each
``N_SIMD * W`` bits wide and ``D`` words deep.  A bin stacks at most
``max_items`` buffers in depth; its width is the widest buffer, its height
the sum of depths, and it costs ``min over modes of ceil(w / mode_w) *
ceil(h / mode_d)`` primitives of its RAM kind, times the kind's weight in
the inventory's cost unit (the gcd of the kinds' capacities).

Written from the paper and the configuration alone: nothing here imports
the program, and every number is worked out again from the buffers and
the inventory that the benchmark made.
"""
from __future__ import annotations

import json
import math
from functools import reduce
from pathlib import Path

import numpy as np


class Problem:
    """One accelerator's buffers on one inventory."""

    def __init__(self, name, rows, max_items, kinds, counts):
        # rows: [(n_pe, (n_simd, depth, wbits))], one layer each, in order
        self.name = name
        self.rows = [(int(n), tuple(int(x) for x in s)) for n, s in rows]
        self.widths, self.depths, self.layers = [], [], []
        for layer, (n_pe, (n_simd, depth, wbits)) in enumerate(self.rows):
            for _ in range(n_pe):
                self.widths.append(n_simd * wbits)
                self.depths.append(depth)
                self.layers.append(layer)
        self.n = len(self.widths)
        self.max_items = int(max_items)
        # kinds: [(name, ((mode_w, mode_d), ...), capacity_bits)]
        self.kinds = [(k, tuple((int(a), int(b)) for a, b in m), int(c)) for k, m, c in kinds]
        self.counts = [int(c) for c in counts]
        self.n_kinds = len(self.kinds)
        self.unit_bits = reduce(math.gcd, (c for _, _, c in self.kinds))
        self.weights = [c // self.unit_bits for _, _, c in self.kinds]
        self.caps = np.asarray([c for _, _, c in self.kinds], dtype=np.int64)
        self.bits = [w * d for w, d in zip(self.widths, self.depths)]
        self.total_bits = sum(self.bits)
        self.bounded = any(c >= 0 for c in self.counts)
        self._memo = [dict() for _ in self.kinds]
        self.np_widths = np.asarray(self.widths, dtype=np.int64)
        self.np_depths = np.asarray(self.depths, dtype=np.int64)
        self.np_layers = np.asarray(self.layers, dtype=np.int64)

    def cost_mode_gap(self, w, h, k=0):
        """``(unit_cost, best mode, unused depth rows, primitives)`` of a
        ``w`` x ``h`` bin on kind ``k``: the first mode of least count."""
        memo = self._memo[k]
        hit = memo.get((w, h))
        if hit is None:
            modes = self.kinds[k][1]
            counts = [-(-w // mw) * -(-h // md) for mw, md in modes]
            best = min(range(len(modes)), key=counts.__getitem__)
            md = modes[best][1]
            hit = (counts[best] * self.weights[k], best, -(-h // md) * md - h, counts[best])
            memo[(w, h)] = hit
        return hit

    def primitives_many(self, w, h, k):
        """Primitives a bin needs, elementwise over arrays of geometry and
        kind (an empty slot, ``w == 0``, needs none)."""
        w = np.asarray(w, dtype=np.int64)
        h = np.asarray(h, dtype=np.int64)
        out = np.zeros(np.broadcast(w, np.asarray(k)).shape, dtype=np.int64)
        for ki, (_, modes, _) in enumerate(self.kinds):
            c = np.min([-(-w // mw) * -(-h // md) for mw, md in modes], axis=0)
            out = np.where(np.asarray(k) == ki, c, out)
        return out

    def unit_costs_many(self, w, h, k):
        """Unit cost elementwise (primitives times the kind's weight)."""
        prim = self.primitives_many(w, h, k)
        weights = np.asarray(self.weights, dtype=np.int64)
        return np.where(np.asarray(w) > 0, prim * weights[np.asarray(k)], 0)

    def overflow(self, used):
        """Unit-weighted primitives beyond the inventory (rows of per-kind
        usage); an unbounded kind never overflows."""
        counts = np.asarray(self.counts, dtype=np.int64)
        over = np.where(counts < 0, 0, np.maximum(np.asarray(used) - counts, 0))
        return (over * np.asarray(self.weights, dtype=np.int64)).sum(axis=-1)


def load_config(path):
    with open(path) as f:
        return json.load(f)


def problem_from_config(cfg, accelerator):
    """The configuration's accelerator on its inventory (``inventory`` null:
    the paper's unbounded single kind)."""
    kinds = [(k, cfg["ram_kinds"][k]["modes"], cfg["ram_kinds"][k]["capacity_bits"])
             for k in cfg["kinds"]]
    inv = cfg.get("inventory")
    counts = [-1] * len(kinds) if inv is None else [inv[k] for k in cfg["kinds"]]
    name = accelerator if inv is None else f"{accelerator}@{cfg['device']}"
    return Problem(name, cfg["accelerators"][accelerator], cfg["max_items"], kinds, counts)


def configs_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "configs"


# ------------------------------------------------------------ judging a packing
def judge(prob: Problem, bins, kinds):
    """What a packing says, worked out again: ``(faults, cost, overflow)``.

    ``faults`` lists each guarantee broken: a buffer placed twice or never,
    a bin over ``max_items``, an empty bin, a kind outside the inventory.
    ``cost`` is the packing's unit cost and ``overflow`` the unit-weighted
    primitives it needs beyond the inventory's counts."""
    faults = []
    placed = sorted(int(i) for b in bins for i in b)
    if placed != list(range(prob.n)):
        seen = set(placed)
        faults.append(f"buffers placed {len(placed)}, distinct {len(seen)}, of {prob.n}")
    if len(kinds) != len(bins):
        faults.append("kind lane misaligned with bins")
        return faults, None, None
    used = np.zeros(prob.n_kinds, dtype=np.int64)
    cost = 0
    for b, k in zip(bins, kinds):
        k = int(k)
        if not b:
            faults.append("empty bin")
            continue
        if len(b) > prob.max_items:
            faults.append(f"bin of {len(b)} buffers over {prob.max_items}")
        if not 0 <= k < prob.n_kinds:
            faults.append(f"kind {k} outside the inventory")
            continue
        if any(not 0 <= int(i) < prob.n for i in b):
            faults.append("buffer index outside the problem")
            continue
        w = max(prob.widths[int(i)] for i in b)
        h = sum(prob.depths[int(i)] for i in b)
        c = prob.cost_mode_gap(w, h, k)
        cost += c[0]
        used[k] += c[3]
    return faults, cost, int(prob.overflow(used))
