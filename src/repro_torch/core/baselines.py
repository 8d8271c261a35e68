"""Classical bin-packing baselines the paper compares conceptually against.

The classical heuristics assume fixed bin capacity and unlimited cardinality;
under the paper's FPGA constraints (variable bin geometry on a BRAM grid +
cardinality limit) they perform poorly — reproducing that observation is the
point of keeping them here.  All return valid `Solution`s.
"""
from __future__ import annotations

import numpy as np

from .problem import PackingProblem, Solution, greedy_assign_kinds


def next_fit(prob: PackingProblem, order: np.ndarray | None = None) -> Solution:
    """Classical next-fit: close the open bin whenever adding a buffer would
    grow the bin's BRAM count (the closest analogue of a fixed capacity)."""
    if order is None:
        order = np.arange(prob.n)
    bins: list[list[int]] = []
    cur: list[int] = []
    cur_w = cur_h = 0
    for i in order:
        i = int(i)
        w, d = int(prob.widths[i]), int(prob.depths[i])
        if not cur:
            cur, cur_w, cur_h = [i], w, d
            continue
        new_w, new_h = max(cur_w, w), cur_h + d
        fits = (
            len(cur) < prob.max_items
            and prob.bin_cost(new_w, new_h) <= prob.bin_cost(cur_w, cur_h)
        )
        if fits:
            cur.append(i)
            cur_w, cur_h = new_w, new_h
        else:
            bins.append(cur)
            cur, cur_w, cur_h = [i], w, d
    if cur:
        bins.append(cur)
    return greedy_assign_kinds(Solution(prob, bins))


def first_fit_decreasing(prob: PackingProblem, intra_layer: bool = False) -> Solution:
    """Cardinality-constrained FFD (Kellerer/Pferschy-style adaptation).

    Buffers sorted by bit count descending; each is placed in the first bin
    where it (a) satisfies cardinality, (b) matches the bin width, and
    (c) does not increase the bin's allocated BRAM count.  Otherwise a new
    bin is opened.  O(n * bins)."""
    order = np.argsort(-(prob.widths * prob.depths), kind="stable")
    bins: list[list[int]] = []
    geom: list[tuple[int, int, int]] = []  # (width, height, cost)
    for i in order:
        i = int(i)
        w, d = int(prob.widths[i]), int(prob.depths[i])
        placed = False
        for bi, b in enumerate(bins):
            bw, bh, bc = geom[bi]
            if len(b) >= prob.max_items or bw != w:
                continue
            if intra_layer and int(prob.layers[b[0]]) != int(prob.layers[i]):
                continue
            nc = prob.bin_cost(bw, bh + d)
            if nc <= bc:
                b.append(i)
                geom[bi] = (bw, bh + d, nc)
                placed = True
                break
        if not placed:
            bins.append([i])
            geom.append((w, d, prob.bin_cost(w, d)))
    return greedy_assign_kinds(Solution(prob, bins))


def singleton(prob: PackingProblem) -> Solution:
    """The unpacked FINN baseline (one buffer per bin)."""
    return prob.singleton_solution()
