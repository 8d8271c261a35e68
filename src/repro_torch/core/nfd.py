"""Next-Fit Dynamic (NFD) — Algorithm 1 of the paper.

NFD is a *repacking* heuristic: it selects poorly-mapping bins (BRAM mapping
efficiency below a threshold), decomposes them into their constituent
buffers, shuffles, and repacks next-fit style.  The open bin grows only when
adding the buffer shrinks the wasted depth on the BRAM grid (``new_gap <
gap``) and the widths align — each check can be probabilistically overridden
(``p_adm_h`` / ``p_adm_w``) to let the surrounding GA/SA explore.

As a *mutation operator* inside GA/SA the repack is kept local: only the
``max_bins`` worst-mapping bins (plus a random exploration subset) are
decomposed per call, so one mutation is a small, cheap move rather than a
global restart.  A full-problem pass (``nfd_from_scratch``) is used for
population initialization.
"""
from __future__ import annotations

import numpy as np

from .problem import PackingProblem, Solution, greedy_assign_kinds


def nfd_pack_order(
    prob: PackingProblem,
    order,
    rng: np.random.Generator,
    p_adm_w: float = 0.0,
    p_adm_h: float = 0.1,
    intra_layer: bool = False,
) -> list[list[int]]:
    """Pack buffers in the given order with the NFD admission rule.

    Returns a list of bins (lists of buffer indices).  O(len(order)).
    """
    bins: list[list[int]] = []
    cur: list[int] = []
    cur_w = 0
    cur_h = 0
    cur_layer = -1
    widths, depths, layers = prob.widths_py, prob.depths_py, prob.layers_py
    max_items = prob.max_items
    cmg = prob._cost_mode_gap
    rand = rng.random
    for i in order:
        i = int(i)
        w, d = widths[i], depths[i]
        if not cur:
            cur = [i]
            cur_w, cur_h, cur_layer = w, d, layers[i]
            continue
        new_w = cur_w if cur_w >= w else w
        new_h = cur_h + d
        ok = (
            len(cur) < max_items
            and (cmg(new_w, new_h)[2] < cmg(cur_w, cur_h)[2] or rand() < p_adm_h)
            and (cur_w == w or rand() < p_adm_w)
            and (not intra_layer or layers[i] == cur_layer)
        )
        if ok:
            cur.append(i)
            cur_w, cur_h = new_w, new_h
        else:
            bins.append(cur)
            cur = [i]
            cur_w, cur_h, cur_layer = w, d, layers[i]
    if cur:
        bins.append(cur)
    return bins


def select_repack_bins(
    sol: Solution,
    rng: np.random.Generator,
    threshold: float,
    max_bins: int,
    extra_frac: float,
) -> np.ndarray:
    """Boolean mask of bins to decompose: worst-efficiency first (below the
    threshold), capped at ``max_bins``, plus a random exploration subset."""
    eff = sol.bin_efficiencies()
    n = len(eff)
    mask = np.zeros(n, dtype=bool)
    below = np.flatnonzero(eff < threshold)
    if len(below) > max_bins:
        # cap: take the worst max_bins of them, randomized among ties
        below = below[np.argsort(eff[below] + 1e-9 * rng.random(len(below)))][:max_bins]
    mask[below] = True
    if extra_frac > 0.0:
        mask |= rng.random(n) < extra_frac
    if not mask.any():
        mask[rng.integers(n)] = True
    return mask


def nfd_repack(
    sol: Solution,
    rng: np.random.Generator,
    threshold: float = 0.95,
    p_adm_w: float = 0.0,
    p_adm_h: float = 0.1,
    intra_layer: bool = False,
    extra_frac: float = 0.0,
    max_bins: int = 12,
) -> Solution:
    """Algorithm 1 as a local mutation: decompose selected bins and repack.

    Kept bins carry their cached records into the child solution, so the
    child's ``cost()`` only evaluates the freshly repacked bins.
    """
    prob = sol.problem
    mask = select_repack_bins(sol, rng, threshold, max_bins, extra_frac)
    keep = [b for b, m in zip(sol.bins, mask) if not m]
    pool = np.asarray(
        [i for b, m in zip(sol.bins, mask) if m for i in b], dtype=np.int64
    )
    rng.shuffle(pool)
    if intra_layer:
        # stable sort by layer after the shuffle: random order within a layer,
        # layers contiguous, so next-fit never straddles a layer boundary for
        # long runs (the layer check still enforces correctness).
        pool = pool[np.argsort(prob.layers[pool], kind="stable")]
    new_bins = nfd_pack_order(
        prob, pool, rng, p_adm_w=p_adm_w, p_adm_h=p_adm_h, intra_layer=intra_layer
    )
    # kept bins carry their RAM kinds into the child; freshly repacked bins
    # start on kind 0 (the finest-grained primitive) — the engines' kind
    # moves and inventory penalty re-balance them.
    # Kept bin lists are SHARED with the parent (persistent-structure style):
    # nothing in the engine mutates a bin list without copying the solution
    # first (buffer_swap works on a fresh copy()), so sharing is safe and
    # avoids an O(n) deep copy per mutation.  new_bins are fresh lists and
    # their geometry rows start dirty.
    nk, nn = len(keep), len(new_bins)
    geom = np.empty((nk + nn, 6), dtype=np.int64)
    geom[:nk] = sol._geom[~mask]
    dirty = np.empty(nk + nn, dtype=bool)
    dirty[:nk] = sol._dirty[~mask]
    dirty[nk:] = True
    kinds = np.zeros(nk + nn, dtype=np.int64)
    kinds[:nk] = sol.kinds[~mask]
    return Solution._with_geometry(prob, keep + new_bins, geom, dirty, kinds)


def nfd_from_scratch(
    prob: PackingProblem,
    rng: np.random.Generator,
    p_adm_w: float = 0.0,
    p_adm_h: float = 0.1,
    intra_layer: bool = False,
    sort_by_width: bool = False,
) -> Solution:
    """One NFD pass over all buffers in random order (used for GA/SA init).

    ``sort_by_width`` groups same-width buffers adjacently (random order
    within a width class) — a width-aware seeding that the admission rule
    then exploits; initial populations mix both orderings for diversity.
    """
    order = rng.permutation(prob.n)
    if sort_by_width:
        order = order[np.argsort(prob.widths[order], kind="stable")]
    if intra_layer:
        order = order[np.argsort(prob.layers[order], kind="stable")]
    sol = Solution(
        prob,
        nfd_pack_order(
            prob, order, rng, p_adm_w=p_adm_w, p_adm_h=p_adm_h, intra_layer=intra_layer
        ),
    )
    # heterogeneous devices: start from an inventory-feasible kind lane
    # (deterministic, no RNG draws; no-op on single-kind problems)
    return greedy_assign_kinds(sol)
