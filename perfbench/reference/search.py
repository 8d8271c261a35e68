"""The searches, replayed in plain Python and NumPy from the seed.

A search's answer is its random stream: the same seed, budget and
hyperparameters give one packing, whatever the hardware under it (the
program's engines do all their arithmetic in exact integers and draw their
randomness on the host).  So the reference holds a search to the one
packing it must return, not to a quality threshold: it runs the same
algorithm from the same seed and compares every number.

* **NFD** (Algorithm 1): buffers in a random order, next-fit; the open bin
  grows only when the wasted depth on the RAM grid shrinks and the widths
  agree, each check overridable with probability ``p_adm_h`` / ``p_adm_w``.
* **GA-NFD** (Algorithm 2): a population of NFD packings; each generation
  repacks a random subset of each mutated individual's worst-mapped bins
  with NFD, then tournament selection with elitism.  Fitness is the cost
  plus 0.01 x the mean distinct layers a bin, plus an overflow penalty on
  a bounded inventory (where a mutation may instead move a bin to another
  RAM kind).
* **SA-S** (Algorithm 3, MPack moves): C chains on a temperature ladder,
  Lundy-Mees cooling, two buffer moves (or RAM-kind flips) a step,
  Metropolis acceptance, the best chain copied over the worst every
  ``exchange_every`` steps.

The draw order, the tie rules and the layout of chain state that the draws
index into are the ones the published engines use (the repository's
``src/repro`` and ``src/repro_torch`` carry them); this file was written
against their documented behaviour and imports neither.
"""
from __future__ import annotations

import math

import numpy as np

from .problem import Problem

LAYER_WEIGHT = 0.01
INVENTORY_PENALTY = 32.0


class Sol:
    """A packing: bins of buffer indices, a RAM kind a bin, and a record a
    bin ``(width, height, unit_cost, bits, distinct layers, primitives)``
    (None until needed)."""

    __slots__ = ("prob", "bins", "kinds", "recs")

    def __init__(self, prob: Problem, bins, kinds=None, recs=None):
        self.prob = prob
        self.bins = bins
        self.kinds = np.zeros(len(bins), dtype=np.int64) if kinds is None else kinds
        self.recs = [None] * len(bins) if recs is None else recs

    def rec(self, bi):
        r = self.recs[bi]
        if r is None:
            p = self.prob
            items = self.bins[bi]
            w = max(p.widths[i] for i in items)
            h = sum(p.depths[i] for i in items)
            c = p.cost_mode_gap(w, h, int(self.kinds[bi]))
            r = (w, h, c[0], sum(p.bits[i] for i in items),
                 len({p.layers[i] for i in items}), c[3])
            self.recs[bi] = r
        return r

    def records(self):
        return [self.rec(bi) for bi in range(len(self.bins))]

    def cost(self) -> int:
        return sum(r[2] for r in self.records())

    def used(self) -> np.ndarray:
        out = np.zeros(self.prob.n_kinds, dtype=np.int64)
        for r, k in zip(self.records(), self.kinds):
            out[int(k)] += r[5]
        return out

    def overflow(self) -> int:
        return int(self.prob.overflow(self.used())) if self.prob.bounded else 0

    def copy(self) -> "Sol":
        return Sol(self.prob, [list(b) for b in self.bins], self.kinds.copy(), list(self.recs))


# ---------------------------------------------------------------------- NFD
def nfd_order(prob: Problem, order, rng, p_adm_w, p_adm_h):
    bins, cur = [], []
    cur_w = cur_h = 0
    gap = prob.cost_mode_gap
    for i in order:
        i = int(i)
        w, d = prob.widths[i], prob.depths[i]
        if not cur:
            cur, cur_w, cur_h = [i], w, d
            continue
        new_w, new_h = max(cur_w, w), cur_h + d
        # short-circuit order decides which uniforms are drawn
        if (len(cur) < prob.max_items
                and (gap(new_w, new_h)[2] < gap(cur_w, cur_h)[2] or rng.random() < p_adm_h)
                and (cur_w == w or rng.random() < p_adm_w)):
            cur.append(i)
            cur_w, cur_h = new_w, new_h
        else:
            bins.append(cur)
            cur, cur_w, cur_h = [i], w, d
    if cur:
        bins.append(cur)
    return bins


def greedy_kinds(sol: Sol) -> Sol:
    """Every bin on its cheapest kind, then, while a bounded kind is over
    its count, the bin of least cost increase per freed primitive moves to
    a kind with room (no draws)."""
    p = sol.prob
    if p.n_kinds == 1 or not p.bounded:
        return sol
    nb, nk = len(sol.bins), p.n_kinds
    wc = np.empty((nb, nk), dtype=np.int64)
    prim = np.empty((nb, nk), dtype=np.int64)
    for bi, r in enumerate(sol.records()):
        for k in range(nk):
            c = p.cost_mode_gap(r[0], r[1], k)
            wc[bi, k], prim[bi, k] = c[0], c[3]
    kinds = np.argmin(wc, axis=1).astype(np.int64)
    counts = np.asarray(p.counts, dtype=np.int64)
    used = np.zeros(nk, dtype=np.int64)
    ar = np.arange(nb)
    np.add.at(used, kinds, prim[ar, kinds])
    for _ in range(nb + 1):
        over = (counts >= 0) & (used > counts)
        if not over.any():
            break
        cur_wc, cur_prim = wc[ar, kinds], prim[ar, kinds]
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
    for bi in np.flatnonzero(kinds != sol.kinds):
        sol.recs[bi] = None
    sol.kinds = kinds
    return sol


def nfd_start(prob: Problem, rng, p_adm_w, p_adm_h, sort_by_width) -> Sol:
    order = rng.permutation(prob.n)
    if sort_by_width:
        order = order[np.argsort(prob.np_widths[order], kind="stable")]
    return greedy_kinds(Sol(prob, nfd_order(prob, order, rng, p_adm_w, p_adm_h)))


def nfd_repack(sol: Sol, rng, p_adm_w, p_adm_h, threshold=0.95, max_bins=12,
               extra_frac=0.01) -> Sol:
    """Decompose the worst-mapped bins (below ``threshold``, at most
    ``max_bins`` of them, ties broken at random) plus a random ``extra_frac``
    of all, shuffle their buffers and repack them with NFD; repacked bins
    start on kind 0."""
    p = sol.prob
    recs = sol.records()
    bits = np.asarray([r[3] for r in recs], dtype=np.int64)
    prim = np.asarray([r[5] for r in recs], dtype=np.int64)
    eff = bits / (prim * p.caps[sol.kinds].astype(np.float64))
    n = len(eff)
    mask = np.zeros(n, dtype=bool)
    below = np.flatnonzero(eff < threshold)
    if len(below) > max_bins:
        below = below[np.argsort(eff[below] + 1e-9 * rng.random(len(below)))][:max_bins]
    mask[below] = True
    if extra_frac > 0.0:
        mask |= rng.random(n) < extra_frac
    if not mask.any():
        mask[rng.integers(n)] = True
    keep = [b for b, m in zip(sol.bins, mask) if not m]
    pool = np.asarray([i for b, m in zip(sol.bins, mask) if m for i in b], dtype=np.int64)
    rng.shuffle(pool)
    fresh = nfd_order(p, pool, rng, p_adm_w, p_adm_h)
    kinds = np.zeros(len(keep) + len(fresh), dtype=np.int64)
    kinds[: len(keep)] = sol.kinds[~mask]
    recs_kept = [r for r, m in zip(recs, mask) if not m]
    return Sol(p, keep + fresh, kinds, recs_kept + [None] * len(fresh))


def other_kind(rng, old, nk) -> int:
    return (old + 1 + int(rng.integers(nk - 1))) % nk


# ----------------------------------------------------------------------- GA
def fitness(sol: Sol, cost, inv_pen, ovf):
    f = float(cost)
    f += LAYER_WEIGHT * (float(sum(r[4] for r in sol.records())) / len(sol.bins))
    if inv_pen > 0.0:
        f += inv_pen * ovf
    return f


def ga_nfd(prob: Problem, seed, *, n_pop, n_tour, p_mut, p_adm_w, p_adm_h,
           max_generations, p_kind=0.25, nfd_max_bins=12, **_ignored) -> dict:
    """GA-NFD from ``seed`` for ``max_generations`` generations (no wall
    clock, no patience): the best packing, its cost, the trace's costs and
    the generations run."""
    rng = np.random.default_rng(seed)
    hetero = prob.n_kinds > 1
    inv_pen = INVENTORY_PENALTY if hetero else 0.0
    pop = [nfd_start(prob, rng, p_adm_w, p_adm_h, k % 2 == 0) for k in range(n_pop)]
    ovfs = np.asarray([s.overflow() for s in pop], dtype=np.float64) if hetero else None
    costs = np.asarray([s.cost() for s in pop], dtype=np.float64)
    fits = np.asarray([fitness(s, c, inv_pen, None if ovfs is None else ovfs[i])
                       for i, (s, c) in enumerate(zip(pop, costs))])
    sel = costs if ovfs is None else costs + inv_pen * ovfs
    bi = int(np.argmin(sel))
    best, best_cost, best_sel = pop[bi].copy(), int(costs[bi]), float(sel[bi])
    trace = [best_sel if hetero else best_cost]
    gen = 0
    while gen < max_generations:
        gen += 1
        for i in range(n_pop):
            if rng.random() < p_mut:
                if hetero and rng.random() < p_kind:
                    child = pop[i].copy()
                    b = int(rng.integers(len(child.bins)))
                    child.kinds[b] = other_kind(rng, int(child.kinds[b]), prob.n_kinds)
                    child.recs[b] = None
                else:
                    child = nfd_repack(pop[i], rng, p_adm_w, p_adm_h, max_bins=nfd_max_bins)
                pop[i] = child
                if ovfs is not None:
                    ovfs[i] = child.overflow()
                costs[i] = child.cost()
                fits[i] = fitness(child, costs[i], inv_pen, None if ovfs is None else ovfs[i])
        sel = costs if ovfs is None else costs + inv_pen * ovfs
        gi = int(np.argmin(sel))
        if float(sel[gi]) < best_sel:
            best_sel, best_cost, best = float(sel[gi]), int(costs[gi]), pop[gi].copy()
            trace.append(best_sel if hetero else best_cost)
        idx = rng.integers(n_pop, size=(n_pop, n_tour))
        winners = idx[np.arange(n_pop), np.argmin(fits[idx], axis=1)]
        winners[0] = int(np.argmin(fits))
        pop = [pop[int(w)] for w in winners]
        costs, fits = costs[winners], fits[winners]
        if ovfs is not None:
            ovfs = ovfs[winners]
    trace.append(best_sel if hetero else best_cost)
    return dict(bins=best.bins, kinds=[int(k) for k in best.kinds], cost=best_cost,
                trace=trace, iterations=gen)


# ----------------------------------------------------------------------- SA
def metropolis(d, temps, u):
    d = np.asarray(d, dtype=np.float64)
    safe_t = np.where(temps > 0, temps, 1.0)
    return (d < 0) | ((temps > 0) & (u < np.exp(-np.maximum(d, 0.0) / safe_t)))


def sa_s(prob: Problem, seed, *, n_chains, max_iterations, sa_t0=30.0, sa_rc=1.0,
         p_adm_w=0.0, p_adm_h=0.1, swap_moves=2, exchange_every=256, ladder_min=0.25,
         ladder_max=4.0, p_kind=0.15, **_ignored) -> dict:
    """SA-S with ``n_chains`` > 1 chains from ``seed`` for ``max_iterations``
    steps (no wall clock, no patience).  Chain state is a padded
    ``(C, bins, max_items)`` item matrix: a buffer leaves a bin by trading
    places with the bin's last buffer, and every ``exchange_every`` steps
    empty bins move to the end (stable), which fixes what each uniform
    draw picks."""
    if n_chains < 2:
        raise ValueError("the replay covers the multi-chain annealer (n_chains >= 2)")
    rng = np.random.default_rng(seed)
    C, lam = n_chains, INVENTORY_PENALTY
    hetero = prob.n_kinds > 1
    pk = p_kind if hetero else 0.0
    nk = prob.n_kinds
    n_moves = max(swap_moves, 1)
    width = 2 * n_moves
    sols = [nfd_start(prob, rng, p_adm_w, p_adm_h, c % 2 == 1) for c in range(C)]
    cap = prob.max_items
    nb = max(len(s.bins) for s in sols)
    items = np.full((C, nb, cap), -1, dtype=np.int32)
    counts = np.zeros((C, nb), dtype=np.int32)
    bw = np.zeros((C, nb), dtype=np.int32)
    bh = np.zeros((C, nb), dtype=np.int32)
    bk = np.zeros((C, nb), dtype=np.int32)
    for c, s in enumerate(sols):
        for b, (bl, r) in enumerate(zip(s.bins, s.records())):
            items[c, b, : len(bl)] = bl
            counts[c, b] = len(bl)
            bw[c, b], bh[c, b] = r[0], r[1]
        bk[c, : len(s.bins)] = s.kinds
    live = np.asarray([len(s.bins) for s in sols], dtype=np.int64)
    costs = np.asarray([s.cost() for s in sols], dtype=np.int64)
    wtab = np.append(prob.np_widths, 0)
    dtab = np.append(prob.np_depths, 0)
    sentinel = prob.n

    def ovf(uk):
        return prob.overflow(uk)

    if hetero:
        UK = np.stack([s.used() for s in sols])
        pcosts = costs + lam * ovf(UK)
    else:
        bk, UK, pcosts = None, None, costs
    g = int(pcosts.argmin())
    gbest_pcost, gbest_cost = pcosts[g], costs[g]
    g_items, g_counts, g_live = items[g].copy(), counts[g].copy(), live[g]
    g_kinds = bk[g].copy() if hetero else None
    g_UK = UK[g].copy() if hetero else None
    trace = [float(gbest_pcost) if hetero else int(gbest_cost)]
    t0s = np.full(C, float(sa_t0))
    if C == 2:
        t0s[1] = sa_t0 * math.sqrt(ladder_min * ladder_max)
    else:
        t0s[1:] = sa_t0 * np.geomspace(ladder_min, ladder_max, C - 1)
    ri = np.arange(C)
    steps = up_prop = up_acc = 0
    tslots = np.zeros((C, width), dtype=np.int64)
    entry_ok = np.zeros((C, width), dtype=bool)
    n_u = 6 if hetero else 4
    for it in range(max_iterations):
        u_all = rng.random((n_moves, n_u, C))
        if hetero:
            bk_new = bk.copy()
        snaps = []
        for m in range(n_moves):
            u = u_all[m]
            src = np.minimum((u[0] * live).astype(np.int64), live - 1)
            dst = np.minimum((u[1] * live).astype(np.int64), live - 1)
            kflip = None
            if hetero:
                kflip = u[4] < pk
                idxf = np.flatnonzero(kflip)
                if idxf.size:
                    shift = 1 + np.minimum((u[5, idxf] * (nk - 1)).astype(np.int64), nk - 2)
                    bk_new[idxf, src[idxf]] = (bk_new[idxf, src[idxf]] + shift) % nk
            ok = (live >= 2) & (src != dst)
            if hetero:
                ok &= ~kflip
            cnt_s = counts[ri, src]
            ok &= cnt_s > 0
            item_k = np.minimum((u[2] * cnt_s).astype(np.int64), np.maximum(cnt_s - 1, 0))
            item = items[ri, src, item_k]
            cnt_d = counts[ri, dst]
            full = cnt_d >= cap
            jd = np.minimum((u[3] * cnt_d).astype(np.int64), np.maximum(cnt_d - 1, 0))
            other = items[ri, dst, jd]
            swap = ok & full
            move = ok & ~full
            applied = move | swap
            snaps.append((src, dst, applied, items[ri, src], items[ri, dst], cnt_s, cnt_d))
            idx = np.flatnonzero(swap)
            if idx.size:
                items[idx, dst[idx], jd[idx]] = item[idx]
                items[idx, src[idx], item_k[idx]] = other[idx]
            idx = np.flatnonzero(move)
            if idx.size:
                items[idx, src[idx], item_k[idx]] = items[idx, src[idx], cnt_s[idx] - 1]
                items[idx, src[idx], cnt_s[idx] - 1] = -1
                counts[idx, src[idx]] -= 1
                items[idx, dst[idx], cnt_d[idx]] = item[idx]
                counts[idx, dst[idx]] += 1
            tslots[:, 2 * m] = src
            tslots[:, 2 * m + 1] = dst
            entry_ok[:, 2 * m] = applied | kflip if hetero else applied
            entry_ok[:, 2 * m + 1] = applied
        # a bin touched twice counts once (its first entry)
        for a in range(1, width):
            for b in range(a):
                entry_ok[:, a] &= ~(entry_ok[:, b] & (tslots[:, a] == tslots[:, b]))
        sel = np.where(entry_ok, tslots, 0)
        rows = ri[:, None]
        old_w = np.where(entry_ok, bw[rows, sel], 0).astype(np.int32)
        old_h = np.where(entry_ok, bh[rows, sel], 0).astype(np.int32)
        ids = items[rows, sel, :]
        ids = np.where(ids >= 0, ids, sentinel)
        new_w = np.where(entry_ok, wtab[ids].max(-1), 0).astype(np.int32)
        new_h = np.where(entry_ok, dtab[ids].sum(-1), 0).astype(np.int32)
        if hetero:
            old_k = np.where(entry_ok, bk[rows, sel], 0).astype(np.int32)
            new_k = np.where(entry_ok, bk_new[rows, sel], 0).astype(np.int32)
            d_e = (prob.unit_costs_many(new_w, new_h, new_k)
                   - prob.unit_costs_many(old_w, old_h, old_k)).sum(-1)
            if prob.bounded:
                po = prob.primitives_many(old_w, old_h, old_k)
                pn = prob.primitives_many(new_w, new_h, new_k)
                dUK = np.zeros((C, nk), dtype=np.int64)
                for kk in range(nk):
                    dUK[:, kk] = ((new_k == kk) * pn).sum(1) - ((old_k == kk) * po).sum(1)
                d_tot = d_e + lam * (ovf(UK + dUK) - ovf(UK))
            else:
                dUK, d_tot = None, d_e
        else:
            zero = np.zeros_like(new_w)
            d_e = (prob.unit_costs_many(new_w, new_h, zero)
                   - prob.unit_costs_many(old_w, old_h, zero)).sum(-1)
            d_tot = d_e
        temps = t0s / (1.0 + sa_rc * it)
        accept = metropolis(d_tot, temps, rng.random(C))
        reject = ~accept
        for m in range(n_moves - 1, -1, -1):
            src, dst, applied, s_items, d_items, s_cnt, d_cnt = snaps[m]
            idx = np.flatnonzero(reject & applied)
            if idx.size:
                items[idx, dst[idx]] = d_items[idx]
                counts[idx, dst[idx]] = d_cnt[idx]
                items[idx, src[idx]] = s_items[idx]
                counts[idx, src[idx]] = s_cnt[idx]
        costs += np.where(accept, d_e, 0)
        flat = np.flatnonzero((entry_ok & accept[:, None]).ravel())
        if flat.size:
            rr, cc = flat // width, tslots.ravel()[flat]
            bw[rr, cc] = new_w.ravel()[flat]
            bh[rr, cc] = new_h.ravel()[flat]
        if hetero:
            np.copyto(bk, bk_new, where=accept[:, None])
            if dUK is not None:
                UK += dUK * accept[:, None]
            pcosts = costs + lam * ovf(UK)
        else:
            pcosts = costs
        steps += C
        uphill = d_tot > 0
        up_prop += int(uphill.sum())
        up_acc += int((uphill & accept).sum())
        r = int(pcosts.argmin())
        if pcosts[r] < gbest_pcost:
            gbest_pcost, gbest_cost = pcosts[r], costs[r]
            g_items, g_counts, g_live = items[r].copy(), counts[r].copy(), live[r]
            if hetero:
                g_kinds, g_UK = bk[r].copy(), UK[r].copy()
            trace.append(float(gbest_pcost) if hetero else int(gbest_cost))
        if exchange_every > 0 and (it + 1) % exchange_every == 0:
            w = int(pcosts.argmax())
            if pcosts[w] > gbest_pcost:
                items[w], counts[w], live[w] = g_items, g_counts, g_live
                gi = np.where(g_items >= 0, g_items, sentinel)
                bw[w], bh[w] = wtab[gi].max(-1), dtab[gi].sum(-1)
                costs[w] = gbest_cost
                if hetero:
                    bk[w], UK[w] = g_kinds, g_UK
            if hetero:
                pcosts = costs + lam * ovf(UK)
            order = np.argsort(counts == 0, axis=1, kind="stable")
            items = np.take_along_axis(items, order[:, :, None], 1)
            counts = np.take_along_axis(counts, order, 1)
            bw = np.take_along_axis(bw, order, 1)
            bh = np.take_along_axis(bh, order, 1)
            if hetero:
                bk = np.take_along_axis(bk, order, 1)
            live = (counts > 0).sum(1)
    keep = [b for b in range(len(g_counts)) if g_counts[b] > 0]
    bins = [[int(x) for x in g_items[b, : int(g_counts[b])]] for b in keep]
    kinds = [int(g_kinds[b]) for b in keep] if hetero else [0] * len(keep)
    return dict(bins=bins, kinds=kinds, cost=int(gbest_cost), trace=trace,
                iterations=steps, uphill=(up_prop, up_acc))


SEARCHES = {"ga-nfd": ga_nfd, "sa-s": sa_s}
