/* One full NFD pass on the host: Algorithm 1's next-fit over a given order,
 * with its admission rule, emitting the bins and their geometry rows; and
 * the inventory-aware kind assignment that follows it on a bounded
 * multi-kind inventory.
 *
 * `nfd_pass` is the loop of `nfd_pack_order` (core/nfd.py) followed by
 * `Solution._refresh` (core/problem.py), in one pass: the loop already holds
 * each bin's width, height and cost when it closes the bin.  Every choice is
 * the Python's, so the bins, the rows and the draws are equal bit for bit:
 *   - a buffer joins the open bin iff the bin holds fewer than `max_items`,
 *     then (the grid gap under the best mode shrinks, or a draw < p_adm_h),
 *     then (the widths are equal, or a draw < p_adm_w), then (no intra-layer
 *     rule, or the layers are equal); each draw is taken only where the
 *     Python's short-circuit takes it, from `uniforms` in order;
 *   - a bin's mode is the first of least primitive count (`_cost_mode_gap`),
 *     its gap the rows left on that mode's depth grid.
 *
 * `assign_kinds` is `greedy_assign_kinds` (core/problem.py), decision for
 * decision; see its comment.
 *
 * Plain C with no library call, built by core/nfd_native.py with the host
 * compiler and loaded with ctypes.
 */
#include <stdint.h>

typedef struct {
  int64_t cost; /* primitives x weight */
  int64_t gap;  /* unused depth rows under the best mode */
  int64_t prim; /* primitives under the best mode */
} ModeCost;

/* ceil(a / b) for b > 0, as Python's -(-a // b) */
static int64_t ceil_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b > 0) ? q + 1 : q;
}

static ModeCost mode_cost(int64_t w, int64_t h, int64_t n_modes, const int64_t *mode_w,
                          const int64_t *mode_d, int64_t weight) {
  int64_t best = (int64_t)1 << 62, best_m = 0;
  for (int64_t m = 0; m < n_modes; ++m) {
    int64_t c = ceil_div(w, mode_w[m]) * ceil_div(h, mode_d[m]);
    if (c < best) {
      best = c;
      best_m = m;
    }
  }
  int64_t md = mode_d[best_m];
  ModeCost out = {best * weight, ceil_div(h, md) * md - h, best};
  return out;
}

/* Geometry row columns, as `Solution._geom`: (width, height, unit_cost,
 * bits, distinct_layers, primitives). */
static void close_bin(int64_t *row, int64_t w, int64_t h, ModeCost mc, int64_t bits,
                      int64_t n_layers) {
  row[0] = w;
  row[1] = h;
  row[2] = mc.cost;
  row[3] = bits;
  row[4] = n_layers;
  row[5] = mc.prim;
}

/* Pack `order[0..n)` (buffer indices into width / depth / layer).
 *
 * Writes bin b's items as order[starts[b] .. starts[b + 1]) and its row at
 * geom[6 b .. 6 b + 6); starts needs n + 1 slots, geom 6 n.  *n_used is the
 * number of uniforms read.  Returns the number of bins, or -1 for a mode of
 * size < 1 (no row can be costed) and -2 if the draws ran past n_uniforms
 * (2 n always suffice). */
int64_t nfd_pass(int64_t n, const int64_t *order, const int64_t *width,
                 const int64_t *depth, const int64_t *layer, int64_t n_modes,
                 const int64_t *mode_w, const int64_t *mode_d, int64_t weight,
                 int64_t max_items, int32_t intra_layer, double p_adm_w, double p_adm_h,
                 const double *uniforms, int64_t n_uniforms, int64_t *starts,
                 int64_t *geom, int64_t *n_used) {
  *n_used = 0;
  if (n_modes < 1) return -1;
  for (int64_t m = 0; m < n_modes; ++m)
    if (mode_w[m] < 1 || mode_d[m] < 1) return -1;
  if (n <= 0) {
    starts[0] = 0;
    return 0;
  }
  int64_t nb = 0, used = 0;
  int64_t first = 0, cnt = 1; /* the open bin: order[first .. first + cnt) */
  int64_t i = order[0];
  int64_t cur_w = width[i], cur_h = depth[i], cur_layer = layer[i];
  int64_t bits = width[i] * depth[i], n_layers = 1;
  ModeCost cur = mode_cost(cur_w, cur_h, n_modes, mode_w, mode_d, weight);
  for (int64_t k = 1; k < n; ++k) {
    i = order[k];
    int64_t w = width[i], d = depth[i];
    int ok = 0;
    ModeCost next = cur;
    int64_t new_w = cur_w >= w ? cur_w : w, new_h = cur_h + d;
    if (cnt < max_items) {
      next = mode_cost(new_w, new_h, n_modes, mode_w, mode_d, weight);
      int fits = next.gap < cur.gap;
      if (!fits) {
        if (used >= n_uniforms) return -2;
        fits = uniforms[used++] < p_adm_h;
      }
      if (fits) {
        int aligned = cur_w == w;
        if (!aligned) {
          if (used >= n_uniforms) return -2;
          aligned = uniforms[used++] < p_adm_w;
        }
        ok = aligned && (!intra_layer || layer[i] == cur_layer);
      }
    }
    if (ok) {
      int seen = 0;
      for (int64_t j = first; j < k && !seen; ++j) seen = layer[order[j]] == layer[i];
      n_layers += !seen;
      ++cnt;
      cur_w = new_w;
      cur_h = new_h;
      cur = next;
      bits += w * d;
    } else {
      starts[nb] = first;
      close_bin(geom + 6 * nb, cur_w, cur_h, cur, bits, n_layers);
      ++nb;
      first = k;
      cnt = 1;
      cur_w = w;
      cur_h = d;
      cur_layer = layer[i];
      bits = w * d;
      n_layers = 1;
      cur = mode_cost(w, d, n_modes, mode_w, mode_d, weight);
    }
  }
  starts[nb] = first;
  close_bin(geom + 6 * nb, cur_w, cur_h, cur, bits, n_layers);
  ++nb;
  starts[nb] = n;
  *n_used = used;
  return nb;
}

/* Bin b's regret towards each kind j from its kind k: (wc[j] - wc[k]) /
 * prim[k] over its row of the cost table, 0 where it holds no primitives on k
 * (it cannot move then). */
static void set_regret(int64_t nk, const int64_t *wc, const int64_t *prim, int64_t k,
                       double *regret) {
  int64_t cp = prim[k];
  for (int64_t j = 0; j < nk; ++j)
    regret[j] = cp > 0 ? (double)(wc[j] - wc[k]) / (double)cp : 0.0;
}

/* Give each of nb bins a RAM kind: every bin starts on its cheapest kind
 * (the first of least unit cost); while a bounded kind (counts >= 0) is over
 * its count, the movable bin of least regret moves.  A bin is movable if its
 * kind is over and it holds primitives there; a target j != its kind takes
 * it if j is unbounded or has room for its primitives on j.  The regret is
 * (unit cost on j - unit cost now) / primitives now, in double as numpy's
 * int64 true division; within a target the lowest bin of least regret wins,
 * across targets a later one only if strictly less.  At most nb + 1 rounds;
 * what overflow is left stays.
 *
 * Kind k's modes are mode_w / mode_d[k_off .. k_off + n_modes[k]), k_off the
 * sum of the earlier counts.  Reads each bin's width and height from its
 * row at geom[6 b ..] and writes its kind to kinds[b] and its unit cost and
 * primitives on that kind into the row.  `table` holds 2 nb n_kinds +
 * n_kinds int64 and `regret` nb n_kinds doubles of scratch.  Returns the
 * number of moves, or -1 for a mode of size < 1. */
int64_t assign_kinds(int64_t nb, int64_t n_kinds, const int64_t *n_modes,
                     const int64_t *mode_w, const int64_t *mode_d, const int64_t *weight,
                     const int64_t *counts, int64_t *kinds, int64_t *geom, int64_t *table,
                     double *regret) {
  const int64_t nk = n_kinds;
  int64_t *wc = table, *prim = table + nb * nk, *used = table + 2 * nb * nk;
  int64_t off = 0;
  for (int64_t k = 0; k < nk; ++k) {
    if (n_modes[k] < 1) return -1;
    for (int64_t m = off; m < off + n_modes[k]; ++m)
      if (mode_w[m] < 1 || mode_d[m] < 1) return -1;
    off += n_modes[k];
  }
  for (int64_t k = 0; k < nk; ++k) used[k] = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t w = geom[6 * b], h = geom[6 * b + 1], best = 0;
    off = 0;
    for (int64_t k = 0; k < nk; ++k) {
      ModeCost mc = mode_cost(w, h, n_modes[k], mode_w + off, mode_d + off, weight[k]);
      off += n_modes[k];
      wc[b * nk + k] = mc.cost;
      prim[b * nk + k] = mc.prim;
      if (mc.cost < wc[b * nk + best]) best = k;
    }
    kinds[b] = best;
    used[best] += prim[b * nk + best];
  }
  /* wc and prim never change: a regret row is rewritten only when its bin moves */
  for (int64_t b = 0; b < nb; ++b)
    set_regret(nk, wc + b * nk, prim + b * nk, kinds[b], regret + b * nk);
#define OVER(k) (counts[k] >= 0 && used[k] > counts[k])
  int64_t moves = 0;
  for (int64_t round = 0; round <= nb; ++round) {
    int64_t n_over = 0;
    for (int64_t k = 0; k < nk; ++k) n_over += OVER(k);
    if (!n_over) break;
    int64_t best_b = -1, best_j = 0;
    double best_r = 0.0;
    for (int64_t j = 0; j < nk; ++j) {
      if (n_over == OVER(j)) continue; /* only j itself is over: no bin may leave for j */
      int64_t room = counts[j] >= 0 ? counts[j] - used[j] : INT64_MAX;
      int64_t jb = -1;
      double jr = 0.0;
      for (int64_t b = 0; b < nb; ++b) {
        int64_t k = kinds[b];
        if (k == j || !OVER(k) || prim[b * nk + k] <= 0 || prim[b * nk + j] > room) continue;
        double r = regret[b * nk + j];
        if (jb < 0 || r < jr) {
          jb = b;
          jr = r;
        }
      }
      if (jb >= 0 && (best_b < 0 || jr < best_r)) {
        best_b = jb;
        best_j = j;
        best_r = jr;
      }
    }
    if (best_b < 0) break;
    int64_t b = best_b;
    used[kinds[b]] -= prim[b * nk + kinds[b]];
    used[best_j] += prim[b * nk + best_j];
    kinds[b] = best_j;
    set_regret(nk, wc + b * nk, prim + b * nk, best_j, regret + b * nk);
    ++moves;
  }
#undef OVER
  for (int64_t b = 0; b < nb; ++b) {
    geom[6 * b + 2] = wc[b * nk + kinds[b]];
    geom[6 * b + 5] = prim[b * nk + kinds[b]];
  }
  return moves;
}
