/* One full NFD pass on the host: Algorithm 1's next-fit over a given order,
 * with its admission rule, emitting the bins and their geometry rows.
 *
 * The loop of `nfd_pack_order` (core/nfd.py) followed by `Solution._refresh`
 * (core/problem.py), in one pass: the loop already holds each bin's width,
 * height and cost when it closes the bin.  Every choice is the Python's, so
 * the bins, the rows and the draws are equal bit for bit:
 *   - a buffer joins the open bin iff the bin holds fewer than `max_items`,
 *     then (the grid gap under the best mode shrinks, or a draw < p_adm_h),
 *     then (the widths are equal, or a draw < p_adm_w), then (no intra-layer
 *     rule, or the layers are equal); each draw is taken only where the
 *     Python's short-circuit takes it, from `uniforms` in order;
 *   - a bin's mode is the first of least primitive count (`_cost_mode_gap`),
 *     its gap the rows left on that mode's depth grid.
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
