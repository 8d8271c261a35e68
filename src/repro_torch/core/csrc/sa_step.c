/* The SA fleet step's host code on the host: the proposal, the touched
 * slots' geometry and the commit of `_block_gen` (core/sa.py), in three
 * calls over one state struct, each a plain loop over the chain rows.
 *
 * Every choice and every number is the reference's numpy body's
 * (repro.core.sa), so the state, the request planes, the penalty and the
 * counters are equal bit for bit:
 *   - a row's moves run in move order and touch that row alone, so a loop
 *     over rows with the moves inside does what numpy does move by move
 *     over all rows;
 *   - a pick is `min(trunc(u * n), n - 1)` in float64, as numpy's
 *     `np.minimum((u * n).astype(np.int64), n - 1)`; a negative slot (an
 *     empty chain's `live - 1`) wraps to the last slot, as numpy's indexing
 *     does;
 *   - integers keep numpy's dtypes (items, counts, geometry and kind lanes
 *     int32; costs, usage, steps and patience int64), and each float64
 *     (`pen`, the penalized costs) is computed in numpy's order:
 *     `lam * (double)(ovf_new - ovf_old)`, `(double)cost + lam * (double)ovf`,
 *     `(double)d_e + pen`; argmin takes the first least value, or the first
 *     NaN, as numpy's does;
 *   - an integer penalty weight (`float_pcosts` 0 on a multi-kind fleet)
 *     keeps `pen` and the penalized costs int64, weighted by `ilam`, as
 *     numpy's integer arithmetic does.
 * The Metropolis compare stays in numpy float64 between `sa_gather` and
 * `sa_commit`; the draws stay numpy `Generator` calls before `sa_propose`.
 * Plain C with no library call, built by core/sa_native.py with the host
 * compiler (no FP contraction) and loaded with ctypes.
 */
#include <stdint.h>
#include <string.h>

/* Field for field `sa_native._Step`; R rows = P problems x C chains, NB
 * slots, CAP items a slot, M moves, W = 2 M touched entries, K kinds, T
 * buffer-table columns (the last one the empty sentinel). */
typedef struct {
  int64_t n_probs, n_chains, n_rows, n_moves, n_slots, cap, n_kinds, n_u, tab_len,
      max_modes, hetero, intra_layer, bounded, float_pcosts, ilam;
  double p_kind, lam;
  /* problem tables */
  const int64_t *wtab, *dtab, *ltab; /* (P or 1, T) */
  const int64_t *caps_r;             /* (R,) */
  const int64_t *kind_counts;        /* (P, K), < 0 unbounded */
  const int64_t *kind_weights;       /* (K,) */
  const int64_t *n_modes;            /* (K,) */
  const int64_t *mode_w, *mode_d;    /* (K, max_modes) */
  /* chain state */
  int32_t *items;  /* (R, NB, CAP), -1 empty */
  int32_t *counts; /* (R, NB) */
  int32_t *bw, *bh, *bk; /* (R, NB); bk on hetero */
  const int64_t *live;   /* (R,) */
  int64_t *costs, *stale, *steps; /* (R,) */
  int64_t *uk;                    /* (R, K) on hetero */
  void *pcosts, *best_pcosts;     /* (R,) double where float_pcosts, else int64
                                     (single-kind: pcosts == costs) */
  int64_t *up_prop, *up_acc;      /* (P,) */
  /* per-problem best */
  void *gbest_pcost; /* (P,) as pcosts */
  int64_t *gbest_cost, *g_live, *g_uk;
  int32_t *g_items, *g_counts, *g_kinds;
  /* a step's inputs and scratch */
  const double *u_all;     /* (P, M, n_u, C) */
  const uint8_t *active;   /* (R,) */
  int64_t *tslots;         /* (R, W) */
  uint8_t *entry_ok;       /* (R, W) */
  int32_t *bk_new;         /* (R, NB), equal to bk between steps */
  int64_t *flips;          /* (R, M) slot a move's kind flip touched, or -1 */
  uint8_t *applied;        /* (R, M) */
  int32_t *snap_items;     /* (R, M, 2, CAP): src and dst slots before the move */
  int32_t *snap_counts;    /* (R, M, 2) */
  int32_t *old_w, *old_h, *new_w, *new_h, *old_k, *new_k; /* (R, W) */
  int64_t *duk;            /* (R, K) */
  void *pen;               /* (R,) as pcosts */
  const int64_t *d_e;      /* (R,) the delta call's answer */
  const uint8_t *accept;   /* (R,) Metropolis mask & active */
  int64_t *improved;       /* (P,) problems whose best improved */
} Step;

static int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
static int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
static int64_t wrap(int64_t s, int64_t n) { return s < 0 ? s + n : s; }

/* min(trunc(u * n), max(n - 1, 0)): a pick among n items (n >= 0) */
static int64_t pick(double u, int64_t n) {
  return imin((int64_t)(u * (double)n), imax(n - 1, 0));
}

/* ceil(a / b) for b > 0, as Python's -(-a // b) */
static int64_t ceil_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b > 0) ? q + 1 : q;
}

/* primitives of a (w, h) bin on kind k: the least over k's modes, 0 for a
 * kind outside the tables (`bin_primitives_many`) */
static int64_t primitives(const Step *s, int64_t w, int64_t h, int64_t k) {
  if (k < 0 || k >= s->n_kinds) return 0;
  const int64_t *mw = s->mode_w + k * s->max_modes, *md = s->mode_d + k * s->max_modes;
  int64_t best = ceil_div(w, mw[0]) * ceil_div(h, md[0]);
  for (int64_t m = 1; m < s->n_modes[k]; ++m) {
    int64_t c = ceil_div(w, mw[m]) * ceil_div(h, md[m]);
    if (c < best) best = c;
  }
  return best;
}

/* unit-weighted usage beyond problem p's counts (`overflow_rows`) */
static int64_t overflow(const Step *s, int64_t p, const int64_t *uk, const int64_t *duk) {
  const int64_t *cnt = s->kind_counts + p * s->n_kinds;
  int64_t total = 0;
  for (int64_t k = 0; k < s->n_kinds; ++k) {
    int64_t over = uk[k] + (duk ? duk[k] : 0) - cnt[k];
    if (over < 0 || cnt[k] < 0) over = 0;
    total += over * s->kind_weights[k];
  }
  return total;
}

/* The moves of every row from the step's uniform block (`sa.propose`):
 * kind flips into bk_new, the move or swap with its rollback snapshot, and
 * the touched slots with the rule that the first entry of a slot wins. */
int64_t sa_propose(Step *s) {
  const int64_t R = s->n_rows, NB = s->n_slots, CAP = s->cap, M = s->n_moves, W = 2 * M,
                K = s->n_kinds, T = s->tab_len, C = s->n_chains, sent = T - 1;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t live = s->live[r];
    const int act = s->active[r] != 0;
    const int64_t p = r / C, c = r % C;
    const int64_t *lt = s->ltab + p * T;
    int32_t *irow = s->items + r * NB * CAP, *crow = s->counts + r * NB;
    int64_t *ts = s->tslots + r * W;
    uint8_t *eo = s->entry_ok + r * W;
    for (int64_t m = 0; m < M; ++m) {
      /* this row's uniforms: row q at u[q * C] */
      const double *u = s->u_all + ((p * M + m) * s->n_u) * C + c;
      const int64_t src = imin((int64_t)(u[0] * (double)live), live - 1);
      const int64_t dst = imin((int64_t)(u[C] * (double)live), live - 1);
      int kflip = 0;
      if (s->hetero) {
        int64_t *flip = s->flips + r * M + m;
        *flip = -1;
        kflip = act && u[4 * C] < s->p_kind;
        if (kflip) {
          const int64_t shift = 1 + imin((int64_t)(u[5 * C] * (double)(K - 1)), K - 2);
          const int64_t slot = wrap(src, NB);
          int32_t *k = s->bk_new + r * NB + slot;
          *k = (int32_t)(((int64_t)*k + shift) % K);
          *flip = slot;
        }
      }
      const int64_t sw = wrap(src, NB), dw = wrap(dst, NB);
      int32_t *srow = irow + sw * CAP, *drow = irow + dw * CAP;
      const int64_t cnt_s = crow[sw], cnt_d = crow[dw];
      int ok = act && live >= 2 && src != dst && !kflip && cnt_s > 0;
      const int64_t item_k = pick(u[2 * C], cnt_s);
      const int64_t item = srow[item_k];
      if (s->intra_layer && ok) {
        const int64_t first = drow[0];
        ok = cnt_d == 0 || lt[first >= 0 ? first : sent] == lt[item >= 0 ? item : sent];
      }
      const int full = cnt_d >= s->caps_r[r];
      const int64_t jd = pick(u[3 * C], cnt_d);
      const int64_t other = drow[jd];
      int swap = ok && full;
      if (s->intra_layer && swap) {
        const int64_t first = srow[0];
        swap = lt[other >= 0 ? other : sent] == lt[first >= 0 ? first : sent];
      }
      const int move = ok && !full;
      const int app = move || swap;
      s->applied[r * M + m] = (uint8_t)app;
      if (app) {
        int32_t *snap = s->snap_items + (r * M + m) * 2 * CAP;
        memcpy(snap, srow, (size_t)CAP * sizeof(int32_t));
        memcpy(snap + CAP, drow, (size_t)CAP * sizeof(int32_t));
        s->snap_counts[(r * M + m) * 2] = (int32_t)cnt_s;
        s->snap_counts[(r * M + m) * 2 + 1] = (int32_t)cnt_d;
      }
      if (swap) {
        drow[jd] = (int32_t)item;
        srow[item_k] = (int32_t)other;
      } else if (move) {
        /* remove: the picked item takes the last one's place; append */
        srow[item_k] = srow[cnt_s - 1];
        srow[cnt_s - 1] = -1;
        crow[sw] -= 1;
        drow[cnt_d] = (int32_t)item;
        crow[dw] += 1;
      }
      ts[2 * m] = src;
      ts[2 * m + 1] = dst;
      /* a kind flip touches only the src slot; a move or swap both */
      eo[2 * m] = (uint8_t)(app || kflip);
      eo[2 * m + 1] = (uint8_t)app;
    }
    for (int64_t a = 1; a < W; ++a)
      for (int64_t b = 0; b < a && eo[a]; ++b)
        if (eo[b] && ts[a] == ts[b]) eo[a] = 0;
  }
  return 0;
}

/* The request planes (`sa.gather`): each touched slot's geometry (and kind)
 * before and after, 0 off the touched entries; on a bounded inventory also
 * the usage change dUK and the penalty delta lam (ovf(UK + dUK) - ovf(UK)). */
int64_t sa_gather(Step *s) {
  const int64_t R = s->n_rows, NB = s->n_slots, CAP = s->cap, W = 2 * s->n_moves,
                K = s->n_kinds, T = s->tab_len, sent = T - 1;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t p = r / s->n_chains;
    const int64_t *wt = s->wtab + p * T, *dt = s->dtab + p * T;
    const int64_t *ts = s->tslots + r * W;
    const uint8_t *eo = s->entry_ok + r * W;
    for (int64_t e = 0; e < W; ++e) {
      const int64_t i = r * W + e;
      if (!eo[e]) {
        s->old_w[i] = s->old_h[i] = s->new_w[i] = s->new_h[i] = 0;
        if (s->hetero) s->old_k[i] = s->new_k[i] = 0;
        continue;
      }
      const int64_t slot = r * NB + wrap(ts[e], NB);
      const int32_t *row = s->items + slot * CAP;
      int64_t w = 0, h = 0;
      for (int64_t c = 0; c < CAP; ++c) {
        const int64_t id = row[c] >= 0 ? row[c] : sent;
        w = c == 0 || wt[id] > w ? wt[id] : w;
        h += dt[id];
      }
      s->old_w[i] = s->bw[slot];
      s->old_h[i] = s->bh[slot];
      s->new_w[i] = (int32_t)w;
      s->new_h[i] = (int32_t)h;
      if (s->hetero) {
        s->old_k[i] = s->bk[slot];
        s->new_k[i] = s->bk_new[slot];
      }
    }
    if (s->hetero && s->bounded) {
      int64_t *du = s->duk + r * K;
      for (int64_t k = 0; k < K; ++k) du[k] = 0;
      for (int64_t e = 0; e < W; ++e) {
        const int64_t i = r * W + e;
        if (!eo[e]) continue;
        const int64_t kn = s->new_k[i], ko = s->old_k[i];
        if (kn >= 0 && kn < K) du[kn] += primitives(s, s->new_w[i], s->new_h[i], kn);
        if (ko >= 0 && ko < K) du[ko] -= primitives(s, s->old_w[i], s->old_h[i], ko);
      }
      const int64_t *uk = s->uk + r * K;
      const int64_t dovf = overflow(s, p, uk, du) - overflow(s, p, uk, NULL);
      if (s->float_pcosts)
        ((double *)s->pen)[r] = s->lam * (double)dovf;
      else
        ((int64_t *)s->pen)[r] = s->ilam * dovf;
    }
  }
  return 0;
}

/* Everything after the Metropolis mask (`sa.accept`): rollback of rejected
 * rows in reverse move order, the commit of accepted ones, the uphill
 * counters, steps, per-chain best and patience, then each problem's best
 * chain copied where it beats the problem's best.  Returns how many
 * problems improved; their indices are in `improved`, ascending. */
int64_t sa_commit(Step *s) {
  const int64_t R = s->n_rows, NB = s->n_slots, CAP = s->cap, M = s->n_moves, W = 2 * M,
                K = s->n_kinds, C = s->n_chains;
  const int het = s->hetero != 0, bounded = het && s->bounded, fpc = s->float_pcosts != 0;
  const double *penf = s->pen;
  const int64_t *peni = s->pen;
  double *pcf = s->pcosts, *bestf = s->best_pcosts, *gbf = s->gbest_pcost;
  int64_t *pci = s->pcosts, *besti = s->best_pcosts, *gbi = s->gbest_pcost;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t p = r / C;
    const int acc = s->accept[r] != 0, act = s->active[r] != 0;
    int32_t *irow = s->items + r * NB * CAP, *crow = s->counts + r * NB;
    const int64_t *ts = s->tslots + r * W;
    if (!acc) {
      for (int64_t m = M - 1; m >= 0; --m) {
        if (!s->applied[r * M + m]) continue;
        const int32_t *snap = s->snap_items + (r * M + m) * 2 * CAP;
        const int32_t *sc = s->snap_counts + (r * M + m) * 2;
        const int64_t sw = wrap(ts[2 * m], NB), dw = wrap(ts[2 * m + 1], NB);
        memcpy(irow + dw * CAP, snap + CAP, (size_t)CAP * sizeof(int32_t));
        crow[dw] = sc[1];
        memcpy(irow + sw * CAP, snap, (size_t)CAP * sizeof(int32_t));
        crow[sw] = sc[0];
      }
    }
    if (het) {
      int32_t *bk = s->bk + r * NB, *bkn = s->bk_new + r * NB;
      for (int64_t m = 0; m < M; ++m) {
        const int64_t slot = s->flips[r * M + m];
        if (slot < 0) continue;
        if (acc)
          bk[slot] = bkn[slot];
        else
          bkn[slot] = bk[slot];
      }
    }
    const int64_t de = s->d_e[r];
    if (acc) {
      s->costs[r] += de;
      const uint8_t *eo = s->entry_ok + r * W;
      for (int64_t e = 0; e < W; ++e) {
        if (!eo[e]) continue;
        const int64_t slot = r * NB + wrap(ts[e], NB);
        s->bw[slot] = s->new_w[r * W + e];
        s->bh[slot] = s->new_h[r * W + e];
      }
    }
    int up;
    if (het) {
      int64_t *uk = s->uk + r * K;
      if (bounded && acc)
        for (int64_t k = 0; k < K; ++k) uk[k] += s->duk[r * K + k];
      const int64_t ovf = overflow(s, p, uk, NULL);
      if (fpc)
        pcf[r] = (double)s->costs[r] + s->lam * (double)ovf;
      else
        pci[r] = s->costs[r] + s->ilam * ovf;
    }
    if (!bounded)
      up = de > 0;
    else
      up = fpc ? (double)de + penf[r] > 0.0 : de + peni[r] > 0;
    if (act && up) {
      s->up_prop[p] += 1;
      s->up_acc[p] += acc;
    }
    s->steps[r] += act;
    int improved;
    if (fpc) {
      improved = act && pcf[r] < bestf[r];
      if (improved) bestf[r] = pcf[r];
    } else {
      improved = act && pci[r] < besti[r];
      if (improved) besti[r] = pci[r];
    }
    s->stale[r] = improved ? 0 : s->stale[r] + act;
  }
  int64_t n = 0;
  for (int64_t j = 0; j < s->n_probs; ++j) {
    const int64_t lo = j * C;
    int64_t r = lo, better;
    if (fpc) {
      double v = pcf[lo];
      for (int64_t c = 1; c < C && v == v; ++c) {
        const double x = pcf[lo + c];
        if (x != x || x < v) {
          v = x;
          r = lo + c;
        }
      }
      better = pcf[r] < gbf[j];
      if (better) gbf[j] = pcf[r];
    } else {
      int64_t v = pci[lo];
      for (int64_t c = 1; c < C; ++c)
        if (pci[lo + c] < v) {
          v = pci[lo + c];
          r = lo + c;
        }
      better = pci[r] < gbi[j];
      if (better) gbi[j] = pci[r];
    }
    if (!better) continue;
    s->gbest_cost[j] = s->costs[r];
    memcpy(s->g_items + j * NB * CAP, s->items + r * NB * CAP,
           (size_t)(NB * CAP) * sizeof(int32_t));
    memcpy(s->g_counts + j * NB, s->counts + r * NB, (size_t)NB * sizeof(int32_t));
    s->g_live[j] = s->live[r];
    if (het) {
      memcpy(s->g_kinds + j * NB, s->bk + r * NB, (size_t)NB * sizeof(int32_t));
      memcpy(s->g_uk + j * K, s->uk + r * K, (size_t)K * sizeof(int64_t));
    }
    s->improved[n++] = j;
  }
  return n;
}
