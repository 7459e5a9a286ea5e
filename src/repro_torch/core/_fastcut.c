/* Streaming greedy vertex-cut engine over flat numpy buffers.
 *
 * Exact mirror of the reference Python loop in vertex_cut.py:
 * same case rules, same (load, cluster-id) tie-breaking, same double
 * accumulation order, so assignments are bit-identical.
 */
#include <stdint.h>

static inline int least_in_mask(const uint64_t *mask, int64_t L,
                                const double *loads) {
    int best = -1;
    double best_l = 0.0;
    for (int64_t i = 0; i < L; i++) {
        uint64_t word = mask[i];
        while (word) {
            int c = (int)(i * 64 + __builtin_ctzll(word));
            double lc = loads[c];
            if (best < 0 || lc < best_l) { best = c; best_l = lc; }
            word &= word - 1;
        }
    }
    return best;
}

static inline int least_in_and(const uint64_t *a, const uint64_t *b,
                               int64_t L, const double *loads) {
    int best = -1;
    double best_l = 0.0;
    for (int64_t i = 0; i < L; i++) {
        uint64_t word = a[i] & b[i];
        while (word) {
            int c = (int)(i * 64 + __builtin_ctzll(word));
            double lc = loads[c];
            if (best < 0 || lc < best_l) { best = c; best_l = lc; }
            word &= word - 1;
        }
    }
    return best;
}

static inline int least_in_or(const uint64_t *a, const uint64_t *b,
                              int64_t L, const double *loads) {
    int best = -1;
    double best_l = 0.0;
    for (int64_t i = 0; i < L; i++) {
        uint64_t word = a[i] | b[i];
        while (word) {
            int c = (int)(i * 64 + __builtin_ctzll(word));
            double lc = loads[c];
            if (best < 0 || lc < best_l) { best = c; best_l = lc; }
            word &= word - 1;
        }
    }
    return best;
}

static inline int least_global(const double *loads, int p) {
    int best = 0;
    double best_l = loads[0];
    for (int c = 1; c < p; c++)
        if (loads[c] < best_l) { best = c; best_l = loads[c]; }
    return best;
}

static inline int mask_any(const uint64_t *m, int64_t L) {
    for (int64_t i = 0; i < L; i++)
        if (m[i]) return 1;
    return 0;
}

static inline int mask_and_any(const uint64_t *a, const uint64_t *b,
                               int64_t L) {
    for (int64_t i = 0; i < L; i++)
        if (a[i] & b[i]) return 1;
    return 0;
}

/* rule_pg: 0 = Libra (su/sv pre-swapped so A(su) is tried first),
 *          1 = PowerGraph (endpoint with more unassigned edges first). */
void stream_cut(int64_t start, int64_t m,
                const int32_t *su, const int32_t *sv, const double *w,
                int32_t p, int32_t rule_pg, double bound,
                double *loads, uint64_t *masks, int64_t L,
                int64_t *rem, int32_t *out) {
    for (int64_t e = start; e < m; e++) {
        int32_t u = su[e], v = sv[e];
        uint64_t *au = masks + (int64_t)u * L;
        uint64_t *av = masks + (int64_t)v * L;
        double we = w[e];
        int c;
        int has_u = mask_any(au, L), has_v = mask_any(av, L);
        if (has_u && has_v) {
            if (mask_and_any(au, av, L)) {           /* case 1 */
                c = least_in_and(au, av, L, loads);
                if (loads[c] >= bound) {
                    c = least_in_or(au, av, L, loads);
                    if (loads[c] >= bound)
                        c = least_global(loads, p);
                }
            } else {                                  /* case 2 */
                uint64_t *s = au, *t = av;
                if (rule_pg && rem[u] < rem[v]) { s = av; t = au; }
                c = least_in_mask(s, L, loads);
                if (loads[c] >= bound) {
                    c = least_in_mask(t, L, loads);
                    if (loads[c] >= bound)
                        c = least_global(loads, p);
                }
            }
        } else if (has_u || has_v) {                  /* case 3 */
            c = least_in_mask(has_u ? au : av, L, loads);
            if (loads[c] >= bound)
                c = least_global(loads, p);
        } else {                                      /* case 4 */
            c = least_global(loads, p);
        }
        loads[c] += we;
        au[c >> 6] |= 1ull << (c & 63);
        av[c >> 6] |= 1ull << (c & 63);
        if (rule_pg) { rem[u]--; rem[v]--; }
        out[e] = c;
    }
}
