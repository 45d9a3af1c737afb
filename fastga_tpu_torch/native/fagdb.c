/* FASTA -> GDB in one pass over the file's bytes.
 *
 * The semantics are those of io/gdb.py's numpy body (Create_GDB, GDB.c):
 * a line starting with '>' opens a scaffold whose header is the rest of that
 * line; every '\n' and '\r' of the sequence is dropped; acgtACGT are bases
 * and every other byte a non-base.  A non-base run shorter than ``ncut``
 * stays in its contig as base 0 ('a', never masked); a longer one splits
 * the contig (a leading one leaves a contig of length 0); a scaffold's
 * trailing run is dropped from its length.  Each contig starts on a fresh
 * .bps byte, base i at bit 2*(i%4).  Lower-case runs are the soft-mask
 * intervals, in contig coordinates.
 *
 * All outputs live in growing buffers owned by the fag_t handle:
 *   scaf  5 int64 a scaffold: header begin, header end, slen, fctg, ectg
 *   ctg   4 int64 a contig:   clen, sbeg, boff, scaf
 *   mask  3 int64 a run:      contig, beg, end
 *   bps   the packed bases
 * fag_parse returns 0, 1 when the last scaffold has no base, 2 when the
 * input does not start with '>', and -1 when memory runs out.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int64_t *scaf;
    int64_t nscaf;
    int64_t *ctg;
    int64_t nctg;
    int64_t *mask;
    int64_t nmask;
    uint8_t *bps;
    int64_t nbps;
    int64_t counts[4];
    int64_t maxctg;
    int64_t saw_upper;
    int64_t cap_scaf, cap_ctg, cap_mask, cap_bps;
} fag_t;

#define F_LOWER 4
#define F_GAP 8
#define F_SKIP 16

fag_t *fag_new(void) { return (fag_t *)calloc(1, sizeof(fag_t)); }

void fag_free(fag_t *g)
{
    if (g == NULL)
        return;
    free(g->scaf);
    free(g->ctg);
    free(g->mask);
    free(g->bps);
    free(g);
}

/* Room for ``need`` more int64 after ``n`` in *v (capacity *cap). */
static int grow64(int64_t **v, int64_t *cap, int64_t n, int64_t need)
{
    if (n + need <= *cap)
        return 0;
    int64_t c = *cap ? *cap : 1024;
    while (c < n + need)
        c *= 2;
    int64_t *w = (int64_t *)realloc(*v, c * sizeof(int64_t));
    if (w == NULL)
        return -1;
    *v = w;
    *cap = c;
    return 0;
}

/* Room for byte index ``upto`` - 1 in bps, new bytes zeroed. */
static int grow_bps(fag_t *g, int64_t upto)
{
    if (upto <= g->cap_bps)
        return 0;
    int64_t c = g->cap_bps ? g->cap_bps : (1 << 16);
    while (c < upto)
        c *= 2;
    uint8_t *w = (uint8_t *)realloc(g->bps, c);
    if (w == NULL)
        return -1;
    memset(w + g->cap_bps, 0, c - g->cap_bps);
    g->bps = w;
    g->cap_bps = c;
    return 0;
}

#define PUSH_MASK(b, e)                                                     \
    do {                                                                    \
        if (grow64(&g->mask, &g->cap_mask, 3 * g->nmask, 3))                \
            return -1;                                                      \
        int64_t *m_ = g->mask + 3 * g->nmask++;                             \
        m_[0] = g->nctg;                                                    \
        m_[1] = (b);                                                        \
        m_[2] = (e);                                                        \
    } while (0)

#define FLUSH_CONTIG()                                                      \
    do {                                                                    \
        if (mbeg >= 0) {                                                    \
            PUSH_MASK(mbeg, ci);                                            \
            mbeg = -1;                                                      \
        }                                                                   \
        if (grow64(&g->ctg, &g->cap_ctg, 4 * g->nctg, 4))                   \
            return -1;                                                      \
        int64_t *c_ = g->ctg + 4 * g->nctg++;                               \
        c_[0] = ci;                                                         \
        c_[1] = sbeg;                                                       \
        c_[2] = boff;                                                       \
        c_[3] = g->nscaf - 1;                                               \
        boff += (ci + 3) >> 2;                                              \
        if (ci > g->maxctg)                                                 \
            g->maxctg = ci;                                                 \
        ci = 0;                                                             \
    } while (0)

/* Close the open scaffold: drop its trailing gap, flush its last contig. */
#define END_SCAFFOLD()                                                      \
    do {                                                                    \
        if (ci == 0)                                                        \
            return 1;                                                       \
        int64_t *s_ = g->scaf + 5 * (g->nscaf - 1);                         \
        s_[2] = spos - gap;                                                 \
        FLUSH_CONTIG();                                                     \
        s_ = g->scaf + 5 * (g->nscaf - 1);                                  \
        s_[4] = g->nctg;                                                    \
    } while (0)

/* The four base counts, from the packed bytes: a kept gap byte is a zero
 * 'a' there already, and each contig's last byte pads with zeros, which
 * are taken off the count of 'a'. */
static void count_bases(fag_t *g)
{
    uint64_t lut[256];
    for (int b = 0; b < 256; b++) {
        lut[b] = 0;
        for (int k = 0; k < 4; k++)
            lut[b] += (uint64_t)1 << (16 * ((b >> (2 * k)) & 3));
    }
    int64_t cnt[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < g->nbps;) {
        /* 16-bit lanes, each gaining at most 4 a byte */
        int64_t end = i + 16000 < g->nbps ? i + 16000 : g->nbps;
        uint64_t acc = 0;
        for (; i < end; i++)
            acc += lut[g->bps[i]];
        for (int k = 0; k < 4; k++)
            cnt[k] += (int64_t)((acc >> (16 * k)) & 0xffff);
    }
    int64_t seqtot = 0;
    for (int64_t i = 0; i < g->nctg; i++)
        seqtot += g->ctg[4 * i];
    cnt[0] -= 4 * g->nbps - seqtot;
    for (int k = 0; k < 4; k++)
        g->counts[k] = cnt[k];
}

int fag_parse(fag_t *g, const uint8_t *d, int64_t n, int64_t ncut)
{
    uint8_t tab[256];
    memset(tab, F_GAP, sizeof(tab));
    tab['\r'] = F_SKIP;
    for (int k = 0; k < 4; k++) {
        tab[(uint8_t)"acgt"[k]] = (uint8_t)(k | F_LOWER);
        tab[(uint8_t)"ACGT"[k]] = (uint8_t)k;
    }
    if (n == 0 || d[0] != '>')
        return 2;

    int upper = 0;
    int64_t boff = 0;
    /* the open scaffold and contig */
    int64_t spos = 0, gap = 0, gbeg = 0, sbeg = 0, ci = 0, mbeg = -1;
    uint8_t cur = 0;

    int64_t p = 0;
    while (p < n) {
        const uint8_t *nl = (const uint8_t *)memchr(d + p, '\n', n - p);
        int64_t e = nl ? nl - d : n;
        if (d[p] == '>') {
            if (g->nscaf)
                END_SCAFFOLD();
            if (grow64(&g->scaf, &g->cap_scaf, 5 * g->nscaf, 5))
                return -1;
            int64_t *s = g->scaf + 5 * g->nscaf++;
            s[0] = p + 1;
            s[1] = e;
            s[2] = 0;
            s[3] = g->nctg;
            s[4] = g->nctg;
            spos = gap = gbeg = sbeg = ci = 0;
            mbeg = -1;
        } else {
            /* a byte of .bps at most for each base or kept gap byte */
            if (grow_bps(g, boff + (ci >> 2) + 1 + gap + (e - p)))
                return -1;
            uint8_t *bps = g->bps;
            const uint8_t *q = d + p, *qe = d + e;
            while (q < qe) {
                if (gap == 0 && (ci & 3) == 0) {
                    /* four bases of the open contig's case to a byte */
                    unsigned w = mbeg >= 0 ? F_LOWER : 0;
                    uint8_t *o = bps + boff + (ci >> 2);
                    const uint8_t *q0 = q;
                    while (qe - q >= 4) {
                        unsigned t0 = tab[q[0]], t1 = tab[q[1]];
                        unsigned t2 = tab[q[2]], t3 = tab[q[3]];
                        if (((t0 ^ w) | (t1 ^ w) | (t2 ^ w) | (t3 ^ w)) & ~3u)
                            break;
                        *o++ = (uint8_t)((t0 & 3) | (t1 & 3) << 2
                                         | (t2 & 3) << 4 | (t3 & 3) << 6);
                        q += 4;
                    }
                    if (q > q0) {
                        ci += q - q0;
                        spos += q - q0;
                        upper |= !w;
                        if (q == qe)
                            break;
                    }
                }
                /* one byte: a gap byte, a change of case, a line's tail */
                unsigned t = tab[*q++];
                if (t & (F_GAP | F_SKIP)) {
                    if (t & F_SKIP)
                        continue;
                    if (gap == 0) {
                        gbeg = spos;
                        if (mbeg >= 0) {
                            PUSH_MASK(mbeg, ci);
                            mbeg = -1;
                        }
                    }
                    gap++;
                    spos++;
                    continue;
                }
                if (gap) {
                    if (gap >= ncut) {
                        FLUSH_CONTIG();
                        sbeg = gbeg + gap;
                    } else {
                        ci += gap;
                        cur = bps[boff + (ci >> 2)];
                    }
                    gap = 0;
                }
                unsigned c = t & 3;
                if (t & F_LOWER) {
                    if (mbeg < 0)
                        mbeg = ci;
                } else {
                    upper = 1;
                    if (mbeg >= 0) {
                        PUSH_MASK(mbeg, ci);
                        mbeg = -1;
                    }
                }
                int sh = (int)(ci & 3) << 1;
                cur = sh ? (uint8_t)(cur | (c << sh)) : (uint8_t)c;
                bps[boff + (ci >> 2)] = cur;
                ci++;
                spos++;
            }
        }
        p = e + 1;
    }
    END_SCAFFOLD();

    g->nbps = boff;
    count_bases(g);
    g->saw_upper = upper;
    return 0;
}
