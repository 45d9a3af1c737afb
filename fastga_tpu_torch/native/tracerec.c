/*  Native exact trace reconstruction: the converters' hot path.
 *
 *  C implementation of ops/tracerec.py (same algorithms, same outputs):
 *  banded O(nd) wave between trace points with the reference aligner's
 *  tie-breaking (align.c iter_np:5584-5903 semantics), the interval loop
 *  (Compute_Trace_PTS), and affine-style gap consolidation (Gap_Improver).
 *
 *  Exposed through ctypes (see native/__init__.py); ops/tracerec.py falls
 *  back to the pure-Python versions when this library is unavailable.
 *
 *  Sequences are int8 arrays of codes 0..3 with no sentinels; the wrapper
 *  passes full contig arrays and absolute coordinates.  Output trace is
 *  the signed-indel convention: -(a+1) = A position a deleted (gap in B),
 *  +(b+1) = B position b inserted (gap in A).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define GREEDIEST 0
#define UPPERMOST 1
#define LOWERMOST 2

#define LONG_SNAKE 50
#define ORIGIN 3

typedef struct
  { int64_t *pvf;       /* (dmax+3) x W           */
    int8_t  *phf;
    int      rows, W;
    int32_t *out;       /* trace output buffer    */
    int      ocap, olen;
    int8_t  *mv;        /* backward move stack    */
    int      mvcap;
    int     *gf, *gg, *gh;  /* gap_improver arrays */
    int      gcap, ghcap;
  } Work;

static int ensure_wave(Work *w, int rows, int W)
{ if (rows > w->rows || W > w->W)
    { free(w->pvf); free(w->phf);
      w->pvf = NULL; w->phf = NULL;
      if (rows < w->rows) rows = w->rows;
      if (W < w->W) W = w->W;
      w->rows = 0; w->W = 0;   /* committed only when both allocs land */
      w->pvf = (int64_t *) malloc(sizeof(int64_t)*rows*W);
      w->phf = (int8_t *) malloc((size_t)rows*W);
      if (w->pvf == NULL || w->phf == NULL)
        { free(w->pvf); free(w->phf);
          w->pvf = NULL; w->phf = NULL;
          return (-1);
        }
      w->rows = rows; w->W = W;
    }
  return (0);
}

static int ensure_out(Work *w, int need)
{ if (w->olen + need > w->ocap)
    { int cap = w->ocap*2 + need + 4096;
      int32_t *n = (int32_t *) realloc(w->out, sizeof(int32_t)*cap);
      if (n == NULL) return (-1);
      w->out = n; w->ocap = cap;
    }
  return (0);
}

static int ensure_mv(Work *w, int need)
{ if (need > w->mvcap)
    { int cap = need*2 + 256;
      int8_t *n = (int8_t *) realloc(w->mv, cap);
      if (n == NULL) return (-1);
      w->mv = n; w->mvcap = cap;
    }
  return (0);
}

Work *trw_new(void)
{ return (Work *) calloc(1, sizeof(Work)); }

void trw_free(Work *w)
{ if (w == NULL) return;
  free(w->pvf); free(w->phf); free(w->out); free(w->mv);
  free(w->gf); free(w->gg); free(w->gh);
  free(w);
}

static inline int8_t getA(const int8_t *A, int64_t alen, int64_t i)
{ return (i < 0 || i >= alen) ? 4 : A[i]; }

/* one interval: align A[aoff..aoff+M) vs B[boff..boff+N).
   Returns diffs, appends signed trace ints to w->out; -1 on error. */
/* Banded O(nd) furthest-reach waves with three equal-cost tie policies.
 *
 * Semantics follow the reference's interval reconstruction exactly
 * (align.c iter_np, cited for parity review) — the wave recurrence,
 * the tie order (a gap move from the "high" neighbour beats both the
 * diagonal and the "low" neighbour on equal reach, and the diagonal
 * beats the low neighbour), and the UPPERMOST/LOWERMOST gap-sliding
 * rules must all match for bit-identical traces.  The realization here
 * is original: moves carry an explicit {pred, sweep-half} encoding, the
 * traceback collects them on a stack instead of reversing the
 * predecessor chain in place, and emission replays the stack forward.
 */

enum { MV_DIAG = 0,      /* pred (d-1, k):   substitution        */
       MV_LO   = 1,      /* pred (d-2, k-1): gap move, low side  */
       MV_HI   = 2,      /* pred (d-2, k+1): gap move, high side */
       MV_HALF = 4 };    /* recorded by the upper-half sweep     */

/* pick the furthest reach among the three predecessors of one cell;
   ties prefer the k+1 gap move, then the diagonal */
static inline int64_t fr_pick(int64_t via_lo, int64_t via_diag,
                              int64_t via_hi, int half_tag, int8_t *mv)
{ if (via_diag < via_lo)
    { if (via_hi < via_lo)
        { *mv = (int8_t)(MV_LO | half_tag); return via_lo; }
      *mv = (int8_t)(MV_HI | half_tag);  return via_hi;
    }
  if (via_hi < via_diag)
    { *mv = MV_DIAG; return via_diag; }
  *mv = (int8_t)(MV_HI | half_tag);
  return via_hi;
}

static int iter_np(Work *w, const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t aoff, int64_t boff, int M, int N,
                   int dmax, int posl, int posh, int mode)
{ int mid = M - N;                       /* the finishing diagonal    */
  int low0 = mid < 0 ? mid : 0;
  int hgh0 = mid > 0 ? mid : 0;
  int half = dmax/2 + 2;
  int W = (hgh0 - low0) + 2*half + 3;
  int org = 1 - (low0 - half);
  int rows = dmax + 3;
  int low, hgh, D, k, nmv;
  int64_t *RV; int8_t *MV;

  if (ensure_wave(w, rows, W)) return (-1);
  RV = w->pvf; MV = w->phf;

  /* cell accessors: reach value and recorded move per (wave, diag) */
#define R(d,kk)  RV[(size_t)((d)+2)*w->W + (kk) + org]
#define MOV(d,kk) MV[(size_t)((d)+2)*w->W + (kk) + org]

  { int i;
    for (i = low0-half; i <= hgh0+half+1; i++)
      { R(-2,i) = -2; R(-1,i) = -2; }
  }
  R(-1,0) = -1;

  low = low0 + 1;
  hgh = hgh0 - 1;

  for (D = 0; 1; D++)
    { int64_t reach, prev;
      int8_t mv8;
      if (D > dmax) return (-1);
      if ((D & 1) == 0)
        { if (low > posl) low -= 1;
          if (hgh < posh) hgh += 1;
        }
      R(D,hgh+1) = R(D,low-1) = -2;

      /* one wave in three sweeps; `prev` carries the cell computed in
         the previous iteration of the running sweep so each cell costs
         one stored-row read */
#define SNAKE(kk)                                                   \
      { int64_t lim = (N < M-(kk)) ? N : M-(kk);                    \
        while (reach < lim &&                                       \
               getA(B,blen,boff+reach) ==                           \
               getA(A,alen,aoff+(kk)+reach))                        \
          reach += 1;                                               \
        MOV(D,kk) = mv8;                                            \
        R(D,kk) = reach;                                            \
      }

      prev = -2;
      for (k = hgh; k > mid; k--)              /* upper half, k desc */
        { reach = fr_pick(R(D-2,k-1), R(D-1,k) + 1, prev + 1,
                          MV_HALF, &mv8);
          SNAKE(k)
          prev = reach;
        }
      prev = -2;
      for (k = low; k < mid; k++)              /* lower half, k asc  */
        { reach = fr_pick(prev, R(D-1,k) + 1, R(D-2,k+1) + 1,
                          0, &mv8);
          SNAKE(k)
          prev = reach;
        }
      /* finishing diagonal: low neighbour from the lower sweep, high
         neighbour from this wave's upper sweep — a low-side gap here
         belongs to the lower sweep's tie family, a high-side gap to
         the upper's */
      reach = fr_pick(prev, R(D-1,mid) + 1, R(D,mid+1) + 1,
                      MV_HALF, &mv8);
      if (mv8 == (MV_LO | MV_HALF))
        mv8 = MV_LO;
      SNAKE(mid)

      if (R(D,mid) >= N)
        break;
    }
#undef SNAKE

  /* Backward walk from (D, mid): collect one move per step onto the
     stack, applying the gap-sliding tie fixups for the UPPER/LOWERMOST
     modes.  Predecessor coordinates depend on which sweep recorded the
     move: half-tagged gap moves toward the finishing diagonal live in
     the SAME wave (their neighbour was computed earlier in the same
     sweep), the others two waves back.  A fixup may reroute the step to
     an equal-cost predecessor (patching the stored reach so later steps
     see the slid gap); the rerouted move is pushed in its place. */
  if (ensure_mv(w, D + W + 8)) return (-1);   /* same-wave runs <= W */
  nmv = 0;
  { int64_t c = N;
    int d = D, mv, pk, pd;
    k = mid;
    mv = MOV(d,k);

    while (d > 0 || k != 0)
      { int gap = mv & 3;
        if (gap == MV_DIAG)
          { pd = d - 1; pk = k; }
        else if (gap == MV_LO)
          { pd = (mv & MV_HALF) ? d - 2 : d; pk = k - 1; }
        else
          { pd = (mv & MV_HALF) ? d : d - 2; pk = k + 1; }

        if (mode == UPPERMOST && gap == MV_LO)
          { /* slide this gap column as high as its match run permits,
               rerouting to the equal-cost high-side or diagonal
               predecessor when the slide reaches their frontier */
            int64_t stop = (k < 0) ? -k : 0;
            int hi_same = (mv & MV_HALF) || k == mid;
            int hw = hi_same ? d : d - 2;
            if (R(pd,pk) <= c) c = R(pd,pk) - 1;
            while (c >= stop &&
                   getA(A,alen,aoff+k+c) == getA(B,blen,boff+c))
              c -= 1;
            if (c <= R(hw,k+1))
              { mv = hi_same ? (MV_HI | MV_HALF) : MV_HI;
                pd = hw; pk = k + 1; }
            else if (c == R(d-1,k))
              { mv = MV_DIAG; pd = d - 1; pk = k; }
            else
              R(pd,pk) = c + 1;
          }
        else if (mode == LOWERMOST && gap == MV_HI)
          { /* mirror image: slide the gap column as low as possible */
            int64_t stop = (k < 0) ? -k : 0;
            int lo_same = !(mv & MV_HALF) || k == mid;
            int lw = lo_same ? d : d - 2;
            if (R(pd,pk) < c) c = R(pd,pk);
            while (c >= stop &&
                   getA(A,alen,aoff+k+c) == getA(B,blen,boff+c))
              c -= 1;
            if (c < R(lw,k-1))
              { mv = lo_same ? MV_LO : (MV_LO | MV_HALF);
                pd = lw; pk = k - 1; }
            else if (c == R(d-1,k))
              { mv = MV_DIAG; pd = d - 1; pk = k; }
            else
              { R(pd,pk) = c; c -= 1; }
          }

        w->mv[nmv++] = (int8_t) mv;
        d = pd; k = pk;
        mv = MOV(d,k);
      }
  }

  /* forward replay of the stack: emit signed indel positions */
  { int64_t apos_base = -aoff - 1;
    int64_t bpos_base = boff + 1;
    int d = 0, i;
    k = 0;
    for (i = nmv - 1; i >= 0; i--)
      { int mv = w->mv[i];
        int gap = mv & 3;
        int64_t cc = R(d,k);
        if (gap == MV_DIAG)
          d += 1;
        else if (gap == MV_LO)       /* forward step k -> k+1: B gap */
          { if (ensure_out(w,1)) return (-1);
            w->out[w->olen++] = (int32_t)(bpos_base + cc);
            if (mv & MV_HALF) d += 2;
            k += 1;
          }
        else                         /* forward step k -> k-1: A gap */
          { if (ensure_out(w,1)) return (-1);
            w->out[w->olen++] = (int32_t)(apos_base - (cc + k));
            if (!(mv & MV_HALF)) d += 2;
            k -= 1;
          }
      }
  }
#undef R
#undef MOV
  return D + (mid < 0 ? -mid : mid);
}

/*  Full reconstruction.  tpts = (diff,badv) pairs, ntp pairs.
 *  Returns diffs (>=0) or -1; trace placed in w->out (w->olen ints). */
int trw_compute_trace_pts(Work *w,
                          const int8_t *A, int64_t alen,
                          const int8_t *B, int64_t blen,
                          int64_t abpos, int64_t aepos,
                          int64_t bbpos, int64_t bepos,
                          const int32_t *tpts, int ntp,
                          int tspace, int mode, int selfie)
{ int dmax = 0, i, d;
  int64_t ab, ae, bb, be, db;
  int64_t dlow = -0x3FFFFFFFll, dhgh = 0x3FFFFFFFll;
  int diffs = 0;

  w->olen = 0;
  for (i = 0; i < ntp; i++)
    if (tpts[2*i] > dmax) dmax = tpts[2*i];
  if (dmax & 1) dmax += 1;

  db = abpos - bbpos;
  if (selfie)
    { int64_t de = aepos - bepos;
      if (db == 0 || de == 0 || (db > 0) != (de > 0)) return (-1);
      if (db < 0) dhgh = -1; else dlow = 1;
    }

  ab = abpos;
  ae = (ab/tspace)*tspace;
  bb = bbpos;
  for (i = 0; i < ntp-1; i++)
    { ae = ae + tspace;
      be = bb + tpts[2*i+1];
      if (ae > alen || be > blen) return (-1);
      db = ab - bb;
      d = iter_np(w, A, alen, B, blen, ab, bb, (int)(ae-ab), (int)(be-bb),
                  dmax, (int)(dlow-db) < -0x3FFFFFFF ? -0x3FFFFFFF
                                                     : (int)(dlow-db),
                  (int)(dhgh-db) > 0x3FFFFFFF ? 0x3FFFFFFF
                                              : (int)(dhgh-db), mode);
      if (d < 0) return (-1);
      diffs += d;
      ab = ae; bb = be;
    }
  ae = aepos; be = bepos;
  if (ae > alen || be > blen) return (-1);
  db = ab - bb;
  d = iter_np(w, A, alen, B, blen, ab, bb, (int)(ae-ab), (int)(be-bb),
              dmax, (int)(dlow-db) < -0x3FFFFFFF ? -0x3FFFFFFF
                                                 : (int)(dlow-db),
              (int)(dhgh-db) > 0x3FFFFFFF ? 0x3FFFFFFF : (int)(dhgh-db),
              mode);
  if (d < 0) return (-1);
  diffs += d;
  return diffs;
}

int32_t *trw_trace(Work *w) { return w->out; }
int      trw_trace_len(Work *w) { return w->olen; }

/* ---- gap improver ------------------------------------------------------ */

static inline int8_t g1A(const int8_t *A, int64_t alen, int64_t ix)
{ /* mirrors the Python padded-array convention Ap[ix]: two leading
     sentinels, so Ap[ix] = element ix-1 (1-based) = A[ix-2] */
  return (ix < 2 || ix > alen + 1) ? 4 : A[ix-2]; }

static int g_hamming(const int8_t *A, int64_t alen, int64_t ai,
                     const int8_t *B, int64_t blen, int64_t bi, int64_t n)
{ int h = 0; int64_t i;
  for (i = 0; i < n; i++)
    { int8_t x = g1A(A,alen,ai+1+i);
      if (x == 4) break;
      { int8_t y = g1A(B,blen,bi+1+i);
        if (x != y)
          { if (y == 4) break;
            h += 1;
          }
      }
    }
  return h;
}

static int64_t g_snake(const int8_t *A, int64_t alen, int64_t ai,
                       const int8_t *B, int64_t blen, int64_t bi)
{ int64_t i = 0;
  while (1)
    { int8_t x = g1A(A,alen,ai+1+i);
      if (x == 4 || x != g1A(B,blen,bi+1+i)) break;
      i += 1;
    }
  return i;
}

static int64_t g_rsnake(const int8_t *A, int64_t alen, int64_t ai,
                        const int8_t *B, int64_t blen, int64_t bi)
{ int64_t i = 0;
  while (1)
    { int8_t x = g1A(A,alen,ai-i);
      if (x == 4 || x != g1A(B,blen,bi-i)) break;
      i += 1;
    }
  return i;
}

static int ensure_gaps(Work *w, int diag, int hgt)
{ if (diag > w->gcap)
    { int cap = diag*2 + 256;
      free(w->gf); free(w->gg);
      w->gf = w->gg = NULL;
      w->gcap = 0;   /* committed only when both allocs land */
      w->gf = (int *) malloc(sizeof(int)*cap);
      w->gg = (int *) malloc(sizeof(int)*cap);
      if (w->gf == NULL || w->gg == NULL)
        { free(w->gf); free(w->gg);
          w->gf = w->gg = NULL;
          return (-1);
        }
      w->gcap = cap;
    }
  if (diag*hgt > w->ghcap)
    { int cap = diag*hgt*2 + 1024;
      free(w->gh);
      w->gh = NULL;
      w->ghcap = 0;
      w->gh = (int *) malloc(sizeof(int)*cap);
      if (w->gh == NULL) return (-1);
      w->ghcap = cap;
    }
  return (0);
}

/* in-place trace rewrite; returns diff adjustment or INT32_MIN on error */
int trw_gap_improver(Work *w,
                     const int8_t *A, int64_t alen,
                     const int8_t *B, int64_t blen,
                     int64_t abpos, int64_t bbpos, int64_t aepos,
                     int32_t *t, int T)
{ int cdiff = 0;
  int64_t d = abpos - bbpos;
  int x = 0;
  int32_t q;

  if (T == 0) return 0;
  q = t[0];
  while (x < T)
    { int32_t p = q;
      int m = x;
      int64_t Fdag = d;
      int64_t Fpos = p, Lpos;
      int Hamm = 0, Gaps = 1, Diag;
      while (1)
        { x += 1;
          q = 0;
          if (x >= T || (q = t[x]) != p)
            { m = x - m;
              if (p < 0)
                { d -= m;
                  if (q >= 0) break;
                  if (p - q >= LONG_SNAKE) break;
                  Hamm += g_hamming(A,alen,-p, B,blen,-(d+p), p-q);
                }
              else
                { d += m;
                  if (q <= 0) break;
                  if (q - p >= LONG_SNAKE) break;
                  Hamm += g_hamming(A,alen,p+d, B,blen,p, q-p);
                }
              Gaps += 1;
              p = q;
              m = x;
            }
        }
      if (Gaps == 1) continue;
      Lpos = p;
      Diag = (int)((Fdag > d ? Fdag - d : d - Fdag) + 1);

      if (ensure_gaps(w, Diag, Gaps + Hamm + 2)) return INT32_MIN;

      if (Fpos < 0)
        { int64_t pb;
          int passes, hn;
          Fpos = -Fpos; Lpos = -Lpos;
          if (x < Diag) pb = 0;
          else { int32_t mm = t[x-Diag];
                 pb = (mm < 0) ? -mm : mm + Fdag; }
          while (g1A(A,alen,Fpos) != g1A(B,blen,Fpos-Fdag)
                 && g1A(A,alen,Fpos) != 4
                 && g1A(B,blen,Fpos-Fdag) != 4)
            { if (Fpos <= pb) break;
              Fpos -= 1;
            }
          if (x >= T) pb = alen;
          else { int32_t mm = t[x];
                 pb = (mm < 0) ? -mm : mm + d; }
          while (g1A(A,alen,Lpos+1) != g1A(B,blen,Lpos-d+1)
                 && g1A(A,alen,Lpos+1) != 4
                 && g1A(B,blen,Lpos-d+1) != 4)
            { if (Lpos >= pb) break;
              Lpos += 1;
            }

          { int64_t m2;
            int fi;
            int *F = w->gf, *G = w->gg, *H = w->gh;
            int64_t pcur = Fpos + g_snake(A,alen,Fpos,B,blen,Fpos-Fdag);
            F[0] = (int)pcur;
            for (fi = 1; fi < Diag; fi++) F[fi] = (int)(Fpos - 2);
            memset(G, 0, sizeof(int)*Diag);
            passes = 0;
            hn = 0;
            pcur = Fpos;
            while (pcur < Lpos)
              { int b = (int)Fpos, c2 = 0;
                int u = 0x7FFFFFFF;
                fi = 0;
                for (m2 = Fdag; m2 >= d; m2--)
                  { int n = F[fi];
                    if (n >= b)
                      { pcur = n + 1;
                        H[hn++] = 0;
                        if (n > b)
                          { c2 = 0; u = G[fi] + 1; b = n; }
                        else
                          { if (G[fi] + 1 < u) { c2 = 0; u = G[fi] + 1; }
                            else c2 += 1;
                          }
                      }
                    else
                      { n += 1;
                        pcur = b;
                        c2 += 1;
                        if (n == b)
                          { if (G[fi] < u) H[hn++] = 0;
                            else { H[hn++] = c2; G[fi] = u; }
                          }
                        else { H[hn++] = c2; G[fi] = u; }
                      }
                    pcur += g_snake(A,alen,pcur,B,blen,pcur-m2);
                    F[fi] = (int)pcur;
                    fi += 1;
                  }
                passes += 1;
              }
            if (passes < Gaps + Hamm)
              { int y = x, nham = 0;
                int hrow = hn;
                pcur = Lpos;
                m2 = d;
                while (hrow > 0)
                  { int kk;
                    pcur -= g_rsnake(A,alen,pcur,B,blen,pcur-m2);
                    if (pcur < Fpos) pcur = Fpos;
                    hrow -= Diag;
                    kk = H[hrow + (int)(Fdag - m2)];
                    if (kk == 0) { pcur -= 1; nham += 1; }
                    else
                      { m2 += kk;
                        for (; kk > 0; kk--) t[--y] = (int32_t)(-pcur);
                      }
                  }
                cdiff += nham - Hamm;
              }
          }
        }
      else
        { int64_t pb;
          int passes, hn;
          if (x < Diag) pb = 0;
          else { int32_t mm = t[x-Diag];
                 pb = (mm < 0) ? -(mm + Fdag) : mm; }
          while (g1A(B,blen,Fpos) != g1A(A,alen,Fpos+Fdag)
                 && g1A(B,blen,Fpos) != 4
                 && g1A(A,alen,Fpos+Fdag) != 4)
            { if (Fpos <= pb) break;
              Fpos -= 1;
            }
          if (x >= T) pb = blen;
          else { int32_t mm = t[x];
                 pb = (mm < 0) ? -(mm + d) : mm; }
          while (g1A(B,blen,Lpos+1) != g1A(A,alen,Lpos+d+1)
                 && g1A(B,blen,Lpos+1) != 4
                 && g1A(A,alen,Lpos+d+1) != 4)
            { if (Lpos >= pb) break;
              Lpos += 1;
            }

          { int64_t m2;
            int fi;
            int *F = w->gf, *G = w->gg, *H = w->gh;
            int64_t pcur = Fpos + g_snake(A,alen,Fpos+Fdag,B,blen,Fpos);
            F[0] = (int)pcur;
            for (fi = 1; fi < Diag; fi++) F[fi] = (int)(Fpos - 2);
            memset(G, 0, sizeof(int)*Diag);
            passes = 0;
            hn = 0;
            pcur = Fpos;
            while (pcur < Lpos)
              { int b = (int)Fpos, c2 = 0;
                int u = 0x7FFFFFFF;
                fi = 0;
                for (m2 = Fdag; m2 <= d; m2++)
                  { int n = F[fi];
                    if (n >= b)
                      { pcur = n + 1;
                        H[hn++] = 0;
                        if (n > b)
                          { c2 = 0; u = G[fi] + 1; b = n; }
                        else
                          { if (G[fi] + 1 < u) { c2 = 0; u = G[fi] + 1; }
                            else c2 += 1;
                          }
                      }
                    else
                      { n += 1;
                        pcur = b;
                        c2 += 1;
                        if (n == b)
                          { if (G[fi] < u) H[hn++] = 0;
                            else { H[hn++] = c2; G[fi] = u; }
                          }
                        else { H[hn++] = c2; G[fi] = u; }
                      }
                    pcur += g_snake(A,alen,m2+pcur,B,blen,pcur);
                    F[fi] = (int)pcur;
                    fi += 1;
                  }
                passes += 1;
              }
            if (passes < Gaps + Hamm)
              { int y = x, nham = 0;
                int hrow = hn;
                pcur = Lpos;
                m2 = d;
                while (hrow > 0)
                  { int kk;
                    pcur -= g_rsnake(A,alen,pcur+m2,B,blen,pcur);
                    if (pcur < Fpos) pcur = Fpos;
                    hrow -= Diag;
                    kk = H[hrow + (int)(m2 - Fdag)];
                    if (kk == 0) { pcur -= 1; nham += 1; }
                    else
                      { m2 -= kk;
                        for (; kk > 0; kk--) t[--y] = (int32_t)pcur;
                      }
                  }
                cdiff += nham - Hamm;
              }
          }
        }
    }
  return cdiff;
}

/* Device-wave replay support: re-extend snakes along a backtracked
   per-wave diagonal path (ops/wave_replay.py hot loop).  Writes the
   per-wave furthest-reach A positions into xs (length ntw+1) and
   returns 0, or -1 when the final reach falls short of the trim point
   (caller falls back to the exact host engine). */

static int64_t fwd_snake_len(const int8_t *A, int64_t alen,
                             const int8_t *B, int64_t blen,
                             int64_t x, int64_t k)
{ int64_t y = x - k;
  int64_t n = 0;
  while (x + n < alen && y + n < blen && x + n >= 0 && y + n >= 0
         && A[x + n] == B[y + n])
    n += 1;
  return n;
}

static int64_t rev_snake_len(const int8_t *A, int64_t alen,
                             const int8_t *B, int64_t blen,
                             int64_t x, int64_t k)
{ int64_t y = x - k;
  int64_t n = 0;
  while (x - 1 - n >= 0 && y - 1 - n >= 0 && x - 1 - n < alen
         && y - 1 - n < blen && A[x - 1 - n] == B[y - 1 - n])
    n += 1;
  return n;
}

int trw_path_reach(const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t anti, const int32_t *diags, int ntw,
                   int64_t trimx, int dir, int64_t *xs)
{ int64_t x;
  int w;

  if (dir > 0)
    { x = (anti + diags[0]) >> 1;
      x += fwd_snake_len(A, alen, B, blen, x, diags[0]);
      xs[0] = x;
      for (w = 1; w <= ntw; w++)
        { int64_t dcur = diags[w], dprev = diags[w-1];
          int64_t c_pre = 2*xs[w-1] - dprev + (dcur == dprev ? 2 : 1);
          x = (c_pre + dcur) >> 1;
          x += fwd_snake_len(A, alen, B, blen, x, dcur);
          xs[w] = x;
        }
      return (xs[ntw] >= trimx) ? 0 : -1;
    }
  else
    { x = (anti + diags[0]) >> 1;
      x -= rev_snake_len(A, alen, B, blen, x, diags[0]);
      xs[0] = x;
      for (w = 1; w <= ntw; w++)
        { int64_t dcur = diags[w], dprev = diags[w-1];
          int64_t c_pre = 2*xs[w-1] - dprev - (dcur == dprev ? 2 : 1);
          x = (c_pre + dcur) >> 1;
          x -= rev_snake_len(A, alen, B, blen, x, dcur);
          xs[w] = x;
        }
      return (xs[ntw] <= trimx) ? 0 : -1;
    }
}

/* ---- full wave replay (ops/wave_replay.py in C) -----------------------
   Rebuilds the trace-point pairs from a tube's per-wave path diagonals
   in one pass (reach re-extension fused with grid-crossing emission and
   trace assembly; align.c:805-870 forward / 1325-1414 reverse
   semantics).  Returns 0 ok, -1 reach short of trim point (caller falls
   back to the exact engine), -2 output capacity exceeded. */

static int replay_fwd_core(const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t anti, const int32_t *diags, int64_t dst,
                   int ntw,
                   int64_t trima, int64_t trimx, int64_t trimd,
                   int64_t aoff, int64_t tspace,
                   int32_t *tr, int cap, int32_t *ntr)
{ int64_t d0 = diags[0];
  int64_t x0 = (anti + d0) >> 1;
  int64_t na0 = ((x0 + (tspace - aoff)) / tspace) * tspace - tspace + aoff;
  int64_t x, last, b, e, k, trimy;
  int     w, n = 0;

  x = x0 + fwd_snake_len(A, alen, B, blen, x0, d0);
  last = na0;
  k = d0;
  b = (anti - d0) >> 1;
  e = 0;
  for (w = 0; w <= ntw; w++)
    { int64_t kc;
      if (w > 0)
        { int64_t dcur = diags[w*dst], dprev = diags[(w-1)*dst];
          int64_t c_pre = 2*x - dprev + (dcur == dprev ? 2 : 1);
          x = (c_pre + dcur) >> 1;
          x += fwd_snake_len(A, alen, B, blen, x, dcur);
        }
      kc = diags[w*dst];
      while (last + tspace <= x)
        { int64_t m = last + tspace;
          int64_t a = m - kc;
          if (n >= cap)
            return -2;
          tr[2*n]   = (int32_t)(w - e);
          tr[2*n+1] = (int32_t)(a - b);
          n += 1;
          b = a;  e = w;  k = kc;
          last = m;
        }
    }
  if (x < trimx)
    return -1;
  trimy = trima - trimx;
  if (b + k != trimx)
    { if (n >= cap)
        return -2;
      tr[2*n]   = (int32_t)(trimd - e);
      tr[2*n+1] = (int32_t)(trimy - b);
      n += 1;
    }
  else if (b != trimy && n > 0)
    { tr[2*(n-1)]   += (int32_t)(trimd - e);
      tr[2*(n-1)+1] += (int32_t)(trimy - b);
    }
  *ntr = n;
  return 0;
}

int trw_replay_fwd(const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t anti, const int32_t *diags, int ntw,
                   int64_t trima, int64_t trimx, int64_t trimd,
                   int64_t aoff, int64_t tspace,
                   int32_t *tr, int cap, int32_t *ntr)
{ return replay_fwd_core(A, alen, B, blen, anti, diags, 1, ntw,
                         trima, trimx, trimd, aoff, tspace,
                         tr, cap, ntr);
}

/* Reverse replay.  ``pre`` receives the prepend pairs in build order
   (the caller reverses); when the first emission must merge into the
   caller's existing trace[0] (align.c:1340-1414 seam merge), the delta
   is returned in first_dd/first_db with *first_mod = 1.
   has_existing = (path.tlen != 0) on entry. */

static int replay_rev_core(const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t anti, const int32_t *diags, int64_t dst,
                   int ntw,
                   int64_t trima, int64_t trimx, int64_t trimd,
                   int64_t aoff, int64_t tspace, int has_existing,
                   int32_t *pre, int cap, int32_t *npre,
                   int32_t *first_dd, int32_t *first_db,
                   int *first_mod)
{ int64_t d0 = diags[0];
  int64_t x0 = (anti + d0) >> 1;
  int64_t na0 = ((x0 + (tspace - aoff) - 1) / tspace - 1) * tspace + aoff;
  int64_t x, last, b, e, trimy;
  int     w, n = 0;
  int     started = 0;   /* pebble 0 consumed as the (b,e) origin */
  int64_t kprev = d0;

  *first_mod = 0;
  *first_dd = *first_db = 0;
  trimy = trima - trimx;

  /* pebble 0 = (d0, x0, wave 0) pre-snake */
  b = x0 - d0;
  e = 0;
  x = x0 - rev_snake_len(A, alen, B, blen, x0, d0);
  last = na0 + tspace;

  /* Python: if x0 not on the grid, the first crossing (or the trim
     point when none) merges with/creates the seam pair */
  { int64_t xm = x0;        /* b + k = pebble 0's mark x0 */
    int64_t r = xm % tspace;  if (r < 0) r += tspace;
    if (r != aoff)
      started = -1;   /* defer: first crossing handles the seam */
    else
      started = 1;    /* pebble 0 is a regular origin */
  }

  for (w = 0; w <= ntw; w++)
    { int64_t kc;
      if (w > 0)
        { int64_t dcur = diags[w*dst], dprev = diags[(w-1)*dst];
          int64_t c_pre = 2*x - dprev - (dcur == dprev ? 2 : 1);
          x = (c_pre + dcur) >> 1;
          x -= rev_snake_len(A, alen, B, blen, x, dcur);
        }
      kc = diags[w*dst];
      while (last - tspace >= x)
        { int64_t m = last - tspace;
          int64_t a = m - kc;
          if (started == -1)
            { /* seam emission: (w - e, b - a) merges or prepends */
              if (has_existing)
                { *first_dd = (int32_t)(w - e);
                  *first_db = (int32_t)(b - a);
                  *first_mod = 1;
                }
              else
                { if (n >= cap) return -2;
                  pre[2*n]   = (int32_t)(w - e);
                  pre[2*n+1] = (int32_t)(b - a);
                  n += 1;
                }
              started = 1;
            }
          else
            { if (n >= cap) return -2;
              pre[2*n]   = (int32_t)(w - e);
              pre[2*n+1] = (int32_t)(b - a);
              n += 1;
            }
          b = a;  e = w;  kprev = kc;
          last = m;
        }
    }
  if (x > trimx)
    return -1;

  if (started == -1)
    { /* no crossings at all: seam goes straight to the trim point */
      if (has_existing)
        { *first_dd = (int32_t)(trimd - e);
          *first_db = (int32_t)(b - trimy);
          *first_mod = 1;
        }
      else
        { if (cap < 1) return -2;
          pre[0] = (int32_t)(trimd - e);
          pre[1] = (int32_t)(b - trimy);
          n = 1;
        }
      *npre = n;
      return 0;
    }

  if (b + kprev != trimx)
    { if (n >= cap) return -2;
      pre[2*n]   = (int32_t)(trimd - e);
      pre[2*n+1] = (int32_t)(b - trimy);
      n += 1;
    }
  else if (b != trimy)
    { if (n > 0)
        { pre[2*(n-1)]   += (int32_t)(trimd - e);
          pre[2*(n-1)+1] += (int32_t)(b - trimy);
        }
      else
        { *first_dd = (int32_t)(trimd - e);
          *first_db = (int32_t)(b - trimy);
          *first_mod = 1;
        }
    }
  *npre = n;
  return 0;
}

int trw_replay_rev(const int8_t *A, int64_t alen,
                   const int8_t *B, int64_t blen,
                   int64_t anti, const int32_t *diags, int ntw,
                   int64_t trima, int64_t trimx, int64_t trimd,
                   int64_t aoff, int64_t tspace, int has_existing,
                   int32_t *pre, int cap, int32_t *npre,
                   int32_t *first_dd, int32_t *first_db,
                   int *first_mod)
{ return replay_rev_core(A, alen, B, blen, anti, diags, 1, ntw,
                         trima, trimx, trimd, aoff, tspace,
                         has_existing, pre, cap, npre,
                         first_dd, first_db, first_mod);
}

/* ---- batched fwd+rev replay with seam merge ---------------------------
   One call per device batch (ops/wave_batch.on_pair): per-item wrapper
   overhead (~22 us of ctypes/numpy glue per replay) dominated the host
   replay phase on the single-core box.

   The diagonal logs are the [G+1, ld] row-major arrays the engine
   fetches (column i = item i; ld = batch width).  For each item with
   skip[i] == 0, runs the forward replay, then the reverse replay with
   has_existing = (fwd pairs > 0), applies the seam merge, and emits the
   FINAL trace (reverse prepend reversed + merged forward pairs) at
   tr[2*troff[i] .. 2*troff[i+1]).  stats[6*i..]: abpos, bbpos, aepos,
   bepos, diffs, seam(d0 fwd).  rcs[i]: 0 ok, -1 fwd reach short, -2 rev
   reach short, -3 capacity (caller falls back per item). */

int trw_replay_pair_batch(
    const int8_t **As, const int64_t *alens,
    const int8_t **Bs, const int64_t *blens,
    const int64_t *antis, const int64_t *aoffs, int64_t tspace,
    const int32_t *df, int64_t ldf, const int32_t *ntwf,
    const int64_t *trimaf, const int64_t *trimxf, const int64_t *trimdf,
    const int32_t *dr, int64_t ldr, const int32_t *ntwr,
    const int64_t *trimar, const int64_t *trimxr, const int64_t *trimdr,
    const uint8_t *skip, int nitems,
    int32_t *tr, int64_t cap, int64_t *troff, int64_t *stats,
    int32_t *rcs)
{ int64_t off = 0;
  int     i;
  int64_t scap = 0;
  int32_t *ftr, *pre;

  for (i = 0; i < nitems; i++)
    { int64_t c = alens[i] / tspace + ntwf[i] + ntwr[i] + 32;
      if (c > scap)
        scap = c;
    }
  ftr = (int32_t *) malloc(2 * (size_t) scap * sizeof(int32_t));
  pre = (int32_t *) malloc(2 * (size_t) scap * sizeof(int32_t));
  if (ftr == NULL || pre == NULL)
    { free(ftr); free(pre);
      for (i = 0; i < nitems; i++)
        { rcs[i] = -3; troff[i] = off; }
      troff[nitems] = off;
      return -3;
    }

  for (i = 0; i < nitems; i++)
    { int32_t nf = 0, np = 0;
      int32_t fdd = 0, fdb = 0;
      int     fmod = 0, rc;
      int64_t j, need;

      troff[i] = off;
      rcs[i] = 0;
      if (skip[i])
        continue;
      rc = replay_fwd_core(As[i], alens[i], Bs[i], blens[i],
                           antis[i], df + i, ldf, ntwf[i],
                           trimaf[i], trimxf[i], trimdf[i],
                           aoffs[i], tspace, ftr, (int) scap, &nf);
      if (rc != 0)
        { rcs[i] = (rc == -1) ? -1 : -3;
          continue;
        }
      rc = replay_rev_core(As[i], alens[i], Bs[i], blens[i],
                           antis[i], dr + i, ldr, ntwr[i],
                           trimar[i], trimxr[i], trimdr[i],
                           aoffs[i], tspace, nf > 0,
                           pre, (int) scap, &np, &fdd, &fdb, &fmod);
      if (rc != 0)
        { rcs[i] = (rc == -1) ? -2 : -3;
          continue;
        }
      if (fmod && nf > 0)
        { ftr[0] += fdd;
          ftr[1] += fdb;
        }
      need = (int64_t) nf + np;
      if (off + need > cap)
        { rcs[i] = -3;
          continue;
        }
      for (j = 0; j < np; j++)
        { tr[2*(off + j)]     = pre[2*(np - 1 - j)];
          tr[2*(off + j) + 1] = pre[2*(np - 1 - j) + 1];
        }
      memcpy(tr + 2*(off + np), ftr, 2 * (size_t) nf * sizeof(int32_t));
      off += need;
      stats[6*i]     = trimxr[i];                  /* abpos */
      stats[6*i + 1] = trimar[i] - trimxr[i];      /* bbpos */
      stats[6*i + 2] = trimxf[i];                  /* aepos */
      stats[6*i + 3] = trimaf[i] - trimxf[i];      /* bepos */
      stats[6*i + 4] = trimdf[i] + trimdr[i];      /* diffs */
      stats[6*i + 5] = df[i];                      /* fwd d0 (seam) */
    }
  troff[nitems] = off;
  free(ftr);
  free(pre);
  return 0;
}

/* ---- per-group redundancy elimination (models/aligner.py dedup_group;
   FastGA.c:3435-3694 semantics) -----------------------------------------

   Records arrive sorted by abpos (ascending, stable).  Coordinates are
   updated in place for fused records; every record's final trace is
   written to newtr/newoff (survivors read theirs back).  flags[i] != 0
   marks an eliminated record. */

typedef struct
  { const int32_t *ptr;   /* (d,b) pairs */
    int64_t        len;   /* pair count  */
  } DTrace;

static int64_t dd_entwine(int64_t *ab, int64_t *ae, int64_t *bb,
                          int64_t *be, DTrace *tr, int jo, int ko,
                          int64_t tspace, int64_t *where_out)
{ /* trace-distance between two overlapping paths (FastGA.c:2818-2947);
     mirrors models/aligner.py entwine exactly */
  int64_t where = -1;
  int64_t y2 = bb[jo];
  int64_t b2 = bb[ko];
  const int32_t *jt = tr[jo].ptr;
  int64_t jtn = 2 * tr[jo].len;
  const int32_t *kt = tr[ko].ptr;
  int64_t ktn = 2 * tr[ko].len;
  int64_t j = ab[jo] / tspace;
  int64_t k = ab[ko] / tspace;
  int64_t ac = k * tspace;
  int64_t i, yp, num, mn, aend, jtj, ktk;

  j = 1 + 2 * (k - j);
  k = 1;
  for (i = 1; i < j; i += 2)
    y2 += jt[i];

  if (j == 1)
    yp = y2 + (jt[j] * (ab[ko] - ab[jo])) / (ac + tspace - ab[jo]);
  else
    yp = y2 + (jt[j] * (ab[ko] - ac)) / tspace;

  num = b2 - yp;
  mn  = num;

  aend = (ae[jo] < ae[ko]) ? ae[jo] : ae[ko];

  ac += tspace;
  while (ac < aend)
    { y2 += jt[j];
      b2 += kt[k];
      j += 2;
      k += 2;
      i = b2 - y2;
      if (mn < 0 && mn < i)
        mn = (i >= 0) ? 0 : i;
      else if (mn > 0 && mn > i)
        mn = (i <= 0) ? 0 : i;
      if (i == 0)
        where = ac;
      ac += tspace;
    }

  ac -= tspace;
  jtj = (j < jtn) ? jt[j] : 0;
  ktk = (k < ktn) ? kt[k] : 0;
  if (aend == ae[jo])
    { y2 = be[jo];
      if (ae[ko] >= ac)
        b2 += (ktk * (aend - ac)) / tspace;
      else
        b2 += (ktk * (aend - ac)) / (ae[ko] - ac);
    }
  else
    { b2 = be[ko];
      if (ae[jo] >= ac)
        y2 += (jtj * (aend - ac)) / tspace;
      else
        y2 += (jtj * (aend - ac)) / (ae[jo] - ac);
    }

  i = b2 - y2;
  if (mn < 0 && mn < i)
    mn = (i >= 0) ? 0 : i;
  else if (mn > 0 && mn > i)
    mn = (i <= 0) ? 0 : i;
  *where_out = where;
  return mn;
}

#define DD_BOX_FUZZ 10

int trw_dedup_group(int g,
                    int64_t *ab, int64_t *ae, int64_t *bb, int64_t *be,
                    int64_t *diffs,
                    const int32_t *tr_flat, const int64_t *troff,
                    int64_t tspace,
                    uint8_t *flags,
                    int32_t *newtr, int64_t *newoff, int64_t newcap)
{ DTrace  *tr;
  int32_t *arena = NULL;
  int64_t  acap = 0, aused = 0;
  int      j, k;

  tr = (DTrace *) malloc(g * sizeof(DTrace));
  if (tr == NULL)
    return -1;
  for (j = 0; j < g; j++)
    { tr[j].ptr = tr_flat + 2 * troff[j];
      tr[j].len = troff[j + 1] - troff[j];
      flags[j] = 0;
    }

  /* pass 1: identical / shared-endpoint containment */
  for (j = g - 1; j >= 0; j--)
    for (k = j + 1; k < g; k++)
      { if (ae[j] <= ab[k])
          break;
        if (flags[k])
          continue;
        if (ab[j] == ab[k] && bb[j] == bb[k])
          { if (ae[j] == ae[k] && be[j] == be[k])
              { if (diffs[j] < ae[k])   /* (sic) diffs vs aepos */
                  { flags[k] = 1; continue; }
                else
                  { flags[j] = 1; break; }
              }
            else
              { if (ae[j] > ae[k])
                  { flags[k] = 1; continue; }
                else
                  { flags[j] = 1; break; }
              }
          }
        else if (ae[j] == ae[k] && be[j] == be[k])
          { if (ab[j] < ab[k])
              { flags[k] = 1; continue; }
            else
              { flags[j] = 1; break; }
          }
      }

  /* pass 2: entwine fuse + fuzzy box elimination */
  for (j = g - 1; j >= 0; j--)
    { if (flags[j])
        continue;
      for (k = j + 1; k < g; k++)
        { int64_t dist, where;
          if (ae[j] <= ab[k])
            break;
          if (flags[k])
            continue;
          if (be[j] <= bb[k] || bb[j] >= be[k])
            continue;
          dist = dd_entwine(ab, ae, bb, be, tr, j, k, tspace, &where);
          if (where != -1)
            { /* fuse at the shared trace point */
              int64_t ocut = (where - ab[j] - 1) / tspace + 1;
              int64_t wcut = (where - ab[k] - 1) / tspace + 1;
              int64_t nlen = ocut + (tr[k].len - wcut);
              int64_t d2 = 0, i2;
              int32_t *dst;
              if (aused + 2 * nlen > acap)
                { int64_t want = 2 * (aused + 2 * nlen) + 4096;
                  int32_t *na = (int32_t *) malloc(want * sizeof(int32_t));
                  if (na == NULL)
                    { free(arena); free(tr); return -1; }
                  /* existing DTrace arena pointers must stay valid:
                     copy and rebase */
                  if (arena != NULL)
                    { int jj;
                      memcpy(na, arena, aused * sizeof(int32_t));
                      for (jj = 0; jj < g; jj++)
                        if (tr[jj].ptr >= arena
                            && tr[jj].ptr < arena + aused)
                          tr[jj].ptr = na + (tr[jj].ptr - arena);
                      free(arena);
                    }
                  arena = na;
                  acap = want;
                }
              dst = arena + aused;
              memcpy(dst, tr[j].ptr, 2 * ocut * sizeof(int32_t));
              memcpy(dst + 2 * ocut, tr[k].ptr + 2 * wcut,
                     2 * (tr[k].len - wcut) * sizeof(int32_t));
              tr[j].ptr = dst;
              tr[j].len = nlen;
              aused += 2 * nlen;
              for (i2 = 0; i2 < nlen; i2++)
                d2 += dst[2 * i2];
              diffs[j] = d2;
              ae[j] = ae[k];
              be[j] = be[k];
              flags[k] = 1;
              continue;
            }
          if (dist != 0)
            { if ((ae[j] - ab[j]) + DD_BOX_FUZZ >= ae[k] - ab[k])
                { if (ae[k] <= ae[j] + DD_BOX_FUZZ
                      && bb[k] >= bb[j] - DD_BOX_FUZZ
                      && be[k] <= be[j] + DD_BOX_FUZZ)
                    { flags[k] = 1; continue; }
                }
              else
                { if (ae[j] <= ae[k] + DD_BOX_FUZZ
                      && bb[j] >= bb[k] - DD_BOX_FUZZ
                      && be[j] <= be[k] + DD_BOX_FUZZ
                      && ab[j] >= ab[k] - DD_BOX_FUZZ)
                    { /* j eliminated but its scan continues — an
                         eliminated op can still fuse/eliminate later
                         records (models/aligner.py uses `continue`) */
                      flags[j] = 1; continue;
                    }
                }
            }
        }
    }

  /* emit final traces */
  { int64_t off = 0;
    newoff[0] = 0;
    for (j = 0; j < g; j++)
      { if (!flags[j])
          { if (off + 2 * tr[j].len > newcap)
              { free(arena); free(tr); return -2; }
            memcpy(newtr + off, tr[j].ptr,
                   2 * tr[j].len * sizeof(int32_t));
            off += 2 * tr[j].len;
          }
        newoff[j + 1] = off;
      }
  }
  free(arena);
  free(tr);
  return 0;
}
