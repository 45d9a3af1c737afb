// wave_chunk: up to G O(nd) waves per tube, from a wave state.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_chunk_pallas (MEGA mode,
// mega_k > 0): one call runs up to G = k*chunk waves with early exit; the
// arithmetic is that of ops/wave.py build_forward_chunk (one_wave).
//
// Bound: the bytes it must move (state in/out, one choice byte per slot and
// one kbase word per live wave, the pool words the live lanes span) take
// about 0.01 ms at n=512/W=256/G=384; the kernel is bound by the latency of
// one wave, since a tube's waves form a dependent chain and a launch lasts
// (its longest-living tube's waves) x (one wave's latency).
//
// Design, against that latency:
// - one warp per tube, one tube per CTA (512 CTAs of 32 threads at n=512:
//   about 4 per SM, all resident; 2 and 4 tubes per CTA timed the same),
//   so no barrier is wider than a warp.  The lanes walk only the live band
//   [low2, hgh2] in strides of 32, not all W slots, so a band of tens of
//   diagonals costs one or two strides at any W (W = 512 and 2048 too);
// - V/Thi/Tlo/M and the per-slot x live in the tube's shared memory.
//   Pass 1 (choice, pick, snake, sentinels) keeps its results in registers
//   and writes a stride back only after the next stride has read its
//   neighbours, so every read sees the wave's input state.  Pass 2 (the
//   suffix-max / prefix-min improver scan, the trim test, the WAVE_LAG
//   prune) scans the band in the direction of the running max with
//   __shfl_*_sync and a carry; each of the seven reductions of a wave is
//   one redux instruction (__reduce_*_sync);
// - the snake compares 128 bases a step (SK words a side, the first
//   mismatch from the XOR's trailing or leading zero bit pairs), and the
//   60-bit match window takes its whole shift once a snake ends, in closed
//   form (equal to the reference's sub-shifts of at most 16);
// - per-tube sequence windows of A and B (WIN words each, the Hopper form
//   of the Pallas kernel's VMEM staging) in shared memory, filled with
//   cp.async and refilled ahead in the direction of travel when the band's
//   x- or y-range leaves them.  The snake's fetch reads a window when its
//   SK+1 words lie inside, else global memory (a snake past the window:
//   long exact repeats, lagging interior diagonals); word indices clamp to
//   [0, P-1] on both paths, since a window holds pool[clamp(i)] at i;
// - the choice row is built in shared memory and stored as 16-byte words,
//   CH_NONE outside the band.
//
// On an H100 (chip_smoke.py) a wave takes about 1.5 us at n=512/W=256,
// against about 7 us for a CTA per tube with a thread per slot, of which
// the snake's global loads were 0.4 us and the block-wide barriers and
// serial reductions the rest.
//
// Semantics carried over exactly (compare through canon_state): the int32
// wraparound of wave_common.cuh; the arithmetic trim test (wave_pallas.py
// trim_ok, bit-equal to the 2^15-entry tables); the descending-k running
// max of best/trim; the sentinel clip; the WAVE_LAG prune; the over-band and
// empty-band fallback flags.  Differences from the XLA twin, by design:
// - recentering is gated per tube (a warp cannot see the batch), so
//   slot-space state and the kbase log differ from the batch-gated twin;
//   diagonal-space results are the same;
// - a tube stops at its last live wave; log rows after it are unwritten,
//   and the dead-wave fixed point hgh = low - 1 is applied on exit.
#include "wave_common.cuh"

using namespace wave;

__device__ __forceinline__ void cp_async4(uint32_t* sdst,
                                          const uint32_t* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gsrc)
               : "memory");
}

// win[i] = pool[clamp(lo + i, 0, P-1)] for i < WIN; the caller waits
__device__ __forceinline__ void fill_window(uint32_t* win,
                                            const uint32_t* __restrict__ pool,
                                            int P, long long lo, int lane) {
  for (int i = lane; i < WIN; i += 32) {
    long long g = lo + i;
    g = g < 0 ? 0 : (g > P - 1 ? P - 1 : g);
    cp_async4(win + i, pool + g);
  }
}

// the word of choice bytes at byte offset b: the bytes in [lo, hi] from
// `w`, CH_NONE elsewhere
__device__ __forceinline__ uint32_t band_word(uint32_t w, int b, int lo,
                                              int hi) {
  const int l = clampi(lo - b, 0, 4), h = clampi(hi - b + 1, 0, 4);
  const uint32_t mk = h <= l ? 0u
                             : (uint32_t)(((1ull << (8 * h)) - 1ull)
                                          & ~((1ull << (8 * l)) - 1ull));
  return (w & mk) | (0x03030303u & ~mk);
}

// the tube's shared memory: V, Thi, Tlo, M, X [W] ints, the A and B
// windows [WIN] words, the choice row [W] bytes
__host__ __device__ constexpr size_t tube_smem(int W) {
  return (size_t)(5 * W + 2 * WIN) * 4 + (size_t)W;
}

template <bool FWD>
__global__ void __launch_bounds__(32)
wave_chunk_kernel(const uint32_t* __restrict__ pool, int P,
                  const int* __restrict__ targs,
                  const int* __restrict__ Vi, const uint32_t* __restrict__ Thii,
                  const uint32_t* __restrict__ Tloi, const int* __restrict__ Mi,
                  const int* __restrict__ sci, int* __restrict__ Vo,
                  uint32_t* __restrict__ Thio, uint32_t* __restrict__ Tloo,
                  int* __restrict__ Mo, int* __restrict__ sco,
                  uint8_t* __restrict__ chlog, int* __restrict__ kblog, int N,
                  int W, int G, int PA, int mscore, int dscore) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  int* sV = (int*)smem_raw;
  uint32_t* sThi = (uint32_t*)(sV + W);
  uint32_t* sTlo = sThi + W;
  int* sM = (int*)(sTlo + W);
  int* sX = sM + W;
  uint32_t* winA = (uint32_t*)(sX + W);
  uint32_t* winB = winA + WIN;
  uint8_t* row = (uint8_t*)(winB + WIN);

  const int BAR = FWD ? -1 : 0x7FFFFFFF;
  const size_t rowoff = (size_t)n * W;
  for (int s = lane; s < W; s += 32) {
    sV[s] = Vi[rowoff + s];
    sThi[s] = Thii[rowoff + s];
    sTlo[s] = Tloi[rowoff + s];
    sM[s] = Mi[rowoff + s];
  }
  const int aw = targs[n], alen = targs[N + n], bw = targs[2 * N + n];
  const int blen = targs[3 * N + n], minp = targs[4 * N + n];
  const int maxp = targs[5 * N + n];
  const int* sc = sci + (size_t)n * NSC;
  int kbase = sc[SC_KBASE], low = sc[SC_LOW], hgh = sc[SC_HGH];
  int besta = sc[SC_BESTA], bestx = sc[SC_BESTX], lasta = sc[SC_LASTA];
  int trima = sc[SC_TRIMA], trimx = sc[SC_TRIMX], trimd = sc[SC_TRIMD];
  int trimw = sc[SC_TRIMW], trims = sc[SC_TRIMS];
  bool alive = sc[SC_ALIVE] > 0, fall = sc[SC_FALL] > 0;
  int dif = sc[SC_DIF];
  // absolute pool word index of each window's first word (the windows
  // are filled by the first wave)
  int alo = 0, blo = 0;
  __syncwarp();

  int wi = 0;
  for (; wi < G && alive; ++wi) {
    // ---- band expansion ----
    const int low2 = (wadd(kbase, low) - 1 >= minp) ? low - 1 : low;
    const int hgh2 = (wadd(kbase, hgh) + 1 <= maxp) ? hgh + 1 : hgh;
    const int dif2 = dif + 1;
    const int slo = low2 > 0 ? low2 : 0, shi = hgh2 < W - 1 ? hgh2 : W - 1;
    const int nit = shi >= slo ? ((shi - slo) >> 5) + 1 : 0;
    auto vr = [&](int t) -> int {
      if (t < 0 || t >= W || t < low2 || t > hgh2) return BAR;
      if ((t == low2 && low2 != low) || (t == hgh2 && hgh2 != hgh))
        return BAR;
      return sV[t];
    };

    // ---- windows: keep the band's x- and y-range (plus a fetch) inside,
    // checked every 4th wave (placement only, in wrapping int32: a fetch
    // outside a window reads global memory) ----
    if ((wi & 3) == 0) {
      const int amin = wsub(besta, FWD ? WAVE_LAG + 4 : 4);
      const int amax = wadd(besta, FWD ? 4 : WAVE_LAG + 4);
      const int kmin = wadd(kbase, low2), kmax = wadd(kbase, hgh2);
      // bases a fetch touches: FWD [p, p + 16*SK + 16), reverse
      // [p - 16*SK, p + 16)
      const int lo_pad = FWD ? 0 : 16 * SK, hi_pad = FWD ? 16 * SK + 16 : 16;
      const int al = wadd(aw, wsub(wadd(amin, kmin) >> 1, lo_pad) >> 4);
      const int ah = wadd(aw, wadd(wadd(amax, kmax) >> 1, hi_pad) >> 4);
      const int bl = wadd(bw, wsub(wsub(amin, kmax) >> 1, lo_pad) >> 4);
      const int bh = wadd(bw, wadd(wsub(amax, kmin) >> 1, hi_pad) >> 4);
      bool fill = false;
      if (wi == 0 || al < alo || ah > wadd(alo, WIN - 1)) {
        alo = FWD ? wsub(al, 8) : wsub(ah, WIN - 9);
        fill_window(winA, pool, P, alo, lane);
        fill = true;
      }
      if (wi == 0 || bl < blo || bh > wadd(blo, WIN - 1)) {
        blo = FWD ? wsub(bl, 8) : wsub(bh, WIN - 9);
        fill_window(winB, pool, P, blo, lane);
        fill = true;
      }
      if (fill) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
      }
    }

    // ---- pass 1: choice, pick, snake, sentinels (write-back one stride
    // late, after the next stride has read its neighbours) ----
    int cbest = BAR, aclip = FWD ? BIG : -BIG, bclip = FWD ? -BIG : BIG;
    int pc = 0, pm = 0, ps = -1;
    uint32_t ph = 0, pl = 0;
    for (int it = 0; it < nit; ++it) {
      const int s = slo + (it << 5) + lane;
      const bool inb = s <= shi;
      int c = 0, x = 0, m = 0;
      uint32_t thi = 0, tlo = 0;
      if (inb) {
        const int am = vr(s - 1), ac = vr(s), ap = vr(s + 1);
        bool take_p, take_m;
        int c_pre;
        if (FWD) {
          take_p = (ac < am && am < ap) || (!(ac < am) && ac < ap);
          take_m = ac < am && !(am < ap);
          c_pre = take_p ? wadd(ap, 1) : (take_m ? wadd(am, 1) : wadd(ac, 2));
        } else {
          take_m = (ac > ap && ap > am) || (!(ac > ap) && ac > am);
          take_p = ac > ap && !(ap > am);
          c_pre = take_m ? wsub(am, 1) : (take_p ? wsub(ap, 1) : wsub(ac, 2));
        }
        row[s] = take_p ? CH_HIGH : (take_m ? CH_LOW : CH_DIAG);
        const int src = take_p ? (s + 1 < W ? s + 1 : W - 1)
                               : (take_m ? (s > 0 ? s - 1 : 0) : s);
        thi = sThi[src];
        tlo = sTlo[src];
        m = sM[src] - (int)((thi >> 28) & 1u);
        thi = (thi << 1) | (tlo >> 31);
        tlo = tlo << 1;
        const int k = wadd(kbase, s);
        x = wadd(c_pre, k) >> 1;
        int R = 0;
        for (;;) {
          const int run = snake_step<FWD, true>(pool, P, winA, alo, winB, blo,
                                                x, wsub(x, k), aw, alen, bw,
                                                blen);
          R += run;
          x = FWD ? wadd(x, run) : wsub(x, run);
          if (run != 16 * SK) break;
        }
        // the match window after R matches, in closed form: the R bits
        // shifted past bit 60 (sub-shifts of at most 16, each counting the
        // zeros that leave, align.c:698-701; the ones shifted in count
        // none), then the shift itself
        {
          const uint64_t w60 = ((uint64_t)thi << 32) | tlo;
          const int rc = R < 61 ? R : 61;
          const uint64_t out = (w60 >> (61 - rc)) & ((1ull << rc) - 1ull);
          m += rc - __popcll(out);
          const uint64_t nw = R >= 64 ? ~0ull
                                      : (w60 << R) | ((1ull << R) - 1ull);
          thi = (uint32_t)(nw >> 32);
          tlo = (uint32_t)nw;
        }
        bool as, bs;
        sentinels<FWD>(x, k, alen, blen, true, bs, as);
        c = wsub((int)((unsigned)x << 1), k);
        sX[s] = x;
        cbest = op2<FWD>(cbest, c);
        if (as) aclip = FWD ? min(aclip, s) : max(aclip, s);
        if (bs) bclip = FWD ? max(bclip, s) : min(bclip, s);
      }
      __syncwarp();
      if (ps >= 0) {
        sV[ps] = pc;
        sThi[ps] = ph;
        sTlo[ps] = pl;
        sM[ps] = pm;
      }
      ps = inb ? s : -1;
      pc = c;
      ph = thi;
      pl = tlo;
      pm = m;
    }
    if (ps >= 0) {
      sV[ps] = pc;
      sThi[ps] = ph;
      sTlo[ps] = pl;
      sM[ps] = pm;
    }
    if (lane == 0) kblog[(size_t)wi * N + n] = kbase;
    __syncwarp();
    cbest = wred<FWD>(cbest);
    aclip = wred<!FWD>(aclip);
    bclip = wred<FWD>(bclip);
    const bool hit = aclip != (FWD ? BIG : -BIG) || bclip != (FWD ? -BIG : BIG);

    // ---- the choice row: the band's bytes from shared memory, CH_NONE
    // outside [slo, shi] ----
    {
      uint8_t* crow = chlog + ((size_t)wi * N + n) * W;
      for (int q = lane; q < (W >> 4); q += 32) {
        const uint4 r = ((const uint4*)row)[q];
        ((uint4*)crow)[q] = make_uint4(band_word(r.x, 16 * q, slo, shi),
                                       band_word(r.y, 16 * q + 4, slo, shi),
                                       band_word(r.z, 16 * q + 8, slo, shi),
                                       band_word(r.w, 16 * q + 12, slo, shi));
      }
    }

    const bool better = FWD ? cbest > besta : cbest < besta;
    const int besta2 = better ? cbest : besta;
    // the clip's band (its `more` needs bestx2, from pass 2)
    int low3 = low2, hgh3 = hgh2;
    bool more;
    clip_band<FWD>(hit, aclip, bclip, besta2, bestx, alen, blen, low3, hgh3,
                   more);
    const int thr = FWD ? wsub(besta2, WAVE_LAG) : wadd(besta2, WAVE_LAG);

    // ---- pass 2: improver scan (descending k for FWD), trim test, prune.
    // An improver beats every slot above it (FWD; below it in reverse),
    // so improvers' values strictly fall with k in the scan's direction:
    // the extreme of any subset of them (improvers, el, et) sits at its
    // lowest slot (FWD) or its highest (reverse).  An improver's value is
    // never BAR (besta starts at anti >= 0), so these are the first
    // indices of the row extremes that build_forward_chunk takes. ----
    const int NOSLOT = FWD ? W : -1;
    int carry = BAR;
    int bsl = NOSLOT, lsl = NOSLOT, tsl = NOSLOT;
    int okhi = -BIG, oklo = BIG;
    for (int j = 0; j < nit; ++j) {
      const int it = FWD ? nit - 1 - j : j;
      const int s = slo + (it << 5) + lane;
      const bool inb = s <= shi;
      const int c = inb ? sV[s] : BAR;
      const int ex = warp_scan_excl<FWD>(c, carry, BAR);
      if (!inb) continue;
      const bool improver = FWD ? c > op2<true>(besta, ex)
                                : c < op2<false>(besta, ex);
      if (improver) {
        bsl = op2<!FWD>(bsl, s);
        if (sM[s] >= PA) {
          lsl = op2<!FWD>(lsl, s);
          const uint32_t th = sThi[s], tl = sTlo[s];
          const uint32_t b15 = tl & 0x7FFFu;
          const uint32_t b30 = ((tl >> 15) | (th << 17)) & 0x7FFFu;
          int s15 = 0, m15 = 0, s30 = 0, m30 = 0;
          for (int bit = 0; bit < TRIM_LEN; ++bit) {
            m15 = max(m15, s15);
            m30 = max(m30, s30);
            s15 += ((b15 >> (TRIM_LEN - 1 - bit)) & 1u) ? mscore : -dscore;
            s30 += ((b30 >> (TRIM_LEN - 1 - bit)) & 1u) ? mscore : -dscore;
          }
          if ((s15 - m15 >= 0) && (s30 - m30 + s15 >= 0))
            tsl = op2<!FWD>(tsl, s);
        }
      }
      if ((FWD ? c >= thr : c <= thr) && s >= low3 && s <= hgh3) {
        okhi = max(okhi, s);
        oklo = min(oklo, s);
      }
    }
    const int bslot = wred<!FWD>(bsl);
    const int lslot = wred<!FWD>(lsl);
    const int tslot = wred<!FWD>(tsl);
    const int hgh4a = __reduce_max_sync(FULL, okhi);
    const int low4a = __reduce_min_sync(FULL, oklo);
    const bool el_any = lslot != NOSLOT, et_any = tslot != NOSLOT;
    const int l_val = el_any ? sV[lslot] : BAR;
    const int t_val = et_any ? sV[tslot] : BAR;

    const int bestx2 = better ? sX[bslot] : bestx;
    const bool l_upd = el_any && (FWD ? l_val > besta : l_val < besta);
    const int lasta2 = l_upd ? l_val : lasta;
    const bool t_upd = et_any && (FWD ? t_val > besta : t_val < besta);
    if (t_upd) {
      trima = t_val;
      trimx = sX[tslot];
      trimd = dif2;
      trimw = dif2;
      trims = wadd(kbase, tslot);
    }
    low3 = low2;
    hgh3 = hgh2;
    clip_band<FWD>(hit, aclip, bclip, besta2, bestx2, alen, blen, low3, hgh3,
                   more);
    const bool anyok = hgh4a >= low4a;
    int hgh4 = anyok ? hgh4a : low3 - 1;
    int low4 = anyok ? low4a : low3;
    const bool empty = !anyok;

    // ---- liveness / budgets ----
    const bool going =
        more && (FWD ? lasta2 >= wsub(besta2, TRIM_MLAG)
                     : lasta2 <= wadd(besta2, TRIM_MLAG));
    const int width = hgh4 - low4 + 1;
    const bool over = going && width > W - 4;
    fall = fall || over || (going && empty);
    const bool alive2 = going && !over && !empty;

    // ---- recenter, gated per tube: an in-place shift of the W slots,
    // in strides ordered so no source is overwritten before it is read ----
    if (alive2 && (low4 <= 2 || hgh4 >= W - 3)) {
      const int shift = ((low4 + hgh4) >> 1) - W / 2;
      for (int q = 0; q < W; q += 32) {
        const int s = (shift > 0 ? q : W - 32 - q) + lane;
        const int src = s + shift;
        const bool in = src >= 0 && src < W;
        const int nv = in ? sV[src] : BAR;
        const uint32_t nh = in ? sThi[src] : 0u;
        const uint32_t nl = in ? sTlo[src] : 0u;
        const int nm = in ? sM[src] : 0;
        __syncwarp();
        sV[s] = nv;
        sThi[s] = nh;
        sTlo[s] = nl;
        sM[s] = nm;
        __syncwarp();
      }
      kbase += shift;
      low4 -= shift;
      hgh4 -= shift;
    }
    __syncwarp();

    low = low4;
    hgh = hgh4;
    besta = besta2;
    bestx = bestx2;
    lasta = lasta2;
    dif = dif2;
    alive = alive2;
  }
  // a dead tube's band reaches the fixed point of a dead wave
  if (wi < G) hgh = low - 1;

  for (int s = lane; s < W; s += 32) {
    Vo[rowoff + s] = sV[s];
    Thio[rowoff + s] = sThi[s];
    Tloo[rowoff + s] = sTlo[s];
    Mo[rowoff + s] = sM[s];
  }
  if (lane == 0) {
    int* o = sco + (size_t)n * NSC;
    o[SC_KBASE] = kbase; o[SC_LOW] = low; o[SC_HGH] = hgh;
    o[SC_BESTA] = besta; o[SC_BESTX] = bestx; o[SC_LASTA] = lasta;
    o[SC_TRIMA] = trima; o[SC_TRIMX] = trimx; o[SC_TRIMD] = trimd;
    o[SC_TRIMW] = trimw; o[SC_TRIMS] = trims;
    o[SC_ALIVE] = alive ? 1 : 0; o[SC_FALL] = fall ? 1 : 0;
    o[SC_DIF] = dif; o[14] = 0; o[15] = 0;
  }
}

template <bool FWD>
static cudaError_t launch(const uint32_t* pool, int P, const int* targs,
                          const int* V, const uint32_t* Thi,
                          const uint32_t* Tlo, const int* M, const int* sc,
                          int* Vo, uint32_t* Thio, uint32_t* Tloo, int* Mo,
                          int* sco, uint8_t* chlog, int* kblog, int N, int W,
                          int G, int PA, int ms, int ds, cudaStream_t st) {
  const size_t shm = tube_smem(W);   // 47,104 B at W = 2048
  wave_chunk_kernel<FWD><<<N, 32, shm, st>>>(
      pool, P, targs, V, Thi, Tlo, M, sc, Vo, Thio, Tloo, Mo, sco, chlog,
      kblog, N, W, G, PA, ms, ds);
  return cudaGetLastError();
}

extern "C" int wave_chunk_launch(const void* pool, int P, const void* targs,
                                 const void* V, const void* Thi,
                                 const void* Tlo, const void* M,
                                 const void* sc, void* Vo, void* Thio,
                                 void* Tloo, void* Mo, void* sco,
                                 void* chlog, void* kblog, int N, int W,
                                 int G, int fwd, int PA, int ms, int ds,
                                 void* stream) {
  if (N == 0) return 0;
  auto f = fwd ? launch<true> : launch<false>;
  return (int)f((const uint32_t*)pool, P, (const int*)targs, (const int*)V,
                (const uint32_t*)Thi, (const uint32_t*)Tlo, (const int*)M,
                (const int*)sc, (int*)Vo, (uint32_t*)Thio, (uint32_t*)Tloo,
                (int*)Mo, (int*)sco, (uint8_t*)chlog, (int*)kblog, N, W, G,
                PA, ms, ds, (cudaStream_t)stream);
}
