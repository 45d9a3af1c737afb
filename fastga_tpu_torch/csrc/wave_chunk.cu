// wave_chunk: up to G O(nd) waves per tube, from a wave state.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_chunk_pallas (MEGA mode,
// mega_k > 0): one call runs up to G = k*chunk waves with early exit; the
// arithmetic is that of ops/wave.py build_forward_chunk (one_wave).
//
// Design: one CTA per tube, threads on diagonal slots (W/SPT threads, SPT
// consecutive slots each: SPT = 2 at W = 2048, over the 1,024-thread
// limit).  V/Thi/Tlo/M and the per-slot x live in shared memory (20 B x W,
// 40 KB at W = 2048); neighbour reads (k-1/k+1), the suffix-max /
// prefix-min improver scan, arg-extremes and any/min/max are block
// reductions through shared memory.  The snake runs per thread and reads
// its 5+5 pool words straight from global memory (no VMEM page windows or
// strip selects: per-lane loads are cheap here), first mismatch = ctz of
// the XOR.  The trim test uses the arithmetic form (wave_pallas.py
// trim_ok, from mscore/dscore), bit-equal to the 2^15-entry tables.
//
// Differences from the XLA twin, by design:
// - recentering is gated per tube (a CTA cannot see the batch), so
//   slot-space state and the kbase log differ from the batch-gated twin;
//   diagonal-space results are the same (compare through canon_state);
// - a tube stops at its last live wave; log rows after it are unwritten,
//   and the dead-wave fixed point hgh = low - 1 is applied on exit.
//
// Bound: the bytes it must move (state in/out, one choice byte per slot
// and one kbase word per live wave, the pool words the live lanes span)
// are small; the kernel is latency-bound on its per-wave barriers (about
// ten per wave) and on the dependent pool loads of the snake.  The design
// keeps every per-wave intermediate in shared memory or registers, so the
// only per-wave global traffic is the log row.
#include "wave_common.cuh"

using namespace wave;

template <int SPT, bool FWD>
__global__ void __launch_bounds__(1024)
wave_chunk_kernel(const uint32_t* __restrict__ pool, int P,
                  const int* __restrict__ targs,
                  const int* __restrict__ Vi, const uint32_t* __restrict__ Thii,
                  const uint32_t* __restrict__ Tloi, const int* __restrict__ Mi,
                  const int* __restrict__ sci, int* __restrict__ Vo,
                  uint32_t* __restrict__ Thio, uint32_t* __restrict__ Tloo,
                  int* __restrict__ Mo, int* __restrict__ sco,
                  uint8_t* __restrict__ chlog, int* __restrict__ kblog, int N,
                  int W, int G, int PA, int mscore, int dscore) {
  extern __shared__ int smem[];
  int* sV = smem;
  uint32_t* sThi = (uint32_t*)(smem + W);
  uint32_t* sTlo = (uint32_t*)(smem + 2 * W);
  int* sM = smem + 3 * W;
  int* sX = smem + 4 * W;
  int* sred = smem + 5 * W;   // 32 * 8 ints

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int BAR = FWD ? -1 : 0x7FFFFFFF;
  const size_t rowoff = (size_t)n * W;
  for (int s = tid; s < W; s += blockDim.x) {
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
  __syncthreads();

  int wi = 0;
  for (; wi < G && alive; ++wi) {
    // ---- band expansion ----
    const int low2 = (wadd(kbase, low) - 1 >= minp) ? low - 1 : low;
    const int hgh2 = (wadd(kbase, hgh) + 1 <= maxp) ? hgh + 1 : hgh;
    const int dif2 = dif + 1;
    auto vr = [&](int t) -> int {
      if (t < 0 || t >= W || t < low2 || t > hgh2) return BAR;
      if ((t == low2 && low2 != low) || (t == hgh2 && hgh2 != hgh))
        return BAR;
      return sV[t];
    };

    int c[SPT], xv[SPT], mv[SPT], excl[SPT];
    uint32_t th[SPT], tl[SPT];
    bool inb[SPT], as[SPT], bs[SPT];
    uint8_t* crow = chlog + ((size_t)wi * N + n) * W;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int s = tid * SPT + j;
      inb[j] = s >= low2 && s <= hgh2;
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
      crow[s] = inb[j] ? (take_p ? CH_HIGH : (take_m ? CH_LOW : CH_DIAG))
                       : CH_NONE;
      const int src = take_p ? (s + 1 < W ? s + 1 : W - 1)
                             : (take_m ? (s > 0 ? s - 1 : 0) : s);
      uint32_t thi = sThi[src], tlo = sTlo[src];
      int m = sM[src] - (int)((thi >> 28) & 1u);
      thi = (thi << 1) | (tlo >> 31);
      tlo = tlo << 1;
      const int k = wadd(kbase, s);
      int x = wadd(c_pre, k) >> 1;
      if (inb[j]) {
        for (;;) {
          const int run = snake_run<FWD>(pool, P, x, wsub(x, k), aw, alen,
                                         bw, blen);
          for (int kk = 0; kk < 4; ++kk) {
            int r = run - 16 * kk;
            r = r < 0 ? 0 : (r > 16 ? 16 : r);
            if (r > 0) {
              const uint32_t ones = (1u << r) - 1u;
              const uint32_t ob = (thi >> (29 - r)) & ones;
              m += r - __popc(ob);
              thi = (thi << r) | (tlo >> (32 - r));
              tlo = (tlo << r) | ones;
            }
          }
          x = FWD ? wadd(x, run) : wsub(x, run);
          if (run != 64) break;
        }
      }
      sentinels<FWD>(x, k, alen, blen, inb[j], bs[j], as[j]);
      c[j] = wsub((int)((unsigned)x << 1), k);
      xv[j] = x;
      th[j] = thi;
      tl[j] = tlo;
      mv[j] = m;
    }
    if (tid == 0) kblog[(size_t)wi * N + n] = kbase;

    // ---- best / trim updates (descending-k running max semantics) ----
    int cm[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      cm[j] = inb[j] ? c[j] : BAR;
      sX[tid * SPT + j] = xv[j];
    }
    int cbest;
    block_scan_excl<SPT, FWD>(cm, excl, cbest, BAR, sred);
    const bool better = FWD ? cbest > besta : cbest < besta;

    int imp_c[SPT], et_c[SPT];
    int red[8];
    red[0] = BAR; red[1] = BAR; red[2] = 0; red[3] = BAR; red[4] = 0;
    red[5] = 0;
    red[6] = FWD ? BIG : -BIG;    // aclip
    red[7] = FWD ? -BIG : BIG;    // bclip
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int s = tid * SPT + j;
      const bool improver =
          inb[j] && (FWD ? c[j] > op2<true>(besta, excl[j])
                         : c[j] < op2<false>(besta, excl[j]));
      imp_c[j] = improver ? c[j] : BAR;
      const bool el = improver && mv[j] >= PA;
      bool tok = false;
      if (el) {
        const uint32_t b15 = tl[j] & 0x7FFFu;
        const uint32_t b30 = ((tl[j] >> 15) | (th[j] << 17)) & 0x7FFFu;
        int s15 = 0, m15 = 0, s30 = 0, m30 = 0;
        for (int bit = 0; bit < TRIM_LEN; ++bit) {
          m15 = max(m15, s15);
          m30 = max(m30, s30);
          s15 += ((b15 >> (TRIM_LEN - 1 - bit)) & 1u) ? mscore : -dscore;
          s30 += ((b30 >> (TRIM_LEN - 1 - bit)) & 1u) ? mscore : -dscore;
        }
        tok = (s15 - m15 >= 0) && (s30 - m30 + s15 >= 0);
      }
      const bool et = el && tok;
      et_c[j] = et ? c[j] : BAR;
      red[0] = op2<FWD>(red[0], imp_c[j]);
      red[1] = op2<FWD>(red[1], el ? c[j] : BAR);
      red[2] |= el;
      red[3] = op2<FWD>(red[3], et_c[j]);
      red[4] |= et;
      red[5] |= (as[j] || bs[j]);
      if (as[j]) red[6] = FWD ? min(red[6], s) : max(red[6], s);
      if (bs[j]) red[7] = FWD ? max(red[7], s) : min(red[7], s);
    }
    // max/min per value: bit i set = max
    if (FWD)
      block_reduce<8, 0b10111111u>(red, sred);
    else
      block_reduce<8, 0b01110100u>(red, sred);
    const int bmax = red[0], l_val = red[1], t_val = red[3];
    const bool el_any = red[2] > 0, et_any = red[4] > 0, hit = red[5] > 0;
    const int aclip = red[6], bclip = red[7];

    int sl[2] = {W, W};
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int s = tid * SPT + j;
      if (imp_c[j] == bmax) sl[0] = min(sl[0], s);
      if (et_c[j] == t_val) sl[1] = min(sl[1], s);
    }
    block_reduce<2, 0u>(sl, sred);
    const int bslot = sl[0], tslot = sl[1];

    const int besta2 = better ? cbest : besta;
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

    // ---- write back (in-band slots only) ----
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (!inb[j]) continue;
      const int s = tid * SPT + j;
      sV[s] = c[j];
      sThi[s] = th[j];
      sTlo[s] = tl[j];
      sM[s] = mv[j];
    }

    // ---- sentinel clip, WAVE_LAG prune ----
    int low3 = low2, hgh3 = hgh2;
    bool more;
    clip_band<FWD>(hit, aclip, bclip, besta2, bestx2, alen, blen, low3, hgh3,
                   more);
    const int thr = FWD ? wsub(besta2, WAVE_LAG) : wadd(besta2, WAVE_LAG);
    int pr[3] = {0, -BIG, BIG};
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int s = tid * SPT + j;
      const bool ok = inb[j] && (FWD ? c[j] >= thr : c[j] <= thr) &&
                      s >= low3 && s <= hgh3;
      if (ok) {
        pr[0] = 1;
        pr[1] = max(pr[1], s);
        pr[2] = min(pr[2], s);
      }
    }
    block_reduce<3, 0b011u>(pr, sred);
    const bool anyok = pr[0] > 0;
    int hgh4 = anyok ? pr[1] : low3 - 1;
    int low4 = anyok ? pr[2] : low3;
    const bool empty = !anyok;

    // ---- liveness / budgets ----
    const bool going =
        more && (FWD ? lasta2 >= wsub(besta2, TRIM_MLAG)
                     : lasta2 <= wadd(besta2, TRIM_MLAG));
    const int width = hgh4 - low4 + 1;
    const bool over = going && width > W - 4;
    fall = fall || over || (going && empty);
    const bool alive2 = going && !over && !empty;

    // ---- recenter, gated per tube ----
    if (alive2 && (low4 <= 2 || hgh4 >= W - 3)) {
      const int shift = ((low4 + hgh4) >> 1) - W / 2;
      int nv[SPT], nm[SPT];
      uint32_t nh[SPT], nl[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int src = tid * SPT + j + shift;
        const bool in = src >= 0 && src < W;
        nv[j] = in ? sV[src] : BAR;
        nh[j] = in ? sThi[src] : 0u;
        nl[j] = in ? sTlo[src] : 0u;
        nm[j] = in ? sM[src] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int s = tid * SPT + j;
        sV[s] = nv[j];
        sThi[s] = nh[j];
        sTlo[s] = nl[j];
        sM[s] = nm[j];
      }
      kbase += shift;
      low4 -= shift;
      hgh4 -= shift;
    }
    __syncthreads();

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

  for (int s = tid; s < W; s += blockDim.x) {
    Vo[rowoff + s] = sV[s];
    Thio[rowoff + s] = sThi[s];
    Tloo[rowoff + s] = sTlo[s];
    Mo[rowoff + s] = sM[s];
  }
  if (tid == 0) {
    int* o = sco + (size_t)n * NSC;
    o[SC_KBASE] = kbase; o[SC_LOW] = low; o[SC_HGH] = hgh;
    o[SC_BESTA] = besta; o[SC_BESTX] = bestx; o[SC_LASTA] = lasta;
    o[SC_TRIMA] = trima; o[SC_TRIMX] = trimx; o[SC_TRIMD] = trimd;
    o[SC_TRIMW] = trimw; o[SC_TRIMS] = trims;
    o[SC_ALIVE] = alive ? 1 : 0; o[SC_FALL] = fall ? 1 : 0;
    o[SC_DIF] = dif; o[14] = 0; o[15] = 0;
  }
}

template <int SPT, bool FWD>
static cudaError_t launch(const uint32_t* pool, int P, const int* targs,
                          const int* V, const uint32_t* Thi,
                          const uint32_t* Tlo, const int* M, const int* sc,
                          int* Vo, uint32_t* Thio, uint32_t* Tloo, int* Mo,
                          int* sco, uint8_t* chlog, int* kblog, int N, int W,
                          int G, int PA, int ms, int ds, cudaStream_t st) {
  const size_t shm = (size_t)(5 * W + 32 * 8) * sizeof(int);
  wave_chunk_kernel<SPT, FWD><<<N, W / SPT, shm, st>>>(
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
  auto p = (const uint32_t*)pool;
  auto t = (const int*)targs;
  auto v = (const int*)V;
  auto h = (const uint32_t*)Thi;
  auto l = (const uint32_t*)Tlo;
  auto m = (const int*)M;
  auto s = (const int*)sc;
  auto st = (cudaStream_t)stream;
  if (N == 0) return 0;
  cudaError_t e;
  if (W > 1024) {
    e = fwd ? launch<2, true>(p, P, t, v, h, l, m, s, (int*)Vo,
                              (uint32_t*)Thio, (uint32_t*)Tloo, (int*)Mo,
                              (int*)sco, (uint8_t*)chlog, (int*)kblog, N, W,
                              G, PA, ms, ds, st)
            : launch<2, false>(p, P, t, v, h, l, m, s, (int*)Vo,
                               (uint32_t*)Thio, (uint32_t*)Tloo, (int*)Mo,
                               (int*)sco, (uint8_t*)chlog, (int*)kblog, N, W,
                               G, PA, ms, ds, st);
  } else {
    e = fwd ? launch<1, true>(p, P, t, v, h, l, m, s, (int*)Vo,
                              (uint32_t*)Thio, (uint32_t*)Tloo, (int*)Mo,
                              (int*)sco, (uint8_t*)chlog, (int*)kblog, N, W,
                              G, PA, ms, ds, st)
            : launch<1, false>(p, P, t, v, h, l, m, s, (int*)Vo,
                               (uint32_t*)Thio, (uint32_t*)Tloo, (int*)Mo,
                               (int*)sco, (uint8_t*)chlog, (int*)kblog, N, W,
                               G, PA, ms, ds, st);
  }
  return (int)e;
}
