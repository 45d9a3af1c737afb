// Shared device code of the wave kernels (wave_chunk.cu, wave0.cu).
//
// Integer semantics follow the JAX package's XLA twins: int32 arithmetic
// wraps (done in uint32 and cast back), shifts of negative values are
// arithmetic, and pool word reads clamp to [0, P-1] like the host mirror
// ops/wave.py _np_fetch64.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace wave {

constexpr int CH_DIAG = 0, CH_LOW = 1, CH_HIGH = 2, CH_NONE = 3;
constexpr int WAVE_LAG = 70, TRIM_MLAG = 250, PATH_LEN = 60, TRIM_LEN = 15;
constexpr int BIG = 1 << 30;
constexpr int NSC = 16;
enum { SC_KBASE, SC_LOW, SC_HGH, SC_BESTA, SC_BESTX, SC_LASTA, SC_TRIMA,
       SC_TRIMX, SC_TRIMD, SC_TRIMW, SC_TRIMS, SC_ALIVE, SC_FALL, SC_DIF };
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// number of leading matching bases of a 16-base XOR word (16 if equal)
__device__ __forceinline__ int ctz2(uint32_t x) {
  return x == 0 ? 16 : ((__ffs((int)x) - 1) >> 1);
}

// reverse the sixteen 2-bit groups of a word
__device__ __forceinline__ uint32_t rev2(uint32_t v) {
  uint32_t b = __brev(v);
  return ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
}

// four funnel-shifted 16-base words starting at base `start` of the
// sequence at word offset `woff`
__device__ __forceinline__ void fetch64(const uint32_t* __restrict__ pool,
                                        int P, int woff, int start,
                                        uint32_t out[4]) {
  const int w = start >> 4;
  const int sh = (start & 15) << 1;
  const long long base = (long long)woff + w;
  uint32_t ws[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    long long i = base + k;
    i = i < 0 ? 0 : (i > P - 1 ? P - 1 : i);
    ws[k] = __ldg(pool + i);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __funnelshift_r(ws[k], ws[k + 1], sh);
}

// length of the matching run (<= 64) at (x, y) in direction FWD
template <bool FWD>
__device__ __forceinline__ int snake_run(const uint32_t* __restrict__ pool,
                                         int P, int x, int y, int aw,
                                         int alen, int bw, int blen) {
  uint32_t wa[4], wb[4];
  int va, vb;
  if (FWD) {
    va = clampi(wsub(alen, x), 0, 64);
    vb = clampi(wsub(blen, y), 0, 64);
    fetch64(pool, P, aw, x, wa);
    fetch64(pool, P, bw, y, wb);
  } else {
    va = clampi(x, 0, 64);
    vb = clampi(y, 0, 64);
    uint32_t ta[4], tb[4];
    fetch64(pool, P, aw, wsub(x, 64), ta);
    fetch64(pool, P, bw, wsub(y, 64), tb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wa[k] = rev2(ta[3 - k]);
      wb[k] = rev2(tb[3 - k]);
    }
  }
  int run = ctz2(wa[0] ^ wb[0]);
  bool full = run == 16;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int mm = ctz2(wa[k] ^ wb[k]);
    if (full) run = 16 * k + mm;
    full = full && mm == 16;
  }
  run = run < va ? run : va;
  return run < vb ? run : vb;
}

// sentinel flags at the end of a snake: (b_sent, a_sent)
template <bool FWD>
__device__ __forceinline__ void sentinels(int x, int k, int alen, int blen,
                                          bool act, bool& bs, bool& as) {
  const int y = wsub(x, k);
  if (FWD) {
    bs = (y < 0) || (y >= blen);
    as = !bs && ((x < 0) || (x >= alen));
  } else {
    const int y1 = wsub(y, 1), x1 = wsub(x, 1);
    bs = (y1 < 0) || (y1 >= blen);
    as = !bs && ((x1 < 0) || (x1 >= alen));
  }
  bs = bs && act;
  as = as && act;
}

template <bool MX>
__device__ __forceinline__ int op2(int a, int b) {
  return MX ? (a > b ? a : b) : (a < b ? a : b);
}

// All-reduce of K values over the block; MXMASK bit i selects max (1) or
// min (0) for value i.  `sred` holds 32*K ints.  Two barriers.
template <int K, unsigned MXMASK>
__device__ __forceinline__ void block_reduce(int (&v)[K], int* sred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int o = __shfl_xor_sync(FULL, v[i], d);
      v[i] = ((MXMASK >> i) & 1) ? op2<true>(v[i], o) : op2<false>(v[i], o);
    }
    if (lane == 0) sred[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int r = sred[i * 32];
    for (int w = 1; w < nw; ++w)
      r = ((MXMASK >> i) & 1) ? op2<true>(r, sred[i * 32 + w])
                              : op2<false>(r, sred[i * 32 + w]);
    v[i] = r;
  }
  __syncthreads();
}

// Exclusive suffix max (FWD) / prefix min (reverse) scan over slots, each
// thread owning SPT consecutive slots.  excl[j] is the max over slots
// above slot j (FWD) or the min over slots below it; `total` is the
// reduction over all slots.  Fill (identity) is BAR.  Two barriers.
template <int SPT, bool FWD>
__device__ __forceinline__ void block_scan_excl(const int (&v)[SPT],
                                                int (&excl)[SPT], int& total,
                                                int bar, int* sred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int loc[SPT];
  int t;
  if (FWD) {
    t = bar;
#pragma unroll
    for (int j = SPT - 1; j >= 0; --j) { loc[j] = t; t = op2<true>(t, v[j]); }
    // inclusive suffix over lanes
    int inc = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(FULL, inc, d);
      if (lane + d < 32) inc = op2<true>(inc, o);
    }
    int ex = __shfl_down_sync(FULL, inc, 1);
    if (lane == 31) ex = bar;
    if (lane == 0) sred[warp] = inc;
    __syncthreads();
    int carry = bar, tot = bar;
    for (int w = 0; w < nw; ++w) {
      tot = op2<true>(tot, sred[w]);
      if (w > warp) carry = op2<true>(carry, sred[w]);
    }
    __syncthreads();
    ex = op2<true>(ex, carry);
#pragma unroll
    for (int j = 0; j < SPT; ++j) excl[j] = op2<true>(loc[j], ex);
    total = tot;
  } else {
    t = bar;
#pragma unroll
    for (int j = 0; j < SPT; ++j) { loc[j] = t; t = op2<false>(t, v[j]); }
    int inc = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc = op2<false>(inc, o);
    }
    int ex = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) ex = bar;
    if (lane == 31) sred[warp] = inc;
    __syncthreads();
    int carry = bar, tot = bar;
    for (int w = 0; w < nw; ++w) {
      tot = op2<false>(tot, sred[w]);
      if (w < warp) carry = op2<false>(carry, sred[w]);
    }
    __syncthreads();
    ex = op2<false>(ex, carry);
#pragma unroll
    for (int j = 0; j < SPT; ++j) excl[j] = op2<false>(loc[j], ex);
    total = tot;
  }
}

// clipping of the band at sequence sentinels (align.c:757-782 / mirrored)
template <bool FWD>
__device__ __forceinline__ void clip_band(bool hit, int aclip, int bclip,
                                          int besta, int bestx, int alen,
                                          int blen, int& low, int& hgh,
                                          bool& more) {
  const int by = wsub(besta, bestx);
  bool b_in, a_in;
  if (FWD) {
    b_in = by >= 0 && by < blen;
    a_in = bestx >= 0 && bestx < alen;
  } else {
    const int by1 = wsub(by, 1), bx1 = wsub(bestx, 1);
    b_in = by1 >= 0 && by1 < blen;
    a_in = bx1 >= 0 && bx1 < alen;
  }
  more = !hit || (b_in && a_in);
  if (FWD) {
    if (hit && hgh >= aclip) hgh = aclip - 1;
    if (hit && low <= bclip) low = bclip + 1;
  } else {
    if (hit && low <= aclip) low = aclip + 1;
    if (hit && hgh >= bclip) hgh = bclip - 1;
  }
}

}  // namespace wave
