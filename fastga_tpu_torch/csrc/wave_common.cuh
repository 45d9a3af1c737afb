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
constexpr int WIN = 512;    // words per sequence window (8,192 bases)
constexpr int SK = 8;       // words a snake step compares (128 bases)

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// SK funnel-shifted 16-base words from base `start` of the sequence at
// word offset `woff`.  WINDOWED: through a shared-memory window holding
// pool words from absolute index `wlo` when the SK+1 words lie inside it,
// else (and always without a window) from global memory; word indices
// clamp to [0, P-1] on both paths, since a window holds pool[clamp(i)] at i.
template <bool WINDOWED>
__device__ __forceinline__ void fetchw(const uint32_t* __restrict__ pool,
                                       int P, const uint32_t* win, int wlo,
                                       int woff, int start,
                                       uint32_t out[SK]) {
  const int sh = (start & 15) << 1;
  const long long base = (long long)woff + (start >> 4);
  const long long r = base - wlo;
  uint32_t ws[SK + 1];
  if (WINDOWED && r >= 0 && r <= WIN - (SK + 1)) {
#pragma unroll
    for (int k = 0; k <= SK; ++k) ws[k] = win[r + k];
  } else {
#pragma unroll
    for (int k = 0; k <= SK; ++k) {
      long long i = base + k;
      i = i < 0 ? 0 : (i > P - 1 ? P - 1 : i);
      ws[k] = __ldg(pool + i);
    }
  }
#pragma unroll
  for (int k = 0; k < SK; ++k) out[k] = __funnelshift_r(ws[k], ws[k + 1], sh);
}

// length of the matching run (<= 16*SK) at (x, y) in direction FWD: the
// bases match up to the first mismatch of the two sequences' SK words, the
// end of either sequence, or 16*SK.  A snake repeats the step while it
// returns 16*SK.
template <bool FWD, bool WINDOWED>
__device__ __forceinline__ int snake_step(const uint32_t* __restrict__ pool,
                                          int P, const uint32_t* wa, int alo,
                                          const uint32_t* wb, int blo, int x,
                                          int y, int aw, int alen, int bw,
                                          int blen) {
  uint32_t wA[SK], wB[SK];
  int rk[SK], va, vb;
  // the run up to the first mismatch as the least of the per-word runs
  // (a word without a mismatch gives 16*SK), a tree of mins
  if (FWD) {
    va = clampi(wsub(alen, x), 0, 16 * SK);
    vb = clampi(wsub(blen, y), 0, 16 * SK);
    fetchw<WINDOWED>(pool, P, wa, alo, aw, x, wA);
    fetchw<WINDOWED>(pool, P, wb, blo, bw, y, wB);
    // from the bottom: trailing zero bit pairs
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const uint32_t d = wA[k] ^ wB[k];
      rk[k] = d ? 16 * k + ((__ffs((int)d) - 1) >> 1) : 16 * SK;
    }
  } else {
    va = clampi(x, 0, 16 * SK);
    vb = clampi(y, 0, 16 * SK);
    fetchw<WINDOWED>(pool, P, wa, alo, aw, wsub(x, 16 * SK), wA);
    fetchw<WINDOWED>(pool, P, wb, blo, bw, wsub(y, 16 * SK), wB);
    // from the top: leading zero bit pairs
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const uint32_t d = wA[k] ^ wB[k];
      rk[k] = d ? 16 * (SK - 1 - k) + (__clz((int)d) >> 1) : 16 * SK;
    }
  }
#pragma unroll
  for (int h = SK / 2; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < h; ++k) rk[k] = min(rk[k], rk[k + h]);
  int run = rk[0];
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

// warp all-reduce: max (MX) or min
template <bool MX>
__device__ __forceinline__ int wred(int v) {
  return MX ? __reduce_max_sync(FULL, v) : __reduce_min_sync(FULL, v);
}

// One 32-slot stride of the improver scan: the running max over the lanes
// above this one (MX; the running min over the lanes below it otherwise),
// joined with `carry`, the running value of the strides scanned before.
// `carry` moves on to include this stride.  Fill (identity) is `bar`.
template <bool MX>
__device__ __forceinline__ int warp_scan_excl(int v, int& carry, int bar) {
  const int lane = threadIdx.x & 31;
  int inc = v, ex;
  if (MX) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(FULL, inc, d);
      if (lane + d < 32) inc = op2<true>(inc, o);
    }
    ex = __shfl_down_sync(FULL, inc, 1);
    if (lane == 31) ex = bar;
    ex = op2<true>(ex, carry);
    carry = op2<true>(carry, __shfl_sync(FULL, inc, 0));
  } else {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc = op2<false>(inc, o);
    }
    ex = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) ex = bar;
    ex = op2<false>(ex, carry);
    carry = op2<false>(carry, __shfl_sync(FULL, inc, 31));
  }
  return ex;
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
