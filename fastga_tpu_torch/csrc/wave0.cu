// wave0: the wave-0 state of every tube.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_wave0_pallas (the device
// twin of ops/wave.py host_wave0): snake every diagonal of [dgmin, dgmax]
// from `anti`, take the furthest reach as best/trim, then apply the
// sentinel clip.  There is no recentering, so the result is bit-equal to
// host_wave0 in slot space; rows with valid == 0 come out dead.
//
// Design: the CTA layout and snake code of wave_chunk.cu (one CTA per
// tube, threads on diagonal slots, pool words read straight from global
// memory).  Bound: it reads the tube columns and the pool words the band
// spans and writes the state (16 B per slot); one pass with two block
// reductions and one scan, so it is launch- and latency-bound at these
// sizes.
#include "wave_common.cuh"

using namespace wave;

template <int SPT, bool FWD>
__global__ void __launch_bounds__(1024)
wave0_kernel(const uint32_t* __restrict__ pool, int P,
             const int* __restrict__ cols, int* __restrict__ Vo,
             uint32_t* __restrict__ Thio, uint32_t* __restrict__ Tloo,
             int* __restrict__ Mo, int* __restrict__ sco, int N, int W) {
  extern __shared__ int smem[];
  int* sX = smem;
  int* sred = smem + W;   // 32 * 4 ints
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int BAR = FWD ? -1 : 0x7FFFFFFF;
  const int aw = cols[n], alen = cols[N + n], bw = cols[2 * N + n];
  const int blen = cols[3 * N + n];
  const int dgmin = cols[6 * N + n], dgmax = cols[7 * N + n];
  const int anti = cols[8 * N + n];
  const bool valid = cols[9 * N + n] > 0;

  const int kbase = dgmin + ((dgmax - dgmin) >> 1) - W / 2;
  const int low = dgmin - kbase, hgh = dgmax - kbase;

  int c[SPT], cm[SPT], excl[SPT];
  bool inb[SPT], as[SPT], bs[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = tid * SPT + j;
    inb[j] = s >= low && s <= hgh && valid;
    const int k = wadd(kbase, s);
    int x = wadd(anti, k) >> 1;
    if (inb[j]) {
      for (;;) {
        const int run = snake_run<FWD>(pool, P, x, wsub(x, k), aw, alen, bw,
                                       blen);
        x = FWD ? wadd(x, run) : wsub(x, run);
        if (run != 64) break;
      }
    }
    sentinels<FWD>(x, k, alen, blen, inb[j], bs[j], as[j]);
    c[j] = wsub((int)((unsigned)x << 1), k);
    cm[j] = inb[j] ? c[j] : BAR;
    sX[s] = x;
  }
  int cbest;
  block_scan_excl<SPT, FWD>(cm, excl, cbest, BAR, sred);
  const int besta0 = anti;
  const int bestx0 = wadd(anti, wadd(kbase, hgh)) >> 1;
  const bool better = FWD ? cbest > besta0 : cbest < besta0;

  int imp_c[SPT];
  int red[4] = {BAR, 0, FWD ? BIG : -BIG, FWD ? -BIG : BIG};
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = tid * SPT + j;
    const bool improver =
        inb[j] && (FWD ? c[j] > op2<true>(besta0, excl[j])
                       : c[j] < op2<false>(besta0, excl[j]));
    imp_c[j] = improver ? c[j] : BAR;
    red[0] = op2<FWD>(red[0], imp_c[j]);
    red[1] |= (as[j] || bs[j]);
    if (as[j]) red[2] = FWD ? min(red[2], s) : max(red[2], s);
    if (bs[j]) red[3] = FWD ? max(red[3], s) : min(red[3], s);
  }
  if (FWD)
    block_reduce<4, 0b1011u>(red, sred);
  else
    block_reduce<4, 0b0110u>(red, sred);
  int sl[1] = {W};
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (imp_c[j] == red[0]) sl[0] = min(sl[0], tid * SPT + j);
  block_reduce<1, 0u>(sl, sred);
  const int bslot = sl[0];

  const int besta = better ? cbest : besta0;
  const int bestx = better ? sX[bslot] : bestx0;
  const int trim_slot = better ? wadd(kbase, bslot) : wadd(kbase, hgh);
  int low2 = low, hgh2 = hgh;
  bool more;
  clip_band<FWD>(red[1] > 0, red[2], red[3], besta, bestx, alen, blen, low2,
                 hgh2, more);

  const size_t rowoff = (size_t)n * W;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = tid * SPT + j;
    Vo[rowoff + s] = inb[j] ? c[j] : BAR;
    Thio[rowoff + s] = inb[j] ? ((1u << 28) - 1u) : 0u;
    Tloo[rowoff + s] = inb[j] ? 0xFFFFFFFFu : 0u;
    Mo[rowoff + s] = inb[j] ? PATH_LEN : 0;
  }
  if (tid == 0) {
    int* o = sco + (size_t)n * NSC;
    o[SC_KBASE] = kbase; o[SC_LOW] = low2; o[SC_HGH] = hgh2;
    o[SC_BESTA] = besta; o[SC_BESTX] = bestx; o[SC_LASTA] = besta;
    o[SC_TRIMA] = besta; o[SC_TRIMX] = bestx; o[SC_TRIMD] = 0;
    o[SC_TRIMW] = 0; o[SC_TRIMS] = trim_slot;
    o[SC_ALIVE] = (more && valid) ? 1 : 0; o[SC_FALL] = 0; o[SC_DIF] = 0;
    o[14] = 0; o[15] = 0;
  }
}

template <int SPT, bool FWD>
static cudaError_t launch(const uint32_t* pool, int P, const int* cols,
                          int* Vo, uint32_t* Thio, uint32_t* Tloo, int* Mo,
                          int* sco, int N, int W, cudaStream_t st) {
  const size_t shm = (size_t)(W + 32 * 4) * sizeof(int);
  wave0_kernel<SPT, FWD><<<N, W / SPT, shm, st>>>(pool, P, cols, Vo, Thio,
                                                  Tloo, Mo, sco, N, W);
  return cudaGetLastError();
}

extern "C" int wave0_launch(const void* pool, int P, const void* cols,
                            void* Vo, void* Thio, void* Tloo, void* Mo,
                            void* sco, int N, int W, int fwd, void* stream) {
  auto p = (const uint32_t*)pool;
  auto c = (const int*)cols;
  auto st = (cudaStream_t)stream;
  if (N == 0) return 0;
  cudaError_t e;
  if (W > 1024)
    e = fwd ? launch<2, true>(p, P, c, (int*)Vo, (uint32_t*)Thio,
                              (uint32_t*)Tloo, (int*)Mo, (int*)sco, N, W, st)
            : launch<2, false>(p, P, c, (int*)Vo, (uint32_t*)Thio,
                               (uint32_t*)Tloo, (int*)Mo, (int*)sco, N, W, st);
  else
    e = fwd ? launch<1, true>(p, P, c, (int*)Vo, (uint32_t*)Thio,
                              (uint32_t*)Tloo, (int*)Mo, (int*)sco, N, W, st)
            : launch<1, false>(p, P, c, (int*)Vo, (uint32_t*)Thio,
                               (uint32_t*)Tloo, (int*)Mo, (int*)sco, N, W, st);
  return (int)e;
}
