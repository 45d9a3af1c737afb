// wave0: the wave-0 state of every tube.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_wave0_pallas (the device
// twin of ops/wave.py host_wave0): snake every diagonal of [dgmin, dgmax]
// from `anti`, take the furthest reach as best/trim, then apply the
// sentinel clip.  There is no recentering, so the result is bit-equal to
// host_wave0 in slot space; rows with valid == 0 come out dead.
//
// Bound: bytes.  A call reads eight int32 tube columns and the pool words
// the band's snakes span and writes the state, 16 B a slot and 64 B of
// scalars a tube: about 0.5 MB at n=512/W=256, 0.00067 ms at 3.35 TB/s,
// under the card's least kernel duration (chip_smoke.py times an empty
// kernel at the same grid, wave0_floor_launch).
//
// Design (one warp per tube, as wave_chunk.cu):
// - a warp per tube (TPC tubes a CTA), with no barrier wider than a warp;
//   the lanes walk only the band's slots [max(low, 0), min(hgh, W-1)] in
//   strides of 32, so a band of tens of diagonals is one or two strides at
//   any W;
// - the snake is wave_chunk's 128-base snake_step (wave_common.cuh) on
//   global memory: wave 0 has no sequence window to reuse;
// - the strides run in the direction of the improver scan (down from the
//   top slot forward, up from the bottom slot in reverse), so the snake,
//   the exclusive running max/min (shuffles with a carry across strides)
//   and the improver test are one pass; a lane keeps its last improver's
//   slot and x, which is the arg-extreme (improvers' values rise strictly
//   along the scan), and one shuffle fetches bestx from its lane;
// - the reductions are redux instructions (__reduce_*_sync);
// - the band's c values go to the warp's W ints of shared memory, and the
//   warp writes the four state rows V/Thi/Tlo/M (one [4, N, W] tensor) as
//   16-byte words: the band's values, BAR / 0 outside it.
// Semantics kept bit for bit: host_wave0 (wave_kernels.wave0_plain), dead
// rows for valid == 0, the sentinel clip, int32 wraparound.
#include "wave_common.cuh"

using namespace wave;

// the tube columns the kernel reads, int32 [N] each
struct Cols {
  const int *aw, *alen, *bw, *blen, *dgmin, *dgmax, *anti, *valid;
};

// tubes a CTA: of 1, 2 and 4, timed at n=512/W=256 on the H100, 1 was the
// fastest (PERF.md)
constexpr int TPC = 1;

template <bool FWD>
__global__ void __launch_bounds__(32 * TPC)
wave0_kernel(const uint32_t* __restrict__ pool, int P, const Cols cols,
             int* __restrict__ state, int* __restrict__ sco, int N, int W) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * TPC + (threadIdx.x >> 5);
  if (n >= N) return;
  int* sC = smem + (threadIdx.x >> 5) * W;
  const int BAR = FWD ? -1 : 0x7FFFFFFF;
  const int aw = cols.aw[n], alen = cols.alen[n], bw = cols.bw[n];
  const int blen = cols.blen[n], dgmin = cols.dgmin[n];
  const int dgmax = cols.dgmax[n], anti = cols.anti[n];
  const bool valid = cols.valid[n] > 0;

  const int kbase = wsub(wadd(dgmin, wsub(dgmax, dgmin) >> 1), W / 2);
  const int low = wsub(dgmin, kbase), hgh = wsub(dgmax, kbase);
  // the in-band slots of [0, W)
  const int slo = valid ? max(low, 0) : 0;
  const int shi = valid ? min(hgh, W - 1) : -1;
  const int nit = shi >= slo ? ((shi - slo) >> 5) + 1 : 0;

  const int besta0 = anti;
  int cbest = BAR, carry = BAR;
  int aclip = FWD ? BIG : -BIG, bclip = FWD ? -BIG : BIG;
  bool hit = false;
  int bsl = FWD ? W : -1, bx = 0;
  for (int j = 0; j < nit; ++j) {
    const int s = slo + ((FWD ? nit - 1 - j : j) << 5) + lane;
    const bool inb = s <= shi;
    int c = BAR, x = 0;
    if (inb) {
      const int k = wadd(kbase, s);
      x = wadd(anti, k) >> 1;
      for (;;) {
        const int run = snake_step<FWD, false>(pool, P, nullptr, 0, nullptr,
                                               0, x, wsub(x, k), aw, alen, bw,
                                               blen);
        x = FWD ? wadd(x, run) : wsub(x, run);
        if (run != 16 * SK) break;
      }
      bool as, bs;
      sentinels<FWD>(x, k, alen, blen, true, bs, as);
      c = wsub((int)((unsigned)x << 1), k);
      sC[s] = c;
      cbest = op2<FWD>(cbest, c);
      hit = hit || as || bs;
      if (as) aclip = FWD ? min(aclip, s) : max(aclip, s);
      if (bs) bclip = FWD ? max(bclip, s) : min(bclip, s);
    }
    const int ex = warp_scan_excl<FWD>(c, carry, BAR);
    if (inb && (FWD ? c > op2<true>(besta0, ex) : c < op2<false>(besta0, ex))) {
      bsl = s;
      bx = x;
    }
  }
  cbest = wred<FWD>(cbest);
  aclip = wred<!FWD>(aclip);
  bclip = wred<FWD>(bclip);
  hit = __any_sync(FULL, hit);
  const int bslot = wred<!FWD>(bsl);
  const int bxs = __shfl_sync(FULL, bx, (bslot - slo) & 31);

  const bool better = FWD ? cbest > besta0 : cbest < besta0;
  const int besta = better ? cbest : besta0;
  const int bestx = better ? bxs : wadd(anti, wadd(kbase, hgh)) >> 1;
  const int trim_slot = better ? wadd(kbase, bslot) : wadd(kbase, hgh);
  int low2 = low, hgh2 = hgh;
  bool more;
  clip_band<FWD>(hit, aclip, bclip, besta, bestx, alen, blen, low2, hgh2,
                 more);
  __syncwarp();

  // the state rows, 16 bytes a lane a store
  const size_t NW = (size_t)N * W;
  int4* Vo = (int4*)(state + (size_t)n * W);
  int4* Thio = (int4*)(state + NW + (size_t)n * W);
  int4* Tloo = (int4*)(state + 2 * NW + (size_t)n * W);
  int4* Mo = (int4*)(state + 3 * NW + (size_t)n * W);
  for (int q = lane; q < (W >> 2); q += 32) {
    const int s0 = q << 2;
    const int4 cv = ((const int4*)sC)[q];
    const bool i0 = s0 >= slo && s0 <= shi, i1 = s0 + 1 >= slo && s0 + 1 <= shi;
    const bool i2 = s0 + 2 >= slo && s0 + 2 <= shi;
    const bool i3 = s0 + 3 >= slo && s0 + 3 <= shi;
    Vo[q] = make_int4(i0 ? cv.x : BAR, i1 ? cv.y : BAR, i2 ? cv.z : BAR,
                      i3 ? cv.w : BAR);
    const int th = (1 << 28) - 1;
    Thio[q] = make_int4(i0 ? th : 0, i1 ? th : 0, i2 ? th : 0, i3 ? th : 0);
    Tloo[q] = make_int4(-i0, -i1, -i2, -i3);
    Mo[q] = make_int4(i0 ? PATH_LEN : 0, i1 ? PATH_LEN : 0,
                      i2 ? PATH_LEN : 0, i3 ? PATH_LEN : 0);
  }
  // the scalars (wave_common.cuh SC_*), a 16-byte word each of lanes 0-3
  if (lane < 4) {
    int4 o;
    if (lane == 0) o = make_int4(kbase, low2, hgh2, besta);
    else if (lane == 1) o = make_int4(bestx, besta, besta, bestx);
    else if (lane == 2) o = make_int4(0, 0, trim_slot, (more && valid) ? 1 : 0);
    else o = make_int4(0, 0, 0, 0);
    ((int4*)(sco + (size_t)n * NSC))[lane] = o;
  }
}

// an empty kernel at wave0's grid: the launch floor chip_smoke.py times
__global__ void wave0_floor_kernel() {}

template <bool FWD>
static cudaError_t launch(const uint32_t* pool, int P, const Cols& c,
                          int* state, int* sco, int N, int W,
                          cudaStream_t st) {
  const size_t shm = (size_t)TPC * W * sizeof(int);   // 8 KB at W=2048
  wave0_kernel<FWD><<<(N + TPC - 1) / TPC, 32 * TPC, shm, st>>>(
      pool, P, c, state, sco, N, W);
  return cudaGetLastError();
}

// state: int32 [4, N, W] (V, Thi, Tlo, M), sco: int32 [N, 16].  W must be a
// multiple of 32 (16-byte row stores).
extern "C" int wave0_launch(const void* pool, int P, const void* aw,
                            const void* alen, const void* bw,
                            const void* blen, const void* dgmin,
                            const void* dgmax, const void* anti,
                            const void* valid, void* state, void* sco, int N,
                            int W, int fwd, void* stream) {
  if (N == 0) return 0;
  if (W <= 0 || W % 32) return (int)cudaErrorInvalidValue;
  const Cols c = {(const int*)aw,    (const int*)alen,  (const int*)bw,
                  (const int*)blen,  (const int*)dgmin, (const int*)dgmax,
                  (const int*)anti,  (const int*)valid};
  auto p = (const uint32_t*)pool;
  auto st = (cudaStream_t)stream;
  return fwd ? (int)launch<true>(p, P, c, (int*)state, (int*)sco, N, W, st)
             : (int)launch<false>(p, P, c, (int*)state, (int*)sco, N, W, st);
}

extern "C" int wave0_floor_launch(int N, int W, void* stream) {
  if (N == 0) return 0;
  wave0_floor_kernel<<<(N + TPC - 1) / TPC, 32 * TPC,
                       (size_t)TPC * W * sizeof(int),
                       (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
