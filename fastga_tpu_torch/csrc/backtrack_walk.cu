// backtrack_walk: the path walk over the choice logs of one wave run.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_backtrack_walk (plain and
// kb_embedded variants) and the lax.scan walk of ops/wave.py
// WaveEngine._backtrack_fn: from each tube's (trim_diag, trim_wave), step
// down through the waves, following the logged predecessor choice, and
// emit the path diagonal at every wave.
//
// Design: one thread per tube walks all G waves, reading
// ch[w, n, clip(diag - kb[w, n], 0, W-1)] straight from the un-transposed
// [G, N, W] log and the separate [G, N] kbase log (no transpose, no kbase
// bits packed into the log).  Writes d0 [N] and D [G, N] (D[w] = the
// diagonal at wave w+1, before stepping wave w).
//
// Bound: one log byte and one kbase word per wave per tube are read and
// one D word written, so the bytes are small; the walk is a chain of G
// dependent loads per tube and is latency-bound.  Consecutive tubes sit on
// consecutive threads, so the kbase reads and D writes of a warp are
// coalesced.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void backtrack_walk_kernel(const uint8_t* __restrict__ ch,
                                      const int* __restrict__ kb,
                                      const int* __restrict__ trim_diag,
                                      const int* __restrict__ trim_wave,
                                      int* __restrict__ d0,
                                      int* __restrict__ D, int G, int N,
                                      int W) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int diag = trim_diag[n];
  const int tw = trim_wave[n];
  for (int w = G - 1; w >= 0; --w) {
    D[(size_t)w * N + n] = diag;
    if (w + 1 <= tw) {
      int slot = (int)((unsigned)diag - (unsigned)kb[(size_t)w * N + n]);
      slot = slot < 0 ? 0 : (slot > W - 1 ? W - 1 : slot);
      const int cc = ch[((size_t)w * N + n) * W + slot];
      diag += cc == 1 ? -1 : (cc == 2 ? 1 : 0);
    }
  }
  d0[n] = diag;
}

extern "C" int backtrack_walk_launch(const void* ch, const void* kb,
                                     const void* trim_diag,
                                     const void* trim_wave, void* d0,
                                     void* D, int G, int N, int W,
                                     void* stream) {
  if (N == 0) return 0;
  const int T = 128;
  backtrack_walk_kernel<<<(N + T - 1) / T, T, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ch, (const int*)kb, (const int*)trim_diag,
      (const int*)trim_wave, (int*)d0, (int*)D, G, N, W);
  return (int)cudaGetLastError();
}
