// backtrack_walk: the path walk over the choice logs of one wave run.
//
// Replaces fastga_tpu/ops/wave_pallas.py build_backtrack_walk (plain and
// kb_embedded variants) and the lax.scan walk of ops/wave.py
// WaveEngine._backtrack_fn: from each tube's (trim_diag, trim_wave), step
// down through the waves, following the logged predecessor choice, and
// emit the path diagonal at every wave.  Reads the un-transposed [G, N, W]
// choice log and the separate [G, N] kbase log; writes d0 [N] and D [G, N]
// (D[w] = the diagonal at wave w+1, before stepping wave w).
//
// Bound: one log byte and one kbase word per wave per tube are read and
// one D word written, a few MB a call, so the bytes are small.  The walk
// is a chain of G dependent steps per tube: each step's log read depends
// on the diagonal the previous step gave.  With one device-memory round
// trip per step (a thread per tube) it is latency-bound at about 0.84 us a
// wave on an H100.
//
// Design: one warp per tube, four tubes per CTA, rounds of 32 waves.  The
// path moves by at most one diagonal per wave.  So if d is the diagonal
// at the top wave w0 of a round, the diagonal at wave w0-j lies in
// [d-j, d+j], and for the next round (whose top diagonal is within 32 of
// d) in [d-32-j, d+32+j]: at most 127 slots of the log row.  While the warp
// resolves one round, lane j copies that window of row w0-32-j (the next
// round's) into shared memory with 16-byte cp.async, from kbase words
// loaded a round earlier still, so a round waits on no device load: the
// warp resolves its 32 steps in turn, one shared-memory byte read each
// (the same address in every lane), and lane j writes D for its row.  One
// chain of 32 shared-memory reads per 32 waves, no device round trip on
// it.  Where diag - kb could leave int32 (wraparound), a round reads its
// slots from device memory instead, so the walk equals the plain one on
// any input: the `(unsigned)diag - (unsigned)kb` wrap and the clamp to
// [0, W-1] are kept.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 4;     // tubes (warps) per CTA
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int RC = 9;      // 16-byte chunks of a row's window: 127 bytes
                           // and the alignment

__device__ __forceinline__ int clamp_slot(int diag, int kbv, int W) {
  const int slot = (int)((unsigned)diag - (unsigned)kbv);
  return slot < 0 ? 0 : (slot > W - 1 ? W - 1 : slot);
}

// one round's windows and per-row data, filled by lane j for row w0 - j
struct Stage {
  uint4 buf[32 * RC];
  int kb[32];      // kbase of the row
  int base[32];    // byte offset of slot 0 in the row's window
  int act[32];     // -1: the row takes a step (w + 1 <= trim_wave), else 0
};

__device__ __forceinline__ void stage_row(Stage& st, int lane,
                                          const uint8_t* __restrict__ ch,
                                          int w, int n, int N, int W, int tw,
                                          int diag, int kbv) {
  const bool act = w >= 0 && w + 1 <= tw;
  int base = 0;
  if (act) {
    long long lo = (long long)diag - 32 - lane - kbv;
    long long hi = (long long)diag + 32 + lane - kbv;
    lo = lo < 0 ? 0 : (lo > W - 1 ? W - 1 : lo);
    hi = hi < 0 ? 0 : (hi > W - 1 ? W - 1 : hi);
    // whole 16-byte chunks (a chunk holding a byte of the tensor lies in
    // its allocation, whose start is aligned)
    const uint8_t* rowp = ch + ((size_t)w * N + n) * W;
    const uintptr_t a0 = ((uintptr_t)(rowp + lo)) & ~(uintptr_t)15;
    const int nc = (int)((((uintptr_t)(rowp + hi)) >> 4) - (a0 >> 4)) + 1;
    const unsigned s0 =
        (unsigned)__cvta_generic_to_shared(&st.buf[lane * RC]);
#pragma unroll
    for (int k = 0; k < RC; ++k)
      if (k < nc)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         s0 + 16 * k),
                     "l"(a0 + 16 * k)
                     : "memory");
    base = (int)((intptr_t)rowp - (intptr_t)a0);
  }
  st.kb[lane] = kbv;
  st.base[lane] = base;
  st.act[lane] = act ? -1 : 0;
}

__device__ __forceinline__ int load_kb(const int* __restrict__ kb, int w,
                                       int n, int N, int tw) {
  return (w >= 0 && w + 1 <= tw) ? kb[(size_t)w * N + n] : 0;
}

}  // namespace

__global__ void __launch_bounds__(32 * TPB)
backtrack_walk_kernel(const uint8_t* __restrict__ ch,
                      const int* __restrict__ kb,
                      const int* __restrict__ trim_diag,
                      const int* __restrict__ trim_wave,
                      int* __restrict__ d0, int* __restrict__ D, int G, int N,
                      int W) {
  __shared__ Stage stages[TPB][2];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int n = blockIdx.x * TPB + wp;
  if (n >= N) return;   // warps are independent: no block barrier follows
  int diag = trim_diag[n];
  const int tw = trim_wave[n];
  int w0 = G - 1;
  stage_row(stages[wp][0], lane, ch, w0 - lane, n, N, W, tw, diag,
            load_kb(kb, w0 - lane, n, N, tw));
  int kbn = load_kb(kb, w0 - 32 - lane, n, N, tw);   // the next round's
  for (int r = 0; w0 >= 0; ++r, w0 -= 32) {
    const Stage& cur = stages[wp][r & 1];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (w0 >= 32)
      stage_row(stages[wp][(r & 1) ^ 1], lane, ch, w0 - 32 - lane, n, N, W,
                tw, diag, kbn);
    kbn = load_kb(kb, w0 - 64 - lane, n, N, tw);
    const long long gap = (long long)diag - cur.kb[lane];
    int mine = diag;
    if (!__any_sync(FULL, gap < -(1LL << 30) || gap > (1LL << 30))) {
      // diag - 31 - kb + o stays in int32, and the slot
      // clamp(o + diag - 31 - kb) lies in the row's window
      const uint8_t* bytes = (const uint8_t*)cur.buf;
      int o = 31;   // the diagonal is diag + o - 31
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (lane == j) mine = (int)((unsigned)diag + o - 31);
        int slot = o + (diag - 31 - cur.kb[j]);
        slot = slot < 0 ? 0 : (slot > W - 1 ? W - 1 : slot);
        const int cc = bytes[16 * RC * j + ((slot + cur.base[j]) & cur.act[j])];
        o += (((cc >> 1) & 1) - (cc & 1)) & cur.act[j];
      }
      diag = (int)((unsigned)diag + o - 31);
    } else {
      // the exact steps, each slot read from device memory
      for (int j = 0; j < 32; ++j) {
        if (lane == j) mine = diag;
        if (!cur.act[j]) continue;
        const int cc = ch[((size_t)(w0 - j) * N + n) * W
                          + clamp_slot(diag, cur.kb[j], W)];
        diag = (int)((unsigned)diag + (cc == 1 ? -1 : (cc == 2 ? 1 : 0)));
      }
    }
    if (w0 - lane >= 0) D[(size_t)(w0 - lane) * N + n] = mine;
    __syncwarp();
  }
  if (lane == 0) d0[n] = diag;
}

extern "C" int backtrack_walk_launch(const void* ch, const void* kb,
                                     const void* trim_diag,
                                     const void* trim_wave, void* d0,
                                     void* D, int G, int N, int W,
                                     void* stream) {
  if (N == 0) return 0;
  backtrack_walk_kernel<<<(N + TPB - 1) / TPB, 32 * TPB, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)ch, (const int*)kb, (const int*)trim_diag,
      (const int*)trim_wave, (int*)d0, (int*)D, G, N, W);
  return (int)cudaGetLastError();
}
