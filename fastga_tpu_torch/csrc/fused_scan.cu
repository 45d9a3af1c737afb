// fused_scan: K int32 inclusive scans over one stream in one pass per phase.
//
// Replaces fastga_tpu/ops/scan_pallas.py fused_scan (kernel body _mk_kernel):
// each channel c is a sum, max, min or "last" (mark-fill) scan, optionally
// segmented by one of the shared flag streams (a flagged row restarts the
// running value, inclusive of itself; "last" transports the value at the
// most recent flagged row, 0 before the first).  reverse=1 is the suffix
// scan: logical row j is physical row M-1-j, and no flipped copy is made.
// The semantics are those of scan_pallas.fused_scan_ref: sums wrap in int32
// (added as uint32 here, since signed overflow is undefined in C++).
//
// Segmented scan operator on (flag, value) pairs:
//   (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)),
// with op(v1, v2) = v1 for "last", whose values are masked by their own
// flag first.  Identities: sum 0, max INT_MIN, min INT_MAX, last 0 (flag 0).
//
// Bound: bytes.  The call must read every flag and value word once and write
// every output word once, 4 * M * (flags + 2 * channels) bytes; there is a
// handful of integer operations per word.
//
// Design (reduce-then-scan, three launches on the caller's stream):
//   1. scan_tile<false>: one CTA per tile of 4096 rows stages the tile's
//      flags once in shared memory, then for each channel in turn stages the
//      values (coalesced, in logical order, either direction), folds each
//      thread's 16 consecutive rows, and reduces the thread aggregates with
//      warp shuffles into the tile's (flag, value) aggregate;
//   2. scan_blocks: one CTA of 1024 threads turns the tile aggregates of
//      each channel into exclusive carries;
//   3. scan_tile<true>: the tiles again, each thread continuing from the
//      carry and its block prefix, results written back through shared
//      memory so the stores are coalesced.
// All channels and flags of a call go through each phase together, as the
// Pallas kernel fuses them.  Phases 1 and 3 each read the inputs, so the
// kernel moves about 1.5x the bound's bytes; a single-pass decoupled
// look-back scan would remove the second read.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define MAXCH 16
#define MAXFL 4
#define THREADS 256
#define ITEMS 16
#define TILE (THREADS * ITEMS)
#define PAD(i) ((i) + ((i) >> 5))
#define FULL 0xffffffffu

enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2, OP_LAST = 3 };

struct ScanArgs {
  const int* val[MAXCH];
  int* out[MAXCH];
  const int* flag[MAXFL];
  int op[MAXCH];
  int fid[MAXCH];
  int nch, nflags, reverse, nblk;
  long long M;
  int* agg_v;  // [nch * nblk] tile aggregates
  int* agg_f;
  int* carry;  // [nch * nblk] exclusive carries
};

__device__ __forceinline__ int ident_of(int op) {
  return op == OP_MAX ? INT_MIN : (op == OP_MIN ? INT_MAX : 0);
}

__device__ __forceinline__ int apply(int op, int a, int b) {
  switch (op) {
    case OP_SUM: return (int)((unsigned)a + (unsigned)b);
    case OP_MAX: return a > b ? a : b;
    case OP_MIN: return a < b ? a : b;
    default: return a;  // last: the left value stands until a mark
  }
}

__device__ __forceinline__ void combine(int op, int f1, int v1, int f2,
                                        int v2, int& f, int& v) {
  f = f1 | f2;
  v = f2 ? v2 : apply(op, v1, v2);
}

__device__ __forceinline__ long long phys(const ScanArgs& a, long long j) {
  return a.reverse ? a.M - 1 - j : j;
}

// Exclusive scan of one (f, v) pair per thread across the CTA: (pf, pv) is
// the combination of all lower threads, (tf, tv) that of all threads.
// s_wf/s_wv hold one entry per warp plus the total.
__device__ void block_exclusive(int op, int f, int v, int& pf, int& pv,
                                int& tf, int& tv, int* s_wf, int* s_wv) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int fi = f, vi = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int fo = __shfl_up_sync(FULL, fi, off);
    const int vo = __shfl_up_sync(FULL, vi, off);
    if (lane >= off) combine(op, fo, vo, fi, vi, fi, vi);
  }
  int fe = __shfl_up_sync(FULL, fi, 1), ve = __shfl_up_sync(FULL, vi, 1);
  if (lane == 0) {
    fe = 0;
    ve = ident_of(op);
  }
  if (lane == 31) {
    s_wf[w] = fi;
    s_wv[w] = vi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int rf = 0, rv = ident_of(op);
    for (int i = 0; i < nw; ++i) {
      const int f2 = s_wf[i], v2 = s_wv[i];
      s_wf[i] = rf;
      s_wv[i] = rv;
      combine(op, rf, rv, f2, v2, rf, rv);
    }
    s_wf[nw] = rf;
    s_wv[nw] = rv;
  }
  __syncthreads();
  combine(op, s_wf[w], s_wv[w], fe, ve, pf, pv);
  tf = s_wf[nw];
  tv = s_wv[nw];
  __syncthreads();
}

template <bool WRITE>
__global__ void __launch_bounds__(THREADS) scan_tile(ScanArgs a) {
  __shared__ int s_val[PAD(TILE)];
  __shared__ unsigned char s_flag[MAXFL][PAD(TILE)];
  __shared__ int s_wf[THREADS / 32 + 1], s_wv[THREADS / 32 + 1];
  const int b = blockIdx.x;
  const long long base = (long long)b * TILE;
  const int n = (int)(a.M - base < TILE ? a.M - base : TILE);
  for (int fl = 0; fl < a.nflags; ++fl) {
    const int* __restrict__ src = a.flag[fl];
    for (int k = threadIdx.x; k < TILE; k += THREADS)
      s_flag[fl][PAD(k)] = k < n ? (src[phys(a, base + k)] != 0) : 0;
  }
  const int k0 = threadIdx.x * ITEMS;
  for (int c = 0; c < a.nch; ++c) {
    const int op = a.op[c], fid = a.fid[c], id = ident_of(op);
    const int* __restrict__ src = a.val[c];
    for (int k = threadIdx.x; k < TILE; k += THREADS)
      s_val[PAD(k)] = k < n ? src[phys(a, base + k)] : id;
    __syncthreads();
    int f = 0, v = id;
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      const int fi = fid >= 0 ? s_flag[fid][PAD(k)] : 0;
      int vi = s_val[PAD(k)];
      if (op == OP_LAST && !fi) vi = 0;
      combine(op, f, v, fi, vi, f, v);
    }
    int pf, pv, tf, tv;
    block_exclusive(op, f, v, pf, pv, tf, tv, s_wf, s_wv);
    const size_t slot = (size_t)c * a.nblk + b;
    if (!WRITE) {
      if (threadIdx.x == 0) {
        a.agg_f[slot] = tf;
        a.agg_v[slot] = tv;
      }
      continue;
    }
    int r = pf ? pv : apply(op, a.carry[slot], pv);
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      const int fi = fid >= 0 ? s_flag[fid][PAD(k)] : 0;
      int vi = s_val[PAD(k)];
      if (op == OP_LAST && !fi) vi = 0;
      r = fi ? vi : apply(op, r, vi);
      s_val[PAD(k)] = r;
    }
    __syncthreads();
    int* __restrict__ dst = a.out[c];
    for (int k = threadIdx.x; k < n; k += THREADS)
      dst[phys(a, base + k)] = s_val[PAD(k)];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) scan_blocks(ScanArgs a) {
  __shared__ int s_wf[33], s_wv[33];
  const int nblk = a.nblk;
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < nblk ? b0 + per : nblk;
  for (int c = 0; c < a.nch; ++c) {
    const int op = a.op[c];
    const size_t off = (size_t)c * nblk;
    int f = 0, v = ident_of(op);
    for (int b = b0; b < b1; ++b)
      combine(op, f, v, a.agg_f[off + b], a.agg_v[off + b], f, v);
    int pf, pv, tf, tv;
    block_exclusive(op, f, v, pf, pv, tf, tv, s_wf, s_wv);
    for (int b = b0; b < b1; ++b) {
      a.carry[off + b] = pv;
      combine(op, pf, pv, a.agg_f[off + b], a.agg_v[off + b], pf, pv);
    }
  }
}

// vals/outs/flags: host arrays of device pointers; ops/fids: host int
// arrays (fid -1 = not segmented).  agg_v/agg_f/carry: device scratch of
// nscratch = nch * ceil(M / 4096) ints each.
extern "C" int fused_scan_launch(const void* vals, const void* outs,
                                 const void* flags, const void* ops,
                                 const void* fids, int nch, int nflags,
                                 long long M, int reverse, void* agg_v,
                                 void* agg_f, void* carry,
                                 long long nscratch, void* stream) {
  if (nch < 1 || nch > MAXCH || nflags < 0 || nflags > MAXFL || M < 1)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.nch = nch;
  a.nflags = nflags;
  a.reverse = reverse != 0;
  a.M = M;
  a.nblk = (int)((M + TILE - 1) / TILE);
  if (nscratch != (long long)nch * a.nblk) return (int)cudaErrorInvalidValue;
  const int* const* vp = (const int* const*)vals;
  int* const* op_ = (int* const*)outs;
  const int* const* fp = (const int* const*)flags;
  const int* opc = (const int*)ops;
  const int* fic = (const int*)fids;
  for (int c = 0; c < MAXCH; ++c) {
    a.val[c] = c < nch ? vp[c] : nullptr;
    a.out[c] = c < nch ? op_[c] : nullptr;
    a.op[c] = c < nch ? opc[c] : OP_SUM;
    a.fid[c] = c < nch ? fic[c] : -1;
    if (c < nch && (a.op[c] < OP_SUM || a.op[c] > OP_LAST ||
                    a.fid[c] >= nflags || a.fid[c] < -1))
      return (int)cudaErrorInvalidValue;
  }
  for (int f = 0; f < MAXFL; ++f) a.flag[f] = f < nflags ? fp[f] : nullptr;
  a.agg_v = (int*)agg_v;
  a.agg_f = (int*)agg_f;
  a.carry = (int*)carry;
  cudaStream_t s = (cudaStream_t)stream;
  scan_tile<false><<<a.nblk, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_blocks<<<1, 1024, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tile<true><<<a.nblk, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
