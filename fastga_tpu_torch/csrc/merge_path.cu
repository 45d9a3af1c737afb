// merge_path: one ascending stream from two ascending int64 streams.
//
// Replaces fastga_tpu/ops/merge_pallas.py merge_sorted_streams (kernel body
// _mk_kernel, splits _merge_path_splits): A and B hold ncols int64 columns
// each; columns 0 and 1 are the lexicographic keys (k1, k2), the others ride
// along.  Ties go to A first, so the result is the stable sort of
// concat(A, B) by (k1, k2) on every row, the +MAX invalid tails included,
// whenever each stream is itself ascending.
//
// Bound: bytes.  The call must read every input word once and write every
// output word once, 16 * M * ncols bytes for M = E1 + E2 rows; the
// comparisons are a few per row.
//
// Design (two launches on the caller's stream):
//   1. merge_splits: one thread per tile boundary d = k * 2048 runs the
//      merge-path diagonal binary search over the keys in global memory:
//      splits[k] = the number of A rows among the first d outputs;
//   2. merge_tiles: one CTA per tile of 2048 outputs stages its A and B key
//      ranges in shared memory (32 KB); each of 256 threads finds its own
//      sub-split for 8 consecutive outputs by the same search in shared
//      memory and merges them in sequence, recording a source index; then
//      every column is written in output order (coalesced stores), keys from
//      shared memory and payloads read through the source index from the
//      tile's contiguous A and B ranges.
// The TPU kernel's hi/lo int32 planes, pre-reversed B stream, bitonic
// network and VMEM windows are TPU workarounds and are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

#define MAXCOLS 8
#define MTHREADS 256
#define MITEMS 8
#define MTILE (MTHREADS * MITEMS)

struct MergeArgs {
  const long long* a[MAXCOLS];
  const long long* b[MAXCOLS];
  long long* o[MAXCOLS];
  int ncols, nblk;
  long long E1, E2, M;
  long long* splits;  // [nblk + 1]
};

// (a1, a2) <= (b1, b2): A's row goes first
__device__ __forceinline__ bool le2(long long a1, long long a2, long long b1,
                                    long long b2) {
  return a1 < b1 || (a1 == b1 && a2 <= b2);
}

__global__ void merge_splits(MergeArgs m) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k > m.nblk) return;
  const long long d = k * MTILE < m.M ? k * MTILE : m.M;
  long long lo = d - m.E2 > 0 ? d - m.E2 : 0;
  long long hi = d < m.E1 ? d : m.E1;
  const long long* __restrict__ a1 = m.a[0];
  const long long* __restrict__ a2 = m.a[1];
  const long long* __restrict__ b1 = m.b[0];
  const long long* __restrict__ b2 = m.b[1];
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long j = d - 1 - mid;
    if (le2(a1[mid], a2[mid], b1[j], b2[j]))
      lo = mid + 1;
    else
      hi = mid;
  }
  m.splits[k] = lo;
}

__global__ void __launch_bounds__(MTHREADS) merge_tiles(MergeArgs m) {
  __shared__ long long s_k1[MTILE], s_k2[MTILE];
  __shared__ int s_src[MTILE];
  const long long d0 = (long long)blockIdx.x * MTILE;
  const long long d1 = d0 + MTILE < m.M ? d0 + MTILE : m.M;
  const long long a0 = m.splits[blockIdx.x], a1 = m.splits[blockIdx.x + 1];
  const long long b0 = d0 - a0, b1 = d1 - a1;
  const int na = (int)(a1 - a0), nb = (int)(b1 - b0), n = na + nb;
  for (int i = threadIdx.x; i < na; i += MTHREADS) {
    s_k1[i] = m.a[0][a0 + i];
    s_k2[i] = m.a[1][a0 + i];
  }
  for (int i = threadIdx.x; i < nb; i += MTHREADS) {
    s_k1[na + i] = m.b[0][b0 + i];
    s_k2[na + i] = m.b[1][b0 + i];
  }
  __syncthreads();
  const int dd = threadIdx.x * MITEMS;
  if (dd < n) {
    int lo = dd - nb > 0 ? dd - nb : 0;
    int hi = dd < na ? dd : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int j = na + dd - 1 - mid;
      if (le2(s_k1[mid], s_k2[mid], s_k1[j], s_k2[j]))
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = dd - lo;
    const int cnt = n - dd < MITEMS ? n - dd : MITEMS;
    for (int t = 0; t < cnt; ++t) {
      const bool take_a =
          j >= nb || (i < na && le2(s_k1[i], s_k2[i], s_k1[na + j],
                                    s_k2[na + j]));
      s_src[dd + t] = take_a ? i++ : na + j++;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += MTHREADS) {
    const int s = s_src[t];
    m.o[0][d0 + t] = s_k1[s];
    m.o[1][d0 + t] = s_k2[s];
  }
  for (int c = 2; c < m.ncols; ++c) {
    const long long* __restrict__ A = m.a[c];
    const long long* __restrict__ B = m.b[c];
    long long* __restrict__ O = m.o[c];
    for (int t = threadIdx.x; t < n; t += MTHREADS) {
      const int s = s_src[t];
      O[d0 + t] = s < na ? A[a0 + s] : B[b0 + (s - na)];
    }
  }
}

// acols/bcols/ocols: host arrays of ncols device pointers (int64 columns of
// E1, E2 and E1 + E2 rows); splits: device scratch of nsplits =
// ceil((E1 + E2) / 2048) + 1 int64.
extern "C" int merge_path_launch(const void* acols, const void* bcols,
                                 const void* ocols, int ncols, long long E1,
                                 long long E2, void* splits,
                                 long long nsplits, void* stream) {
  if (ncols < 2 || ncols > MAXCOLS || E1 < 0 || E2 < 0 || E1 + E2 < 1)
    return (int)cudaErrorInvalidValue;
  MergeArgs m;
  m.ncols = ncols;
  m.E1 = E1;
  m.E2 = E2;
  m.M = E1 + E2;
  m.nblk = (int)((m.M + MTILE - 1) / MTILE);
  if (nsplits != (long long)m.nblk + 1) return (int)cudaErrorInvalidValue;
  const long long* const* ap = (const long long* const*)acols;
  const long long* const* bp = (const long long* const*)bcols;
  long long* const* op = (long long* const*)ocols;
  for (int c = 0; c < MAXCOLS; ++c) {
    m.a[c] = c < ncols ? ap[c] : nullptr;
    m.b[c] = c < ncols ? bp[c] : nullptr;
    m.o[c] = c < ncols ? op[c] : nullptr;
  }
  m.splits = (long long*)splits;
  cudaStream_t s = (cudaStream_t)stream;
  merge_splits<<<(m.nblk + 1 + 255) / 256, 256, 0, s>>>(m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_tiles<<<m.nblk, MTHREADS, 0, s>>>(m);
  return (int)cudaGetLastError();
}
