// fused_scan: K inclusive scans over one stream, one launch, one pass.
//
// Replaces fastga_tpu/ops/scan_pallas.py fused_scan (kernel body _mk_kernel):
// each channel c is a sum, max, min or "last" (mark-fill) scan, optionally
// segmented by one of the shared flag streams (a flagged row restarts the
// running value, inclusive of itself; "last" transports the value at the
// most recent flagged row, 0 before the first).  reverse=1 is the suffix
// scan, with no flipped copy.  The semantics are those of
// scan_pallas.fused_scan_ref: int32 sums wrap (added as unsigned, since
// signed overflow is undefined in C++).  A wide call has one int64 sum
// channel ("sum64", the chain sweep's coverage sum of
// ops/device_pipeline.py), exact where the int32 sum would wrap.
//
// Segmented scan operator on (flag, value) pairs:
//   (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)),
// with op(v1, v2) = v1 for "last", whose values are masked by their own
// flag first.  Identities: sum 0, max INT_MIN, min INT_MAX, last 0 (flag 0).
//
// Bound: bytes.  A call must read every flag and value word once and write
// every output word once, M * (4 * flags + 2 * sizeof(value) * channels)
// bytes (at the chain sweep's 13 channels and 1 flag, M = 50,331,648:
// 5.4 GB, 1.62 ms at 3.35 TB/s); a handful of integer operations a word.
//
// Design: a single-pass scan with decoupled look-back, one launch, and
// these bytes plus 8 per tile and channel of look-back words:
// - a CTA of 256 threads scans one tile of all channels at once: 4,096
//   rows where the channels' values fit 96 KB of shared memory (up to 6
//   int32 channels, the int64 one), else 2,048 (104 KB at 13 channels);
//   two CTAs an SM up to 13 channels.  Tiles go out in scan order by an atomic
//   ticket, so a CTA only waits on tiles whose CTAs already run and every
//   wait ends; the tile of ticket t is physical tile t forward, nblk-1-t
//   in reverse, so the suffix scan walks the same aligned tiles from the
//   top, each from its top row;
// - each thread copies its own rows of every value stream to shared memory
//   with cp.async (16 bytes a copy where the pointers are 16-byte aligned
//   and the rows lie inside [0, M)) and loads its rows of each flag stream
//   into a bit mask, so all of a tile's loads are in flight together; the
//   tile is read from device memory once, and a thread reads back only
//   the rows it copied;
// - the per-row code is compiled for each op and direction (a runtime op
//   or a runtime row order put the rows in local memory); per channel a
//   thread folds its rows and the warp reduces the folds with shuffles,
//   and warp 0 turns the warps' totals into warp prefixes and the tile's
//   aggregate;
// - warp 0 publishes the aggregate as one 64-bit word a channel (state,
//   flag, value; an int64 value takes two words whose states must agree),
//   each complete in itself, so relaxed stores and loads need no fence.
//   It looks back over 32 preceding tiles at a time: lane j reloads tile
//   hi-j's words until they are published, the window goes through shared
//   memory, and lane c walks channel c's column from the nearest tile
//   until it meets an inclusive prefix.  A window thus costs one round
//   trip to L2 and at most 32 short steps at any K, under the time the
//   card takes to stream 32 tiles, so the inclusive prefixes keep up and a
//   look-back rarely needs a second window.  The tile then publishes its
//   inclusive prefix the same way;
// - per channel each thread folds again, the warp scans the folds, and
//   each thread rescans its rows from its prefix (the tile's, the warp's
//   and the lanes' before it) and stores them, 16 bytes a store where
//   aligned.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define MAXCH 16
#define MAXFL 4
#define THREADS 256
#define NWARP (THREADS / 32)
#define FULL 0xffffffffu

typedef unsigned long long u64;

enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2, OP_LAST = 3 };
// a look-back word: bits 0-31 a 32-bit half of a value (int64 values take
// two words, low half first), bit 32 the flag, bits 33-34 the state
enum { ST_AGG = 1, ST_INCL = 2 };

template <typename V>
struct ScanArgs {
  const V* val[MAXCH];
  V* out[MAXCH];
  const int* flag[MAXFL];
  int op[MAXCH];
  int fid[MAXCH];
  int nch, nflags, reverse, vec, nblk;
  long long M;
  // [0]: the ticket counter; then, by ticket, channel and half, the words
  // of each tile's aggregate, overwritten by its inclusive prefix; zero
  u64* words;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

template <typename V>
struct Lim;
template <>
struct Lim<int> {
  static constexpr int lo = INT_MIN, hi = INT_MAX;
};
template <>
struct Lim<long long> {
  static constexpr long long lo = LLONG_MIN, hi = LLONG_MAX;
};

// look-back words a tile: one a channel, or the int64 channel's two
template <typename V>
constexpr int LBW = sizeof(V) == 4 ? MAXCH : 2;

template <typename V>
__device__ __forceinline__ V ident_of(int op) {
  return op == OP_MAX ? (V)Lim<V>::lo : (op == OP_MIN ? (V)Lim<V>::hi : (V)0);
}

// (f1, v1) + (f2, v2) for an op known at compile time (the per-row code)
template <int OP, typename V>
__device__ __forceinline__ void combine_t(int f1, V v1, int f2, V v2, int& f,
                                          V& v) {
  f = f1 | f2;
  V r;
  if constexpr (OP == OP_SUM) r = wrap_add(v1, v2);
  else if constexpr (OP == OP_MAX) r = v1 > v2 ? v1 : v2;
  else if constexpr (OP == OP_MIN) r = v1 < v2 ? v1 : v2;
  else r = v1;   // last: the left value stands until a mark
  v = f2 ? v2 : r;
}

// the same for an op known at run time (the per-tile code)
template <typename V>
__device__ __forceinline__ void combine(int op, int f1, V v1, int f2, V v2,
                                        int& f, V& v) {
  switch (op) {
    case OP_SUM: combine_t<OP_SUM>(f1, v1, f2, v2, f, v); break;
    case OP_MAX: combine_t<OP_MAX>(f1, v1, f2, v2, f, v); break;
    case OP_MIN: combine_t<OP_MIN>(f1, v1, f2, v2, f, v); break;
    default: combine_t<OP_LAST>(f1, v1, f2, v2, f, v);
  }
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// publish channel c's (f, v) of ticket t in `state`: one 64-bit store a
// half, each word complete in itself, so no fence orders them
template <typename V>
__device__ __forceinline__ void publish(u64* words, int t, int K, int c,
                                        int state, int f, V v) {
  constexpr int H = sizeof(V) / 4;
  const u64 bits = (u64)v;
  u64* w = words + 1 + ((size_t)t * K + c) * H;
#pragma unroll
  for (int h = 0; h < H; ++h)
    st_relaxed(w + h, ((bits >> (32 * h)) & 0xFFFFFFFFull) | (u64)f << 32
                          | (u64)state << 33);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* sdst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gsrc) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gsrc), "n"(BYTES) : "memory");
}

// this thread's `nin` rows (of ITEMS) at `src` to shared `dst`
template <int ITEMS, typename V>
__device__ __forceinline__ void copy_rows(V* dst, const V* src, int nin,
                                          bool full) {
  if (full) {
#pragma unroll
    for (int k = 0; k < ITEMS * (int)sizeof(V) / 16; ++k)
      cp_async<16>((char*)dst + 16 * k, (const char*)src + 16 * k);
  } else {
    for (int i = 0; i < nin; ++i) cp_async<sizeof(V)>(dst + i, src + i);
  }
}

// this thread's rows of a flag stream as bits (bit i: row i is flagged)
template <int ITEMS>
__device__ __forceinline__ unsigned flag_bits(const int* src, int nin,
                                              bool full) {
  unsigned m = 0;
  if (full) {
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const int4 x = __ldcs((const int4*)src + k);
      m |= (unsigned)(x.x != 0) << (4 * k) | (unsigned)(x.y != 0) << (4 * k + 1)
           | (unsigned)(x.z != 0) << (4 * k + 2)
           | (unsigned)(x.w != 0) << (4 * k + 3);
    }
  } else {
    for (int i = 0; i < nin; ++i) m |= (unsigned)(__ldcs(src + i) != 0) << i;
  }
  return m;
}

// ITEMS rows from 16-byte aligned shared memory
template <int ITEMS>
__device__ __forceinline__ void ld_rows(const int* p, int (&v)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS / 4; ++k) {
    const int4 x = ((const int4*)p)[k];
    v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
  }
}
template <int ITEMS>
__device__ __forceinline__ void ld_rows(const long long* p,
                                        long long (&v)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS / 2; ++k) {
    const longlong2 x = ((const longlong2*)p)[k];
    v[2 * k] = x.x; v[2 * k + 1] = x.y;
  }
}

// ITEMS rows to 16-byte aligned device memory
template <int ITEMS>
__device__ __forceinline__ void st_rows(int* p, const int (&v)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS / 4; ++k)
    ((int4*)p)[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                              v[4 * k + 3]);
}
template <int ITEMS>
__device__ __forceinline__ void st_rows(long long* p,
                                        const long long (&v)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS / 2; ++k)
    ((longlong2*)p)[k] = make_longlong2(v[2 * k], v[2 * k + 1]);
}

// one flag stream's bits out of the (up to) four
__device__ __forceinline__ unsigned pick(const unsigned (&fm)[MAXFL],
                                         int fid) {
  return fid == 0 ? fm[0] : fid == 1 ? fm[1] : fid == 2 ? fm[2]
         : fid == 3 ? fm[3] : 0u;
}

// this thread's rows of one channel, masked (rows past M, never copied,
// are the identity with no flag; "last" values are masked by their
// flag), and their fold in scan order
template <int OP, bool REV, int ITEMS, typename V>
__device__ __forceinline__ void fold_rows(const V* sv, unsigned fb, int nin,
                                          V (&v)[ITEMS], int& f, V& acc) {
  ld_rows<ITEMS>(sv, v);
  f = 0;
  acc = ident_of<V>(OP);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = REV ? ITEMS - 1 - j : j;
    const int fi = (fb >> i) & 1;
    if (i >= nin) v[i] = ident_of<V>(OP);
    if (OP == OP_LAST && !fi) v[i] = 0;
    combine_t<OP>(f, acc, fi, v[i], f, acc);
  }
}

// phase 1 for one channel: the warp's total in scan order, to lane 0
template <int OP, bool REV, int ITEMS, typename V>
__device__ __forceinline__ void warp_total(const V* sv, unsigned fb, int nin,
                                           int lane, int& sf, V& sv_) {
  V v[ITEMS];
  fold_rows<OP, REV, ITEMS>(sv, fb, nin, v, sf, sv_);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int of = __shfl_down_sync(FULL, sf, off);
    const V ov = __shfl_down_sync(FULL, sv_, off);
    if (lane + off < 32) {
      if (REV)
        combine_t<OP>(of, ov, sf, sv_, sf, sv_);
      else
        combine_t<OP>(sf, sv_, of, ov, sf, sv_);
    }
  }
}

// phase 3 for one channel: scan the warp, rescan my rows from my prefix
// (the tile's and the warp's, (pf, pv)), store
template <int OP, bool REV, int ITEMS, typename V>
__device__ __forceinline__ void rescan(const V* sv, unsigned fb, int nin,
                                       int lane, int pf, V pv, V* dst,
                                       bool full) {
  V v[ITEMS];
  int sf;
  V s;
  fold_rows<OP, REV, ITEMS>(sv, fb, nin, v, sf, s);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int src = (REV ? lane + off : lane - off) & 31;
    const int of = __shfl_sync(FULL, sf, src);
    const V ov = __shfl_sync(FULL, s, src);
    if (REV ? lane + off < 32 : lane >= off)
      combine_t<OP>(of, ov, sf, s, sf, s);
  }
  const int esrc = (REV ? lane + 1 : lane - 1) & 31;
  const int ef = __shfl_sync(FULL, sf, esrc);
  const V ev = __shfl_sync(FULL, s, esrc);
  V r;
  if (lane != (REV ? 31 : 0)) combine_t<OP>(pf, pv, ef, ev, pf, r);
  else r = pv;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = REV ? ITEMS - 1 - j : j;
    if ((fb >> i) & 1) {
      r = v[i];
    } else {
      int f_;
      combine_t<OP>(0, r, 0, v[i], f_, r);
    }
    v[i] = r;
  }
  if (full) {
    st_rows<ITEMS>(dst, v);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (i < nin) dst[i] = v[i];
  }
}

template <typename V, int ITEMS, bool REV>
__global__ void __launch_bounds__(THREADS) scan_kernel(const ScanArgs<V> a) {
  constexpr int TILE = THREADS * ITEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  V* s_val = (V*)smem;                      // [nch][TILE]
  __shared__ V s_wv[MAXCH][NWARP];          // warp totals, then prefixes
  __shared__ int s_wf[MAXCH][NWARP];
  __shared__ u64 s_lw[32][LBW<V> + 1];      // a look-back window's words
  __shared__ int s_ticket;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int K = a.nch;
  if (t == 0) s_ticket = (int)atomicAdd(a.words, 1ull);
  __syncthreads();
  const int ticket = s_ticket;
  const long long tile = REV ? a.nblk - 1 - ticket : ticket;
  const long long r0 = tile * TILE + (long long)t * ITEMS;  // my first row
  const int nin = (int)(a.M - r0 >= ITEMS ? ITEMS
                                          : (a.M - r0 > 0 ? a.M - r0 : 0));
  const bool full = a.vec && nin == ITEMS;
  const int k0 = t * ITEMS;

  // ---- the tile: values to shared memory, flags to bit masks ----
  for (int c = 0; c < K; ++c)
    copy_rows<ITEMS>(s_val + c * TILE + k0, a.val[c] + r0, nin, full);
  unsigned fm[MAXFL] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int f = 0; f < MAXFL; ++f)
    if (f < a.nflags) fm[f] = flag_bits<ITEMS>(a.flag[f] + r0, nin, full);
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // ---- per channel: fold my rows, reduce the warp in scan order ----
  for (int c = 0; c < K; ++c) {
    const V* sv = s_val + c * TILE + k0;
    const unsigned fb = pick(fm, a.fid[c]);
    int sf;
    V s;
    switch (a.op[c]) {
      case OP_SUM: warp_total<OP_SUM, REV, ITEMS>(sv, fb, nin, lane, sf, s);
                   break;
      case OP_MAX: warp_total<OP_MAX, REV, ITEMS>(sv, fb, nin, lane, sf, s);
                   break;
      case OP_MIN: warp_total<OP_MIN, REV, ITEMS>(sv, fb, nin, lane, sf, s);
                   break;
      default: warp_total<OP_LAST, REV, ITEMS>(sv, fb, nin, lane, sf, s);
    }
    if (lane == 0) {
      s_wf[c][warp] = sf;
      s_wv[c][warp] = s;
    }
  }
  __syncthreads();

  // ---- warp 0: warp prefixes, the tile's aggregate, look-back ----
  if (warp == 0) {
    constexpr int H = sizeof(V) / 4;
    const int opc = lane < K ? a.op[lane] : OP_SUM;
    int tf = 0;
    V tv = ident_of<V>(opc);
    if (lane < K) {
      for (int j = 0; j < NWARP; ++j) {
        const int w = REV ? NWARP - 1 - j : j;
        const int f2 = s_wf[lane][w];
        const V v2 = s_wv[lane][w];
        s_wf[lane][w] = tf;
        s_wv[lane][w] = tv;
        combine(opc, tf, tv, f2, v2, tf, tv);
      }
      publish(a.words, ticket, K, lane, ticket == 0 ? ST_INCL : ST_AGG, tf,
              tv);
    }
    // lane c < K: channel c's exclusive prefix, the windows combined
    int xf = 0;
    V xv = ident_of<V>(opc);
    bool done = ticket == 0 || lane >= K;
    for (int hi = ticket - 1; __any_sync(FULL, !done); hi -= 32) {
      // lane j: the words of tile hi - j, each reloaded until published
      // (a int64 value's two halves in one state)
      const int q = hi - lane;
      const u64* src = a.words + 1 + (size_t)(q > 0 ? q : 0) * K * H;
      u64 w[LBW<V>];
#pragma unroll
      for (int i = 0; i < LBW<V>; ++i) w[i] = 0;
      for (bool ready = q < 0; !ready;) {
        ready = true;
#pragma unroll
        for (int i = 0; i < LBW<V>; ++i)
          if (i < K * H && (w[i] >> 33) == 0) w[i] = ld_relaxed(src + i);
#pragma unroll
        for (int i = 0; i < LBW<V>; ++i) {
          if (i >= K * H) continue;
          if ((w[i] >> 33) == 0) ready = false;
          if (H == 2 && (i & 1) && (w[i] >> 33) != (w[i - 1] >> 33)) {
            w[i] = w[i - 1] = 0;
            ready = false;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LBW<V>; ++i)
        if (i < K * H) s_lw[lane][i] = w[i];
      __syncwarp();
      // lane c walks its column from the nearest tile: each is earlier in
      // scan order than those before it, and an inclusive prefix ends it
      if (!done) {
        for (int j = 0; j < 32 && hi - j >= 0; ++j) {
          const u64 w0 = s_lw[j][lane * H];
          u64 bits = w0 & 0xFFFFFFFFull;
          if (H == 2) bits |= (s_lw[j][lane * H + 1] & 0xFFFFFFFFull) << 32;
          combine(opc, (int)(w0 >> 32) & 1, (V)bits, xf, xv, xf, xv);
          if ((w0 >> 33) == ST_INCL) {
            done = true;
            break;
          }
        }
      }
      __syncwarp();
    }
    if (lane < K) {
      if (ticket > 0) {
        int pf;
        V pv;
        combine(opc, xf, xv, tf, tv, pf, pv);
        publish(a.words, ticket, K, lane, ST_INCL, pf, pv);
      }
      // the prefix of each warp's rows: the tile's, then the warps' before
      for (int w = 0; w < NWARP; ++w)
        combine(opc, xf, xv, s_wf[lane][w], s_wv[lane][w], s_wf[lane][w],
                s_wv[lane][w]);
    }
  }
  __syncthreads();

  // ---- per channel: scan the warp, rescan my rows, store ----
  for (int c = 0; c < K; ++c) {
    const V* sv = s_val + c * TILE + k0;
    const unsigned fb = pick(fm, a.fid[c]);
    const int pf = s_wf[c][warp];
    const V pv = s_wv[c][warp];
    V* dst = a.out[c] + r0;
    switch (a.op[c]) {
      case OP_SUM: rescan<OP_SUM, REV, ITEMS>(sv, fb, nin, lane, pf, pv, dst,
                                              full);
                   break;
      case OP_MAX: rescan<OP_MAX, REV, ITEMS>(sv, fb, nin, lane, pf, pv, dst,
                                              full);
                   break;
      case OP_MIN: rescan<OP_MIN, REV, ITEMS>(sv, fb, nin, lane, pf, pv, dst,
                                              full);
                   break;
      default: rescan<OP_LAST, REV, ITEMS>(sv, fb, nin, lane, pf, pv, dst,
                                           full);
    }
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename V, int ITEMS, bool REV>
static cudaError_t launch(ScanArgs<V>& a, int cap, cudaStream_t s) {
  constexpr int TILE = THREADS * ITEMS;
  a.nblk = (int)((a.M + TILE - 1) / TILE);
  if (a.nblk > cap) return cudaErrorInvalidValue;
  const size_t shm = (size_t)a.nch * TILE * sizeof(V);
  auto kern = scan_kernel<V, ITEMS, REV>;
  // the static arrays count against the 48 KB default too, so the limit
  // is raised for every size
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (e != cudaSuccess) return e;
  kern<<<a.nblk, THREADS, shm, s>>>(a);
  return cudaGetLastError();
}

template <typename V, int ITEMS>
static cudaError_t launch_dir(ScanArgs<V>& a, int cap, cudaStream_t s) {
  return a.reverse ? launch<V, ITEMS, true>(a, cap, s)
                   : launch<V, ITEMS, false>(a, cap, s);
}

template <typename V>
static cudaError_t launch_v(const void* vals, const void* outs,
                            const void* flags, const int* ops,
                            const int* fids, int nch, int nflags, long long M,
                            int reverse, void* words, int cap,
                            cudaStream_t s) {
  ScanArgs<V> a;
  a.nch = nch;
  a.nflags = nflags;
  a.reverse = reverse != 0;
  a.M = M;
  a.vec = 1;
  const V* const* vp = (const V* const*)vals;
  V* const* op_ = (V* const*)outs;
  const int* const* fp = (const int* const*)flags;
  for (int c = 0; c < MAXCH; ++c) {
    a.val[c] = c < nch ? vp[c] : nullptr;
    a.out[c] = c < nch ? op_[c] : nullptr;
    a.op[c] = c < nch ? ops[c] : OP_SUM;
    a.fid[c] = c < nch ? fids[c] : -1;
    if (c < nch) a.vec &= aligned16(a.val[c]) && aligned16(a.out[c]);
  }
  for (int f = 0; f < MAXFL; ++f) {
    a.flag[f] = f < nflags ? fp[f] : nullptr;
    if (f < nflags) a.vec &= aligned16(a.flag[f]);
  }
  a.words = (u64*)words;
  // 4,096-row tiles where the values fit 96 KB of shared memory (up to 6
  // int32 channels, the int64 one; two CTAs an SM), else 2,048 (104 KB at
  // 13 channels, two CTAs an SM)
  if ((size_t)nch * sizeof(V) * THREADS * 16 <= 96 * 1024)
    return launch_dir<V, 16>(a, cap, s);
  if constexpr (sizeof(V) == 4) return launch_dir<V, 8>(a, cap, s);
  return cudaErrorInvalidValue;   // an int64 call has one channel
}

// vals/outs/flags: host arrays of device pointers; ops/fids: host int
// arrays (fid -1 = not segmented).  wide: one int64 channel (op sum), else
// int32 channels.  words: device uint64 [1 + cap * nch * (wide ? 2 : 1)],
// zero; cap >= the tiles of M (ceil(M / fused_scan_tile_min())).
extern "C" int fused_scan_launch(const void* vals, const void* outs,
                                 const void* flags, const void* ops,
                                 const void* fids, int nch, int nflags,
                                 long long M, int reverse, int wide,
                                 void* words, int cap, void* stream) {
  if (nch < 1 || nch > MAXCH || nflags < 0 || nflags > MAXFL || M < 1 ||
      (wide && nch != 1))
    return (int)cudaErrorInvalidValue;
  const int* opc = (const int*)ops;
  const int* fic = (const int*)fids;
  for (int c = 0; c < nch; ++c)
    if (opc[c] < OP_SUM || opc[c] > OP_LAST || fic[c] >= nflags ||
        fic[c] < -1 || (wide && opc[c] != OP_SUM))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? launch_v<long long>(vals, outs, flags, opc, fic, nch,
                                          nflags, M, reverse, words, cap, s)
                    : launch_v<int>(vals, outs, flags, opc, fic, nch, nflags,
                                    M, reverse, words, cap, s));
}

// the smallest tile launch_v cuts M into, so the caller can size `words`
extern "C" int fused_scan_tile_min() { return THREADS * 8; }
