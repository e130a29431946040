// Per-slot fold of integer values for sm_90a (kernel 4 of the port).
//
// Replaces no TPU kernel: the JAX package leaves its GROUP BYs' integer
// sums, counts, minima and maxima to XLA's scatters, and the port's first
// form called PyTorch's index_add_ and scatter_reduce_ (ops/aggregate.py
// SegmentSum, segment_minmax). Those calls take one atomic per row, and the
// GROUP BYs send most rows to one address: a GROUP BY-less aggregate maps
// every row to slot 0, and a filtered GROUP BY maps every dead row (past the
// live prefix, or null) to the drop slot H. Atomics serialised on one
// address run at ~1.35 G/s, so a call over 2^25 rows took ~25 ms whatever
// its groups (PERF.md).
//
// out[s] = fold over the rows i < min(n, *num_rows) with gid[i] == s of
// values[i] (1 for a count), for 0 <= s < H; out holds each op's identity
// on entry (the wrapper fills it). Integer adds (wrapping mod 2^k, as
// index_add_'s do), minima and maxima give the same result in any order,
// so the fold is exact and run-to-run identical.
//
// What bounds it on the card. The row stream: a group id (4 or 8 bytes) and
// a value (1-8 bytes) a live row, read once, and each output slot written
// once. At 2^25 rows of int64 ids and values that is 537 MB, 0.16 ms at
// 3.35 TB/s. Where many rows share a slot, the atomics on that slot bind
// instead; where nearly every row has a slot of its own in a table larger
// than L2 (2^26 slots of 8 bytes), the random read-modify-writes of the
// output do.
//
// What the design does about it.
// 1. A row that adds nothing takes no atomic: the row loop ends at the live
//    prefix, read on the card from num_rows (no host read), and a row whose
//    group id is outside [0, H) (the drop slot H) is skipped. The grid is
//    sized from the capacity n, as the host knows it; blocks past the
//    prefix exit at once.
// 2. Rows of one slot are combined on chip before any global atomic. In a
//    warp, lanes with one group id are grouped with __match_any_sync. Where
//    the warp holds few slots of many lanes each (a GROUP BY-less aggregate:
//    one), each slot's values are reduced with redux.sync (int64: the sum
//    in three 22-bit chunks, the minimum or maximum as high word then low
//    word), and the slot's first lane folds the warp's value. Where it holds
//    many slots (13 hot groups in 32 rows), those reductions would run one
//    slot after another, so every lane folds its own value: its atomic
//    meets only the few lanes of its own slot. The fold goes to shared
//    memory:
//    - "direct", where the block's H accumulators fit in kDirectBytes of
//      shared memory (every GROUP BY-less aggregate: H = 8): one
//      accumulator a slot, in a copy of its own for each warp where the
//      copies fit, so that the block's warps do not contend on a hot slot;
//    - "cache" otherwise: a table of kCacheSlots accumulators, each taken
//      for good by the first slot that claims it (atomicCAS on its tag),
//      looked up from gid & (kCacheSlots - 1) over kProbe entries; a slot
//      that finds none goes to device memory (min/max only when a read of
//      the word shows it would change it). It serves a table that the
//      planner sized far above its groups: 1,320 groups in 2^18 slots over
//      30 M rows fold in 0.31 ms with it and 3.2 ms with every slot in
//      device memory (H100); near-distinct ids gain nothing from it, and
//      lose ~0.07 ms a launch to its probes at 50,000-200,000 groups.
//    A persistent grid (as many blocks as the card holds at once) walks the
//    rows, so each block flushes its accumulators once: one global atomic
//    per block per slot it touched.
// 3. Values are read in place in their own width (1, 2, 4 or 8 bytes,
//    signed, or unsigned for bool and uint8), widened in registers to the
//    accumulator (int32 for up to 4 bytes, int64 for 8); the wrapper
//    narrows the result back. No copy of any input is made.
// Every warp intrinsic sits in a loop whose trip count is uniform across the
// warp (lanes past the end are inactive), so each mask names exactly the
// lanes that execute it.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the first error it met), which the Python
// wrapper raises on.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// "direct" when a block's H accumulators take at most this many bytes
constexpr long long kDirectBytes = 32 * 1024;
// "cache": accumulators a block keeps for its hot slots, and the entries a
// slot looks at before it goes to device memory
constexpr int kCacheSlots = 1024;
constexpr int kProbe = 4;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
// how a value is stored: none (a count adds 1), unsigned 1 byte (bool,
// uint8), signed 1, 2, 4 or 8 bytes (ops/hash_kernels.py _FOLD_KINDS)
enum Kind { kNone = 0, kU8 = 1, kI8 = 2, kI16 = 3, kI32 = 4, kI64 = 5 };

struct Fold {
  const void* gid;  // [n] int32 or int64
  const void* values;  // [n] of `kind`, null for a count
  const int* num_rows;  // [1] the live prefix, or null: all n rows
  void* out;  // [H] accumulators (int32 or int64), holding the identity
  long long n;
  long long h;
  long long ident;  // the op's identity in the accumulator's type
  int gid_bytes;  // 4 or 8
  int kind;
  int direct;  // 1: one shared accumulator a slot; 0: the hot-slot cache
};

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ long long load_gid(const Fold& f, long long i) {
  return f.gid_bytes == 8 ? __ldcs(static_cast<const long long*>(f.gid) + i)
                          : __ldcs(static_cast<const int*>(f.gid) + i);
}

template <typename A>
__device__ __forceinline__ A load_value(const Fold& f, long long i) {
  switch (f.kind) {  // the same kind in every lane
    case kU8: return static_cast<A>(
        __ldcs(static_cast<const unsigned char*>(f.values) + i));
    case kI8: return static_cast<A>(
        __ldcs(static_cast<const signed char*>(f.values) + i));
    case kI16: return static_cast<A>(
        __ldcs(static_cast<const short*>(f.values) + i));
    case kI32: return static_cast<A>(
        __ldcs(static_cast<const int*>(f.values) + i));
    case kI64: return static_cast<A>(
        __ldcs(static_cast<const long long*>(f.values) + i));
    default: return static_cast<A>(1);
  }
}

// The lanes of `grp` (one slot) reduced to one value, known to every lane.
template <int kOp>
__device__ __forceinline__ int warp_fold(unsigned grp, int v) {
  if (kOp == kSum) {
    return static_cast<int>(__reduce_add_sync(grp, static_cast<unsigned>(v)));
  }
  return kOp == kMin ? __reduce_min_sync(grp, v) : __reduce_max_sync(grp, v);
}

template <int kOp>
__device__ __forceinline__ long long warp_fold(unsigned grp, long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  if (kOp == kSum) {
    // three chunks of at most 22 bits: 32 lanes' chunk sums fit 32 bits,
    // and the chunks recombine to the sum mod 2^64
    constexpr unsigned long long kLow22 = (1ull << 22) - 1;
    const unsigned long long c0 =
        __reduce_add_sync(grp, static_cast<unsigned>(u & kLow22));
    const unsigned long long c1 =
        __reduce_add_sync(grp, static_cast<unsigned>((u >> 22) & kLow22));
    const unsigned long long c2 =
        __reduce_add_sync(grp, static_cast<unsigned>(u >> 44));
    return static_cast<long long>(c0 + (c1 << 22) + (c2 << 44));
  }
  // signed order: the high words (signed), then among the lanes that hold
  // the winning high word, the low words (unsigned)
  const int hi = static_cast<int>(u >> 32);
  const unsigned lo = static_cast<unsigned>(u);
  int whi;
  unsigned wlo;
  if (kOp == kMin) {
    whi = __reduce_min_sync(grp, hi);
    wlo = __reduce_min_sync(grp, hi == whi ? lo : 0xffffffffu);
  } else {
    whi = __reduce_max_sync(grp, hi);
    wlo = __reduce_max_sync(grp, hi == whi ? lo : 0u);
  }
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(whi)) << 32) |
      wlo);
}

// a + b wrapping mod 2^32 (2^64), as the atomics add
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ void atomic_fold(int* p, int v, int op) {
  if (op == kSum) atomicAdd(p, v);
  else if (op == kMin) atomicMin(p, v);
  else atomicMax(p, v);
}

__device__ __forceinline__ void atomic_fold(long long* p, long long v,
                                            int op) {
  if (op == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  } else if (op == kMin) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

// Into shared memory. An int64 sum adds two 32-bit words, the low word's
// carry into the high one: shared memory has no 64-bit add, and its
// compare-and-swap loop serialises the lanes of a hot slot. Exact mod 2^64:
// the high word gains one for every time the low word wraps.
__device__ __forceinline__ void shared_fold(int* p, int v, int op) {
  atomic_fold(p, v, op);
}

__device__ __forceinline__ void shared_fold(long long* p, long long v,
                                            int op) {
  if (op != kSum) {
    atomic_fold(p, v, op);
    return;
  }
  const unsigned long long u = static_cast<unsigned long long>(v);
  unsigned* w = reinterpret_cast<unsigned*>(p);  // little-endian: low first
  const unsigned lo = static_cast<unsigned>(u);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = static_cast<unsigned>(u >> 32) + (old + lo < old);
  if (hi) atomicAdd(w + 1, hi);
}

// Into device memory: a minimum or maximum only when a read of the word (at
// L2) shows it would change it. Exact while every write to the word in the
// launch is the same op: the word only falls (rises).
template <typename A>
__device__ __forceinline__ void global_fold(A* p, A v, int op) {
  if (op == kMin && !(v < __ldcg(p))) return;
  if (op == kMax && !(v > __ldcg(p))) return;
  atomic_fold(p, v, op);
}

// Copies of the direct strategy's H accumulators in a block: one a warp
// where they fit kDirectBytes (warps then contend only inside themselves),
// fewer for larger H.
__host__ __device__ __forceinline__ int direct_copies(long long h,
                                                      int acc_bytes) {
  const long long fit = kDirectBytes / (h * acc_bytes);
  return static_cast<int>(fit < kThreads / 32 ? fit : kThreads / 32);
}

template <typename A, int kOp>
__global__ void __launch_bounds__(kThreads) group_fold(Fold f) {
  extern __shared__ __align__(16) unsigned char smem[];
  // direct: [copies][h], this warp's copy at mine; cache: [kCacheSlots]
  A* acc = reinterpret_cast<A*>(smem);
  int* tag = reinterpret_cast<int*>(acc + kCacheSlots);  // cache: slot or -1
  const A ident = static_cast<A>(f.ident);
  const int copies = f.direct ? direct_copies(f.h, sizeof(A)) : 1;
  A* mine = acc + (threadIdx.x >> 5) % copies * f.h;
  const long long entries = f.direct ? f.h : kCacheSlots;
  for (long long e = threadIdx.x; e < entries * copies; e += blockDim.x) {
    acc[e] = ident;
    if (!f.direct) tag[e] = -1;
  }
  __syncthreads();

  long long m = f.n;
  if (f.num_rows != nullptr) {
    const long long live = *f.num_rows;
    m = live < 0 ? 0 : (live < m ? live : m);
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < m; base += stride) {
    const long long i = base + threadIdx.x;
    long long g = -1;
    if (i < m) g = load_gid(f, i);
    const bool take = static_cast<unsigned long long>(g) <
                      static_cast<unsigned long long>(f.h);
    const unsigned act = __ballot_sync(kFull, take);
    if (!take) continue;
    A r = f.kind == kNone ? static_cast<A>(1) : load_value<A>(f, i);
    const int s = static_cast<int>(g);
    const unsigned grp = __match_any_sync(act, s);
    const bool leader = lane_id() == static_cast<unsigned>(__ffs(grp) - 1);
    // A warp of few slots, each of many lanes (every row of a GROUP BY-less
    // aggregate in one), reduces each slot's lanes first: one redux.sync a
    // slot (three for an int64 sum). A warp of many slots does not: its
    // slots' reductions would run one after another, while its lanes'
    // atomics below conflict only as often as one slot's lanes.
    const int slots = __popc(__ballot_sync(act, leader));
    if (__reduce_max_sync(act, __popc(grp)) > slots) {
      r = warp_fold<kOp>(grp, r);
      if (!leader) continue;
    }
    if (f.direct) {
      shared_fold(&mine[s], r, kOp);
      continue;
    }
    bool held = false;
    for (int k = 0; k < kProbe && !held; ++k) {
      const int e = (s + k) & (kCacheSlots - 1);
      int t = *reinterpret_cast<volatile int*>(&tag[e]);
      if (t == -1) {
        t = atomicCAS(&tag[e], -1, s);
        if (t == -1) t = s;
      }
      if (t == s) {
        shared_fold(&acc[e], r, kOp);
        held = true;
      }
    }
    if (!held) global_fold(static_cast<A*>(f.out) + s, r, kOp);
  }
  __syncthreads();

  A* out = static_cast<A*>(f.out);
  for (long long e = threadIdx.x; e < entries; e += blockDim.x) {
    A v = acc[e];
    for (int c = 1; c < copies; ++c) {
      const A w = acc[c * f.h + e];
      v = kOp == kSum ? wrap_add(v, w)
                      : (kOp == kMin ? (w < v ? w : v) : (w > v ? w : v));
    }
    if (v == ident) continue;
    global_fold(out + (f.direct ? e : tag[e]), v, kOp);
  }
}

// The launch of one instantiation: as many blocks as the card holds at
// once, at most one a kThreads rows of the capacity.
template <typename A, int kOp>
cudaError_t launch(const Fold& f, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&group_fold<A, kOp>);
  const size_t smem =
      f.direct ? static_cast<size_t>(f.h) * sizeof(A) *
                     direct_copies(f.h, sizeof(A))
               : kCacheSlots * (sizeof(A) + sizeof(int));
  cudaError_t err;
  int dev = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, smem)))
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  long long blocks = (f.n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm) * sms;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  group_fold<A, kOp><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(f);
  return cudaGetLastError();
}

template <typename A>
cudaError_t launch_op(const Fold& f, int op, cudaStream_t stream) {
  switch (op) {
    case kSum: return launch<A, kSum>(f, stream);
    case kMin: return launch<A, kMin>(f, stream);
    case kMax: return launch<A, kMax>(f, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* dftpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel 4: out [h] (int32 when acc_bytes is 4, int64 when 8; each op's
// identity on entry) folds, per slot, the rows i < min(n, *num_rows) (all n
// when num_rows is null) whose gid [n] (int32 or int64, gid_bytes) lies in
// [0, h): values [n] of `kind` (null with kind 0: a count) widened to the
// accumulator, by op (0 sum, 1 min, 2 max). The strategy is "direct" when
// h accumulators of acc_bytes fit kDirectBytes. All pointers are device
// memory; 1 <= h < 2^31.
int dftpu_group_fold(const void* gid, int gid_bytes, const void* values,
                     int kind, const int* num_rows, long long n, long long h,
                     int op, int acc_bytes, long long ident, void* out,
                     void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || h < 1 || h > INT_MAX || (gid_bytes != 4 && gid_bytes != 8) ||
      kind < kNone || kind > kI64 || (kind == kNone) != (values == nullptr) ||
      (acc_bytes != 4 && acc_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Fold f{};
  f.gid = gid;
  f.values = values;
  f.num_rows = num_rows;
  f.out = out;
  f.n = n;
  f.h = h;
  f.ident = ident;
  f.gid_bytes = gid_bytes;
  f.kind = kind;
  f.direct = h * acc_bytes <= kDirectBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = acc_bytes == 8 ? launch_op<long long>(f, op, st)
                                         : launch_op<int>(f, op, st);
  return static_cast<int>(err);
}

}  // extern "C"
