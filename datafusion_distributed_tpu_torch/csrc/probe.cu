// Multi-table hash probe for sm_90a (kernel 2 of the port).
//
// Replaces pallas_multiway_probe (datafusion_distributed_tpu/ops/pallas_hash.py:259).
// Every (row, table) pair walks table k's open-addressed chain from its
// slot0: linear probing, stop at an empty slot (absent, -1) or at a slot
// whose key lanes all equal the row's (found: the slot), and flag table k
// as overflowed when a chain is still unresolved after max_rounds steps.
// The tables are read-only; K = 1 is the hash-join probe.
//
// What bounds it on the card.
// - HBM bytes of the row stream. Per active (row, table) pair: 4L bytes of
//   key lanes and 4 of slot0 in; per pair 1 byte of active in and 4 of found
//   out. At 8,388,608 rows, 72% active and L = 1 that is 100 MB, 30 us at
//   3.35 TB/s: the whole bytes bound but for the table itself.
// - L2 sectors of the random table reads. A step of a chain reads one
//   32-byte sector of used[] and, for a used slot, one of the key lanes. The
//   table fits the 50 MB L2 (2^21 slots at L = 1: 10.5 MB), but ~6 M active
//   probes of one to a few steps each are millions of random sectors, and on
//   the H100 one random read per active pair, as a library gather, already
//   takes more than the bytes bound (PERF.md). This is what binds.
// - Latency. A chain's steps are dependent reads, and linear probing at a
//   load of 0.7 gives chains of one to a few dozen steps.
//
// What the design does about each.
// 1. Table descriptors travel by value: per table a pointer to its key lanes
//    and used flags and its slot mask, in a struct passed as the kernel
//    parameter (and copied to shared memory by each block). No host-to-device
//    copy per launch, no 64-bit modulo. A launch takes at most kMaxTables
//    tables; the wrapper launches once per group of tables.
// 2. The (row, table) pairs are walked in chunks of kRows pairs a thread,
//    coalesced (pair j of a thread is chunk + j * threads + thread), so K > 1
//    reads the row stream as contiguously as K = 1. Keys and slot0 are read
//    only for active pairs (the padded tail of a table costs one byte a
//    row). A thread walks its kRows chains in lock step, with a trip count
//    uniform across the warp, and issues a step's reads of all its chains
//    before it compares any. Two chains a thread at 256 threads a block
//    measured best (more chains cost registers and so occupancy, and a warp
//    waits for its longest chain). On the L2 route a step reads the used
//    flag first and the key lanes only of a used slot: reading both at once
//    saves a round trip but costs a sector for every empty slot, and the
//    sectors, not the round trips, bind (PERF.md). With one table (every
//    hash-join probe) the table's descriptor stays in registers.
// 3. The row stream is read with streaming loads (ld.global.cs: evict-first),
//    the tables through the read-only path. An L2 evict_last policy on the
//    table reads measured no faster (PERF.md), so there is none.
// 4. Two routes, chosen by the wrapper from the tables' bytes:
//    - shared memory (probe_smem): when all of a launch's tables (key lanes
//      and used flags) fit a block's dynamic shared memory, a persistent grid
//      of blocks each loads them once with bulk copies (cp.async.bulk,
//      completion on an mbarrier), then walks its pairs and probes from
//      shared memory: the random reads leave L2 altogether;
//    - L2 (probe_l2): everything else. Its variant with packed records
//      (pack_records, then probe_l2 with kL2Packed) first copies each slot's
//      key lanes and used flag into one record of 2 or 4 ints, so a step
//      reads one sector, with no read behind another; the packing pass
//      reads and writes the whole table, so the wrapper takes it only for a
//      probe with many pairs per table slot (ops/hash_kernels.py).
//    A route the card refuses (shared memory, grid) is an error; neither
//    route falls back to the other.
// 5. Overflow: one flag per lane per table, reduced in the block with
//    __syncthreads_or and stored once per block (only a set flag is stored,
//    over flags the entry point zero-filled on the stream).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns the first CUDA error it met (0 when none), which the Python
// wrapper raises on.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTables = 8;  // ops/hash_kernels.py MAX_TABLES_PER_LAUNCH
constexpr int kRows = 2;  // pairs a thread walks at once
constexpr unsigned kFull = 0xffffffffu;
// most (row, table) pairs of a probe: pair numbers, a grid stride past the
// last pair included, stay int32 (ops/hash_kernels.py MAX_PAIRS)
constexpr long long kMaxPairs = (1LL << 31) - (1LL << 23);
constexpr int kL2Threads = 256;
constexpr int kSmemThreads = 1024;
constexpr int kPackThreads = 256;

enum Route { kL2 = 0, kL2Packed = 1, kSmem = 2 };

struct Table {
  const int* keys;  // [H, lanes] key lanes, or [H, rec] records (kL2Packed)
  const unsigned char* used;  // [H]
  int mask;  // H - 1
  int first;  // the table's first slot within the launch's span of slots
};

struct Probe {
  const int* keys;  // [n, ktotal, lanes]
  const int* slot0;  // [n, ktotal]
  const unsigned char* active;  // [n, ktotal]
  int* found;  // [n, ktotal]
  unsigned char* over;  // [ktotal]
  long long n;
  int ktotal;  // tables of the whole probe
  int k0;  // the launch's first table
  int ntab;  // tables of this launch
  int lanes;
  int max_rounds;
  // shared-memory route: the launch's span of key lanes and of used flags,
  // each widened to 16-byte boundaries for the bulk copies
  const void* keys_span;
  const void* used_span;
  unsigned keys_bytes;
  unsigned used_bytes;
  int keys_shift;  // ints from keys_span to the span's first slot
  int used_shift;  // bytes from used_span to the span's first slot
  Table tab[kMaxTables];
};

// ---------------------------------------------------------------------------
// loads

// table reads: the read-only path (ld.global.nc)
__device__ __forceinline__ int ld_table(const int* p) { return __ldg(p); }

__device__ __forceinline__ unsigned ld_table_u8(const unsigned char* p) {
  return __ldg(p);
}

__device__ __forceinline__ int2 ld_table_v2(const int* p) {
  return __ldg(reinterpret_cast<const int2*>(p));
}

__device__ __forceinline__ int4 ld_table_v4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ints per packed record: the key lanes, then the used flag
__host__ __device__ constexpr int record_ints(int lanes) {
  return lanes == 1 ? 2 : 4;
}

// ---------------------------------------------------------------------------
// the walk

// One slot's used flag and (kL > 0) key lanes, from the route's table (the
// L2 route with kL > 0 reads them in probe_chunk, key lanes after the flag).
template <int kL, int kRoute>
__device__ __forceinline__ void fetch(const Table& t, int s, const int* skeys,
                                      const unsigned char* sused,
                                      unsigned& used,
                                      int (&lane)[kL > 0 ? kL : 1]) {
  if constexpr (kRoute == kSmem) {
    const int at = t.first + s;
    used = sused[at];
    if constexpr (kL > 0) {
#pragma unroll
      for (int l = 0; l < kL; ++l) lane[l] = skeys[at * kL + l];
    }
  } else if constexpr (kRoute == kL2Packed) {
    const int* r = t.keys + static_cast<long long>(s) * record_ints(kL);
    if constexpr (kL == 1) {
      const int2 v = ld_table_v2(r);
      lane[0] = v.x;
      used = static_cast<unsigned>(v.y);
    } else {
      const int4 v = ld_table_v4(r);
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int l = 0; l < kL; ++l) lane[l] = w[l];
      used = static_cast<unsigned>(w[kL]);
    }
  } else {  // L2, runtime lane count: lanes_equal reads the key lanes
    used = ld_table_u8(t.used + s);
  }
}

// Runtime lane count (kL == 0): compare lane by lane, the probe row's lanes
// read through L1 at each step.
template <int kRoute>
__device__ __forceinline__ bool lanes_equal(const Probe& p, const Table& t,
                                            int s, const int* skeys,
                                            long long col) {
  const int* mine = p.keys + col * p.lanes;
  bool m = true;
  for (int l = 0; l < p.lanes && m; ++l) {
    int v;
    if constexpr (kRoute == kSmem) {
      v = skeys[(t.first + s) * p.lanes + l];
    } else {
      v = ld_table(t.keys + static_cast<long long>(s) * p.lanes + l);
    }
    m = v == __ldg(mine + l);
  }
  return m;
}

// The (row, table) pairs of a launch are numbered row-major: pair t is row
// t / ntab against the launch's table k = t % ntab, at column `col` of the
// [n, ktotal] arrays (the wrapper keeps n * ktotal below 2^31).
__device__ __forceinline__ int pair_col(const Probe& p, int t, int& k) {
  const int row = p.ntab == 1 ? t : t / p.ntab;
  k = t - row * p.ntab;
  return row * p.ktotal + p.k0 + k;
}

// One chunk of a thread's pairs: pair j is chunk + j * kThreads + threadIdx.x
// (coalesced for each j), its active flag, and for active pairs its slot0
// and key lanes.
template <int kL>
struct Rows {
  static constexpr int kKeys = kL > 0 ? kL : 1;
  bool act[kRows];
  int s[kRows];
  int key[kRows][kKeys];
};

template <int kThreads>
__device__ __forceinline__ void load_flags(const Probe& p, int npairs, int c,
                                           bool (&act)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int t = c + j * kThreads + static_cast<int>(threadIdx.x);
    int k;
    act[j] = t < npairs && __ldcs(p.active + pair_col(p, t, k)) != 0;
  }
}

template <int kL, int kThreads>
__device__ __forceinline__ void load_values(const Probe& p, int c,
                                            Rows<kL>& r) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!r.act[j]) continue;
    int k;
    const int col = pair_col(p, c + j * kThreads + static_cast<int>(threadIdx.x), k);
    r.s[j] = __ldcs(p.slot0 + col);
    if constexpr (kL > 0) {
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        r.key[j][l] = __ldcs(p.keys + static_cast<long long>(col) * kL + l);
      }
    }
  }
}

// Walk the chains of one chunk's pairs in lock step, with a trip count
// uniform across the warp (a warp vote ends it), and store every pair's
// found slot: every step first issues the used flag and key lanes of all
// the thread's unresolved pairs as independent loads, then compares them.
// With one table (kOne) its descriptor stays in registers; else each pair
// reads its table's from shared memory.
template <int kL, int kRoute, int kThreads, bool kOne>
__device__ __forceinline__ void probe_chunk(const Probe& p, const Table* tabs,
                                            const int* skeys,
                                            const unsigned char* sused,
                                            int npairs, int c,
                                            Rows<kL>& r, unsigned& over) {
  constexpr int kKeys = kL > 0 ? kL : 1;
  const Table one = tabs[0];
  bool go[kRows];
  int res[kRows], col[kRows], table[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    go[j] = r.act[j];
    res[j] = -1;
    table[j] = 0;
    const int t = c + j * kThreads + static_cast<int>(threadIdx.x);
    col[j] = t < npairs ? pair_col(p, t, table[j]) : -1;
  }
  for (int step = 0; step < p.max_rounds; ++step) {
    unsigned used[kRows];
    int got[kRows][kKeys];
    if constexpr (kRoute == kL2 && kL > 0) {
      // the used flags first; key lanes only of used slots (an empty slot's
      // key lanes would cost one more L2 sector)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (go[j]) used[j] = ld_table_u8((kOne ? one : tabs[table[j]]).used +
                                         r.s[j]);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!go[j] || !used[j]) continue;
        const int* k = (kOne ? one : tabs[table[j]]).keys +
                       static_cast<long long>(r.s[j]) * kL;
#pragma unroll
        for (int l = 0; l < kL; ++l) got[j][l] = ld_table(k + l);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {  // all loads first ...
        if (go[j]) fetch<kL, kRoute>(kOne ? one : tabs[table[j]], r.s[j],
                                     skeys, sused, used[j], got[j]);
      }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {  // ... then every compare
      if (!go[j]) continue;
      const Table& t = kOne ? one : tabs[table[j]];
      bool match = used[j] != 0;
      if constexpr (kL > 0) {
#pragma unroll
        for (int l = 0; l < kL; ++l) match &= got[j][l] == r.key[j][l];
      } else if (match) {
        match = lanes_equal<kRoute>(p, t, r.s[j], skeys, col[j]);
      }
      if (match) {
        res[j] = r.s[j];
        go[j] = false;
      } else if (used[j] == 0) {
        go[j] = false;  // an empty slot: the key is absent
      } else {
        r.s[j] = (r.s[j] + 1) & t.mask;
      }
      any |= go[j];
    }
    // every lane of the warp is here: the chunk loop is uniform in the block
    if (!__any_sync(kFull, any)) break;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (go[j]) over |= 1u << table[j];  // unresolved after max_rounds
    if (col[j] >= 0) __stcs(p.found + col[j], res[j]);
  }
}

// Walk the block's chunks of pairs (grid-stride), one at a time: load the
// chunk's flags, then its active pairs' slot0 and key lanes, then walk their
// chains. Then reduce the overflow flags in the block and store them once
// per block, so every thread of the block calls this.
template <int kL, int kRoute, int kThreads, bool kOne>
__device__ __forceinline__ void walk(const Probe& p, const Table* tabs,
                                     const int* skeys,
                                     const unsigned char* sused) {
  const int npairs = static_cast<int>(p.n) * p.ntab;
  const int chunk = kRows * kThreads;
  const int stride = chunk * static_cast<int>(gridDim.x);
  unsigned over = 0;  // bit k: a chain of table k ran out of rounds
  // c and the trip count are the same in every thread of the block
  for (int c = static_cast<int>(blockIdx.x) * chunk; c < npairs; c += stride) {
    Rows<kL> r;
    load_flags<kThreads>(p, npairs, c, r.act);
    load_values<kL, kThreads>(p, c, r);
    probe_chunk<kL, kRoute, kThreads, kOne>(p, tabs, skeys, sused, npairs, c,
                                            r, over);
  }
  for (int k = 0; k < p.ntab; ++k) {
    if (__syncthreads_or((over >> k) & 1u) && threadIdx.x == 0) {
      p.over[p.k0 + k] = 1;
    }
  }
}

template <int kL, int kRoute, int kThreads>
__device__ __forceinline__ void walk_tables(const Probe& p, const Table* tabs,
                                            const int* skeys,
                                            const unsigned char* sused) {
  if (p.ntab == 1) {  // every hash-join probe
    walk<kL, kRoute, kThreads, true>(p, tabs, skeys, sused);
  } else {
    walk<kL, kRoute, kThreads, false>(p, tabs, skeys, sused);
  }
}

// The launch's table descriptors, copied to shared memory: a thread's pairs
// may be of different tables.
__device__ __forceinline__ void load_tables(const Probe& p, Table* tabs) {
  if (static_cast<int>(threadIdx.x) < p.ntab) {
    tabs[threadIdx.x] = p.tab[threadIdx.x];
  }
}

template <int kL, int kRoute>
__global__ void __launch_bounds__(kL2Threads) probe_l2(Probe p) {
  __shared__ Table tabs[kMaxTables];
  load_tables(p, tabs);
  __syncthreads();
  walk_tables<kL, kRoute, kL2Threads>(p, tabs, nullptr, nullptr);
}

template <int kL>
__global__ void __launch_bounds__(kSmemThreads) probe_smem(Probe p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Table tabs[kMaxTables];
  // a block without a chunk skips the table copy (the same verdict in every
  // thread of the block)
  if (static_cast<long long>(blockIdx.x) * kRows * kSmemThreads >=
      p.n * p.ntab) {
    return;
  }
  const unsigned b = smem_addr(&bar);
  load_tables(p, tabs);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(p.keys_bytes + p.used_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(smem)), "l"(p.keys_span), "r"(p.keys_bytes), "r"(b)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(smem + p.keys_bytes)), "l"(p.used_span),
        "r"(p.used_bytes), "r"(b)
        : "memory");
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred ok;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 ok, [%1], 0;\n"
        " selp.u32 %0, 1, 0, ok;\n}"
        : "=r"(done) : "r"(b) : "memory");
  }
  walk_tables<kL, kSmem, kSmemThreads>(
      p, tabs, reinterpret_cast<const int*>(smem) + p.keys_shift,
      smem + p.keys_bytes + p.used_shift);
}

// Records of the slots [first, first + count) of the packed tables: the key
// lanes, the used flag, zero padding.
__global__ void __launch_bounds__(kPackThreads)
    pack_records(const int* tkeys, const unsigned char* used, long long first,
                 long long count, int lanes, int* rec) {
  const int width = record_ints(lanes);
  for (long long s = blockIdx.x * static_cast<long long>(kPackThreads) +
                     threadIdx.x;
       s < count; s += static_cast<long long>(gridDim.x) * kPackThreads) {
    int* r = rec + s * width;
    const int* k = tkeys + (first + s) * lanes;
    for (int l = 0; l < lanes; ++l) r[l] = k[l];
    r[lanes] = used[first + s];
    for (int l = lanes + 1; l < width; ++l) r[l] = 0;
  }
}

// ---------------------------------------------------------------------------
// host side

template <int kRoute>
const void* l2_kernel(int lanes) {
  switch (lanes) {
    case 1: return reinterpret_cast<const void*>(&probe_l2<1, kRoute>);
    case 2: return reinterpret_cast<const void*>(&probe_l2<2, kRoute>);
    case 3: return reinterpret_cast<const void*>(&probe_l2<3, kRoute>);
    case 4: return reinterpret_cast<const void*>(&probe_l2<4, kRoute>);
    default: return reinterpret_cast<const void*>(&probe_l2<0, kRoute>);
  }
}

template <>
const void* l2_kernel<kL2Packed>(int lanes) {
  switch (lanes) {
    case 1: return reinterpret_cast<const void*>(&probe_l2<1, kL2Packed>);
    case 2: return reinterpret_cast<const void*>(&probe_l2<2, kL2Packed>);
    default: return reinterpret_cast<const void*>(&probe_l2<3, kL2Packed>);
  }
}

const void* smem_kernel(int lanes) {
  switch (lanes) {
    case 1: return reinterpret_cast<const void*>(&probe_smem<1>);
    case 2: return reinterpret_cast<const void*>(&probe_smem<2>);
    case 3: return reinterpret_cast<const void*>(&probe_smem<3>);
    case 4: return reinterpret_cast<const void*>(&probe_smem<4>);
    default: return reinterpret_cast<const void*>(&probe_smem<0>);
  }
}

// Blocks of a persistent grid: one chunk of pairs each at most, and no more
// than the card holds at once.
cudaError_t grid_for(const void* kernel, int threads, size_t smem,
                     long long pairs, int* blocks) {
  cudaError_t err;
  int dev = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           threads, smem)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const long long chunk = static_cast<long long>(kRows) * threads;
  long long b = (pairs + chunk - 1) / chunk;
  const long long most = static_cast<long long>(per_sm) * sms;
  if (b > most) b = most;
  if (b < 1) b = 1;
  *blocks = static_cast<int>(b);
  return cudaSuccess;
}

// Dynamic shared memory a probe_smem block may take on this device.
cudaError_t smem_limit(long long* bytes) {
  cudaError_t err;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if ((err = cudaFuncGetAttributes(&attr, smem_kernel(1)))) return err;
  *bytes = static_cast<long long>(optin) -
           static_cast<long long>(attr.sharedSizeBytes);
  return cudaSuccess;
}

inline uintptr_t down16(uintptr_t a) { return a & ~uintptr_t{15}; }
inline uintptr_t up16(uintptr_t a) { return (a + 15) & ~uintptr_t{15}; }

}  // namespace

extern "C" {

const char* dftpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dynamic shared memory the shared-memory route may use on the current
// device (bytes), for the wrapper's choice of route.
int dftpu_probe_smem_limit(long long* bytes) {
  return static_cast<int>(smem_limit(bytes));
}

// Kernel 2: one launch probes tables k0 .. k0 + ntab - 1 of ktotal.
// keys [n, ktotal, lanes] i32, slot0 [n, ktotal] i32, active [n, ktotal] u8,
// tkeys [sum H, lanes] i32 and used [sum H] u8 (every table, packed),
// offsets/slots [ntab] i64 in HOST memory (the launch's tables' first slot in
// the packed arrays and slot counts) -> found [n, ktotal] i32 (columns k0 ..
// k0 + ntab - 1; -1 = absent), over [ktotal] bool (entries k0 .. k0 + ntab
// - 1 written). route: 0 L2, 1 L2 with packed records (scratch:
// [sum of the launch's slots, 2 if lanes == 1 else 4] i32, lanes <= 3), 2
// shared memory. ntab <= 8, n * ktotal <= kMaxPairs.
int dftpu_multiway_probe(const int* keys, const int* slot0,
                         const unsigned char* active, const int* tkeys,
                         const unsigned char* used, const long long* offsets,
                         const long long* slots, int ntab, int k0, int ktotal,
                         long long n, int lanes, int max_rounds, int route,
                         int* scratch, int* found, unsigned char* over,
                         void* stream) {
  if (ntab < 1 || ntab > kMaxTables || lanes < 1 || n < 0 ||
      n * ktotal > kMaxPairs || (route == kL2Packed && lanes > 3) ||
      route < kL2 || route > kSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Probe p{};
  p.keys = keys;
  p.slot0 = slot0;
  p.active = active;
  p.found = found;
  p.over = over;
  p.n = n;
  p.ktotal = ktotal;
  p.k0 = k0;
  p.ntab = ntab;
  p.lanes = lanes;
  p.max_rounds = max_rounds;
  const long long first = offsets[0];
  long long span = 0;  // slots of the launch's tables
  for (int k = 0; k < ntab; ++k) {
    Table& t = p.tab[k];
    t.keys = tkeys + offsets[k] * lanes;
    t.used = used + offsets[k];
    t.mask = static_cast<int>(slots[k] - 1);
    t.first = static_cast<int>(offsets[k] - first);
    span = offsets[k] + slots[k] - first;
  }
  void* args[] = {&p};
  cudaError_t err;
  int blocks = 0;
  if ((err = cudaMemsetAsync(over + k0, 0, ntab, st)))
    return static_cast<int>(err);
  if (route == kSmem) {
    // The spans are widened to 16-byte boundaries: at most 15 bytes on
    // either side, inside the 512-byte granules of PyTorch's allocator.
    const uintptr_t ks = reinterpret_cast<uintptr_t>(tkeys + first * lanes);
    const uintptr_t ke = reinterpret_cast<uintptr_t>(tkeys +
                                                     (first + span) * lanes);
    const uintptr_t us = reinterpret_cast<uintptr_t>(used + first);
    const uintptr_t ue = reinterpret_cast<uintptr_t>(used + first + span);
    p.keys_span = reinterpret_cast<const void*>(down16(ks));
    p.used_span = reinterpret_cast<const void*>(down16(us));
    p.keys_bytes = static_cast<unsigned>(up16(ke) - down16(ks));
    p.used_bytes = static_cast<unsigned>(up16(ue) - down16(us));
    p.keys_shift = static_cast<int>((ks - down16(ks)) / sizeof(int));
    p.used_shift = static_cast<int>(us - down16(us));
    const size_t bytes = static_cast<size_t>(p.keys_bytes) + p.used_bytes;
    long long limit = 0;
    if ((err = smem_limit(&limit))) return static_cast<int>(err);
    if (static_cast<long long>(bytes) > limit)
      return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = smem_kernel(lanes);
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(bytes))))
      return static_cast<int>(err);
    if ((err = grid_for(kernel, kSmemThreads, bytes, n * ntab, &blocks)))
      return static_cast<int>(err);
    if ((err = cudaLaunchKernel(kernel, blocks, kSmemThreads, args, bytes, st)))
      return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const void* kernel;
  if (route == kL2Packed) {
    const int width = record_ints(lanes);
    long long pb = (span + kPackThreads - 1) / kPackThreads;
    if (pb > 4096) pb = 4096;
    pack_records<<<static_cast<int>(pb), kPackThreads, 0, st>>>(
        tkeys, used, first, span, lanes, scratch);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
    for (int k = 0; k < ntab; ++k) {
      p.tab[k].keys = scratch + static_cast<long long>(p.tab[k].first) * width;
    }
    kernel = l2_kernel<kL2Packed>(lanes);
  } else {
    kernel = l2_kernel<kL2>(lanes);
  }
  if ((err = grid_for(kernel, kL2Threads, 0, n * ntab, &blocks)))
    return static_cast<int>(err);
  if ((err = cudaLaunchKernel(kernel, blocks, kL2Threads, args, 0, st)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
