// Open-addressed hash-table kernels for sm_90a: group build, and group build
// fused with an int32 accumulator fold.
//
// Replaces two Pallas TPU kernels of the reference package
// (datafusion_distributed_tpu/ops/pallas_hash.py):
//   dftpu_group_build      <- pallas_build_group_ids        (kernel 1)
//   dftpu_group_aggregate  <- pallas_global_hash_aggregate  (kernel 3)
// (Kernel 2, the read-only multi-table probe, is csrc/probe.cu.)
//
// Layout. The TPU kernels insert rows one at a time into 2^16-slot VMEM
// partitions; that layout is an artifact of VMEM. These kernels instead
// compute the rounds of the reference's XLA claim loop
// (ops/aggregate.py build_group_table) exactly, so every slot, key and
// overflow verdict equals the default JAX path bit for bit. One round r:
//   claim   : every unresolved row atomicMin's its row id into owner[slot];
//   win     : the owner of a slot that was unused at the start of the round
//             writes its key lanes and marks the slot used;
//   resolve : every unresolved row compares its lanes with its slot's; a
//             match resolves it, a used slot that does not match advances
//             it to (slot + 1) & (H - 1).
// The loop ends when no row is unresolved, or after max_rounds (overflow).
//
// What bounds them on the card. Both are memory-bound gathers and
// scatters: per round each unresolved row reads its L key lanes and its
// slot's L lanes (random 4-byte reads). The table fits the H100's 50 MB L2
// (H = 2^21, L = 3: slot keys 25.2 MB, used 2.1 MB, owner 8.4 MB); the rows
// do not (8,388,608 rows of 3 lanes: 100 MB of keys). So what a round costs
// is the rows it reads, and the fixed cost of a round: both are cut here.
//
// Design of kernels 1 and 3 (one cooperative launch per build):
// - The whole claim loop runs in one launch, with grid-wide barriers
//   (cooperative_groups) between phases; the kernel reads the unresolved
//   count itself and writes the round count, the overflow flag and the
//   running round statistics to device memory. A build makes no host sync.
// - Compaction: round 1 walks all N rows; its resolve phase appends every
//   still-unresolved (row, slot) pair to a list (one atomicAdd per block),
//   and each later round walks only the previous round's list
//   (double-buffered). atomicMin is order-free and win/resolve are per row,
//   so the list's order changes no output.
// - The resolve phase of round r also claims the advanced slot for round
//   r + 1, so a round is two phases and two barriers. That needs no reset
//   of owner[] between rounds: a winner frees its slot's owner word when it
//   wins, and the words of used slots are never read as a verdict again.
//   A row whose new slot is already used does not claim it at all. When a
//   round has more entries than the table has slots (round 1 of a big
//   build), the win phase walks the slots instead of the rows.
// - Once at most kTailRows rows are left, block 0 finishes the build alone
//   with block barriers; the other blocks stop (kernel 3 meets them at one
//   last grid barrier before the fold). Long probe chains then cost no grid
//   barriers.
// - One atomic per distinct slot per warp: the lanes that claim one slot
//   are grouped with __match_any_sync, their lowest row id found with
//   __reduce_min_sync, and the group's first lane issues the atomicMin,
//   unless a read of the word shows it would change nothing. Kernel 3's
//   fold groups lanes by gid the same way (redux.sync add wraps mod 2^32,
//   as atomicAdd and XLA's scatter-add do) and folds the first groups each
//   block meets in shared memory, flushed once per block, so a hot key no
//   longer serialises one atomic per row on one address.
// Every warp-level intrinsic and block barrier sits in a loop whose trip
// count is uniform across the block (threads past the end are inactive),
// so each mask names exactly the lanes that execute it. Memory that the
// launch itself writes is read with __ldcg (L2), never through the
// non-coherent L1 or the read-only path.
//
// Every entry point launches on the caller's stream, allocates nothing
// (scratch comes from the caller) and returns cudaGetLastError() (or the
// first error it met), which the Python wrapper raises on. A cooperative
// launch that the card refuses (a grid larger than can be co-resident) is
// such an error: there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// at most this many unresolved rows: block 0 finishes the build alone
constexpr long long kTailRows = 4LL * kThreads;
// kernel 3: groups each block folds in shared memory; most accumulators
// (ops/hash_kernels.py MAX_ACCS)
constexpr int kCacheGroups = 64;
constexpr int kMaxAccs = 32;

struct Build {
  // inputs, read-only for the whole launch
  const int* keys;  // [n, lanes]
  const int* slot0;  // [n]
  const unsigned char* live;  // [n]
  long long n;
  int lanes;
  int mask;  // num_slots - 1
  int max_rounds;
  // outputs
  int* gid;  // [n]
  int* slot_keys;  // [num_slots, lanes]
  unsigned char* slot_used;  // [num_slots]
  int* rounds;  // [1]
  unsigned char* overflow;  // [1]
  unsigned long long* stats;  // [3] builds, rounds summed, most rounds
  // scratch
  int2* list[2];  // [n] each: (row, slot) of the rows left unresolved
  int* owner;  // [num_slots]: lowest claiming row, INT_MAX when free
  int* counts;  // [max_rounds + 1]: live rows, then unresolved per round
  // kernel 3 only
  const int* values;  // [n, naccs]
  unsigned long long ops;  // 2 bits per accumulator: 0 sum, 1 min, 2 max
  int naccs;
  int* acc;  // [num_slots, naccs]
  int* rep;  // [num_slots]
};

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ int op_of(const Build& b, int a) {
  return static_cast<int>((b.ops >> (2 * a)) & 3u);
}

__device__ __forceinline__ int identity_of(int op) {
  return op == 0 ? 0 : (op == 1 ? INT_MAX : INT_MIN);
}

// atomicMin / atomicMax, skipped when a read of the word (at L2, the point
// of coherence) shows it would change nothing. Exact while every write to
// the word in the phase is an atomicMin (atomicMax): the word only falls
// (rises), so a value already at or below v stays so.
__device__ __forceinline__ void min_if_lower(int* p, int v) {
  if (v < __ldcg(p)) atomicMin(p, v);
}

__device__ __forceinline__ void max_if_higher(int* p, int v) {
  if (v > __ldcg(p)) atomicMax(p, v);
}

// Lanes with `take` atomicMin `row` into owner[s]: one atomic per distinct
// slot per warp. Every lane of the warp calls it.
__device__ __forceinline__ void claim(bool take, int row, int s, int* owner) {
  const unsigned act = __ballot_sync(kFull, take);
  if (!take) return;
  const unsigned grp = __match_any_sync(act, s);
  const int lowest = __reduce_min_sync(grp, row);
  if (lane_id() == static_cast<unsigned>(__ffs(grp) - 1)) {
    min_if_lower(&owner[s], lowest);
  }
}

// Threads with `take` append (row, s) to out: one atomicAdd on *count per
// block, so the counter is no hot spot. Every thread of the block calls it.
__device__ void append(bool take, int row, int s, int2* out, int* count) {
  __shared__ int warp_at[kThreads / 32];
  __shared__ int block_at;
  const unsigned m = __ballot_sync(kFull, take);
  const unsigned w = threadIdx.x >> 5;
  if (lane_id() == 0) warp_at[w] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      const int c = warp_at[k];
      warp_at[k] = total;
      total += c;
    }
    block_at = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (take) {
    out[block_at + warp_at[w] + __popc(m & ((1u << lane_id()) - 1u))] =
        make_int2(row, s);
  }
  __syncthreads();  // warp_at and block_at are rewritten by the next call
}

// Entry j of round r's work: round 1 walks every row and skips dead ones,
// later rounds walk the list of rows the previous round left unresolved.
__device__ __forceinline__ bool entry(const Build& b, int r, const int2* list,
                                      long long j, long long m, int& row,
                                      int& s) {
  if (j >= m) return false;
  if (r == 1) {
    if (!b.live[j]) return false;
    row = static_cast<int>(j);
    s = b.slot0[j];
    return true;
  }
  const int2 e = __ldcg(&list[j]);
  row = e.x;
  s = e.y;
  return true;
}

// Every phase walks its items in block-sized chunks from `first` (the
// block's first item) by `stride`, so each block's threads make the same
// number of trips (block barriers and warp intrinsics may sit inside).

// Phase 0: empty table, zeroed counters, kernel 3's accumulator identities.
template <bool kFold>
__device__ void init_table(const Build& b, long long first, long long stride) {
  const long long h = static_cast<long long>(b.mask) + 1;
  for (long long s = first + threadIdx.x; s < h; s += stride) {
    b.owner[s] = INT_MAX;
    b.slot_used[s] = 0;
    for (int l = 0; l < b.lanes; ++l) b.slot_keys[s * b.lanes + l] = 0;
    if (kFold) {
      b.rep[s] = INT_MAX;
      for (int a = 0; a < b.naccs; ++a) {
        b.acc[s * b.naccs + a] = identity_of(op_of(b, a));
      }
    }
  }
  for (long long r = first + threadIdx.x; r <= b.max_rounds; r += stride) {
    b.counts[r] = 0;
  }
}

// Round 1's claim: every live row claims slot0; dead rows get gid 0;
// counts[0] = live rows.
__device__ void claim_first(const Build& b, long long first,
                            long long stride) {
  int live_rows = 0;
  for (long long base = first; base < b.n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool in = i < b.n;
    const bool take = in && b.live[i];
    if (in && !take) b.gid[i] = 0;
    claim(take, static_cast<int>(i), take ? b.slot0[i] : 0, b.owner);
    live_rows += take;
  }
  live_rows = __reduce_add_sync(kFull, live_rows);
  if (lane_id() == 0 && live_rows) atomicAdd(&b.counts[0], live_rows);
}

// The owner of a slot unused at the start of round r writes its lanes,
// marks the slot used and frees the owner word for later claims. Only the
// owner reads slot_used[s], so its own write cannot change another row's
// verdict, and only the owner can see owner[s] == its row id. With more
// entries than slots (round 1 of a big build) the phase walks the slots:
// an unused slot's owner word is INT_MAX unless a row claimed the slot this
// round, and then it names the winner, whose current slot it is.
__device__ void win_slot(const Build& b, int row, int s) {
  for (int l = 0; l < b.lanes; ++l) {
    b.slot_keys[static_cast<long long>(s) * b.lanes + l] =
        b.keys[static_cast<long long>(row) * b.lanes + l];
  }
  b.slot_used[s] = 1;
  b.owner[s] = INT_MAX;
}

__device__ void win(const Build& b, int r, const int2* list, long long m,
                    long long first, long long stride) {
  const long long h = static_cast<long long>(b.mask) + 1;
  if (m > h) {
    for (long long s = first + threadIdx.x; s < h; s += stride) {
      const int row = __ldcg(&b.owner[s]);
      if (row != INT_MAX && !__ldcg(&b.slot_used[s])) {
        win_slot(b, row, static_cast<int>(s));
      }
    }
    return;
  }
  for (long long j = first + threadIdx.x; j < m; j += stride) {
    int row, s;
    if (!entry(b, r, list, j, m, row, s)) continue;
    if (__ldcg(&b.owner[s]) == row && !__ldcg(&b.slot_used[s])) {
      win_slot(b, row, s);
    }
  }
}

// Resolve round r, and claim round r + 1's slots. A match writes gid; a
// row left unresolved advances past a used slot, is appended to `next`
// (counts[r] counts them) and claims its new slot if that slot is free. In
// the last round an unresolved row gets gid 0.
__device__ void resolve(const Build& b, int r, const int2* list, long long m,
                        int2* next, long long first, long long stride) {
  const bool claim_next = r < b.max_rounds;
  for (long long base = first; base < m; base += stride) {
    int row = 0, s = 0;
    const bool act = entry(b, r, list, base + threadIdx.x, m, row, s);
    bool left = false;
    bool free_next = false;
    if (act) {
      const bool used = __ldcg(&b.slot_used[s]) != 0;
      bool match = used;
      for (int l = 0; l < b.lanes && match; ++l) {
        match = __ldcg(&b.slot_keys[static_cast<long long>(s) * b.lanes + l]) ==
                b.keys[static_cast<long long>(row) * b.lanes + l];
      }
      if (match) {
        b.gid[row] = s;
      } else {
        if (used) s = (s + 1) & b.mask;
        left = true;
        if (claim_next) {
          free_next = !__ldcg(&b.slot_used[s]);
        } else {
          b.gid[row] = 0;
        }
      }
    }
    append(left, row, s, next, &b.counts[r]);
    claim(free_next, row, s, b.owner);
  }
}

// Kernel 3's fold: per live row, rep = lowest row per group and one int32
// sum/min/max per accumulator, aggregated per gid within each warp and then,
// for the first kCacheGroups groups a block meets (a hot group among them
// almost surely), in shared memory, flushed to device memory once per block.
// Unused slots end with rep 0 (rows folded into them are overflowed rows,
// gid 0). Integer sums (mod 2^32), minima and maxima do not depend on order.
__device__ void fold(const Build& b, long long first, long long stride) {
  __shared__ int tag[kCacheGroups];  // gid held by the entry, or -1
  __shared__ int crep[kCacheGroups];
  __shared__ int cacc[kCacheGroups][kMaxAccs];
  for (int e = threadIdx.x; e < kCacheGroups; e += blockDim.x) {
    tag[e] = -1;
    crep[e] = INT_MAX;
    for (int a = 0; a < b.naccs; ++a) cacc[e][a] = identity_of(op_of(b, a));
  }
  const long long h = static_cast<long long>(b.mask) + 1;
  for (long long s = first + threadIdx.x; s < h; s += stride) {
    if (!__ldcg(&b.slot_used[s])) b.rep[s] = 0;
  }
  __syncthreads();
  for (long long base = first; base < b.n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool take = i < b.n && b.live[i];
    const unsigned act = __ballot_sync(kFull, take);
    if (!take) continue;
    const int g = __ldcg(&b.gid[i]);
    const unsigned grp = __match_any_sync(act, g);
    const bool leader = lane_id() == static_cast<unsigned>(__ffs(grp) - 1);
    const int lowest = __reduce_min_sync(grp, static_cast<int>(i));
    int e = -1;  // the leader's cache entry for g, if it has one
    if (leader) {
      const int want = g & (kCacheGroups - 1);
      int held = *reinterpret_cast<volatile int*>(&tag[want]);
      if (held == -1) {
        held = atomicCAS(&tag[want], -1, g);
        if (held == -1) held = g;
      }
      if (held == g) {
        e = want;
        atomicMin(&crep[e], lowest);
      } else if (__ldcg(&b.slot_used[g])) {
        min_if_lower(&b.rep[g], lowest);
      }
    }
    for (int a = 0; a < b.naccs; ++a) {
      const int v = b.values[i * b.naccs + a];
      int* dst = e >= 0 ? &cacc[e][a]
                        : &b.acc[static_cast<long long>(g) * b.naccs + a];
      switch (op_of(b, a)) {  // the same op in every lane
        case 0: {
          const unsigned sum = __reduce_add_sync(grp, static_cast<unsigned>(v));
          if (leader) atomicAdd(dst, static_cast<int>(sum));
          break;
        }
        case 1: {
          const int lo = __reduce_min_sync(grp, v);
          if (leader) {
            if (e >= 0) atomicMin(dst, lo); else min_if_lower(dst, lo);
          }
          break;
        }
        default: {
          const int hi = __reduce_max_sync(grp, v);
          if (leader) {
            if (e >= 0) atomicMax(dst, hi); else max_if_higher(dst, hi);
          }
          break;
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kCacheGroups; e += blockDim.x) {
    const int g = tag[e];
    if (g < 0) continue;
    if (__ldcg(&b.slot_used[g])) min_if_lower(&b.rep[g], crep[e]);
    for (int a = 0; a < b.naccs; ++a) {
      const int op = op_of(b, a);
      const int v = cacc[e][a];
      if (v == identity_of(op)) continue;
      int* dst = &b.acc[static_cast<long long>(g) * b.naccs + a];
      if (op == 0) atomicAdd(dst, v);
      else if (op == 1) min_if_lower(dst, v);
      else max_if_higher(dst, v);
    }
  }
}

template <bool kFold>
__device__ void run_build(const Build& b) {
  cg::grid_group grid = cg::this_grid();
  const long long grid_first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long grid_stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long first = grid_first;
  long long stride = grid_stride;

  init_table<kFold>(b, first, stride);
  grid.sync();
  claim_first(b, first, stride);
  grid.sync();

  int rounds = 0;
  int left = 0;
  if (__ldcg(&b.counts[0]) > 0) {
    bool tail = false;
    for (int r = 1;; ++r) {
      const long long m = r == 1 ? b.n : __ldcg(&b.counts[r - 1]);
      const int2* cur = b.list[r & 1];
      int2* next = b.list[(r + 1) & 1];
      if (!tail && m <= kTailRows) {  // the same verdict in every block
        tail = true;
        if (blockIdx.x != 0) break;
        first = 0;
        stride = blockDim.x;
      }
      win(b, r, cur, m, first, stride);
      if (tail) __syncthreads(); else grid.sync();
      resolve(b, r, cur, m, next, first, stride);
      if (tail) __syncthreads(); else grid.sync();
      left = __ldcg(&b.counts[r]);
      if (left == 0 || r == b.max_rounds) {
        rounds = r;
        break;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *b.rounds = rounds;
    *b.overflow = left != 0;
    atomicAdd(&b.stats[0], 1ull);
    atomicAdd(&b.stats[1], static_cast<unsigned long long>(rounds));
    atomicMax(&b.stats[2], static_cast<unsigned long long>(rounds));
  }
  if (kFold) {
    grid.sync();  // block 0's tail rounds are done
    fold(b, grid_first, grid_stride);
  }
}

__global__ void __launch_bounds__(kThreads) group_build_kernel(Build b) {
  run_build<false>(b);
}

__global__ void __launch_bounds__(kThreads) group_aggregate_kernel(Build b) {
  run_build<true>(b);
}

// One cooperative launch: a thread per row, and at most 16 slots a thread
// to clear, in as many blocks as the card holds at once at most. A small
// build then pays for fewer blocks at every grid barrier.
cudaError_t launch_build(const void* kernel, Build& b, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, 0)))
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const long long h = static_cast<long long>(b.mask) + 1;
  long long blocks = (std::max(b.n, h / 16) + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm) * sms;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  void* args[] = {&b};
  return cudaLaunchCooperativeKernel(kernel, static_cast<unsigned>(blocks),
                                     kThreads, args, 0, stream);
}

Build make_build(const int* keys, const int* slot0, const unsigned char* live,
                 long long n, int lanes, long long num_slots, int max_rounds,
                 int* gid, int* slot_keys, unsigned char* slot_used,
                 int* rounds, unsigned char* overflow,
                 unsigned long long* stats, int2* lists, int* owner,
                 int* counts) {
  Build b{};
  b.keys = keys;
  b.slot0 = slot0;
  b.live = live;
  b.n = n;
  b.lanes = lanes;
  b.mask = static_cast<int>(num_slots - 1);
  b.max_rounds = max_rounds;
  b.gid = gid;
  b.slot_keys = slot_keys;
  b.slot_used = slot_used;
  b.rounds = rounds;
  b.overflow = overflow;
  b.stats = stats;
  b.list[0] = lists;
  b.list[1] = lists + n;
  b.owner = owner;
  b.counts = counts;
  return b;
}

}  // namespace

extern "C" {

const char* dftpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel 1: claim-loop group build, one cooperative launch.
// keys [n, lanes] i32, slot0 [n] i32, live [n] u8 -> gid [n] i32,
// slot_keys [num_slots, lanes] i32, slot_used [num_slots] u8, rounds [1]
// i32, overflow [1] u8; stats [3] u64 (builds, rounds summed, most rounds)
// is added to. Scratch: lists [2, n] int2, owner [num_slots] i32, counts
// [max_rounds + 1] i32. All pointers are device memory; n < 2^31,
// max_rounds >= 1.
int dftpu_group_build(const int* keys, const int* slot0,
                      const unsigned char* live, long long n, int lanes,
                      long long num_slots, int max_rounds, int* gid,
                      int* slot_keys, unsigned char* slot_used, int* rounds,
                      unsigned char* overflow, unsigned long long* stats,
                      int* lists, int* owner, int* counts, void* stream) {
  Build b = make_build(keys, slot0, live, n, lanes, num_slots, max_rounds,
                       gid, slot_keys, slot_used, rounds, overflow, stats,
                       reinterpret_cast<int2*>(lists), owner, counts);
  cudaError_t err = launch_build((const void*)group_build_kernel, b,
                                 static_cast<cudaStream_t>(stream));
  if (err) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3: kernel 1's build and, in the same launch, one pass folding
// values [n, naccs] i32 into acc [num_slots, naccs] (starting from each
// op's identity) and the lowest live row index of each used slot into rep
// [num_slots] (unused slots end as 0). ops holds two bits per accumulator
// (0 sum, 1 min, 2 max; naccs <= 32). The rest as kernel 1.
int dftpu_group_aggregate(const int* keys, const int* slot0,
                          const unsigned char* live, const int* values,
                          unsigned long long ops, long long n, int lanes,
                          int naccs,
                          long long num_slots, int max_rounds, int* gid,
                          int* slot_keys, unsigned char* slot_used, int* acc,
                          int* rep, int* rounds, unsigned char* overflow,
                          unsigned long long* stats, int* lists, int* owner,
                          int* counts, void* stream) {
  Build b = make_build(keys, slot0, live, n, lanes, num_slots, max_rounds,
                       gid, slot_keys, slot_used, rounds, overflow, stats,
                       reinterpret_cast<int2*>(lists), owner, counts);
  b.values = values;
  b.ops = ops;
  b.naccs = naccs;
  b.acc = acc;
  b.rep = rep;
  cudaError_t err = launch_build((const void*)group_aggregate_kernel, b,
                                 static_cast<cudaStream_t>(stream));
  if (err) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
