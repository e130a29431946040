// Native host data plane of the coordinator/worker runtime.
//
// The host-side hot loops of the runtime's copying regroup between stages
// (hash + bucket CSR build) for producer tables that live in host memory.
// Tables on the card are regrouped on the card (runtime/coordinator.py).
//
// The hash MUST be bit-identical to ops/hash.py (murmur3 fmix32 mixing over
// folded uint32 lanes) so rows co-locate whether a shuffle ran on the card
// or on the host.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 at first use (native/__init__.py).
// Bound via ctypes.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// fold an int64 payload to a uint32 lane: hi ^ lo (matches
// ops/hash.py fold_to_u32 for int64/float64-bitcast columns)
inline uint32_t fold64(int64_t v) {
    uint64_t u = static_cast<uint64_t>(v);
    return static_cast<uint32_t>(u ^ (u >> 32));
}

}  // namespace

extern "C" {

// Combined hash of multiple key columns.
//   cols:   ncols pointers to int64 payload arrays [n]
//           (callers pre-normalize: int64/date/int32 cast to int64;
//            float64 bitcast to int64; float32 bits zero-extended)
//   kinds:  per column: 0 = fold hi^lo (64-bit payloads),
//                       1 = low 32 bits used directly (32-bit payloads)
//   valids: ncols pointers to uint8 validity arrays [n] (or nullptr)
//   out:    uint32 hash per row
void dftpu_hash_rows(const int64_t* const* cols, const int32_t* kinds,
                     const uint8_t* const* valids, int32_t ncols, int64_t n,
                     uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = 0x9E3779B9u;
    for (int32_t c = 0; c < ncols; ++c) {
        const int64_t* col = cols[c];
        const uint8_t* valid = valids[c];
        const uint32_t mult = 0x01000193u + 2u * static_cast<uint32_t>(c);
        const int32_t kind = kinds[c];
        for (int64_t i = 0; i < n; ++i) {
            uint32_t lane = kind == 0
                                ? fold64(col[i])
                                : static_cast<uint32_t>(col[i]);
            if (valid != nullptr && valid[i] == 0) lane = 0xDEADBEEFu;
            out[i] = (out[i] ^ fmix32(lane)) * mult;
        }
    }
    for (int64_t i = 0; i < n; ++i) out[i] = fmix32(out[i]);
}

// Destinations + per-bucket counts for a hash shuffle. Dead rows get
// dest = -1 and are not counted.
void dftpu_shuffle_dest(const uint32_t* hash, const uint8_t* live, int64_t n,
                        int32_t parts, int32_t* dest, int64_t* counts) {
    for (int32_t p = 0; p < parts; ++p) counts[p] = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (live != nullptr && live[i] == 0) {
            dest[i] = -1;
            continue;
        }
        int32_t d = static_cast<int32_t>(hash[i] % static_cast<uint32_t>(parts));
        dest[i] = d;
        counts[d] += 1;
    }
}

// CSR of row indices grouped by destination: offsets[parts+1], indices[live].
void dftpu_bucket_indices(const int32_t* dest, int64_t n, int32_t parts,
                          const int64_t* counts, int64_t* offsets,
                          int64_t* indices) {
    offsets[0] = 0;
    for (int32_t p = 0; p < parts; ++p) offsets[p + 1] = offsets[p] + counts[p];
    // cursor per bucket
    int64_t* cursor = new int64_t[parts];
    for (int32_t p = 0; p < parts; ++p) cursor[p] = offsets[p];
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = dest[i];
        if (d < 0) continue;
        indices[cursor[d]++] = i;
    }
    delete[] cursor;
}

int32_t dftpu_version() { return 1; }

}  // extern "C"
