// The verdict memo (K14), three CUDA kernels for Hopper (sm_90a).
//
// They replace the JAX package's engine/memo.py device functions, as
// `memo_evaluate_kernel` (:673, jit :710) and `memo_pair_packed4_kernel`
// (:715, jit :781) run them:
//   MEMO_DEDUP          dedup_groups (:205): a stable LSD radix sort of the
//                       [B] x 3 u32 key words (k0 most significant, 12
//                       passes of 8 bits, a pass whose digit is the same
//                       for every key skipped on the device), the group ids
//                       by a scan of the "new key" flags, the
//                       representatives (each group's first row in sort
//                       order) and the overflow past rep_cap
//   MEMO_CACHE          cache_probe (:326), bucket_insert_lanes (:263), the
//                       lattice on the missed representatives
//                       (index_probes of verdict.cuh),
//                       apply_rank_updates (:383), cache_insert (:434) and
//                       scatter_back (:484), with the stats row
//   MEMO_KEYS_LATTICE   memo_evaluate_kernel's front (_index_identity and
//                       memo_key_words, mode 0) and its _combine on the
//                       memo's value words (mode 1)
// The pair's front and back passes are DATAPATH_PAIR's memo mode
// (csrc/datapath.cu).
//
// Each launcher runs several kernels in order on one stream (a global
// order or count needs a grid-wide barrier):
//   dedup  init, 12 x (histogram, per-digit scan, digit bases, stable
//          scatter), flags, the
//          flag scan (block sums, one-block scan, apply), the group ids
//          and representatives, the padding of rep_orig;
//   cache  the row copy (when the output is another buffer), the probe
//          of each representative, the stable sort of the
//          representatives by bucket (1-4 radix passes), the rank within
//          the bucket and the insert lane, the lattice on the misses, the
//          commit (rank nibbles and entries, only when nothing overflowed),
//          the scatter-back to every tuple, the stats row, and the
//          restore of the rows after an overflow of the pair.
// Order where the reference's XLA sort leaves it open: equal keys, and
// equal buckets, keep their input order (the stable order XLA's CPU sort
// gives, which the CPU tests check), so the representatives are the
// smallest rows and the k-th same-bucket insert is the k-th in key
// order.  The cache's scratch row is never written: an entry that does not
// insert is dropped (the reference writes it there; no probe reads it).
// Entries go to distinct (bucket, lane) slots by construction; the rank
// word and the sub-word nibble plane change by atomic adds, which commute
// as the reference's .add scatters do.
//
// What bounds them on an H100: bytes.  The sort moves 16 B a key per
// pass that is not skipped (read and scattered), about 200 MB for 2,097,152
// keys over 6-8 passes, with a histogram read per pass; the cache reads
// one 164-byte row per representative and writes 4 B of values and a hit
// byte per tuple.  This first version does the simple thing: one thread
// per element, shared-memory histograms, warp match for the stable ranks,
// global atomics for the counts.  A one-sweep sort, a hash pre-pass that
// sorts only the distinct keys, and fusing the scans are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "radix.cuh"
#include "verdict.cuh"

namespace cmm {

using cdp::PolicyView;

using crx::BLOCK;
using crx::SCAN_TILE;
using crx::SortArgs;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr int STAT_UNIQUE = 0, STAT_HIT = 1, STAT_INSERT = 2,
              STAT_OVERFLOW = 3, STAT_TUPLES = 4;

struct DedupArgs {
  const uint32_t* keys;  // [3, B]
  SortArgs sort;
  uint32_t* flags;       // [B] new-key flags
  uint32_t* prefix;      // [B] their exclusive scan
  uint32_t* sums;        // [ceil(B / SCAN_TILE)]
  int32_t* n_elems;      // [1] = B
  int32_t* srow;         // [B]
  int32_t* gid;          // [B]
  int32_t* n_unique;     // [1]
  int32_t* rep_orig;     // [rep_cap + 1]
  uint8_t* rep_valid;    // [rep_cap]
  int32_t* overflow;     // [1]
  int32_t B;
  int32_t rep_cap;
};

struct CacheArgs {
  PolicyView pol;
  const uint32_t* keys;       // [3, B]
  const uint32_t* ep_w;       // [B] tuple words, or null: from k2
  const uint32_t* dir_w;
  const int32_t* srow;        // MEMO_DEDUP's outputs
  const int32_t* gid;
  const int32_t* rep_orig;
  const int32_t* n_unique;
  const int32_t* dedup_overflow;
  const uint32_t* rows_in;    // [n_rows + 1, width]
  uint32_t* rows_out;         // == rows_in, or a buffer the rows copy into
  const uint32_t* restore;    // null, or rows copied back on an overflow
  uint32_t* v0;               // outputs [B]
  uint32_t* v1;
  uint8_t* hit;
  uint32_t* stats;            // [5]
  // per representative [rep_cap]
  uint8_t* r_hit;
  uint8_t* r_hit_lane;
  uint8_t* r_ins_lane;
  uint8_t* r_do_ins;          // the insert lane is ok, then: inserts
  uint32_t* r_bucket;
  uint32_t* r_rank_word;
  uint32_t* r_empty;          // bit k: lane k's k0 is EMPTY
  uint32_t* rv0;              // the representatives' value words
  uint32_t* rv1;
  SortArgs sort;              // by bucket; sort.n = &counters[0]
  int32_t* counters;          // [3]: valid reps, inserts, hits
  int32_t B;
  int32_t rep_cap;
  int32_t n_rows;
  int32_t width;
  int32_t entries;
  int32_t ranked;
  int32_t subword;
  int32_t has_l3;
  int32_t accumulate;
  int32_t bucket_passes;
};

struct KeysArgs {
  const uint32_t* tuples;     // [6, B]: ep, identity, dport, proto, dir, frag
  PolicyView pol;
  uint32_t* keys;             // mode 0: [3, B]
  const uint32_t* v0;         // mode 1: the memo's value words [B]
  const uint32_t* v1;
  uint8_t* allowed;           // mode 1 outputs [B]
  int32_t* proxy_port;
  uint8_t* match_kind;
  int32_t B;
  int32_t mode;
};

// -- MEMO_DEDUP --------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) dedup_init(DedupArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i == 0) {
    a.sort.parity[0] = 0;
    *a.n_elems = a.B;
  }
  if (i >= a.B) return;
  const size_t b = static_cast<size_t>(a.B);
#pragma unroll
  for (int w = 0; w < 3; ++w) a.sort.key[0][w][i] = __ldg(a.keys + w * b + i);
  a.sort.val[0][i] = static_cast<uint32_t>(i);
}

// new-key flags over the sorted keys (sorted by the 12 passes: buffer
// parity[12])
__global__ void __launch_bounds__(BLOCK) dedup_flags(DedupArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= a.B) return;
  const int cur = a.sort.parity[12];
  uint32_t f = 1;
  if (p > 0) {
    f = 0;
#pragma unroll
    for (int w = 0; w < 3; ++w)
      f |= a.sort.key[cur][w][p] != a.sort.key[cur][w][p - 1];
  }
  a.flags[p] = f;
}

__global__ void __launch_bounds__(BLOCK) dedup_groups_kernel(DedupArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= a.B) return;
  const int cur = a.sort.parity[12];
  const int32_t row = static_cast<int32_t>(a.sort.val[cur][p]);
  const uint32_t f = a.flags[p];
  const int32_t g = static_cast<int32_t>(a.prefix[p] + f) - 1;
  a.srow[p] = row;
  a.gid[p] = g;
  if (f && g < a.rep_cap) a.rep_orig[g] = row;
  if (p == a.B - 1) {
    *a.n_unique = g + 1;
    *a.overflow = g + 1 > a.rep_cap ? g + 1 - a.rep_cap : 0;
  }
}

// slots past n_unique hold srow[0] (jnp.nonzero's fill 0), slot rep_cap 0
__global__ void __launch_bounds__(BLOCK) dedup_pad(DedupArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g > a.rep_cap) return;
  const int32_t nu = *a.n_unique;
  if (g == a.rep_cap) {
    a.rep_orig[g] = 0;
    return;
  }
  a.rep_valid[g] = g < nu;
  if (g >= nu) a.rep_orig[g] = a.srow[0];
}

// -- MEMO_CACHE --------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
    copy_words(const uint32_t* src, uint32_t* dst, size_t n,
               const uint32_t* stats) {
  if (stats && __ldg(stats + STAT_OVERFLOW) == 0) return;
  for (size_t i = blockIdx.x * static_cast<size_t>(BLOCK) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * BLOCK)
    dst[i] = src[i];
}

__device__ __forceinline__ int n_valid(const CacheArgs& a) {
  const int32_t nu = *a.n_unique;
  return nu < a.rep_cap ? nu : a.rep_cap;
}

__device__ __forceinline__ int rank_col(const CacheArgs& a) {
  return a.subword ? 4 * a.entries + a.entries / 8 : 5 * a.entries;
}

// One bucket row per representative: the lane compares over the three
// key words, the summed value words of the hit lanes, the first hit lane,
// the empty-lane mask and the rank word (cache_probe).
__global__ void __launch_bounds__(BLOCK) cache_probe_kernel(CacheArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g == 0) {
    a.counters[0] = n_valid(a);
    a.counters[1] = a.counters[2] = 0;
    a.sort.parity[0] = 0;
  }
  if (g >= n_valid(a)) return;
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  const uint32_t k0 = __ldg(a.keys + r), k1 = __ldg(a.keys + b + r),
                 k2 = __ldg(a.keys + 2 * b + r);
  uint32_t h = cdp::fnv1a_word(cdp::fnv1a2(k0, k1), k2);
  const uint32_t bucket = h & static_cast<uint32_t>(a.n_rows - 1);
  const uint32_t* row = a.rows_in + static_cast<size_t>(bucket) * a.width;
  const int e = a.entries;
  bool hit = false;
  uint32_t cv0 = 0, cv1 = 0, empty = 0;
  int hit_lane = -1;
  for (int k = 0; k < e; ++k) {
    const uint32_t w0 = row[k];
    if (w0 == EMPTY) empty |= 1u << k;
    if (w0 == k0 && row[e + k] == k1 && row[2 * e + k] == k2) {
      hit = true;
      if (hit_lane < 0) hit_lane = k;
      cv0 += row[3 * e + k];
      cv1 += a.subword ? (row[4 * e + k / 8] >> (4 * (k % 8))) & 0xFu
                       : row[4 * e + k];
    }
  }
  a.r_hit[g] = hit;
  a.r_hit_lane[g] = static_cast<uint8_t>(hit_lane < 0 ? 0 : hit_lane);
  a.r_bucket[g] = bucket;
  a.r_rank_word[g] = a.ranked ? row[rank_col(a)] : 0u;
  a.r_empty[g] = empty;
  a.rv0[g] = hit ? cv0 : 0u;
  a.rv1[g] = hit ? cv1 : 0u;
  a.sort.key[0][0][g] = bucket;
  a.sort.val[0][g] = static_cast<uint32_t>(g);
}

// The rank of each representative among the representatives of its
// bucket (in key order: the bucket sort is stable), capped at the lane
// count, then its insert lane (bucket_insert_lanes): the rank-th coldest
// lane (empty first, then by rank nibble, ties by lane) with the rank
// word and at most 8 lanes, else the first empty lane (or bucket mod
// lanes when none is empty) plus the rank.
__global__ void __launch_bounds__(BLOCK) cache_lanes_kernel(CacheArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= n_valid(a)) return;
  const int cur = a.sort.parity[a.bucket_passes];
  const uint32_t* sb = a.sort.key[cur][0];
  const uint32_t bucket = sb[p];
  const int g = static_cast<int>(a.sort.val[cur][p]);
  const int e = a.entries;
  int rank = 0;
  while (rank < e && p - 1 - rank >= 0 && sb[p - 1 - rank] == bucket) ++rank;
  const uint32_t empty = a.r_empty[g];
  int lane;
  if (a.ranked && e <= 8) {
    // insertion sort of (score, lane): empty lanes score -1
    int order[8];
    int score[8];
    const uint32_t rw = a.r_rank_word[g];
    for (int k = 0; k < e; ++k) {
      const int s = (empty >> k) & 1u ? -1 : static_cast<int>((rw >> (4 * k)) & 0xFu);
      int j = k;
      while (j > 0 && score[j - 1] > s) {
        score[j] = score[j - 1];
        order[j] = order[j - 1];
        --j;
      }
      score[j] = s;
      order[j] = k;
    }
    lane = order[rank < e ? rank : e - 1];
  } else {
    const int base = empty ? __ffs(empty) - 1 : static_cast<int>(bucket % e);
    lane = (base + rank) % e;
  }
  a.r_ins_lane[g] = static_cast<uint8_t>(lane);
  a.r_do_ins[g] = rank < e;
}

// The lattice on each missed representative; its value words replace the
// representative's, and one whose insert lane is ok is counted (the
// reference's do_ins, counted even when the batch overflows).
__global__ void __launch_bounds__(BLOCK) cache_lattice_kernel(CacheArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= n_valid(a) || a.r_hit[g]) {
    if (g < n_valid(a)) a.r_do_ins[g] = 0;
    return;
  }
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  const uint32_t k0 = __ldg(a.keys + r), k1 = __ldg(a.keys + b + r),
                 k2 = __ldg(a.keys + 2 * b + r);
  const int32_t ep = static_cast<int32_t>(a.ep_w ? __ldg(a.ep_w + r) : k2 >> 1);
  const int32_t dir =
      static_cast<int32_t>(a.dir_w ? __ldg(a.dir_w + r) : k2 & 1u);
  const cdp::ProbeBits q = cdp::index_probes(
      a.pol, ep, dir, k1 >> 16, (k1 >> 8) & 0xFFu, k0, (k1 >> 1) & 1u,
      a.has_l3 ? static_cast<int>(k1 & 1u) : -1);
  a.rv0[g] = (static_cast<uint32_t>(q.j) << 16) |
             (static_cast<uint32_t>(q.proxy) & 0xFFFFu);
  a.rv1[g] = (q.p1 ? 1u : 0u) | (q.p2 ? 2u : 0u) | (q.p3 ? 4u : 0u);
  if (a.r_do_ins[g]) atomicAdd(&a.counters[1], 1);
}

// The misses never exceed the valid representatives, so only the dedup
// can overflow.
__device__ __forceinline__ bool batch_ok(const CacheArgs& a) {
  return *a.dedup_overflow == 0;
}

// The commit, only when nothing overflowed: hit bumps and insert resets
// of the rank nibbles (atomic adds), the inserted entries' words, and in
// the sub-word layout v1 into its nibble by an add of the difference.
__global__ void __launch_bounds__(BLOCK) cache_commit_kernel(CacheArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= n_valid(a) || !batch_ok(a)) return;
  const int e = a.entries;
  uint32_t* row = a.rows_out + static_cast<size_t>(a.r_bucket[g]) * a.width;
  const bool lru = a.ranked && e <= 8;
  const uint32_t rw = a.r_rank_word[g];
  if (a.r_hit[g]) {
    const uint32_t sh = 4u * (a.r_hit_lane[g] % 8u);
    if (lru && ((rw >> sh) & 0xFu) < 15u)
      atomicAdd(row + rank_col(a), 1u << sh);
    return;
  }
  if (!a.r_do_ins[g]) return;
  const int lane = a.r_ins_lane[g];
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  row[lane] = __ldg(a.keys + r);
  row[e + lane] = __ldg(a.keys + b + r);
  row[2 * e + lane] = __ldg(a.keys + 2 * b + r);
  row[3 * e + lane] = a.rv0[g];
  if (a.subword) {
    const uint32_t sh = 4u * (lane % 8);
    const int col = 4 * e + lane / 8;
    const uint32_t old =
        (a.rows_in[static_cast<size_t>(a.r_bucket[g]) * a.width + col] >> sh) &
        0xFu;
    atomicAdd(row + col, ((a.rv1[g] & 0xFu) - old) << sh);
  } else {
    row[4 * e + lane] = a.rv1[g];
  }
  if (lru) {
    const uint32_t sh = 4u * (lane % 8);
    atomicAdd(row + rank_col(a), 0u - (((rw >> sh) & 0xFu) << sh));
  }
}

// Every tuple takes its group's value words and hit flag (the group id
// clipped to rep_cap - 1); the hits are counted per warp.
__global__ void __launch_bounds__(BLOCK) cache_scatter_kernel(CacheArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  bool h = false;
  if (p < a.B) {
    const int t = a.srow[p];
    int gg = a.gid[p];
    gg = gg < a.rep_cap - 1 ? gg : a.rep_cap - 1;
    a.v0[t] = a.rv0[gg];
    a.v1[t] = a.rv1[gg];
    h = a.r_hit[gg] != 0;
    a.hit[t] = h;
  }
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, h);
  if ((threadIdx.x & 31) == 0 && bal) atomicAdd(&a.counters[2], __popc(bal));
}

__global__ void cache_stats_kernel(CacheArgs a) {
  const uint32_t vals[5] = {
      static_cast<uint32_t>(*a.n_unique), static_cast<uint32_t>(a.counters[2]),
      static_cast<uint32_t>(a.counters[1]),
      static_cast<uint32_t>(*a.dedup_overflow), static_cast<uint32_t>(a.B)};
  for (int i = 0; i < 5; ++i) a.stats[i] = (a.accumulate ? a.stats[i] : 0u) + vals[i];
}

int grid_of(long n) { return static_cast<int>((n + BLOCK - 1) / BLOCK); }

// -- MEMO_KEYS_LATTICE ---------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) keys_lattice_kernel(KeysArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B) return;
  const size_t b = static_cast<size_t>(a.B);
  const uint32_t* t = a.tuples;
  if (a.mode == 0) {
    bool known;
    const uint32_t idx = cdp::index_identity(a.pol, __ldg(t + b + i), &known);
    const uint32_t dport = cdp::clip_u(static_cast<int32_t>(__ldg(t + 2 * b + i)),
                                       65535);
    const uint32_t proto = cdp::clip_u(static_cast<int32_t>(__ldg(t + 3 * b + i)),
                                       255);
    a.keys[i] = idx;
    a.keys[b + i] = (dport << 16) | (proto << 8) | (known ? 2u : 0u);
    a.keys[2 * b + i] = (__ldg(t + i) << 1) | __ldg(t + 4 * b + i);
    return;
  }
  const uint32_t v0 = __ldg(a.v0 + i), v1 = __ldg(a.v1 + i);
  const cdp::Lattice v = cdp::combine(
      (v1 & 1u) != 0, (v1 & 2u) != 0, (v1 & 4u) != 0,
      static_cast<int32_t>(v0 & 0xFFFFu), static_cast<int32_t>(v0 >> 16),
      __ldg(t + 5 * b + i) != 0);
  a.allowed[i] = v.allowed;
  a.proxy_port[i] = v.proxy;
  a.match_kind[i] = static_cast<uint8_t>(v.kind);
}

}  // namespace cmm

extern "C" int memo_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cmm::SortArgs));
  out[1] = static_cast<int>(sizeof(cmm::DedupArgs));
  out[2] = static_cast<int>(sizeof(cmm::CacheArgs));
  out[3] = static_cast<int>(sizeof(cmm::KeysArgs));
  out[4] = static_cast<int>(sizeof(cdp::PolicyView));
  return 5;
}

// MEMO_DEDUP on `stream`; returns cudaGetLastError().
extern "C" int launch_memo_dedup(const cmm::DedupArgs* args, void* stream) {
  using namespace cmm;
  const DedupArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.rep_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_of(a.B);
  dedup_init<<<grid, BLOCK, 0, st>>>(a);
  crx::radix_sort<3>(a.sort, 4, st);
  dedup_flags<<<grid, BLOCK, 0, st>>>(a);
  crx::flag_scan(a.flags, a.prefix, a.n_elems, a.B, a.sums, nullptr, st);
  dedup_groups_kernel<<<grid, BLOCK, 0, st>>>(a);
  dedup_pad<<<grid_of(static_cast<long>(a.rep_cap) + 1), BLOCK, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// MEMO_CACHE on `stream`; returns cudaGetLastError().
extern "C" int launch_memo_cache(const cmm::CacheArgs* args, void* stream) {
  using namespace cmm;
  const CacheArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.rep_cap <= 0 || a.entries < 1 || a.entries > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t words = static_cast<size_t>(a.n_rows + 1) * a.width;
  const int copy_grid = static_cast<int>((words + BLOCK - 1) / BLOCK < 4096
                                             ? (words + BLOCK - 1) / BLOCK
                                             : 4096);
  if (a.rows_out != a.rows_in)
    copy_words<<<copy_grid, BLOCK, 0, st>>>(a.rows_in, a.rows_out, words,
                                            nullptr);
  const int reps = grid_of(a.rep_cap);
  cache_probe_kernel<<<reps, BLOCK, 0, st>>>(a);
  crx::radix_sort<1>(a.sort, a.bucket_passes, st);
  cache_lanes_kernel<<<reps, BLOCK, 0, st>>>(a);
  cache_lattice_kernel<<<reps, BLOCK, 0, st>>>(a);
  cache_commit_kernel<<<reps, BLOCK, 0, st>>>(a);
  cache_scatter_kernel<<<grid_of(a.B), BLOCK, 0, st>>>(a);
  cache_stats_kernel<<<1, 1, 0, st>>>(a);
  if (a.restore)
    copy_words<<<copy_grid, BLOCK, 0, st>>>(a.restore, a.rows_out, words,
                                            a.stats);
  return static_cast<int>(cudaGetLastError());
}

// MEMO_KEYS_LATTICE on `stream`; returns cudaGetLastError().
extern "C" int launch_memo_keys(const cmm::KeysArgs* args, void* stream) {
  using namespace cmm;
  if (args->mode < 0 || args->mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->B > 0)
    keys_lattice_kernel<<<grid_of(args->B), BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
