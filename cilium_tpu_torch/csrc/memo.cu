// The verdict memo (K14), three CUDA kernels for Hopper (sm_90a).
//
// They replace the JAX package's engine/memo.py device functions, as
// `memo_evaluate_kernel` (:673, jit :710) and `memo_pair_packed4_kernel`
// (:715, jit :781) run them:
//   MEMO_DEDUP          dedup_groups (:205): the groups of equal
//                       [B] x 3 u32 key words in the stable
//                       lexicographic order of the keys (k0 most
//                       significant), each group's smallest row, the
//                       rows in group order and the overflow past
//                       rep_cap
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
// MEMO_DEDUP is one cooperative launch (every block resident, phases
// parted by a grid barrier) that sorts only the distinct keys:
//   1. a hash pre-pass: each block dedups a tile of 2,048 rows in a
//      shared-memory table (a Zipf batch's hot keys cost one global
//      probe a tile, not one a row), then inserts each of the tile's
//      distinct keys into a global open-addressing table of 2B or more
//      8-byte slots (the key's hash above a row of the key: a claim by
//      atomicCAS, the smallest row by atomicMin, a mismatched hash
//      rejected without reading keys, a matching one confirmed against
//      the read-only input) and records every row's slot; a tile writes
//      the keys it claims (and their slots) out in a run at a place
//      taken from one global count;
//   2. a stable LSD radix sort of the U distinct keys (8-bit digits,
//      least significant first, a digit that is one value over the
//      batch skipped); the last pass writes each slot's group id (its
//      sort position) and rep_orig[g] (the slot's row);
//   3. the rows: (group id, row) pairs in row order sorted stably by the
//      group id over ceil(log2 U) bits (two passes at U <= 65,536), the
//      last pass writing srow and gid; U == B puts each row at its group
//      directly, U == 1 keeps the row order.
// A sort pass is three phases: per-tile digit histograms, a scan of each
// digit's tile counts, and the scatter, which ranks a tile's elements in
// registers (a warp's share in chunks of 32, __match_any_sync), stages
// them in shared memory in sort order and writes them out in that order,
// so that a digit's run is stored by consecutive threads.  A pass of at
// most 32 tiles (1,024 elements a tile up to 32,768, else 4,096) runs on
// that many blocks behind a barrier of theirs, one a pass: its digit
// totals are counted before the first pass, and each tile takes its
// place from the counts the earlier tiles publish as they rank (a
// look-back).  Data one block wrote and another
// reads after a barrier is loaded with __ldcg (the L2, never a stale L1
// line).
//
// Each other launcher runs several kernels in order on one stream:
//   cache  the row copy (when the output is another buffer), the probe
//          of each representative, the stable sort of the
//          representatives by bucket (1-4 radix passes, radix.cuh), the
//          rank within the bucket and the insert lane, the lattice on the
//          misses, the commit (rank nibbles and entries, only when
//          nothing overflowed), the scatter-back to every tuple, the stats
//          row, and the restore of the rows after an overflow of the pair.
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
// What bounds them on an H100: bytes.  The dedup must read the 12 B of
// key words and write srow and gid (8 B) a row; it moves more: the row's
// slot (written, then read back), its group through the slot, and the
// row sort's passes over 8-byte pairs, with the U keys' 16-byte passes
// on top (small at the memo's U of tens of thousands; at U = B every
// key's 12 passes, as the first version's sort did).  The first version
// sorted all B keys, 16 B a key a pass over 6-12 passes of four launches
// each (1.06 ms per 2,097,152 Zipf keys on the H100).  The cache reads
// one 164-byte row per representative and writes 4 B of values and a hit
// byte per tuple: one thread per element, shared-memory histograms, warp
// match for the stable ranks, global atomics for the counts.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "radix.cuh"
#include "verdict.cuh"

namespace cmm {

using cdp::PolicyView;

using crx::BLOCK;
using crx::SortArgs;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr int STAT_UNIQUE = 0, STAT_HIT = 1, STAT_INSERT = 2,
              STAT_OVERFLOW = 3, STAT_TUPLES = 4;

struct DedupArgs {
  const uint32_t* keys;   // [3, B]
  unsigned long long* slot;  // [t_mask + 1]: the key's hash << 32 | a
                             // row of the key (its smallest at the end),
                             // all ones when free
  uint32_t* slot_group;   // [t_mask + 1]: an occupied slot's group id
  uint32_t* row_slot;     // [B]: each row's slot
  uint32_t* sk[2][4];     // [B] each: two sides of the sorts' buffers
  uint32_t* hist;         // [256 * max(FEW_TILES, ceil(B / BIG_TILE))]
  uint32_t* totals;       // [256]
  uint32_t* dtot;         // [16 * 256]: a short pass's digit totals (12
                          // of the keys', 4 of the rows' passes)
  uint32_t* status;       // [16 * FEW_TILES * 256]: its tiles' published
                          // counts (both zeroed by phase 0)
  uint32_t* misc;         // [8]: U, the key words' OR (3) and AND (3)
  uint32_t* bar;          // [4]: the grid barrier, then a short pass's
                          // (zeroed by the launcher)
  int32_t* srow;          // [B]
  int32_t* gid;           // [B]
  int32_t* n_unique;      // [1]
  int32_t* rep_orig;      // [rep_cap + 1]
  uint8_t* rep_valid;     // [rep_cap]
  int32_t* overflow;      // [1]
  int32_t B;
  int32_t rep_cap;
  uint32_t t_mask;        // the table's slots - 1 (a power of two - 1)
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

// the dedup's resident blocks an SM, its registers fitted to them (1
// and 3 measured slower, PERF.md)
constexpr int DEDUP_BLOCKS_PER_SM = 2;
constexpr int DB = 256;                 // threads a block
constexpr int DWARPS = DB / 32;
constexpr int ITILE = 2048;             // rows a block dedups at once
constexpr int IPER = ITILE / DB;        // rows a thread of such a tile
constexpr int LSLOTS = 2 * ITILE;       // the tile's shared hash slots
constexpr int BIG_TILE = 4096;          // elements a sort pass ranks at once
constexpr int SMALL_TILE = 1024;        // the same, for a short pass
constexpr int FEW_TILES = 32;           // a pass this short runs on a few
                                        // blocks behind a barrier of theirs
constexpr int DIGITS = 16;              // the keys' 12, the rows' 4
constexpr uint32_t DEDUP_FREE = 0xFFFFFFFFu;
constexpr unsigned long long SLOT_FREE = ~0ull;
// shared words: the insert's tile (key words, hash slots, per-row
// minimum then global slot, the tile's distinct keys, its claims, 16
// scalars) or a sort pass's (the tile staged in sort order, the warps'
// digit counts, three digit tables)
constexpr int INSERT_WORDS = 3 * ITILE + LSLOTS + 3 * ITILE + 16;
constexpr int PASS_WORDS = 4 * BIG_TILE + DWARPS * 256 + 3 * 256;
constexpr int DEDUP_SMEM_WORDS =
    INSERT_WORDS > PASS_WORDS ? INSERT_WORDS : PASS_WORDS;
static_assert(DB == 256, "a thread per digit");

__device__ __forceinline__ uint32_t key_hash(uint32_t k0, uint32_t k1,
                                             uint32_t k2) {
  uint32_t h = k0 * 0x9E3779B1u;
  h ^= (k1 + 0x85EBCA77u) * 0xC2B2AE3Du;
  h = (h << 13) | (h >> 19);
  h ^= (k2 + 0x27D4EB2Fu) * 0x165667B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Blocks 0 .. parts - 1 wait here until all of them have arrived (the
// launch is cooperative: every block is resident); writes before it are
// seen by __ldcg loads after it.  bar[0] counts arrivals, bar[1] the
// barriers passed.
__device__ __forceinline__ void bar_sync(uint32_t* bar, uint32_t parts) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile uint32_t* gen = bar + 1;
    const uint32_t g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == parts - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// every block; a short pass's blocks (their own counters)
__device__ __forceinline__ void grid_sync(const DedupArgs& a) {
  bar_sync(a.bar, gridDim.x);
}

__device__ __forceinline__ void part_sync(const DedupArgs& a,
                                          uint32_t parts) {
  bar_sync(a.bar + 2, parts);
}

// The columns a sort pass moves: NW word arrays, the digit's in w[dw].
template <int NW>
struct Cols {
  uint32_t* w[NW];
};

__device__ __forceinline__ int tile_of(int n) {
  return n <= FEW_TILES * SMALL_TILE ? SMALL_TILE : BIG_TILE;
}

// whether a pass over n elements is short: at most FEW_TILES tiles
__device__ __forceinline__ bool short_pass(int n) {
  return (n + tile_of(n) - 1) / tile_of(n) <= FEW_TILES;
}

// One stable pass over n elements of src by the 8-bit digit (src.w[dw]
// >> shift) & 0xFF into dst, in tiles of TILE (tile_of(n)), ending at a
// barrier.  Per tile: the stable ranks (a warp's TILE / 8 elements in
// chunks of 32, __match_any_sync), the tile staged in shared memory in
// sort order, then written out in that order, so that a digit's run is
// stored by consecutive threads.  A tile's place among the earlier
// tiles comes, in a long pass, from (a) every tile's digit counts
// (`counted`: the caller wrote them) and (b) their scan over the tiles
// per digit, each behind a grid barrier; a short pass (short_pass) runs
// on as many blocks as it has tiles behind their own barrier (the other
// blocks return at once and wait at the caller's next grid_sync), takes
// the digit totals the caller counted (dtot[digit]), and a tile reads
// the counts the earlier tiles publish as they rank (status[digit],
// count + 1: 0 is unpublished; the blocks are resident and take their
// tiles in order, so every wait ends).  LAST (the keys' last pass) also
// writes each slot's group id, the sort position, and rep_orig.
template <int NW, int TILE, bool LAST>
__device__ void sort_pass(const DedupArgs& a, uint32_t* sm, Cols<NW> src,
                          Cols<NW> dst, int dw, int shift, int digit, int n,
                          bool counted) {
  constexpr int PER = TILE / DB;  // a lane's chunks of 32
  const int tiles = (n + TILE - 1) / TILE;
  const bool few = tiles <= FEW_TILES;
  const uint32_t parts = min(static_cast<uint32_t>(tiles), gridDim.x);
  if (few && blockIdx.x >= parts) return;
  const uint32_t* dig_w = src.w[dw];
  const int d = threadIdx.x;  // this thread's digit in the tables
  const uint32_t* h = a.hist + static_cast<size_t>(d) * tiles;
  if (!few) {
    if (!counted) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        sm[d] = 0;
        __syncthreads();
        const int base = t * TILE;
        const int m = min(TILE, n - base);
        for (int i = threadIdx.x; i < m; i += DB)
          atomicAdd(&sm[(__ldcg(dig_w + base + i) >> shift) & 0xFFu], 1u);
        __syncthreads();
        a.hist[d * tiles + t] = sm[d];
        __syncthreads();
      }
      grid_sync(a);
    }
    for (int dd = blockIdx.x; dd < 256; dd += gridDim.x) {
      uint32_t* hd = a.hist + static_cast<size_t>(dd) * tiles;
      uint32_t carry = 0;
      for (int t0 = 0; t0 < tiles; t0 += DB) {
        const int t = t0 + threadIdx.x;
        const uint32_t x = t < tiles ? __ldcg(hd + t) : 0u;
        uint32_t total;
        const uint32_t incl = crx::block_inclusive<DB>(x, &total);
        if (t < tiles) hd[t] = carry + incl - x;
        carry += total;
      }
      if (threadIdx.x == 0) a.totals[dd] = carry;
    }
    grid_sync(a);
  }
  uint32_t* stage = sm;                    // [NW][TILE]
  uint32_t* s_cnt = sm + NW * TILE;        // [DWARPS][256]
  uint32_t* s_base = s_cnt + DWARPS * 256; // digit's first in dst
  uint32_t* s_loc = s_base + 256;          // digit's first in the tile
  uint32_t* s_out = s_loc + 256;           // dst index - tile index
  volatile uint32_t* status =
      a.status + static_cast<size_t>(digit) * FEW_TILES * 256 + d;
  {
    const uint32_t x =
        __ldcg(few ? a.dtot + digit * 256 + d : a.totals + d);
    s_base[d] = crx::block_inclusive<DB>(x, nullptr) - x;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t* cnt = s_cnt + warp * 256;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int k = threadIdx.x; k < DWARPS * 256; k += DB) s_cnt[k] = 0;
    __syncthreads();
    const int base = t * TILE;
    const int m = min(TILE, n - base);
    const int wbase = base + warp * (TILE / DWARPS);
    uint32_t dig[PER], rank[PER];
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int g = wbase + c * 32 + lane;
      dig[c] = g < n ? (__ldcg(dig_w + g) >> shift) & 0xFFu : 256u + lane;
    }
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, dig[c]);
      const bool ok = dig[c] < 256u;
      rank[c] = ok ? cnt[dig[c]] + __popc(peers & lt) : 0u;
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) cnt[dig[c]] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const uint32_t c = s_cnt[w * 256 + d];
      s_cnt[w * 256 + d] = run;
      run += c;
    }
    uint32_t before = 0;  // digit d's elements in the earlier tiles
    if (few) {
      status[t * 256] = run + 1;
      uint32_t v[FEW_TILES];
#pragma unroll
      for (int u = 0; u < FEW_TILES; ++u) v[u] = u < t ? status[u * 256] : 1u;
#pragma unroll
      for (int u = 0; u < FEW_TILES; ++u) {
        while (v[u] == 0) v[u] = status[u * 256];
        before += v[u] - 1;
      }
    } else {
      before = __ldcg(h + t);
    }
    const uint32_t loc = crx::block_inclusive<DB>(run, nullptr) - run;
    s_loc[d] = loc;
    s_out[d] = s_base[d] + before - loc;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      if (dig[c] < 256u) {
        const int g = wbase + c * 32 + lane;
        const uint32_t at = s_loc[dig[c]] + cnt[dig[c]] + rank[c];
#pragma unroll
        for (int k = 0; k < NW; ++k) stage[k * TILE + at] = __ldcg(src.w[k] + g);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += DB) {
      const uint32_t dg = (stage[dw * TILE + i] >> shift) & 0xFFu;
      const uint32_t to = s_out[dg] + static_cast<uint32_t>(i);
#pragma unroll
      for (int k = 0; k < NW; ++k) dst.w[k][to] = stage[k * TILE + i];
      if constexpr (LAST) {
        const uint32_t s = stage[3 * TILE + i];
        a.slot_group[s] = to;
        if (to < static_cast<uint32_t>(a.rep_cap))
          a.rep_orig[to] = static_cast<int32_t>(
              static_cast<uint32_t>(__ldcg(a.slot + s)));
      }
    }
    __syncthreads();
  }
  if (few) {
    part_sync(a, parts);
  } else {
    grid_sync(a);
  }
}

// sort_pass in the tile size its length takes
template <int NW, bool LAST>
__device__ void run_pass(const DedupArgs& a, uint32_t* sm, Cols<NW> src,
                         Cols<NW> dst, int dw, int shift, int digit, int n,
                         bool counted) {
  if (tile_of(n) == SMALL_TILE) {
    sort_pass<NW, SMALL_TILE, LAST>(a, sm, src, dst, dw, shift, digit, n,
                                    counted);
  } else {
    sort_pass<NW, BIG_TILE, LAST>(a, sm, src, dst, dw, shift, digit, n,
                                  counted);
  }
}

// The U keys' counts of each of their 12 digits (a short key sort's
// totals, dtot[0 .. 12)), grid-wide: shared counts, then one atomic a
// count a block.
__device__ void key_digit_counts(const DedupArgs& a, uint32_t* sm,
                                 uint32_t U) {
  for (int k = threadIdx.x; k < 12 * 256; k += DB) sm[k] = 0;
  __syncthreads();
  for (uint32_t c = blockIdx.x * DB + threadIdx.x; c < U;
       c += gridDim.x * DB) {
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const uint32_t v = __ldcg(a.sk[0][w] + c);
#pragma unroll
      for (int byte = 0; byte < 4; ++byte)
        atomicAdd(&sm[(4 * w + byte) * 256 + ((v >> (8 * byte)) & 0xFFu)], 1u);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 12 * 256; k += DB)
    if (sm[k]) atomicAdd(a.dtot + k, sm[k]);
}

// Phase 1: every tile's rows into the tile's shared table, each of its
// distinct keys into the global one (a slot holds the key's hash above
// a row of the key: a mismatched hash costs no key read), every row's
// slot recorded; the keys a tile claims written to sort side 0 (key
// words, then the slot) at a place taken from a global count; the key
// words' OR and AND.
__device__ void dedup_insert(const DedupArgs& a, uint32_t* sm) {
  uint32_t* tk = sm;                      // [3][ITILE]
  uint32_t* lslot = tk + 3 * ITILE;       // [LSLOTS]
  uint32_t* lrep = lslot + LSLOTS;        // [ITILE]
  uint32_t* sreps = lrep + ITILE;         // [ITILE]: the distinct keys' rows
  uint32_t* sclaim = sreps + ITILE;       // [ITILE]: the claimers' rows
  uint32_t* scal = sclaim + ITILE;        // 0 claims, 1 their base,
                                          // 2 distinct, 3-5 OR, 6-8 AND
  const size_t b = static_cast<size_t>(a.B);
  if (threadIdx.x < 16) scal[threadIdx.x] = threadIdx.x < 6 ? 0u : ~0u;
  __syncthreads();
  uint32_t orw[3] = {0u, 0u, 0u}, andw[3] = {~0u, ~0u, ~0u};
  const int tiles = (a.B + ITILE - 1) / ITILE;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int base = t * ITILE;
    const int n = min(ITILE, a.B - base);
    for (int k = threadIdx.x; k < LSLOTS; k += DB) lslot[k] = DEDUP_FREE;
    if (threadIdx.x == 0) scal[0] = scal[2] = 0;
#pragma unroll
    for (int e = 0; e < IPER; ++e) {
      const int p = e * DB + threadIdx.x;
      if (p < n) {
#pragma unroll
        for (int w = 0; w < 3; ++w) {
          const uint32_t v = __ldg(a.keys + w * b + base + p);
          tk[w * ITILE + p] = v;
          orw[w] |= v;
          andw[w] &= v;
        }
        lrep[p] = static_cast<uint32_t>(p);
      }
    }
    __syncthreads();
    // the tile's table: a slot holds the first row to claim it, listed
    // in sreps; equal keys find it and keep the smallest row in lrep
    int rep[IPER];
#pragma unroll
    for (int e = 0; e < IPER; ++e) {
      const int p = e * DB + threadIdx.x;
      rep[e] = p;
      if (p < n) {
        const uint32_t k0 = tk[p], k1 = tk[ITILE + p], k2 = tk[2 * ITILE + p];
        uint32_t s = key_hash(k0, k1, k2) >> 20;  // LSLOTS = 4096
        for (;;) {
          uint32_t cur = reinterpret_cast<volatile uint32_t*>(lslot)[s];
          if (cur == DEDUP_FREE) {
            cur = atomicCAS(&lslot[s], DEDUP_FREE, static_cast<uint32_t>(p));
            if (cur == DEDUP_FREE) {
              sreps[atomicAdd(&scal[2], 1u)] = static_cast<uint32_t>(p);
              break;
            }
          }
          if (tk[cur] == k0 && tk[ITILE + cur] == k1 &&
              tk[2 * ITILE + cur] == k2) {
            rep[e] = static_cast<int>(cur);
            if (static_cast<uint32_t>(p) < lrep[cur])
              atomicMin(&lrep[cur], static_cast<uint32_t>(p));
            break;
          }
          s = (s + 1) & (LSLOTS - 1);
        }
      }
    }
    __syncthreads();
    // each of the tile's keys into the global table at its smallest row
    const uint32_t distinct = scal[2];
    for (uint32_t r = threadIdx.x; r < distinct; r += DB) {
      const uint32_t p = sreps[r];
      const uint32_t k0 = tk[p], k1 = tk[ITILE + p], k2 = tk[2 * ITILE + p];
      const uint32_t hk = key_hash(k0, k1, k2);
      const unsigned long long mine =
          (static_cast<unsigned long long>(hk) << 32) |
          (static_cast<uint32_t>(base) + lrep[p]);
      uint32_t s = hk & a.t_mask;
      for (;;) {
        unsigned long long cur = __ldcg(a.slot + s);
        if (cur == SLOT_FREE) {
          cur = atomicCAS(a.slot + s, SLOT_FREE, mine);
          if (cur == SLOT_FREE) {
            sclaim[atomicAdd(&scal[0], 1u)] = p;
            break;
          }
        }
        if (static_cast<uint32_t>(cur >> 32) == hk) {
          const uint32_t row = static_cast<uint32_t>(cur);
          if (__ldg(a.keys + row) == k0 && __ldg(a.keys + b + row) == k1 &&
              __ldg(a.keys + 2 * b + row) == k2) {
            if (mine < cur) atomicMin(a.slot + s, mine);
            break;
          }
        }
        s = (s + 1) & a.t_mask;
      }
      lrep[p] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) scal[1] = scal[0] ? atomicAdd(a.misc, scal[0]) : 0u;
    __syncthreads();
    const uint32_t claims = scal[0], cbase = scal[1];
    for (uint32_t k = threadIdx.x; k < claims; k += DB) {
      const uint32_t p = sclaim[k];
#pragma unroll
      for (int w = 0; w < 3; ++w) a.sk[0][w][cbase + k] = tk[w * ITILE + p];
      a.sk[0][3][cbase + k] = lrep[p];
    }
#pragma unroll
    for (int e = 0; e < IPER; ++e) {
      const int p = e * DB + threadIdx.x;
      if (p < n) a.row_slot[base + p] = lrep[rep[e]];
    }
    __syncthreads();
  }
  // the words' OR and AND: warp, block, then one atomic a block
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const uint32_t o = __reduce_or_sync(0xFFFFFFFFu, orw[w]);
    const uint32_t n = __reduce_and_sync(0xFFFFFFFFu, andw[w]);
    if (lane == 0) {
      atomicOr(&scal[3 + w], o);
      atomicAnd(&scal[6 + w], n);
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    atomicOr(a.misc + 1 + threadIdx.x, scal[3 + threadIdx.x]);
    atomicAnd(a.misc + 4 + threadIdx.x, scal[6 + threadIdx.x]);
  }
}

__global__ void __launch_bounds__(DB, DEDUP_BLOCKS_PER_SM)
    dedup_kernel(const DedupArgs a) {
  extern __shared__ uint32_t dsm[];
  const size_t b = static_cast<size_t>(a.B);
  const size_t tid = static_cast<size_t>(blockIdx.x) * DB + threadIdx.x;
  const size_t threads = static_cast<size_t>(gridDim.x) * DB;
  // 0: the table cleared, U = 0, the ORs 0 and the ANDs all ones
  {
    uint4* t4 = reinterpret_cast<uint4*>(a.slot);
    const size_t n4 = (static_cast<size_t>(a.t_mask) + 1) / 2;
    const uint4 free4 = make_uint4(DEDUP_FREE, DEDUP_FREE, DEDUP_FREE,
                                   DEDUP_FREE);
    for (size_t j = tid; j < n4; j += threads) t4[j] = free4;
    for (size_t j = tid; j < DIGITS * 256; j += threads) a.dtot[j] = 0;
    for (size_t j = tid; j < DIGITS * FEW_TILES * 256; j += threads)
      a.status[j] = 0;
    if (tid < 7) a.misc[tid] = tid < 4 ? 0u : ~0u;
  }
  grid_sync(a);
  // 1: the hash pre-pass, the distinct keys and their slots listed
  dedup_insert(a, dsm);
  grid_sync(a);
  const uint32_t U = __ldcg(a.misc);
  // 2: their sort, least significant digit first, constant digits
  // skipped; the last pass writes the groups
  uint32_t vary[3];
  int key_passes = 0;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    vary[w] = __ldcg(a.misc + 1 + w) ^ __ldcg(a.misc + 4 + w);
    for (int shift = 0; shift < 32; shift += 8)
      key_passes += ((vary[w] >> shift) & 0xFFu) != 0;
  }
  // a short sort counts its digits' totals first (sort_pass)
  if (key_passes > 0 && short_pass(static_cast<int>(U))) {
    key_digit_counts(a, dsm, U);
    grid_sync(a);
  }
  int side = 0, done = 0;
  for (int w = 2; w >= 0; --w) {
    for (int shift = 0; shift < 32; shift += 8) {
      if (((vary[w] >> shift) & 0xFFu) == 0) continue;
      Cols<4> src, dst;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        src.w[k] = a.sk[side][k];
        dst.w[k] = a.sk[side ^ 1][k];
      }
      const int digit = 4 * w + shift / 8, u = static_cast<int>(U);
      if (++done == key_passes) {
        run_pass<4, true>(a, dsm, src, dst, w, shift, digit, u, false);
      } else {
        run_pass<4, false>(a, dsm, src, dst, w, shift, digit, u, false);
      }
      side ^= 1;
    }
  }
  grid_sync(a);
  // 3: rep slots past U hold srow[0] (jnp.nonzero's fill 0): group 0's
  // row; one key (no pass) is group 0
  const uint32_t s0 = __ldcg(a.sk[side][3]);
  const int32_t first = static_cast<int32_t>(
      static_cast<uint32_t>(__ldcg(a.slot + s0)));
  for (size_t g = tid; g <= static_cast<size_t>(a.rep_cap); g += threads) {
    if (g == static_cast<size_t>(a.rep_cap)) {
      a.rep_orig[g] = 0;
    } else {
      a.rep_valid[g] = g < U;
      if (g >= U || key_passes == 0) a.rep_orig[g] = first;
    }
  }
  if (tid == 0) {
    *a.n_unique = static_cast<int32_t>(U);
    *a.overflow = U > static_cast<uint32_t>(a.rep_cap)
                      ? static_cast<int32_t>(U - a.rep_cap)
                      : 0;
  }
  // 4: the rows in group order
  if (U == b || U == 1) {
    for (size_t r = tid; r < b; r += threads) {
      const uint32_t g =
          U == 1 ? 0u : __ldcg(a.slot_group + __ldcg(a.row_slot + r));
      const size_t at = U == 1 ? r : g;
      a.srow[at] = static_cast<int32_t>(r);
      a.gid[at] = static_cast<int32_t>(g);
    }
    return;
  }
  const int passes = (32 - __clz(static_cast<int>(U - 1)) + 7) / 8;
  Cols<2> buf[2] = {{{a.sk[0][0], a.sk[0][1]}}, {{a.sk[1][0], a.sk[1][1]}}};
  {
    // (group id, row) in row order, with the first pass's tile counts
    // (a long sort) or every pass's digit totals (a short one)
    const int tile = tile_of(a.B);
    const int tiles = (a.B + tile - 1) / tile;
    const bool few = short_pass(a.B);
    uint32_t* tot = dsm + 256;  // [passes][256]
    for (int k = threadIdx.x; k < passes * 256; k += DB) tot[k] = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      dsm[threadIdx.x] = 0;
      __syncthreads();
      const int base = t * tile;
      const int m = min(tile, a.B - base);
      for (int i = threadIdx.x; i < m; i += DB) {
        const uint32_t r = static_cast<uint32_t>(base + i);
        const uint32_t g = __ldcg(a.slot_group + __ldcg(a.row_slot + r));
        buf[0].w[0][r] = g;
        buf[0].w[1][r] = r;
        if (few) {
          for (int p = 0; p < passes; ++p)
            atomicAdd(&tot[p * 256 + ((g >> (8 * p)) & 0xFFu)], 1u);
        } else {
          atomicAdd(&dsm[g & 0xFFu], 1u);
        }
      }
      __syncthreads();
      if (!few) a.hist[threadIdx.x * tiles + t] = dsm[threadIdx.x];
      __syncthreads();
    }
    if (few) {
      __syncthreads();
      for (int k = threadIdx.x; k < passes * 256; k += DB)
        if (tot[k]) atomicAdd(a.dtot + 12 * 256 + k, tot[k]);
    }
  }
  grid_sync(a);
  const Cols<2> out = {{reinterpret_cast<uint32_t*>(a.gid),
                        reinterpret_cast<uint32_t*>(a.srow)}};
  int cur = 0;
  for (int p = 0; p < passes; ++p) {
    run_pass<2, false>(a, dsm, buf[cur],
                       p == passes - 1 ? out : buf[cur ^ 1], 0, 8 * p,
                       12 + p, a.B, p == 0);
    cur ^= 1;
  }
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

// The dedup's grid on the current device: every block must be resident
// (the grid barrier), at most DEDUP_BLOCKS_PER_SM an SM.  The first call
// on a device raises the kernel's shared-memory limit there (a per-device
// attribute) and keeps the count for that device.
// Internal linkage: a second build of this file in one process keeps
// its own.
namespace {

constexpr int MAX_DEVICES = 64;

int dedup_grid_max() {
  static int most[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  if (most[dev] == 0) {
    const size_t smem = cmm::DEDUP_SMEM_WORDS * sizeof(uint32_t);
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(cmm::dedup_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, cmm::dedup_kernel, cmm::DB, smem) != cudaSuccess)
      return -1;
    most[dev] = sms * (per_sm < cmm::DEDUP_BLOCKS_PER_SM
                           ? per_sm
                           : cmm::DEDUP_BLOCKS_PER_SM);
  }
  return most[dev];
}
}  // namespace

extern "C" int memo_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cmm::SortArgs));
  out[1] = static_cast<int>(sizeof(cmm::DedupArgs));
  out[2] = static_cast<int>(sizeof(cmm::CacheArgs));
  out[3] = static_cast<int>(sizeof(cmm::KeysArgs));
  out[4] = static_cast<int>(sizeof(cdp::PolicyView));
  return 5;
}

// MEMO_DEDUP on `stream`, one cooperative launch of at most
// DEDUP_BLOCKS_PER_SM blocks an SM; returns the launch's error.
extern "C" int launch_memo_dedup(const cmm::DedupArgs* args, void* stream) {
  using namespace cmm;
  DedupArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.rep_cap <= 0 || a.t_mask < 63u ||
      ((a.t_mask + 1u) & a.t_mask) != 0u ||
      static_cast<size_t>(a.t_mask) + 1 < 2 * static_cast<size_t>(a.B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int most = dedup_grid_max();
  if (most <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long need = (static_cast<long>(a.B) + ITILE - 1) / ITILE;
  const int grid = static_cast<int>(need < most ? need : most);
  cudaError_t e = cudaMemsetAsync(a.bar, 0, 4 * sizeof(uint32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(dedup_kernel),
                                  dim3(grid), dim3(DB), params,
                                  DEDUP_SMEM_WORDS * sizeof(uint32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
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
