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
//      last pass writing srow and gid, and rgid (each row's group id in
//      row order, MEMO_CACHE's scatter-back order) written as the pairs
//      are made; U == B puts each row at its group directly, U == 1
//      keeps the row order.
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
// MEMO_CACHE is one cooperative launch too (its phases are listed at
// its kernel below).
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
// each (1.06 ms per 2,097,152 Zipf keys on the H100).  The dedup also
// writes rgid, 4 B a row.  The cache must read one 164-byte row per
// representative and each row's group id (4 B), and write 8 B of values
// and a hit byte per tuple.  It reads the group ids and writes the values
// in row order, 16 bytes a thread, gathering each row's values from the
// U-entry arrays, which stay in the L2 (the first version scattered them
// through srow: three scattered writes a row, over 14-15 launches a call
// whose per-representative grids were sized by rep_cap).  Its
// per-representative phases run over U, and the same-bucket ranks come
// from per-bucket member lists (a count by atomics, then a run of a list
// buffer a bucket), not from a sort.
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
  int32_t* rgid;          // [B]: each row's group id, in row order
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
  const int32_t* rgid;        // MEMO_DEDUP's outputs: each row's group
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
  // scratch (kernels.cache_scratch_words), per representative [rep_cap]
  uint32_t* r_bucket;
  uint32_t* r_rank_word;
  uint32_t* r_empty;          // bit k: lane k's k0 is EMPTY
  uint32_t* r_arrive;         // its arrival in its bucket (0 first)
  uint2* rv;                  // the representatives' value words (v0, v1)
  uint32_t* hit_bits;         // [rep_cap / 32]: bit g, representative g hit
  uint32_t* seg;              // the larger buckets' later members
  uint8_t* r_hit;
  uint8_t* r_hit_lane;
  // per bucket [n_rows]: representatives, and the start + 1 of a bucket's
  // run of seg past its SLOTS members; [n_rows, SLOTS] its first members
  uint32_t* b_count;
  uint32_t* b_start;
  uint32_t* b_placed;         // members placed in the run so far
  uint32_t* b_slots;
  uint32_t* ctl;              // [CTL_WORDS]: the grid barrier's two (0
                              // between calls), then C_ALLOC ..
  int32_t B;
  int32_t rep_cap;
  int32_t n_rows;
  int32_t width;
  int32_t entries;
  int32_t ranked;
  int32_t subword;
  int32_t has_l3;
  int32_t accumulate;
  int32_t hit_smem_words;     // the hit bits' share of shared memory (set
                              // by the launcher)
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

using cdp::bar_sync;

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
      a.rgid[r] = static_cast<int32_t>(g);
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
        a.rgid[r] = static_cast<int32_t>(g);
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
//
// One cooperative launch over the U = min(n_unique, rep_cap)
// representatives, every phase grid-stride over U (or the rows), parted
// by two grid barriers (bar_sync on ctl):
//   0. the per-bucket counts, run starts and placed counts, the hit
//      bits and the control counters zeroed; the rows copied into
//      rows_out when it is another buffer;
//   1. each representative's bucket row probed (the hit, the summed
//      value words of the hit lanes, the first hit lane, the empty lanes,
//      the rank word), its arrival in the bucket counted (the index
//      atomicAdd returns; the first SLOTS arrivals written into the
//      bucket's slots), and on a miss the lattice; its value words kept
//      as one 8-byte word and its hit as a bit;
//   2. a bucket of more than SLOTS representatives gets a run of the
//      list buffer for the rest (its arrival SLOTS takes it from one
//      global count, the later ones wait for its start) and each of them
//      is written at its arrival and counted; every row takes its
//      group's value words and hit flag (its group id rgid[r] clipped to
//      rep_cap - 1) in row order, four rows a thread and four such in
//      flight, one 8-byte gather a row (the L2 serves them) and the hit
//      bits from the block's copy in shared memory, the values stored
//      coalesced with the streaming hint; an overflow of the
//      pair restores the rows; then each representative's rank among
//      its bucket's members in representative order (the members below
//      it, counted up to the lane count; a larger bucket's once its run
//      is complete), its insert lane, and the commit when nothing
//      overflowed; the last block to finish writes the stats row.

constexpr int CB = 256;  // threads a block
// resident blocks an SM (the barrier needs every block resident; 1 and
// 4 measured level or slower, PERF.md)
constexpr int CACHE_BLOCKS_PER_SM = 2;
// the control words after the barrier's two
constexpr int C_ALLOC = 2, C_INSERT = 3, C_HIT = 4, C_DONE = 5,
              CTL_WORDS = 8;
// a bucket's members held in its own slots (a Zipf batch's buckets hold
// one or two representatives); the rest go to a run of seg
constexpr uint32_t SLOTS = 4;
// the hit bits a block stages (at most 384,000 representatives: 48,000 B
// of the 48 KB a block has without opting in; more are read from hit_bits)
constexpr int HIT_SMEM_WORDS = 12000;

__device__ __forceinline__ int n_valid(const CacheArgs& a) {
  const int32_t nu = *a.n_unique;
  return nu < a.rep_cap ? nu : a.rep_cap;
}

__device__ __forceinline__ int rank_col(const CacheArgs& a) {
  return a.subword ? 4 * a.entries + a.entries / 8 : 5 * a.entries;
}

__device__ __forceinline__ void cache_sync(const CacheArgs& a) {
  bar_sync(a.ctl, gridDim.x);
}

// n words of src into dst, 16 bytes a load where both are aligned
__device__ __forceinline__ void copy_rows(const uint32_t* src, uint32_t* dst,
                                          size_t n, size_t tid,
                                          size_t threads) {
  size_t done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const size_t n4 = n / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t j = tid; j < n4; j += threads) d4[j] = __ldcg(s4 + j);
    done = 4 * n4;
  }
  for (size_t j = done + tid; j < n; j += threads) dst[j] = __ldcg(src + j);
}

// Phase 1 for representative g: the probe of its bucket row (cache_probe),
// its arrival, and on a miss the lattice (its value words replace the
// representative's).
__device__ __forceinline__ void cache_probe_rep(const CacheArgs& a, int g) {
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  const uint32_t k0 = __ldg(a.keys + r), k1 = __ldg(a.keys + b + r),
                 k2 = __ldg(a.keys + 2 * b + r);
  const uint32_t bucket = cdp::fnv1a_word(cdp::fnv1a2(k0, k1), k2) &
                          static_cast<uint32_t>(a.n_rows - 1);
  // plain loads: in place, later phases write these rows
  const uint32_t* row = a.rows_in + static_cast<size_t>(bucket) * a.width;
  const int e = a.entries;
  bool hit = false;
  uint32_t cv0 = 0, cv1 = 0, empty = 0;
  int hit_lane = -1;
  // the k0 plane eight lanes at a time, the loads started together
  for (int k8 = 0; k8 < e; k8 += 8) {
    uint32_t w0[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w0[j] = k8 + j < e ? row[k8 + j] : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k8 + j;
      if (k >= e) break;
      if (w0[j] == EMPTY) empty |= 1u << k;
      if (w0[j] == k0 && row[e + k] == k1 && row[2 * e + k] == k2) {
        hit = true;
        if (hit_lane < 0) hit_lane = k;
        cv0 += row[3 * e + k];
        cv1 += a.subword ? (row[4 * e + k / 8] >> (4 * (k % 8))) & 0xFu
                         : row[4 * e + k];
      }
    }
  }
  a.r_bucket[g] = bucket;
  a.r_rank_word[g] = a.ranked ? row[rank_col(a)] : 0u;
  a.r_empty[g] = empty;
  a.r_hit[g] = hit;
  if (hit) atomicOr(a.hit_bits + g / 32, 1u << (g % 32));
  a.r_hit_lane[g] = static_cast<uint8_t>(hit_lane < 0 ? 0 : hit_lane);
  const uint32_t arrive = atomicAdd(a.b_count + bucket, 1u);
  a.r_arrive[g] = arrive;
  if (arrive < SLOTS) a.b_slots[bucket * SLOTS + arrive] = g;
  if (hit) {
    a.rv[g] = make_uint2(cv0, cv1);
    return;
  }
  const int32_t ep = static_cast<int32_t>(a.ep_w ? __ldg(a.ep_w + r) : k2 >> 1);
  const int32_t dir =
      static_cast<int32_t>(a.dir_w ? __ldg(a.dir_w + r) : k2 & 1u);
  // the hashed tables' key planes read 16 bytes at a time (PairReads)
  const cdp::ProbeBits q = cdp::index_probes<cdp::PairReads>(
      a.pol, ep, dir, k1 >> 16, (k1 >> 8) & 0xFFu, k0, (k1 >> 1) & 1u,
      a.has_l3 ? static_cast<int>(k1 & 1u) : -1);
  a.rv[g] = make_uint2(
      (static_cast<uint32_t>(q.j) << 16) |
          (static_cast<uint32_t>(q.proxy) & 0xFFFFu),
      (q.p1 ? 1u : 0u) | (q.p2 ? 2u : 0u) | (q.p3 ? 4u : 0u));
}

// Row r takes its group's value words (one 8-byte gather) and hit flag
// (a bit of `bits`: the block's copy of hit_bits, or hit_bits itself);
// returns the hit.
__device__ __forceinline__ uint32_t scatter_row(const CacheArgs& a,
                                                const uint32_t* bits,
                                                uint32_t g, uint32_t* v0,
                                                uint32_t* v1, uint8_t* h) {
  const uint32_t last = static_cast<uint32_t>(a.rep_cap - 1);
  g = g < last ? g : last;
  const uint2 v = __ldcg(a.rv + g);
  *v0 = v.x;
  *v1 = v.y;
  *h = (bits[g / 32] >> (g % 32)) & 1u;
  return *h;
}

// The row-order scatter-back: where the columns are 16-byte aligned a
// thread takes four rows at once, and QUADS of them in flight (their
// group ids loaded together, then the groups' values); returns this
// thread's hits.  `bits` as scatter_row's.
constexpr int QUADS = 4;

__device__ __forceinline__ uint32_t cache_scatter_back(const CacheArgs& a,
                                                       const uint32_t* bits,
                                                       size_t tid,
                                                       size_t threads) {
  const size_t b = static_cast<size_t>(a.B);
  uint32_t hits = 0;
  size_t done = 0;
  const bool vec = b % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.v0) |
                     reinterpret_cast<uintptr_t>(a.v1) |
                     reinterpret_cast<uintptr_t>(a.rgid)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.hit) & 3) == 0;
  if (vec) {
    const size_t nq = b / 4;
    const uint4* gq = reinterpret_cast<const uint4*>(a.rgid);
    for (size_t q0 = tid; q0 < nq; q0 += QUADS * threads) {
      uint4 g[QUADS];
#pragma unroll
      for (int k = 0; k < QUADS; ++k) {
        const size_t q = q0 + k * threads;
        g[k] = q < nq ? __ldcs(gq + q) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < QUADS; ++k) {
        const size_t q = q0 + k * threads;
        if (q >= nq) break;
        uint32_t x0[4], x1[4];
        uint8_t h[4];
        hits += scatter_row(a, bits, g[k].x, &x0[0], &x1[0], &h[0]);
        hits += scatter_row(a, bits, g[k].y, &x0[1], &x1[1], &h[1]);
        hits += scatter_row(a, bits, g[k].z, &x0[2], &x1[2], &h[2]);
        hits += scatter_row(a, bits, g[k].w, &x0[3], &x1[3], &h[3]);
        __stcs(reinterpret_cast<uint4*>(a.v0) + q,
               make_uint4(x0[0], x0[1], x0[2], x0[3]));
        __stcs(reinterpret_cast<uint4*>(a.v1) + q,
               make_uint4(x1[0], x1[1], x1[2], x1[3]));
        __stcs(reinterpret_cast<unsigned int*>(a.hit) + q,
               static_cast<unsigned int>(h[0]) | (h[1] << 8) | (h[2] << 16) |
                   (static_cast<unsigned int>(h[3]) << 24));
      }
    }
    done = b;
  }
  for (size_t r = done + tid; r < b; r += threads) {
    uint8_t h;
    hits += scatter_row(a, bits, static_cast<uint32_t>(__ldcs(a.rgid + r)),
                        a.v0 + r, a.v1 + r, &h);
    a.hit[r] = h;
  }
  return hits;
}

// Phase 2 for representative g: its rank among its bucket's members in
// representative order, capped at the lane count, then its insert lane
// (bucket_insert_lanes): the rank-th coldest lane (empty first, then by
// rank nibble, ties by lane) with the rank word and at most 8 lanes,
// else the first empty lane (or bucket mod lanes when none is empty)
// plus the rank; the commit when `commit` (hit bumps and insert resets
// of the rank nibbles by atomic adds, the inserted entry's words, and
// in the sub-word layout v1 into its nibble by an add of the
// difference).  Returns whether it inserts (the reference's do_ins,
// counted even when the batch overflows).
__device__ __forceinline__ bool cache_rank_commit(const CacheArgs& a, int g,
                                                  bool commit) {
  const uint32_t bucket = a.r_bucket[g];
  const uint32_t c = __ldcg(a.b_count + bucket);
  const int e = a.entries;
  int rank = 0;
  if (c > 1) {
    const uint32_t* m = a.b_slots + static_cast<size_t>(bucket) * SLOTS;
    for (uint32_t k = 0; k < c && k < SLOTS; ++k)
      rank += __ldcg(m + k) < static_cast<uint32_t>(g);
    if (c > SLOTS) {  // once every member past SLOTS is in its run
      const volatile uint32_t* placed = a.b_placed + bucket;
      while (*placed != c - SLOTS) __nanosleep(32);
      __threadfence();
      m = a.seg + (__ldcg(a.b_start + bucket) - 1);
      for (uint32_t k = 0; k < c - SLOTS && rank < e; ++k)
        rank += __ldcg(m + k) < static_cast<uint32_t>(g);
    }
    rank = rank < e ? rank : e;
  }
  const uint32_t empty = a.r_empty[g];
  const uint32_t rw = a.r_rank_word[g];
  const bool lru = a.ranked && e <= 8;
  int lane;
  if (lru) {
    // insertion sort of (score, lane): empty lanes score -1
    int order[8];
    int score[8];
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
  const bool hit = a.r_hit[g] != 0;
  const bool ins = !hit && rank < e;
  if (!commit) return ins;
  uint32_t* row = a.rows_out + static_cast<size_t>(bucket) * a.width;
  if (hit) {
    const uint32_t sh = 4u * (a.r_hit_lane[g] % 8u);
    if (lru && ((rw >> sh) & 0xFu) < 15u)
      atomicAdd(row + rank_col(a), 1u << sh);
    return false;
  }
  if (!ins) return false;
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  row[lane] = __ldg(a.keys + r);
  row[e + lane] = __ldg(a.keys + b + r);
  row[2 * e + lane] = __ldg(a.keys + 2 * b + r);
  const uint2 v = a.rv[g];
  row[3 * e + lane] = v.x;
  if (a.subword) {
    const uint32_t sh = 4u * (lane % 8);
    const int col = 4 * e + lane / 8;
    // this lane's nibble: other inserts change only their own lanes'
    const uint32_t old =
        (__ldcg(a.rows_in + static_cast<size_t>(bucket) * a.width + col) >>
         sh) & 0xFu;
    atomicAdd(row + col, ((v.y & 0xFu) - old) << sh);
  } else {
    row[4 * e + lane] = v.y;
  }
  if (lru) {
    const uint32_t sh = 4u * (lane % 8);
    atomicAdd(row + rank_col(a), 0u - (((rw >> sh) & 0xFu) << sh));
  }
  return true;
}

// a count summed over the warp, then one atomicAdd a warp (every lane
// of the block calls it)
__device__ __forceinline__ void warp_count(uint32_t* at, uint32_t n) {
  const uint32_t s = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(at, s);
}

__global__ void __launch_bounds__(CB, CACHE_BLOCKS_PER_SM)
    cache_kernel(const __grid_constant__ CacheArgs a) {
  extern __shared__ uint32_t s_hits[];
  const size_t tid = static_cast<size_t>(blockIdx.x) * CB + threadIdx.x;
  const size_t threads = static_cast<size_t>(gridDim.x) * CB;
  const size_t words = static_cast<size_t>(a.n_rows + 1) * a.width;
  // 0: counts, starts and counters zeroed; the rows copied
  for (size_t j = tid; j < static_cast<size_t>(a.n_rows); j += threads) {
    a.b_count[j] = 0;
    a.b_start[j] = 0;
    a.b_placed[j] = 0;
  }
  if (tid >= 2 && tid < CTL_WORDS) a.ctl[tid] = 0;
  const int U = n_valid(a);
  const int hit_words = (U + 31) / 32;
  for (size_t j = tid; j < static_cast<size_t>(hit_words); j += threads)
    a.hit_bits[j] = 0;
  if (a.rows_out != a.rows_in) copy_rows(a.rows_in, a.rows_out, words, tid,
                                         threads);
  cache_sync(a);
  // 1: the probe, the arrivals, the lattice on the misses
  for (int g = static_cast<int>(tid); g < U; g += static_cast<int>(threads))
    cache_probe_rep(a, g);
  cache_sync(a);
  // 2: the larger buckets' runs of seg; the scatter-back; the restore;
  // the ranks, insert lanes and the commit.  A thread's waits are for
  // work its earlier loops' peers do without waiting (an allocation, a
  // placement), and every block is resident: each wait ends.
  for (int g = static_cast<int>(tid); g < U; g += static_cast<int>(threads)) {
    if (a.r_arrive[g] != SLOTS) continue;
    const uint32_t bucket = a.r_bucket[g];
    const uint32_t c = __ldcg(a.b_count + bucket);
    atomicExch(a.b_start + bucket, atomicAdd(a.ctl + C_ALLOC, c - SLOTS) + 1);
  }
  for (int g = static_cast<int>(tid); g < U; g += static_cast<int>(threads)) {
    const uint32_t arrive = a.r_arrive[g];
    if (arrive < SLOTS) continue;
    const volatile uint32_t* sp = a.b_start + a.r_bucket[g];
    uint32_t s;
    while ((s = *sp) == 0) __nanosleep(32);
    a.seg[s - 1 + arrive - SLOTS] = static_cast<uint32_t>(g);
    __threadfence();
    atomicAdd(a.b_placed + a.r_bucket[g], 1u);
  }
  // the hit bits in shared memory where they fit the launch's share
  const uint32_t* bits = a.hit_bits;
  if (hit_words <= a.hit_smem_words) {
    for (int j = threadIdx.x; j < hit_words; j += CB)
      s_hits[j] = __ldcg(a.hit_bits + j);
    __syncthreads();
    bits = s_hits;
  }
  warp_count(a.ctl + C_HIT, cache_scatter_back(a, bits, tid, threads));
  const uint32_t overflow = static_cast<uint32_t>(*a.dedup_overflow);
  const bool restoring =
      a.restore != nullptr &&
      (a.accumulate ? __ldcg(a.stats + STAT_OVERFLOW) : 0u) + overflow != 0;
  if (restoring) copy_rows(a.restore, a.rows_out, words, tid, threads);
  const bool commit = overflow == 0 && !restoring;
  uint32_t inserts = 0;
  for (int g = static_cast<int>(tid); g < U; g += static_cast<int>(threads))
    inserts += cache_rank_commit(a, g, commit);
  warp_count(a.ctl + C_INSERT, inserts);
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.ctl + C_DONE, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    uint32_t vals[5];
    vals[STAT_UNIQUE] = static_cast<uint32_t>(*a.n_unique);
    vals[STAT_HIT] = atomicAdd(a.ctl + C_HIT, 0u);
    vals[STAT_INSERT] = atomicAdd(a.ctl + C_INSERT, 0u);
    vals[STAT_OVERFLOW] = overflow;
    vals[STAT_TUPLES] = static_cast<uint32_t>(a.B);
    for (int i = 0; i < 5; ++i)
      a.stats[i] = (a.accumulate ? __ldcg(a.stats + i) : 0u) + vals[i];
  }
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

// The cache's grid on the current device: every block resident, at most
// CACHE_BLOCKS_PER_SM an SM, kept per device.
int cache_grid_max() {
  static int most[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  if (most[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, cmm::cache_kernel, cmm::CB,
            cmm::HIT_SMEM_WORDS * sizeof(uint32_t)) != cudaSuccess)
      return -1;
    most[dev] = sms * (per_sm < cmm::CACHE_BLOCKS_PER_SM
                           ? per_sm
                           : cmm::CACHE_BLOCKS_PER_SM);
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

// MEMO_CACHE on `stream`, one cooperative launch of at most
// CACHE_BLOCKS_PER_SM blocks an SM; returns the launch's error.
extern "C" int launch_memo_cache(const cmm::CacheArgs* args, void* stream) {
  using namespace cmm;
  CacheArgs a = *args;
  if (a.B <= 0 || a.rep_cap <= 0 || a.entries < 1 || a.entries > 32 ||
      a.n_rows < 1 || (a.n_rows & (a.n_rows - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the hit bits staged in shared memory: up to HIT_SMEM_WORDS words
  const long want = (static_cast<long>(a.rep_cap) + 31) / 32;
  a.hit_smem_words = static_cast<int32_t>(want < HIT_SMEM_WORDS ? want
                                                               : HIT_SMEM_WORDS);
  const size_t smem = static_cast<size_t>(a.hit_smem_words) * 4;
  const int most = cache_grid_max();
  if (most <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the widest phase: the scatter-back's four rows a thread, the
  // representatives, the rows' copy
  long work = (static_cast<long>(a.B) + 3) / 4;
  work = work > a.rep_cap ? work : a.rep_cap;
  const long copy = (static_cast<long>(a.n_rows) + 1) * a.width / 4;
  work = work > copy ? work : copy;
  const long need = (work + CB - 1) / CB;
  const int grid = static_cast<int>(need < most ? need : most);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cache_kernel), dim3(grid), dim3(CB),
      params, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
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
