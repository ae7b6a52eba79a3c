// Shared pieces of the fused datapath kernels: the launch arguments and
// their table layouts, FNV-1a (engine/hashtable.py), the masked-range
// match of the prefilters, the v6 ipcache ranges and the tunnel maps, the
// sub-word lane unpack (engine/subword.py) and the DIR-24-8 lookup
// (ipcache/lpm.py lpm_lookup_plain) of the CIDR path, the large
// prefilter and the range-heavy ipcache.
#pragma once

#include <cstdint>

namespace cdp {

// The table layouts of the v4 datapath, one template parameter per
// plane (kernels.py _fill_tables picks the instantiation):
//   prefilter  PF_RANGES the (base, mask) compare list, PF_LPM DIR-24-8
//   LB         LB_INLINE one row per service slot, LB_CLASSIC bucket
//              entries plus a backend row
//   ipcache    IPC_IDX_PLANES idx values with per-endpoint L3 words (at
//              most 32 endpoints), IPC_IDX idx values alone (probe 2
//              reads l3_allow_bits), IPC_GENERIC raw identities (the
//              lattice resolves the index through id_direct), from a
//              bucketized table or from DIR-24-8 (ipc_l1 not null)
// The ipcache's non-/32 ranges are hashed classes (ipc_range_rows not
// null) or the [B, P] scan (range_base not null), a runtime choice:
// both run only on an exact miss.
constexpr int PF_RANGES = 0, PF_LPM = 1;
constexpr int LB_INLINE = 0, LB_CLASSIC = 1;
constexpr int IPC_IDX_PLANES = 0, IPC_IDX = 1, IPC_GENERIC = 2;
constexpr int N_LAYOUTS = 2 * 2 * 3;  // layout = PF + 2 LB + 4 IPC

// Every table leaf is a u32 word array (int32 tensors holding the same
// bits on the PyTorch side).  The field order here is the ctypes
// Structure's order in kernels.py; datapath_args_size() lets the
// wrapper check that the two agree.
struct DatapathArgs {
  // pair: the pair step's flows, [2, 4, B] packed4 words, half 0
  // ingress, half 1 egress; pool_rows: the single-batch step's pool as
  // its row-major copy [pool_n, 8], which the step reads a picked flow
  // from (two 16-byte loads; see pool below).  One word, one name a kernel.
  union {
    const uint32_t* pair;
    const uint32_t* pool_rows;
  };
  // prefilter ranges [pf_n]
  const uint32_t* pf_base;
  const uint32_t* pf_mask;
  // conntrack: bucket rows [ct_nb, ct_lanes] of ct_ew-word entries,
  // 5-word stash
  const uint32_t* ct_buckets;
  const uint32_t* ct_stash;
  // LB inline rows [lb_nb, 128] and 64-lane stash slots
  const uint32_t* lb_rows;
  const uint32_t* lb_stash;
  // ipcache: bucket rows, 4-column stash, range-class rows
  const uint32_t* ipc_buckets;
  const uint32_t* ipc_stash;
  const uint32_t* ipc_range_rows;
  // policy: hashed L4 tables of l4_ew-word entries and the l4_meta
  // plane [E, 2, Kg]
  const uint32_t* l4_rows;
  const uint32_t* l4_stash;
  const uint32_t* l4w_rows;
  const uint32_t* l4w_stash;
  const uint32_t* l4_meta;
  // outputs, each [2, B] (pair) or [B] (single batch)
  uint8_t* allowed;
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint8_t* ct_result;
  uint8_t* pre_dropped;
  uint32_t* sec_id;
  uint32_t* final_daddr;
  int32_t* final_dport;
  int32_t* rev_nat;
  int32_t* lb_slave;
  uint8_t* ct_create;
  uint8_t* ct_delete;
  uint32_t* tunnel_endpoint;
  int32_t* l4_slot;
  uint8_t* ipcache_miss;
  // carried accumulators: counters [E, 2, Kg + N], telemetry [2, 20]
  uint32_t* acc;
  uint32_t* telem;
  // static layout facts
  int32_t B;
  int32_t pf_n;
  int32_t ct_nb;
  int32_t ct_lanes;
  int32_t ct_stash_n;
  int32_t lb_nb;
  int32_t lb_stash_n;
  int32_t ipc_nb;
  int32_t ipc_lanes;
  int32_t ipc_per;
  int32_t ipc_vw;
  int32_t ipc_lw;
  int32_t ipc_stash_n;
  int32_t range_nrows;
  int32_t range_lanes;
  int32_t range_e;
  int32_t n_classes;
  int32_t class_plens[4];
  int32_t range_widths[5];
  int32_t range_offs[5];
  int32_t l4_nrows;
  int32_t l4_lanes;
  int32_t l4_stash_n;
  int32_t l4w_nrows;
  int32_t l4w_lanes;
  int32_t l4w_stash_n;
  int32_t n_eps;
  int32_t kg;
  int32_t n_ids;
  uint32_t world_plus1;
  uint32_t world_l3_in;
  uint32_t world_l3_out;
  // the single-batch step: flows are pool[:, picks[i]] of an [8, pool_n]
  // pool (FLOW_COLUMNS order), read from its copy pool_rows, or pool[:, i]
  // of an [8, B] pack without picks; sec_id = id_table[idx]
  const uint32_t* pool;
  const uint32_t* picks;
  const uint32_t* id_table;
  int32_t pool_n;
  // entry words of the CT rows (4 compact, 5 wide) and of the hashed L4
  // entries (2 compact, 3 wide)
  int32_t ct_ew;
  int32_t l4_ew;
  // overlay mode: the v4 tunnel map's ranges [tun_n] and their endpoints;
  // tun_base null = no tunnel map (tunnel_endpoint written 0)
  const uint32_t* tun_base;
  const uint32_t* tun_mask;
  const uint32_t* tun_endpoint;
  int32_t tun_n;
  // the single-batch step's forms: static_dir -1 takes each flow's own
  // direction, 0 runs every flow as ingress (no LB, no tunnel), 1 as
  // egress; emit_sec_id 1 writes id_table[idx] as sec_id, 0 the raw
  // index; picks null reads flow i straight from pool[:, i] (the
  // record replay's [8, B] pack); acc and telem null skip the counters
  // and the telemetry
  int32_t static_dir;
  int32_t emit_sec_id;
  // the instantiation (PF + 2 LB + 4 IPC, see above)
  int32_t layout;
  // PF_LPM: the prefilter's DIR-24-8 tables (l1 [2^24], l2 [pf_blocks,
  // 256]); a nonzero lookup drops
  const uint32_t* pf_l1;
  const uint32_t* pf_l2;
  int32_t pf_blocks;
  // LB_CLASSIC: lb_rows are the service bucket rows [lb_nb, 128] of 32
  // planar 4-word entries, lb_stash the [lb_stash_n, 4] entries, and
  // these the backend rows [lb_backend_n, 128]
  const uint32_t* lb_backends;
  int32_t lb_backend_n;
  // the ipcache stash's columns (4 with L3 words, else 2)
  int32_t ipc_stash_w;
  // IPC_GENERIC from DIR-24-8: ipc_l1 [2^24], ipc_l2 [ipc_blocks, 256]
  const uint32_t* ipc_l1;
  const uint32_t* ipc_l2;
  int32_t ipc_blocks;
  // the [B, P] range scan (range_base not null): n_ranges ranges, stored
  // plen + 1, values, and with L3 planes the per-endpoint words; staged
  // in shared memory per block
  const uint32_t* range_base;
  const uint32_t* range_mask;
  const uint32_t* range_plen;
  const uint32_t* range_value;
  const uint32_t* range_l3_in;
  const uint32_t* range_l3_out;
  int32_t n_ranges;
  // probe 2 without L3 planes: l3_allow_bits [n_eps, 2, n_words]; and
  // IPC_GENERIC's identity -> index table id_direct [direct_n] (two
  // regions split at lo_len)
  const uint32_t* l3_allow;
  const uint32_t* id_direct;
  int32_t n_words;
  int32_t direct_n;
  uint32_t lo_len;
  // the pair step's memo mode (csrc/datapath.cu): memo 1 is the front
  // pass, which runs stages 1-5, writes the lattice-free columns and the
  // three policy-key words memo_keys [2, 3, B]; memo 2 is the back pass,
  // which reads those columns, the keys and the memo's value words
  // memo_vals [2, 2, B] (v0, v1) and runs the combine, the counters and
  // the telemetry (both only when memo_stats [5] shows no overflow) and
  // the tunnel stage; memo 0 is the plain pair step
  uint32_t* memo_keys;
  const uint32_t* memo_vals;
  const uint32_t* memo_stats;
  int32_t memo;
  // the dense lattice (l4_rows null, K8's dense branch): port_slot
  // [256, 65536] (u16 values in int32) and l4_allow_bits [n_eps, 2, kg,
  // n_words]
  const uint32_t* port_slot;
  const uint32_t* l4_allow;
};

constexpr uint32_t FNV_OFFSET = 2166136261u;
constexpr uint32_t FNV_PRIME = 16777619u;

// one u32 word into the running hash, byte by byte, wrapping multiply
__device__ __forceinline__ uint32_t fnv1a_word(uint32_t h, uint32_t w) {
#pragma unroll
  for (int s = 0; s < 32; s += 8) h = (h ^ ((w >> s) & 0xFFu)) * FNV_PRIME;
  return h;
}

__device__ __forceinline__ uint32_t fnv1a1(uint32_t a) {
  return fnv1a_word(FNV_OFFSET, a);
}

__device__ __forceinline__ uint32_t fnv1a2(uint32_t a, uint32_t b) {
  return fnv1a_word(fnv1a_word(FNV_OFFSET, a), b);
}

__device__ __forceinline__ uint32_t fnv1a4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d) {
  return fnv1a_word(fnv1a_word(fnv1a2(a, b), c), d);
}

// FNV-1a over n words
__device__ __forceinline__ uint32_t fnv1a_n(const uint32_t* w, int n) {
  uint32_t h = FNV_OFFSET;
  for (int k = 0; k < n; ++k) h = fnv1a_word(h, w[k]);
  return h;
}

// Whether an address of L u32 limbs lies in range p of a masked-range
// table (base, mask [n, L]): every (limb & mask) == base.  Padding rows
// (mask 0, base limb0 1) never match.
template <int L>
__device__ __forceinline__ bool range_match(const uint32_t* base,
                                            const uint32_t* mask, int p,
                                            const uint32_t* ip) {
  bool m = true;
#pragma unroll
  for (int l = 0; l < L; ++l)
    m &= (ip[l] & __ldg(mask + p * L + l)) == __ldg(base + p * L + l);
  return m;
}

// field k of a plane holding 32 / width fields of `width` bits per lane
__device__ __forceinline__ uint32_t unpack_lane(const uint32_t* plane, int k,
                                                int width) {
  if (width == 32) return plane[k];
  const int per = 32 / width;
  return (plane[k / per] >> ((k % per) * width)) & ((1u << width) - 1u);
}

__device__ __forceinline__ int lanes_for(int entries, int width) {
  const int per = 32 / width;
  return (entries + per - 1) / per;
}

// -- how a stage reads its rows ------------------------------------------------
// A stage's row walk reads a row's key plane and compares every word
// (the other planes only where the key matches), then walks its stash.
// Reads<CH, LDG_STASH> says how: CH = 4 reads the key plane in 16-byte
// loads where the plane is 16-byte aligned (the pair kernel of
// csrc/datapath.cu), CH = 1 word by word; LDG_STASH reads the stash
// through the read-only path, which only a stash in global memory takes
// (the pair kernel's may lie in shared memory).  Every other kernel runs
// the stages as ThreadReads.
template <int CH, bool LDG_STASH>
struct Reads {
  static_assert(CH == 1 || CH == 4, "a key plane is read by words or by 16 B");

  // match(e, key) for each word e < n of the key plane
  template <typename Match>
  static __device__ __forceinline__ void keys(const uint32_t* plane, int n,
                                              Match&& match) {
    if constexpr (CH == 1) {
      for (int e = 0; e < n; ++e) match(e, __ldg(plane + e));
    } else {
      const bool vec = (reinterpret_cast<uintptr_t>(plane) & 15) == 0;
      for (int e0 = 0; e0 < n; e0 += 4) {
        uint32_t w[4];
        const int m = n - e0;
        if (vec && m >= 4) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(plane + e0));
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else {
          w[0] = __ldg(plane + e0);
#pragma unroll
          for (int j = 1; j < 4; ++j) w[j] = j < m ? __ldg(plane + e0 + j) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e0 + j < n) match(e0 + j, w[j]);
      }
    }
  }

  static __device__ __forceinline__ uint32_t stash(const uint32_t* p) {
    if constexpr (LDG_STASH) {
      return __ldg(p);
    } else {
      return *p;
    }
  }
};

using ThreadReads = Reads<1, true>;
using PairReads = Reads<4, false>;

constexpr uint32_t BLOCK_FLAG = 1u << 31;

// DIR-24-8: l1[ip >> 8], and for a block cell l2[block, ip & 0xFF] (the
// block row clamps, as an XLA gather does); 0 = no entry.
__device__ __forceinline__ uint32_t dir24_8(const uint32_t* l1,
                                            const uint32_t* l2, int n_blocks,
                                            uint32_t ip) {
  const uint32_t v1 = __ldg(l1 + (ip >> 8));
  if (!(v1 & BLOCK_FLAG)) return v1;
  const uint32_t last = static_cast<uint32_t>(n_blocks - 1);
  const uint32_t b = v1 & ~BLOCK_FLAG;
  return __ldg(l2 + static_cast<size_t>(b < last ? b : last) * 256 +
               (ip & 0xFFu));
}

// -- a grid barrier -----------------------------------------------------------
// Blocks 0 .. parts - 1 wait here until all of them have arrived (the
// launch is cooperative: every block is resident); writes before it are
// seen by __ldcg loads after it.  bar[0] counts arrivals (0 between
// barriers: the last to arrive resets it), bar[1] the barriers passed.
// MEMO_DEDUP and MEMO_CACHE (memo.cu) and the mesh combines (mesh.cu)
// part their phases with it.
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

// -- counter cells aggregated a block -------------------------------------------
// A counter kernel's hits, one cell of a u32 counter buffer a thread (-1:
// none), added with one global atomic a distinct cell and block where the
// block's table has room: a warp's equal cells meet by __match_any_sync,
// and their leader adds the warp's count into the block's CellTable (open
// addressing over CELL_SLOTS cells in shared memory, CELL_PROBES slots
// tried, else straight into the buffer); cell_flush commits the table.  A
// hot cell (the hottest rows of a Zipf stream all count in one cell) thus
// takes one same-address atomic a block in place of one a hit.  Integer
// adds commute, so the buffer ends as with one atomicAdd a hit, bit for
// bit.  LATTICE's counter form and the memo mode's back pass count so.
constexpr int CELL_SLOTS = 512;
constexpr int CELL_SLOT_BITS = 9;
constexpr int CELL_PROBES = 4;
constexpr uint32_t CELL_EMPTY = 0xFFFFFFFFu;

struct CellTable {
  uint32_t cell[CELL_SLOTS];
  uint32_t n[CELL_SLOTS];
};

// Every thread of the block, before its first cell_add.
__device__ __forceinline__ void cell_init(CellTable& t) {
  for (int k = threadIdx.x; k < CELL_SLOTS; k += blockDim.x) {
    t.cell[k] = CELL_EMPTY;
    t.n[k] = 0;
  }
  __syncthreads();
}

// Every lane of the warp; `cell` < 0 adds nothing.  PROBES slots are
// tried before the buffer takes the add.
template <int PROBES = CELL_PROBES>
__device__ __forceinline__ void cell_add(CellTable& t, uint32_t* acc,
                                         int64_t cell) {
  const uint32_t hit = __ballot_sync(0xFFFFFFFFu, cell >= 0);
  if (cell < 0) return;
  const uint32_t peers =
      __match_any_sync(hit, static_cast<unsigned long long>(cell));
  if ((threadIdx.x & 31) != __ffs(peers) - 1) return;
  const uint32_t n = static_cast<uint32_t>(__popc(peers));
  if (cell < CELL_EMPTY) {
    const uint32_t c = static_cast<uint32_t>(cell);
    uint32_t s = (c * 2654435761u) >> (32 - CELL_SLOT_BITS);
    for (int k = 0; k < PROBES; ++k) {
      const uint32_t was = atomicCAS(&t.cell[s], CELL_EMPTY, c);
      if (was == CELL_EMPTY || was == c) {
        atomicAdd(&t.n[s], n);
        return;
      }
      s = (s + 1) & (CELL_SLOTS - 1);
    }
  }
  atomicAdd(acc + cell, n);
}

// Every thread of the block, after its last cell_add.
__device__ __forceinline__ void cell_flush(const CellTable& t, uint32_t* acc) {
  __syncthreads();
  for (int k = threadIdx.x; k < CELL_SLOTS; k += blockDim.x)
    if (t.cell[k] != CELL_EMPTY) atomicAdd(acc + t.cell[k], t.n[k]);
}

}  // namespace cdp
