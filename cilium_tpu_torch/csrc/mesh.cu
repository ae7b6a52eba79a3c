// The policy lattice on a (batch x table) mesh, three CUDA kernels for
// Hopper (sm_90a), and the memo on the mesh's three (MESH_MEMO_PROBE,
// MESH_MEMO_COMBINE, MESH_MEMO_INSERT: see their section).  Each
// replaces one part of a `shard_map` step of the JAX package's
// cilium_tpu/engine/sharded.py; the port's step is a loop over the mesh
// coordinates (cilium_tpu_torch/engine/sharded.py), one probe launch per
// shard and one combine launch per batch row.
//
// MESH_PROBE is the shard-local step of `make_mesh_evaluator` (:172, the
// body :213-250): the replicated id_direct, port_slot and l4_meta give
// the tuple's global identity index and L4 slot; the shard tests only the
// l4_allow_bits and l3_allow_bits words it owns.
// ROUTED_PROBE is the shard-local step of `make_partitioned_evaluator`
// (:292, the body :376-470) and, in failover mode, of
// `failover_lattice_probes` (:917): the FNV-1a bucket of the exact key
// (fnv1a2, common.cuh) is compared on the shard that owns its row only
// (l4_row_parts, verdict.cuh), the stash and the wildcard probe are
// replicated, the L3 word is read on its owner; in failover mode a dead
// primary owner's row or word is read from the backup region one shard
// over, and the tuple is flagged as served from a replica.
// MESH_COMBINE is the table-axis psum of one batch row's tp partial
// records fused with `_combine` and the epilogue of `_counts_and_telemetry`
// (:114-171) and `failover_counts` (:1063): the ORs and the value sum,
// the lattice combine, the L4-slot counters, the L3 counters on the
// word's owner (its slice of the row's buffer), the row's [2, 20]
// telemetry and the replica count, all masked by `valid` when given.
//
// A probe writes a partial record int32 per tuple.  MESH_PROBE's is
// [4, B]: row 0 the flags (F_*), row 1 the proxy, row 2 the slot j, row 3
// the tuple's L3 counter column in the shard's slice.  ROUTED_PROBE's is
// [5, B]: the flags, the owner's exact value, the stash value, the
// wildcard value, the L3 column.  Integer adds commute, so the counters'
// atomics give the reference's sums exactly.
//
// What bounds them on an H100: dependent reads, as LATTICE (lattice.cu).
// A probe streams the tuple's 20 B in (not the fragment word) and its
// record out, and reads one id_direct word, the mesh probe one port_slot
// word, one l4_meta word, one l4_allow_bits and one l3_allow_bits word
// (dense_probes, verdict.cuh), the routed probe one hashed row on its
// owner and the wildcard row, the stash and one L3 word; the combine
// reads the tuple's ep, dir and fragment words, the flags of every record
// (and in routed mode the owner's value), the head record's other words
// and, for an L3 hit, the owner's L3 column, writes 6 B of verdict, and
// writes its counter buffers whole (the l3 buffer, [E, 2, l3_shards x
// c_local], is 17 MB at config 5's partitioned (2, 4) mesh and 34 MB in
// the failover layout).  MESH_PROBE and the memo's probe and insert do
// the simple thing: one tuple per thread, read-only loads.  ROUTED_PROBE
// runs the pair kernel's per-flow design (see its kernel).  MESH_COMBINE
// and each of MESH_MEMO_COMBINE's two passes are one cooperative launch
// that zeroes its counter buffers, waits at a grid barrier and then
// counts (no fill launch before it); their telemetry is telem.cuh's one
// ballot a column (see the kernels).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "radix.cuh"
#include "telem.cuh"
#include "verdict.cuh"

namespace cms {

using cdp::clip_u;
using cdp::gather_ix;
using cdp::PolicyView;

constexpr int BLOCK = 256;
constexpr int MAX_TP = 16;
constexpr uint32_t F_P1 = 1, F_P2 = 2, F_REPLICA = 4, F_P3 = 8, F_KNOWN = 16,
                   F_STASH = 32;
constexpr int MODE_MESH = 0, MODE_ROUTED = 1;

// The field orders are the ctypes Structures' orders in kernels.py;
// mesh_struct_sizes() lets the wrapper check that they agree.
struct MeshProbeArgs {
  const uint32_t* tuples;  // [6, B] u32 words
  // replicated id_direct, port_slot, l4_meta; l4_allow [E, 2, Kg, n_words]
  // and l3_allow [E, 2, n_words] this shard's word slices; n_ids global
  PolicyView pol;
  int32_t* out;  // [4, B]
  int32_t B;
  int32_t w_off;  // the shard's first word
};

struct RoutedProbeArgs {
  const uint32_t* tuples;
  // replicated id_direct, stashes and wildcard rows; l4.rows this shard's
  // resident rows, l3_allow [E, 2, n_words] its resident words
  PolicyView pol;
  const uint8_t* alive;  // [ntp] this batch row's chips (failover)
  int32_t* out;          // [5, B]
  int32_t B;
  int32_t t;  // this shard's table index
  int32_t ntp;
  int32_t rows_sharded;
  int32_t l3_sharded;
  int32_t failover;
  int32_t n_rows_global;  // the bucket mask + 1
  int32_t n_local;        // resident rows per shard (not failover)
  int32_t w_local;        // resident words per shard (not failover)
  int32_t n_row_shard;    // failover: un-augmented rows per shard
  int32_t wn;             // failover: un-augmented words per shard
  int32_t n_ids;
};

// A combine's counter buffers, one region that the kernel zeroes before
// it counts: l4 [E, 2, Kg] at word 0, l3 [E, 2, l3_shards * c_local] at
// l3_at, the telemetry [2, 20] at telem_at (-1: none), the replica count
// at replica_at; `words` in all, a multiple of 4 (the region 16-byte
// aligned).
struct Counts {
  uint32_t* base;
  int64_t l3_at;
  int64_t telem_at;
  int64_t replica_at;
  int64_t words;
};

struct CombineArgs {
  // tp records on this device: [4, B] (MODE_MESH) or [5, B] (MODE_ROUTED)
  const int32_t* parts[MAX_TP];
  const uint32_t* tuples;        // [6, B]
  const uint32_t* meta;          // l4_meta [E, 2, Kg]
  const uint8_t* valid;          // [B] or null (all valid)
  uint8_t* allowed;              // outputs [B]
  int32_t* proxy_port;
  uint8_t* match_kind;
  Counts counts;      // l4, l3, telemetry, replica (zeroed here)
  uint32_t* bar;      // [2] the grid barrier (held, zero between launches)
  int32_t B;
  int32_t tp;
  int32_t mode;
  int32_t ew;
  int32_t n_eps;
  int32_t kg;
  int32_t l3_shards;
  int32_t c_local;
};

// A probe's words of the tuple (the fragment word is the combine's).
struct Tuple {
  int32_t ep, dir;
  uint32_t ident, dport, proto;
};

__device__ __forceinline__ Tuple load_tuple(const uint32_t* t, size_t b,
                                            int i) {
  Tuple u;
  u.ep = static_cast<int32_t>(__ldg(t + i));
  u.ident = __ldg(t + b + i);
  u.dport = clip_u(static_cast<int32_t>(__ldg(t + 2 * b + i)), 65535);
  u.proto = clip_u(static_cast<int32_t>(__ldg(t + 3 * b + i)), 255);
  u.dir = static_cast<int32_t>(__ldg(t + 4 * b + i));
  return u;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(BLOCK) mesh_probe_kernel(
    const MeshProbeArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B) return;
  const size_t b = static_cast<size_t>(a.B);
  const Tuple u = load_tuple(a.tuples, b, i);
  const PolicyView& p = a.pol;
  bool known;
  const uint32_t idx = cdp::index_identity(p, u.ident, &known);
  // the shard's word of idx; a word it does not own tests no bit
  const int w_local = p.n_words;
  int64_t wl = static_cast<int64_t>(idx >> 5) - a.w_off;
  const bool in_shard = wl >= 0 && wl < w_local;
  wl = clamp64(wl, 0, w_local - 1);
  const uint32_t bit = idx & 31u;
  const cdp::Probes q = cdp::dense_probes(
      p.port_slot, p.l4_allow, p.l4.meta, p.l4.n_eps, p.l4.kg, w_local, u.ep,
      u.dir, u.dport, u.proto, static_cast<int>(wl), bit, known && in_shard);
  const size_t row = static_cast<size_t>(gather_ix(u.ep, p.l4.n_eps)) * 2 +
                     gather_ix(u.dir, 2);
  const uint32_t l3 = __ldg(p.l3_allow + row * w_local + wl);
  const bool p2 = known && in_shard && ((l3 >> bit) & 1u);
  const int64_t lcol =
      clamp64(static_cast<int64_t>(idx) - static_cast<int64_t>(a.w_off) * 32,
              0, static_cast<int64_t>(w_local) * 32 - 1);
  int32_t* out = a.out;
  out[i] = static_cast<int32_t>((q.p1 ? F_P1 : 0u) | (p2 ? F_P2 : 0u) |
                                (q.p3 ? F_P3 : 0u));
  out[b + i] = q.proxy;
  out[2 * b + i] = q.j;
  out[3 * b + i] = static_cast<int32_t>(lcol);
}

// ROUTED_PROBE's design (the pair kernel's per-flow design of
// csrc/datapath.cu): one thread a tuple, the tuple's words read and the
// record's written with the streaming hints; the key planes of both L4
// rows read in 16-byte loads (PairReads) where a row is 16-byte aligned;
// both stashes staged once a block in shared memory when they fit
// ROUTED_STASH_SMEM bytes, else read from global memory by the same
// code; the wildcard probe, whose keys do not depend on the identity,
// started before the id_direct -> exact row chain; the exact row and the
// L3 word read only on the shard that owns them (a shard's other tuples
// contribute zeros, which need no read); the failover mode's
// index arithmetic in 32 bits (u32 divisions by the shard's rows and
// words, the backup shard by a compare), with the same results as the
// 64-bit arithmetic on every index; registers fitted to
// ROUTED_BLOCKS_PER_SM blocks an SM, the body a grid-stride loop that
// runs once (as the pair kernel's).
constexpr int ROUTED_BLOCKS_PER_SM = 8;  // 4 and 6 measured slower, PERF.md
constexpr int ROUTED_STASH_SMEM = 16 * 1024;

__host__ __device__ inline int routed_stash_words(const RoutedProbeArgs& a) {
  return a.pol.l4.ew * (a.pol.l4.stash_n + a.pol.l4.wstash_n);
}

__host__ __device__ inline bool routed_stashes_staged(
    const RoutedProbeArgs& a) {
  return routed_stash_words(a) * 4 <= ROUTED_STASH_SMEM;
}

// (q + 1) % n, the compare first (q < n on every index the tables make)
__device__ __forceinline__ uint32_t next_shard(uint32_t q, uint32_t n) {
  return q + 1 < n ? q + 1 : (q + 1) % n;
}

__global__ void __launch_bounds__(BLOCK, ROUTED_BLOCKS_PER_SM)
    routed_probe_kernel(const __grid_constant__ RoutedProbeArgs a) {
  extern __shared__ uint32_t s_stash[];
  const PolicyView& p = a.pol;
  const cdp::L4Tables& l4 = p.l4;
  const uint32_t* ex_stash = l4.stash;
  const uint32_t* wd_stash = l4.wstash;
  if (routed_stashes_staged(a)) {
    const int n_ex = l4.ew * l4.stash_n, n_wd = l4.ew * l4.wstash_n;
    for (int k = threadIdx.x; k < n_ex; k += BLOCK)
      s_stash[k] = __ldg(l4.stash + k);
    for (int k = threadIdx.x; k < n_wd; k += BLOCK)
      s_stash[n_ex + k] = __ldg(l4.wstash + k);
    __syncthreads();
    ex_stash = s_stash;
    wd_stash = s_stash + n_ex;
  }
  const size_t b = static_cast<size_t>(a.B);
  const uint32_t ntp = static_cast<uint32_t>(a.ntp);
  const uint32_t t = static_cast<uint32_t>(a.t);
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < a.B;
       i += gridDim.x * BLOCK) {
    const uint32_t* tw = a.tuples;
    const int32_t ep = static_cast<int32_t>(__ldcs(tw + i));
    const uint32_t ident = __ldcs(tw + b + i);
    const uint32_t dport =
        clip_u(static_cast<int32_t>(__ldcs(tw + 2 * b + i)), 65535);
    const uint32_t proto =
        clip_u(static_cast<int32_t>(__ldcs(tw + 3 * b + i)), 255);
    const int32_t dir = static_cast<int32_t>(__ldcs(tw + 4 * b + i));
    const uint32_t ep32 = static_cast<uint32_t>(ep);
    const uint32_t dir32 = static_cast<uint32_t>(dir);

    // -- the wildcard probe, replicated (no identity in its keys)
    uint32_t v0, v1;
    cdp::l4_keys(l4.ew, ep32, dir32, dport, proto, cdp::L4H_WILD_IDX, &v0,
                 &v1);
    const cdp::L4Probe wd = cdp::l4_probe_ew<cdp::PairReads>(
        l4.wrows, l4.wnrows, l4.wlanes, wd_stash, l4.wstash_n, l4.ew, v0, v1);

    // -- the exact probe, routed to the bucket row's owner
    bool known;
    const uint32_t idx = cdp::index_identity(p, ident, &known);
    uint32_t w0, w1;
    cdp::l4_keys(l4.ew, ep32, dir32, dport, proto, idx, &w0, &w1);
    const uint32_t bucket =
        cdp::fnv1a2(w0, w1) & static_cast<uint32_t>(a.n_rows_global - 1);
    bool owns = true, replica = false;
    uint32_t bl = bucket;
    if (a.rows_sharded && a.failover) {
      const uint32_t n = static_cast<uint32_t>(a.n_row_shard);
      const uint32_t q = bucket / n;
      const bool ap = a.alive[q] != 0;
      owns = (ap ? q : next_shard(q, ntp)) == t;
      const uint32_t r = bucket - q * n + (ap ? 0u : n);
      bl = r < 2 * n - 1 ? r : 2 * n - 1;
      replica = owns && !ap;
    } else if (a.rows_sharded) {
      const int64_t l =
          static_cast<int64_t>(bucket) - static_cast<int64_t>(a.t) * a.n_local;
      owns = l >= 0 && l < a.n_local;
      bl = static_cast<uint32_t>(clamp64(l, 0, a.n_local - 1));
    }
    // a row this shard does not own contributes nothing: not read
    cdp::L4Probe ex{false, 0u};
    if (owns)
      ex = cdp::l4_row_parts<cdp::PairReads>(
          l4.rows + static_cast<size_t>(bl) * l4.lanes, l4.lanes, l4.ew, w0,
          w1);
    const cdp::L4Probe st = cdp::l4_stash_parts<cdp::PairReads>(
        ex_stash, l4.stash_n, l4.ew, w0, w1);

    // -- the L3 word, on its owner
    const uint32_t word = idx >> 5;
    const uint32_t bit = idx & 31u;
    bool owns_w = true;
    int64_t wl = word, lcol;
    if (a.l3_sharded && a.failover) {
      const uint32_t wn = static_cast<uint32_t>(a.wn);
      const uint32_t wp = word / wn;
      const bool apw = a.alive[wp] != 0;
      owns_w = (apw ? wp : next_shard(wp, ntp)) == t;
      const uint32_t r = word - wp * wn + (apw ? 0u : wn);
      wl = r < 2 * wn - 1 ? r : 2 * wn - 1;
      replica = replica || (owns_w && !apw);
      const int64_t g = static_cast<int64_t>(wn) * 32;
      lcol = clamp64(static_cast<int64_t>(idx) - static_cast<int64_t>(wp) * g,
                     0, g - 1) +
             (apw ? 0 : g);
    } else if (a.l3_sharded) {
      const int64_t off = static_cast<int64_t>(a.t) * a.w_local;
      wl = static_cast<int64_t>(word) - off;
      owns_w = wl >= 0 && wl < a.w_local;
      wl = clamp64(wl, 0, a.w_local - 1);
      lcol = clamp64(static_cast<int64_t>(idx) - off * 32, 0,
                     static_cast<int64_t>(a.w_local) * 32 - 1);
    } else {
      lcol = clamp64(idx, 0, a.n_ids - 1);
    }
    const size_t row = static_cast<size_t>(gather_ix(ep, l4.n_eps)) * 2 +
                       gather_ix(dir, 2);
    const uint32_t l3 =
        owns_w ? __ldg(p.l3_allow + row * p.n_words +
                       gather_ix(static_cast<int32_t>(wl), p.n_words))
               : 0u;
    const bool p2 = known && owns_w && ((l3 >> bit) & 1u);
    const uint32_t flags = ((ex.hit && owns) ? F_P1 : 0u) | (p2 ? F_P2 : 0u) |
                           (replica ? F_REPLICA : 0u) | (wd.hit ? F_P3 : 0u) |
                           (known ? F_KNOWN : 0u) | (st.hit ? F_STASH : 0u);
    int32_t* out = a.out;
    __stcs(out + i, static_cast<int32_t>(flags));
    __stcs(out + b + i, static_cast<int32_t>(owns ? ex.val : 0u));
    __stcs(out + 2 * b + i, static_cast<int32_t>(st.val));
    __stcs(out + 3 * b + i, static_cast<int32_t>(wd.val));
    __stcs(out + 4 * b + i, static_cast<int32_t>(lcol));
  }
}

// The table-axis sum of ROUTED_PROBE's records for tuple i (the flags OR
// `any`, the owners' values summed into `val1`, the head record's flags
// f0) decoded into the lattice inputs (sharded.routed_lattice): the exact
// hit, the wildcard hit and the proxy and slot of the first probe that
// hit (3-word entries carry both in the value; 2-word entries the slot,
// the proxy from l4_meta).
struct Routed {
  bool p1, p2, p3;
  int32_t proxy, j;
};

__device__ __forceinline__ Routed routed_decode(const int32_t* head, size_t b,
                                                int i, uint32_t f0,
                                                uint32_t any, uint32_t val1,
                                                const uint32_t* meta, int ew,
                                                int n_eps, int kg, int32_t ep,
                                                int32_t dir) {
  Routed r;
  const bool found1 = (any & F_P1) || (f0 & F_STASH);
  val1 += static_cast<uint32_t>(__ldg(head + 2 * b + i));
  r.p1 = (f0 & F_KNOWN) && found1;
  r.p2 = any & F_P2;
  r.p3 = f0 & F_P3;
  const uint32_t val =
      r.p1 ? val1 : static_cast<uint32_t>(__ldg(head + 3 * b + i));
  if (ew == 3) {
    r.proxy = static_cast<int32_t>(val & 0xFFFFu);
    r.j = static_cast<int32_t>(val >> 16);
  } else {
    r.j = static_cast<int32_t>(val);
    const uint32_t m = __ldg(
        meta + (static_cast<size_t>(gather_ix(ep, n_eps)) * 2 +
                gather_ix(dir, 2)) * kg +
        gather_ix(r.j, kg));
    r.proxy = (r.p1 || r.p3) ? static_cast<int32_t>(m >> 1) : 0;
  }
  return r;
}

// engine/verdict.py telemetry_masks with the datapath's stages absent
// (zeros: no prefilter, CT_NEW, no LB, no ipcache miss), one bit a column
__device__ __forceinline__ uint32_t telem_bits(const cdp::Lattice& v) {
  const uint32_t kind = v.kind;
  const bool al = v.allowed;
  return 1u | (al ? 1u << 1 : 0u) | (!al ? 1u << 2 : 0u) |
         ((!al && kind == cdp::MATCH_NONE) ? 1u << 4 : 0u) |
         ((!al && kind == cdp::MATCH_FRAG_DROP) ? 1u << 5 : 0u) |
         (kind == cdp::MATCH_L4 ? 1u << 6 : 0u) |
         (kind == cdp::MATCH_L3 ? 1u << 7 : 0u) |
         (kind == cdp::MATCH_L4_WILD ? 1u << 8 : 0u) |
         (kind == cdp::MATCH_NONE ? 1u << 9 : 0u) |
         (kind == cdp::MATCH_FRAG_DROP ? 1u << 10 : 0u) | (1u << 12) |
         ((v.proxy > 0 && al) ? 1u << 19 : 0u);
}

// jax's scatter-add at [e, d, c] of an [n_eps, 2, cols] buffer: the cell's
// index, -1 when the update is dropped (negative indices count from the
// end, an index still outside drops it).
__device__ __forceinline__ int64_t cell_of(int n_eps, int64_t cols,
                                           int32_t ep, int32_t dir,
                                           int64_t c) {
  const int64_t e = ep < 0 ? static_cast<int64_t>(ep) + n_eps : ep;
  const int64_t d = dir < 0 ? static_cast<int64_t>(dir) + 2 : dir;
  if (c < 0) c += cols;
  return (e >= 0 && e < n_eps && d >= 0 && d < 2 && c >= 0 && c < cols)
             ? (e * 2 + d) * cols + c
             : -1;
}

// Every thread of the grid, before the barrier: the counter buffers
// zeroed, 16 bytes a store.
__device__ __forceinline__ void zero_counts(const Counts& c) {
  uint4* z = reinterpret_cast<uint4*>(c.base);
  const int64_t n = c.words / 4;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
       k < n; k += static_cast<int64_t>(gridDim.x) * BLOCK)
    z[k] = make_uint4(0u, 0u, 0u, 0u);
}

// MESH_COMBINE's design (the parent's one-tuple-a-thread kernel took
// 0.1058 device ms on a batch row of 2,097,152 tuples and 4 records, of
// which 0.024 the telemetry, 0.022 the atomics and 0.012 the wrapper's
// four zero fills; 0.0333 at the reshard's 131,072 tuples, 0.022 of it
// the fills; PERF.md section 5): one cooperative launch of
// COMBINE_BLOCKS_PER_SM blocks an SM that first zeroes the counter
// buffers (one region, 16-byte stores; no fill launch), then, behind a
// grid barrier, walks the tuples a block-stride round at a time: each
// record's flags read once (their F_P2 bits kept as a mask, so the L3
// loop reads only the owners' columns), one global atomicAdd a counted
// hit (the hits fall in spread cells: 1,079,287 L3 hits in 849,776 cells
// at config 5, where a block's cell table finds nothing to merge), the
// telemetry one ballot a column with the replica count (telem.cuh),
// committed once a block.
constexpr int COMBINE_BLOCKS_PER_SM = 8;  // 4, 6 measured slower

__global__ void __launch_bounds__(BLOCK, COMBINE_BLOCKS_PER_SM)
    mesh_combine_kernel(const __grid_constant__ CombineArgs a) {
  zero_counts(a.counts);
  cdp::bar_sync(a.bar, gridDim.x);
  uint32_t* l4 = a.counts.base;
  uint32_t* l3 = a.counts.base + a.counts.l3_at;
  uint32_t* telem =
      a.counts.telem_at < 0 ? nullptr : a.counts.base + a.counts.telem_at;
  const size_t b = static_cast<size_t>(a.B);
  const bool mesh = a.mode == MODE_MESH;
  const int64_t l3_cols = static_cast<int64_t>(a.l3_shards) * a.c_local;
  const size_t lrow = (mesh ? 3 : 4) * b;
  const uint32_t l3_parts = (1u << a.l3_shards) - 1u;
  uint32_t n_in = 0, n_out = 0, served = 0;
  for (int base = blockIdx.x * BLOCK; base < a.B; base += gridDim.x * BLOCK) {
    const int i = base + threadIdx.x;
    uint32_t tbits = 0;
    bool ingress = false;
    if (i < a.B) {
      const int32_t ep = static_cast<int32_t>(__ldg(a.tuples + i));
      const int32_t dir = static_cast<int32_t>(__ldg(a.tuples + 4 * b + i));
      const bool frag = __ldg(a.tuples + 5 * b + i) != 0;
      uint32_t f0 = 0, any = 0, val1 = 0, srv = 0, p2_of = 0;
      for (int t = 0; t < a.tp; ++t) {
        const uint32_t f = static_cast<uint32_t>(__ldcs(a.parts[t] + i));
        if (t == 0) f0 = f;
        any |= f;
        if (!mesh) val1 += static_cast<uint32_t>(__ldcs(a.parts[t] + b + i));
        srv += (f & F_REPLICA) ? 1u : 0u;
        p2_of |= (f & F_P2) ? 1u << t : 0u;
      }
      const int32_t* head = a.parts[0];
      bool p1, p3;
      int32_t proxy, j;
      if (mesh) {
        p1 = any & F_P1;
        p3 = f0 & F_P3;
        proxy = __ldg(head + b + i);
        j = __ldg(head + 2 * b + i);
      } else {
        const Routed r = routed_decode(head, b, i, f0, any, val1, a.meta,
                                       a.ew, a.n_eps, a.kg, ep, dir);
        p1 = r.p1;
        p3 = r.p3;
        proxy = r.proxy;
        j = r.j;
      }
      const cdp::Lattice v = cdp::combine(p1, any & F_P2, p3, proxy, j, frag);
      a.allowed[i] = v.allowed;
      a.proxy_port[i] = v.proxy;
      a.match_kind[i] = static_cast<uint8_t>(v.kind);
      if (a.valid == nullptr || __ldg(a.valid + i) != 0) {
        served += srv;
        if (v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD) {
          const int64_t c = cell_of(a.n_eps, a.kg, ep, dir, v.j);
          if (c >= 0) atomicAdd(l4 + c, 1u);
        }
        if (v.kind == cdp::MATCH_L3) {
          for (uint32_t own = p2_of & l3_parts; own; own &= own - 1) {
            const int t = __ffs(own) - 1;
            const int64_t c = cell_of(
                a.n_eps, l3_cols, ep, dir,
                static_cast<int64_t>(t) * a.c_local +
                    __ldg(a.parts[t] + lrow + i));
            if (c >= 0) atomicAdd(l3 + c, 1u);
          }
        }
        tbits = telem_bits(v);
        ingress = dir == 0;
      }
    }
    if (telem != nullptr) ctl::telem_warp_add(tbits, ingress, n_in, n_out);
  }
  ctl::telem_commit(telem, a.counts.base + a.counts.replica_at, n_in, n_out,
                    served);
}

// -- the memo on the mesh ------------------------------------------------------

constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr uint32_t INS_OK = 1u << 8;
constexpr int STAT_UNIQUE = 0, STAT_HIT = 1, STAT_INSERT = 2,
              STAT_OVERFLOW = 3, STAT_TUPLES = 4;

struct MemoProbeArgs {
  // [c_local + 1, width]: the slice of each of the batch row's
  // coordinates that lies on this device, null for the others
  const uint32_t* rows[MAX_TP];
  int32_t* rec[MAX_TP];     // [4, rep_cap] out, where rows[t] is set
  const uint32_t* keys;     // [3, B] the row's key words
  const int32_t* rep_orig;  // [rep_cap + 1] MEMO_DEDUP's
  const int32_t* n_unique;  // [1]
  const uint8_t* alive;     // [ntp] the row's chips, or null
  crx::SortArgs sort;       // the valid representatives' buckets
  int32_t* n_valid;         // [1] scratch: min(n_unique, rep_cap)
  int32_t B;
  int32_t rep_cap;
  int32_t c_local;
  int32_t ntp;
  int32_t entries;
  int32_t width;
  int32_t failover;
  int32_t bucket_passes;
};

struct MemoFrontArgs {
  const int32_t* recs[MAX_TP];  // [4, rep_cap] each, on this device
  const int32_t* rep_orig;      // [rep_cap + 1] MEMO_DEDUP's
  const int32_t* n_unique;      // [1]
  const uint32_t* tuples;       // [6, B]
  int32_t* rep;        // [4, rep_cap] out: hit, cv0, cv1, insert word
  int32_t* miss_pos;   // [miss_cap] out
  int32_t* n_miss;     // [1] out
  int32_t* miss_pack;  // [6, miss_cap] out
  uint32_t* scratch;   // held (mesh_memo_scratch_words): the barrier, the
                       // blocks' missed counts, the missed flags' words
  int32_t B;
  int32_t rep_cap;
  int32_t miss_cap;
  int32_t tp;
};

struct MemoBackArgs {
  const int32_t* parts[MAX_TP];  // ROUTED_PROBE's [5, miss_cap] records
  const int32_t* rep;            // the front's outputs
  const int32_t* miss_pos;
  const int32_t* n_miss;
  const int32_t* miss_pack;
  const int32_t* rgid;  // MEMO_DEDUP's: each row's group, in row order
  const int32_t* n_unique;
  const int32_t* dedup_overflow;
  const uint32_t* tuples;  // [6, B]
  const uint32_t* keys;    // [3, B]
  const uint32_t* meta;    // l4_meta [E, 2, Kg]
  const uint8_t* valid;    // [B] (failover) or null
  const uint8_t* alive;    // [ntp] (failover) or null
  uint32_t* mv;            // [2, miss_cap] out: the misses' value words
  uint8_t* allowed;        // [B] outputs
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint8_t* hit;
  Counts counts;       // l4, l3, telemetry, replica (zeroed here)
  uint32_t* stats;     // [5] out
  uint32_t* scratch;   // held (mesh_memo_scratch_words): the barrier, the
                       // counters, the representatives' value words
  int32_t B;
  int32_t rep_cap;
  int32_t miss_cap;
  int32_t tp;
  int32_t ew;
  int32_t n_eps;
  int32_t kg;
  int32_t l3_shards;
  int32_t c_local;
  int32_t failover;
  int32_t l3_sharded;
  int32_t wn;       // failover: un-augmented words per shard
  int32_t w_local;  // partitioned: words per shard
};

struct MemoInsertArgs {
  const uint32_t* rows_in;  // [c_local + 1, width]
  uint32_t* rows_out;
  const int32_t* rep;       // the front's [4, rep_cap]
  const int32_t* miss_pos;
  const int32_t* n_miss;
  const uint32_t* mv;       // [2, miss_cap]
  const uint32_t* stats;    // [5] the row's
  const uint32_t* keys;     // [3, B]
  const int32_t* rep_orig;
  const uint8_t* alive;     // [ntp] or null
  int32_t B;
  int32_t rep_cap;
  int32_t miss_cap;
  int32_t c_local;
  int32_t ntp;
  int32_t entries;
  int32_t width;
  int32_t t;
  int32_t failover;
};

__device__ __forceinline__ uint32_t rep_bucket(const uint32_t* keys, size_t b,
                                               int r, uint32_t c_global) {
  return cdp::fnv1a_word(cdp::fnv1a2(__ldg(keys + r), __ldg(keys + b + r)),
                         __ldg(keys + 2 * b + r)) &
         (c_global - 1);
}

__device__ __forceinline__ int valid_reps(const int32_t* n_unique,
                                          int rep_cap) {
  const int32_t nu = *n_unique;
  return nu < rep_cap ? nu : rep_cap;
}

// MESH_MEMO_PROBE, stage 1: zero records for this device's coordinates,
// and the valid representatives' buckets into the sort
__global__ void __launch_bounds__(BLOCK) memo_probe_init(MemoProbeArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  const int nv = valid_reps(a.n_unique, a.rep_cap);
  if (g == 0) {
    *a.n_valid = nv;
    a.sort.parity[0] = 0;
  }
  if (g >= a.rep_cap) return;
  const size_t rc = static_cast<size_t>(a.rep_cap);
  for (int t = 0; t < a.ntp; ++t) {
    if (a.rec[t] == nullptr) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) a.rec[t][w * rc + g] = 0;
  }
  if (g >= nv) return;
  const uint32_t cg = static_cast<uint32_t>(a.c_local) * a.ntp;
  a.sort.key[0][0][g] = rep_bucket(a.keys, a.B, a.rep_orig[g], cg);
  a.sort.val[0][g] = static_cast<uint32_t>(g);
}

// stage 3, over the representatives in bucket order: the rank among the
// same-bucket representatives (capped at the lanes), and for a bucket in
// the slice of a coordinate on this device the lane compares (an owner
// that is alive), the insert lane (memo.bucket_insert_lanes: the first
// empty lane, else bucket mod lanes, plus the rank) and the owner's
// record
__global__ void __launch_bounds__(BLOCK) memo_probe_kernel(MemoProbeArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= *a.n_valid) return;
  const int cur = a.sort.parity[a.bucket_passes];
  const uint32_t* sb = a.sort.key[cur][0];
  const uint32_t bucket = sb[p];
  const int pc = static_cast<int>(bucket / static_cast<uint32_t>(a.c_local));
  const uint32_t* slice = a.rows[pc];
  if (slice == nullptr) return;
  int32_t* rec = a.rec[pc];
  const int g = static_cast<int>(a.sort.val[cur][p]);
  const int e = a.entries;
  int rank = 0;
  while (rank < e && p - 1 - rank >= 0 && sb[p - 1 - rank] == bucket) ++rank;
  const bool owns = !a.failover || a.alive[pc] != 0;
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  const uint32_t k0 = __ldg(a.keys + r), k1 = __ldg(a.keys + b + r),
                 k2 = __ldg(a.keys + 2 * b + r);
  const uint32_t* row =
      slice + static_cast<size_t>(bucket - static_cast<uint32_t>(pc) *
                                               a.c_local) * a.width;
  bool hit = false;
  uint32_t cv0 = 0, cv1 = 0, empty = 0;
  if (owns) {
    for (int k = 0; k < e; ++k) {
      const uint32_t w0 = __ldg(row + k);
      if (w0 == EMPTY) empty |= 1u << k;
      if (w0 == k0 && __ldg(row + e + k) == k1 && __ldg(row + 2 * e + k) == k2) {
        hit = true;
        cv0 += __ldg(row + 3 * e + k);
        cv1 += __ldg(row + 4 * e + k);
      }
    }
  }
  const size_t rc = static_cast<size_t>(a.rep_cap);
  rec[g] = hit ? 1 : 0;
  rec[rc + g] = static_cast<int32_t>(cv0);
  rec[2 * rc + g] = static_cast<int32_t>(cv1);
  if (rank < e) {
    const int base = empty ? __ffs(empty) - 1 : static_cast<int>(bucket % e);
    rec[3 * rc + g] = static_cast<int32_t>(((base + rank) % e) | INS_OK);
  }
}

// -- MESH_MEMO_COMBINE -------------------------------------------------------
// The parent's front pass was 7 launches (the sum, the three of
// radix.cuh's flag scan, a fill, the compaction, the pack: 0.050-0.053
// device ms on a batch row at rep_cap = miss_cap = 524,288), its back pass
// 4 zero fills and 5 launches (0.435-0.440 ms), of which 0.38 the
// per-tuple stage: it walked MEMO_DEDUP's sorted positions, so each tuple
// read and wrote its columns at a scattered row, and each counted hit took
// a global atomic on the Zipf stream's hot L3 cells (0.17 ms); PERF.md
// section 5.  Each pass is now one cooperative launch, its phases parted
// by a grid barrier (common.cuh bar_sync) on words of the held scratch.
//
// The held scratch, int32 words from its 16-byte aligned start
// (mesh_memo_scratch_words gives the sizes): the front's FRONT_CTL_WORDS
// (the barrier), MAX_COOP_BLOCKS block counts and the missed flags'
// ceil(rep_cap / 32) ballot words; the back's BACK_CTL_WORDS (the barrier,
// the hit, insert and valid-tuple counts and the blocks' finishing ticket,
// all zero between launches) and its rv, a uint2 a representative: v0,
// and v1's three probe bits with the representative's hit in RV_HIT.
constexpr int MAX_COOP_BLOCKS = 2048;
constexpr int FRONT_CTL_WORDS = 4;
constexpr int BACK_CTL_WORDS = 8;
constexpr int CTL_HITS = 4, CTL_INSERTS = 5, CTL_VALID = 6, CTL_TICKET = 7;
constexpr uint32_t RV_HIT = 1u << 31;
constexpr int FRONT_BLOCKS_PER_SM = 2;  // 3, 4, 8 measured slower
constexpr int BACK_BLOCKS_PER_SM = 4;  // 6, 8 no faster
constexpr int BACK_UNROLL = 2;  // 1 and 4 measured slower
// one slot of the block's cell table tried a cell (4 measured 3 % slower:
// the row's L3 hits spread over 31,086 cells, and a full table's probes
// cost more than the global atomic they would save)
constexpr int BACK_CELL_PROBES = 1;
constexpr int WARPS = BLOCK / 32;

inline int64_t front_scratch_words(int rep_cap) {
  return FRONT_CTL_WORDS + MAX_COOP_BLOCKS +
         ((static_cast<int64_t>(rep_cap) + 127) / 128) * 4;
}

inline int64_t back_scratch_words(int rep_cap) {
  return BACK_CTL_WORDS + 2 * static_cast<int64_t>(rep_cap);
}

// The block's sum of one value a thread, to every thread.
__device__ __forceinline__ uint32_t block_sum(uint32_t x) {
  uint32_t total;
  crx::block_inclusive<BLOCK>(x, &total);
  return total;
}

// The front (memo_front_plain): phase 1, over a contiguous range of the
// flags' words a block, each representative's record sum (the hit masked
// by rep_valid) and its missed flag, one ballot word a warp, and the
// block's missed count; behind a barrier, the block's first slot (the
// counts of the blocks before it) and its missed representatives' slots,
// in ascending order; behind another, every slot's six tuple words,
// strided over the grid (the missed representative's row, or in the
// padding rep_orig[rep_cap]'s, its slot set to rep_cap), so that the
// gathers of a block's misses do not wait on each other.
__global__ void __launch_bounds__(BLOCK, FRONT_BLOCKS_PER_SM)
    memo_front_kernel(const __grid_constant__ MemoFrontArgs a) {
  uint32_t* bar = a.scratch;
  uint32_t* blk_cnt = a.scratch + FRONT_CTL_WORDS;
  uint32_t* bits = blk_cnt + MAX_COOP_BLOCKS;
  __shared__ uint32_t s_pop[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t rc = static_cast<size_t>(a.rep_cap);
  const int n_words = (a.rep_cap + 31) / 32;
  const int per = (n_words + gridDim.x - 1) / gridDim.x;
  const int w_lo = min(static_cast<int>(blockIdx.x) * per, n_words);
  const int w_hi = min(w_lo + per, n_words);
  const int nv = valid_reps(a.n_unique, a.rep_cap);
  uint32_t cnt = 0;
  for (int w = w_lo + warp; w < w_hi; w += WARPS) {
    const int g = w * 32 + lane;
    bool missed = false;
    if (g < a.rep_cap) {
      uint32_t tot[4] = {0, 0, 0, 0};
      for (int t = 0; t < a.tp; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          tot[k] += static_cast<uint32_t>(__ldcs(a.recs[t] + k * rc + g));
      const bool hit = g < nv && tot[0] > 0;
      a.rep[g] = hit ? 1 : 0;
#pragma unroll
      for (int k = 1; k < 4; ++k)
        a.rep[k * rc + g] = static_cast<int32_t>(tot[k]);
      missed = g < nv && !hit;
    }
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, missed);
    if (lane == 0) bits[w] = word;
    cnt += static_cast<uint32_t>(__popc(word));
  }
  // every lane of a warp holds the warp's count: lane 0's into the sum
  cnt = block_sum(lane == 0 ? cnt : 0u);
  if (threadIdx.x == 0) blk_cnt[blockIdx.x] = cnt;
  cdp::bar_sync(bar, gridDim.x);

  uint32_t before = 0, total = 0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += BLOCK) {
    const uint32_t c = __ldcg(blk_cnt + k);
    total += c;
    before += k < static_cast<int>(blockIdx.x) ? c : 0u;
  }
  before = block_sum(before);
  total = block_sum(total);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *a.n_miss = static_cast<int32_t>(total);
  const uint32_t mcap = static_cast<uint32_t>(a.miss_cap);
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t run = before;
  for (int w0 = w_lo; w0 < w_hi && run < mcap; w0 += WARPS) {
    const int w = w0 + warp;
    const uint32_t word = w < w_hi ? __ldcg(bits + w) : 0u;
    if (lane == 0) s_pop[warp] = static_cast<uint32_t>(__popc(word));
    __syncthreads();
    uint32_t at = run, chunk = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      at += k < warp ? s_pop[k] : 0u;
      chunk += s_pop[k];
    }
    __syncthreads();
    if ((word >> lane) & 1u) {
      const uint32_t pos = at + static_cast<uint32_t>(__popc(word & lt));
      if (pos < mcap) a.miss_pos[pos] = w * 32 + lane;
    }
    run += chunk;
  }
  cdp::bar_sync(bar, gridDim.x);

  // every slot's tuple, strided over the grid (the gathers independent):
  // the missed representative's, or in the padding rep_orig[rep_cap]'s,
  // read once a thread
  const uint32_t filled = total < mcap ? total : mcap;
  const size_t b = static_cast<size_t>(a.B);
  const size_t mc = static_cast<size_t>(a.miss_cap);
  const int pad = __ldg(a.rep_orig + a.rep_cap);
  uint32_t pw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) pw[k] = __ldg(a.tuples + k * b + pad);
  for (uint32_t s = blockIdx.x * BLOCK + threadIdx.x; s < mcap;
       s += gridDim.x * BLOCK) {
    if (s < filled) {
      const int orig = __ldg(a.rep_orig + __ldcg(a.miss_pos + s));
#pragma unroll
      for (int k = 0; k < 6; ++k)
        a.miss_pack[k * mc + s] =
            static_cast<int32_t>(__ldg(a.tuples + k * b + orig));
    } else {
      a.miss_pos[s] = a.rep_cap;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        a.miss_pack[k * mc + s] = static_cast<int32_t>(pw[k]);
    }
  }
}

// The back (memo_back_plain).  Phase 1, strided over the grid: the counter
// buffers zeroed; per miss slot the routed records' lattice packed into
// value words (memo.pack_value_words: mv, every slot), and for a live
// slot its replica gathers (failover), its insert and its
// representative's rv; per representative rv for a hit (the cache's
// words) and 0 for one that is neither a hit nor a live slot's.  (The
// front's slots name distinct missed representatives in ascending order,
// so a missed representative has a slot iff the misses fit miss_cap or
// it is not past the last slot's.)  Phase 2, behind the barrier, the
// tuples in row order, a block-stride round at a time: each tuple's group
// rgid[i] (clipped to rep_cap - 1) and its rv (an 8-byte gather from
// rep_cap-sized words, which stay in the L2), the combine, the verdict
// columns written where they are read; the counted hits aggregated a
// block (common.cuh cell_add: a warp's equal cells by __match_any_sync,
// then the block's cell table; the L3 cells share the l4 buffer's table,
// the l3 buffer following it in the region); the telemetry one ballot a
// column (telem.cuh); the stats by the last block to finish, which also
// leaves the counters zero for the next launch.
__global__ void __launch_bounds__(BLOCK, BACK_BLOCKS_PER_SM)
    memo_back_kernel(const __grid_constant__ MemoBackArgs a) {
  __shared__ cdp::CellTable cells;
  uint32_t* ctl = a.scratch;
  uint2* rv = reinterpret_cast<uint2*>(a.scratch + BACK_CTL_WORDS);
  const size_t b = static_cast<size_t>(a.B);
  const size_t rc = static_cast<size_t>(a.rep_cap);
  const size_t mc = static_cast<size_t>(a.miss_cap);
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  const int stride = gridDim.x * BLOCK;
  cdp::cell_init(cells);
  zero_counts(a.counts);
  const int n_miss = *a.n_miss;
  const int live = n_miss < a.miss_cap ? n_miss : a.miss_cap;
  uint32_t served = 0, inserts = 0;
  for (int s = tid; s < a.miss_cap; s += stride) {
    uint32_t f0 = 0, any = 0, val1 = 0, srv = 0;
    for (int t = 0; t < a.tp; ++t) {
      const uint32_t f = static_cast<uint32_t>(__ldg(a.parts[t] + s));
      if (t == 0) f0 = f;
      any |= f;
      val1 += static_cast<uint32_t>(__ldg(a.parts[t] + mc + s));
      srv += (f & F_REPLICA) ? 1u : 0u;
    }
    const int32_t ep = __ldg(a.miss_pack + s);
    const int32_t dir = __ldg(a.miss_pack + 4 * mc + s);
    const Routed r = routed_decode(a.parts[0], mc, s, f0, any, val1, a.meta,
                                   a.ew, a.n_eps, a.kg, ep, dir);
    const uint32_t v0 = (static_cast<uint32_t>(r.j) << 16) |
                        (static_cast<uint32_t>(r.proxy) & 0xFFFFu);
    const uint32_t v1 = (r.p1 ? 1u : 0u) | (r.p2 ? 2u : 0u) | (r.p3 ? 4u : 0u);
    a.mv[s] = v0;
    a.mv[mc + s] = v1;
    const uint32_t g = static_cast<uint32_t>(__ldg(a.miss_pos + s));
    if (g < static_cast<uint32_t>(a.rep_cap)) rv[g] = make_uint2(v0, v1);
    if (s < live) {
      served += a.failover ? srv : 0u;
      inserts += (static_cast<uint32_t>(__ldg(a.rep + 3 * rc + g)) & INS_OK)
                     ? 1u
                     : 0u;
    }
  }
  const int nv = valid_reps(a.n_unique, a.rep_cap);
  const bool cut = n_miss > a.miss_cap;  // misses without a slot
  const int last = cut ? __ldg(a.miss_pos + a.miss_cap - 1) : 0;
  for (int g = tid; g < a.rep_cap; g += stride) {
    if (__ldg(a.rep + g) != 0)
      rv[g] = make_uint2(
          static_cast<uint32_t>(__ldg(a.rep + rc + g)),
          (static_cast<uint32_t>(__ldg(a.rep + 2 * rc + g)) & 7u) | RV_HIT);
    else if (g >= nv || (cut && g > last))
      rv[g] = make_uint2(0u, 0u);
  }
  cdp::bar_sync(ctl, gridDim.x);

  uint32_t* acc = a.counts.base;
  const int64_t l3_at = a.counts.l3_at;
  uint32_t* telem =
      a.counts.telem_at < 0 ? nullptr : a.counts.base + a.counts.telem_at;
  const int64_t l3_cols = static_cast<int64_t>(a.l3_shards) * a.c_local;
  uint32_t n_in = 0, n_out = 0, hits = 0, oks = 0;
  for (int base = blockIdx.x * BLOCK * BACK_UNROLL; base < a.B;
       base += stride * BACK_UNROLL) {
    // BACK_UNROLL tuples a thread a round, their loads issued first
    uint32_t tw[BACK_UNROLL][3];
    uint2 rw[BACK_UNROLL];
#pragma unroll
    for (int k = 0; k < BACK_UNROLL; ++k) {
      const int i = base + k * BLOCK + threadIdx.x;
      int gg = i < a.B ? __ldcs(a.rgid + i) : 0;
      gg = gg < a.rep_cap - 1 ? gg : a.rep_cap - 1;
      rw[k] = __ldcg(rv + gg);
      tw[k][0] = i < a.B ? __ldcs(a.tuples + i) : 0u;
      tw[k][1] = i < a.B ? __ldcs(a.tuples + 4 * b + i) : 0u;
      tw[k][2] = i < a.B ? __ldcs(a.tuples + 5 * b + i) : 0u;
    }
#pragma unroll
    for (int k = 0; k < BACK_UNROLL; ++k) {
      const int i = base + k * BLOCK + threadIdx.x;
      uint32_t tbits = 0;
      bool ingress = false;
      int64_t c4 = -1, c3 = -1;
      if (i < a.B) {
        const uint2 w = rw[k];
        const bool hit = w.y & RV_HIT;
        const int32_t ep = static_cast<int32_t>(tw[k][0]);
        const int32_t dir = static_cast<int32_t>(tw[k][1]);
        const bool frag = tw[k][2] != 0;
        const bool p2 = w.y & 2u;
        const cdp::Lattice v = cdp::combine(
            w.y & 1u, p2, w.y & 4u, static_cast<int32_t>(w.x & 0xFFFFu),
            static_cast<int32_t>(w.x >> 16), frag);
        __stcs(a.allowed + i, static_cast<uint8_t>(v.allowed));
        __stcs(a.proxy_port + i, v.proxy);
        __stcs(a.match_kind + i, static_cast<uint8_t>(v.kind));
        __stcs(a.hit + i, static_cast<uint8_t>(hit));
        const bool ok = !a.failover || a.valid == nullptr ||
                        __ldcs(a.valid + i) != 0;
        if (ok) {
          hits += hit ? 1u : 0u;
          ++oks;
          if (v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD)
            c4 = cell_of(a.n_eps, a.kg, ep, dir, v.j);
          if (v.kind == cdp::MATCH_L3 && p2) {
            // the word's serving owner and its local column
            // (u32 divisions: the word index is below 2^27)
            const uint32_t idx32 = __ldcs(a.keys + i), word = idx32 >> 5;
            const int64_t idx = idx32;
            const uint32_t tp = static_cast<uint32_t>(a.tp);
            int64_t col = -1;
            if (!a.l3_sharded) {
              col = clamp64(idx, 0, a.c_local - 1);
            } else if (a.failover) {
              const int64_t g32 = static_cast<int64_t>(a.wn) * 32;
              const uint32_t wp = word / static_cast<uint32_t>(a.wn);
              if (wp < tp) {
                const bool apw = a.alive[wp] != 0;
                const int64_t owner = apw ? wp : (wp + 1 < tp ? wp + 1 : 0u);
                col = owner * a.c_local +
                      clamp64(idx - static_cast<int64_t>(wp) * g32, 0,
                              g32 - 1) +
                      (apw ? 0 : g32);
              }
            } else {
              const uint32_t owner = word / static_cast<uint32_t>(a.w_local);
              if (owner < tp)
                col = static_cast<int64_t>(owner) * a.c_local +
                      clamp64(idx - static_cast<int64_t>(owner) * a.c_local, 0,
                              a.c_local - 1);
            }
            if (col >= 0 && col < l3_cols) {
              c3 = cell_of(a.n_eps, l3_cols, ep, dir, col);
              if (c3 >= 0) c3 += l3_at;
            }
          }
          tbits = telem_bits(v);
          ingress = dir == 0;
        }
      }
      cdp::cell_add<BACK_CELL_PROBES>(cells, acc, c4);
      cdp::cell_add<BACK_CELL_PROBES>(cells, acc, c3);
      if (telem != nullptr) ctl::telem_warp_add(tbits, ingress, n_in, n_out);
    }
  }
  cdp::cell_flush(cells, acc);
  ctl::telem_commit(telem, a.counts.base + a.counts.replica_at, n_in, n_out,
                    served);
  // the block's counts, then the ticket: the last block writes the stats
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);
  inserts = __reduce_add_sync(0xFFFFFFFFu, inserts);
  oks = __reduce_add_sync(0xFFFFFFFFu, oks);
  if ((threadIdx.x & 31) == 0) {
    if (hits) atomicAdd(ctl + CTL_HITS, hits);
    if (inserts) atomicAdd(ctl + CTL_INSERTS, inserts);
    if (oks) atomicAdd(ctl + CTL_VALID, oks);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(ctl + CTL_TICKET, 1u) == gridDim.x - 1) {
    __threadfence();
    const uint32_t n_hit = atomicExch(ctl + CTL_HITS, 0u);
    const uint32_t n_ins = atomicExch(ctl + CTL_INSERTS, 0u);
    const uint32_t n_ok = atomicExch(ctl + CTL_VALID, 0u);
    atomicExch(ctl + CTL_TICKET, 0u);
    const uint32_t over =
        static_cast<uint32_t>(*a.dedup_overflow) +
        (n_miss > a.miss_cap ? static_cast<uint32_t>(n_miss - a.miss_cap)
                             : 0u);
    a.stats[STAT_UNIQUE] = static_cast<uint32_t>(*a.n_unique);
    a.stats[STAT_HIT] = n_hit;
    a.stats[STAT_INSERT] = over == 0 ? n_ins : 0u;
    a.stats[STAT_OVERFLOW] = over;
    a.stats[STAT_TUPLES] = a.failover ? n_ok : static_cast<uint32_t>(a.B);
  }
}

// MESH_MEMO_INSERT: the slice copied, then (when the row did not
// overflow) each live missed representative this coordinate owns, whose
// rank is below the lanes, written at its lane (distinct (row, lane)
// slots by construction)
__global__ void __launch_bounds__(BLOCK) memo_insert_copy(MemoInsertArgs a) {
  const size_t n = static_cast<size_t>(a.c_local + 1) * a.width;
  for (size_t k = blockIdx.x * static_cast<size_t>(BLOCK) + threadIdx.x; k < n;
       k += static_cast<size_t>(gridDim.x) * BLOCK)
    a.rows_out[k] = a.rows_in[k];
}

__global__ void __launch_bounds__(BLOCK) memo_insert_kernel(MemoInsertArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (a.stats[STAT_OVERFLOW] != 0) return;
  const int n = *a.n_miss < a.miss_cap ? *a.n_miss : a.miss_cap;
  if (s >= n) return;
  const int g = a.miss_pos[s];
  const uint32_t ins = static_cast<uint32_t>(
      __ldg(a.rep + 3 * static_cast<size_t>(a.rep_cap) + g));
  if (!(ins & INS_OK)) return;
  const size_t b = static_cast<size_t>(a.B);
  const int r = a.rep_orig[g];
  const uint32_t cg = static_cast<uint32_t>(a.c_local) * a.ntp;
  const uint32_t bucket = rep_bucket(a.keys, b, r, cg);
  const int pc = static_cast<int>(bucket / static_cast<uint32_t>(a.c_local));
  if (pc != a.t || (a.failover && a.alive[pc] == 0)) return;
  const int e = a.entries, lane = static_cast<int>(ins & 0xFFu);
  uint32_t* row = a.rows_out +
                  static_cast<size_t>(bucket - static_cast<uint32_t>(pc) *
                                                   a.c_local) * a.width;
  const size_t mc = static_cast<size_t>(a.miss_cap);
  row[lane] = __ldg(a.keys + r);
  row[e + lane] = __ldg(a.keys + b + r);
  row[2 * e + lane] = __ldg(a.keys + 2 * b + r);
  row[3 * e + lane] = a.mv[s];
  row[4 * e + lane] = a.mv[mc + s];
}

inline int grid_of(long n) { return static_cast<int>((n + BLOCK - 1) / BLOCK); }

template <typename Args, typename Kernel>
int launch(Kernel kernel, const Args* args, void* stream) {
  if (args->B > 0) {
    const int grid = (args->B + BLOCK - 1) / BLOCK;
    kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cms

// The cooperative kernels' grids on the current device: every block
// resident (the grid barrier), at most the kernel's blocks an SM and
// MAX_COOP_BLOCKS (the front's block counts).  The first call on a device
// keeps the count for that device.  Internal linkage: a second build of
// this file in one process keeps its own.
namespace {

constexpr int MAX_DEVICES = 64;

int coop_grid_max(const void* kernel, int blocks_per_sm, int* most) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  if (most[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      cms::BLOCK, 0) !=
            cudaSuccess)
      return -1;
    const int n = sms * (per_sm < blocks_per_sm ? per_sm : blocks_per_sm);
    most[dev] = n < cms::MAX_COOP_BLOCKS ? n : cms::MAX_COOP_BLOCKS;
  }
  return most[dev];
}

// One cooperative launch of `kernel` over at most `want` blocks.
template <typename Args>
int coop_launch(void (*kernel)(Args), int blocks_per_sm, int* most,
                long want, const Args& a, void* stream) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int cap = coop_grid_max(fn, blocks_per_sm, most);
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  Args copy = a;
  void* params[] = {&copy};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(cms::BLOCK), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int combine_most[MAX_DEVICES], front_most[MAX_DEVICES],
    back_most[MAX_DEVICES];

}  // namespace

extern "C" int mesh_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cdp::PolicyView));
  out[1] = static_cast<int>(sizeof(cms::MeshProbeArgs));
  out[2] = static_cast<int>(sizeof(cms::RoutedProbeArgs));
  out[3] = static_cast<int>(sizeof(cms::CombineArgs));
  out[4] = static_cast<int>(sizeof(crx::SortArgs));
  out[5] = static_cast<int>(sizeof(cms::MemoProbeArgs));
  out[6] = static_cast<int>(sizeof(cms::MemoFrontArgs));
  out[7] = static_cast<int>(sizeof(cms::MemoBackArgs));
  out[8] = static_cast<int>(sizeof(cms::MemoInsertArgs));
  return 9;
}

// Launch MESH_PROBE on `stream`; returns cudaGetLastError().
extern "C" int launch_mesh_probe(const cms::MeshProbeArgs* args,
                                 void* stream) {
  return cms::launch(cms::mesh_probe_kernel, args, stream);
}

// Launch ROUTED_PROBE on `stream` (its stashes in dynamic shared memory
// where they fit); returns cudaGetLastError().
extern "C" int launch_routed_probe(const cms::RoutedProbeArgs* args,
                                   void* stream) {
  using namespace cms;
  const RoutedProbeArgs& a = *args;
  if (a.ntp < 1 || a.ntp > MAX_TP || a.n_rows_global < 1 ||
      (a.failover && ((a.rows_sharded && a.n_row_shard < 1) ||
                      (a.l3_sharded && a.wn < 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B > 0) {
    const size_t smem = routed_stashes_staged(a)
                            ? static_cast<size_t>(routed_stash_words(a)) * 4
                            : 0;
    routed_probe_kernel<<<(a.B + BLOCK - 1) / BLOCK, BLOCK, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The held scratch of MESH_MEMO_COMBINE's two passes at this rep_cap,
// int32 words: out[0] the front's, out[1] the back's (each region starts
// 16-byte aligned, its control words zero when it is made).
extern "C" void mesh_memo_scratch_words(int rep_cap, long long* out) {
  out[0] = (cms::front_scratch_words(rep_cap) + 3) / 4 * 4;
  out[1] = (cms::back_scratch_words(rep_cap) + 3) / 4 * 4;
}

// MESH_COMBINE on `stream`, one cooperative launch (also at B = 0: it
// zeroes the counter buffers); returns the launch's error.
extern "C" int launch_mesh_combine(const cms::CombineArgs* args,
                                   void* stream) {
  using namespace cms;
  const CombineArgs& a = *args;
  if (a.B < 0 || a.tp < 1 || a.tp > MAX_TP || a.l3_shards < 1 ||
      a.l3_shards > a.tp || (a.counts.words & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(a.counts.base) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return coop_launch(mesh_combine_kernel, COMBINE_BLOCKS_PER_SM,
                     combine_most, (static_cast<long>(a.B) + BLOCK - 1) / BLOCK,
                     a, stream);
}

// MESH_MEMO_PROBE on `stream`, once per batch row and device: the init,
// the stable sort of the valid representatives by bucket, the probe of
// every coordinate of the row on the device; returns cudaGetLastError().
extern "C" int launch_mesh_memo_probe(const cms::MemoProbeArgs* args,
                                      void* stream) {
  using namespace cms;
  const MemoProbeArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rep_cap <= 0 || a.entries < 1 || a.entries > 32 || a.ntp < 1 ||
      a.ntp > MAX_TP)
    return static_cast<int>(cudaErrorInvalidValue);
  memo_probe_init<<<grid_of(a.rep_cap), BLOCK, 0, st>>>(a);
  crx::radix_sort<1>(a.sort, a.bucket_passes, st);
  memo_probe_kernel<<<grid_of(a.rep_cap), BLOCK, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// MESH_MEMO_COMBINE's front on `stream`, one cooperative launch; returns
// the launch's error.
extern "C" int launch_mesh_memo_front(const cms::MemoFrontArgs* args,
                                      void* stream) {
  using namespace cms;
  const MemoFrontArgs& a = *args;
  if (a.rep_cap <= 0 || a.miss_cap <= 0 || a.tp < 1 || a.tp > MAX_TP ||
      (reinterpret_cast<uintptr_t>(a.scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long words = (static_cast<long>(a.rep_cap) + 31) / 32;
  return coop_launch(memo_front_kernel, FRONT_BLOCKS_PER_SM, front_most,
                     (words + WARPS - 1) / WARPS, a, stream);
}

// MESH_MEMO_COMBINE's back on `stream`, one cooperative launch; returns
// the launch's error.
extern "C" int launch_mesh_memo_back(const cms::MemoBackArgs* args,
                                     void* stream) {
  using namespace cms;
  const MemoBackArgs& a = *args;
  if (a.B <= 0 || a.rep_cap <= 0 || a.miss_cap <= 0 || a.tp < 1 ||
      a.tp > MAX_TP || (a.counts.words & 3) != 0 ||
      ((reinterpret_cast<uintptr_t>(a.counts.base) |
        reinterpret_cast<uintptr_t>(a.scratch)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long want = a.B > a.rep_cap ? a.B : a.rep_cap;
  want = want > a.miss_cap ? want : a.miss_cap;
  return coop_launch(memo_back_kernel, BACK_BLOCKS_PER_SM, back_most,
                     (want + BLOCK - 1) / BLOCK, a, stream);
}

// MESH_MEMO_INSERT on `stream`; returns cudaGetLastError().
extern "C" int launch_mesh_memo_insert(const cms::MemoInsertArgs* args,
                                       void* stream) {
  using namespace cms;
  const MemoInsertArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.miss_cap <= 0 || a.entries < 1 || a.entries > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long words = static_cast<long>(a.c_local + 1) * a.width;
  const int copy_grid = grid_of(words) < 1024 ? grid_of(words) : 1024;
  memo_insert_copy<<<copy_grid, BLOCK, 0, st>>>(a);
  memo_insert_kernel<<<grid_of(a.miss_cap), BLOCK, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
