// The policy lattice on a (batch x table) mesh, three CUDA kernels for
// Hopper (sm_90a).  Each replaces one part of a `shard_map` step of the
// JAX package's cilium_tpu/engine/sharded.py; the port's step is a loop
// over the mesh coordinates (cilium_tpu_torch/engine/sharded.py), one
// probe launch per shard and one combine launch per batch row.
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
// and, for an L3 hit, the owner's L3 column, and writes 6 B of verdict.
// MESH_PROBE, MESH_COMBINE and the memo kernels do the simple thing: one
// tuple per thread, read-only loads, one global atomicAdd per counted
// hit, the telemetry reduced per warp and block before one atomicAdd per
// block and column.  ROUTED_PROBE runs the pair kernel's per-flow design
// (see its kernel).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "radix.cuh"
#include "verdict.cuh"

namespace cms {

using cdp::clip_u;
using cdp::gather_ix;
using cdp::PolicyView;

constexpr int BLOCK = 256;
constexpr int MAX_TP = 16;
constexpr int TELEM_COLS = 20;
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

struct CombineArgs {
  // tp records on this device: [4, B] (MODE_MESH) or [5, B] (MODE_ROUTED)
  const int32_t* parts[MAX_TP];
  const uint32_t* tuples;        // [6, B]
  const uint32_t* meta;          // l4_meta [E, 2, Kg]
  const uint8_t* valid;          // [B] or null (all valid)
  uint8_t* allowed;              // outputs [B]
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint32_t* l4;       // [E, 2, Kg], zeroed
  uint32_t* l3;       // [E, 2, l3_shards * c_local], zeroed
  uint32_t* telem;    // [2, 20] zeroed, or null
  uint32_t* replica;  // [1] zeroed
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
// `any`, the owners' values summed into `val1`) decoded into the lattice
// inputs (sharded.routed_lattice): the exact hit, the wildcard hit and
// the proxy and slot of the first probe that hit (3-word entries carry
// both in the value; 2-word entries the slot, the proxy from l4_meta).
struct Routed {
  bool p1, p2, p3;
  int32_t proxy, j;
};

__device__ __forceinline__ Routed routed_decode(const int32_t* head, size_t b,
                                                int i, uint32_t any,
                                                uint32_t val1,
                                                const uint32_t* meta, int ew,
                                                int n_eps, int kg, int32_t ep,
                                                int32_t dir) {
  Routed r;
  const uint32_t f0 = static_cast<uint32_t>(__ldg(head + i));
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

// The block's telemetry rows into telem [2, 20]: warp ballots per row, a
// block sum in shared memory, one atomicAdd per block, row and column.
// Every thread of the block calls it (`tbits` 0 for an inactive one).
__device__ __forceinline__ void telem_block_sum(uint32_t* telem,
                                                uint32_t tbits, int row) {
  __shared__ uint32_t s_rows[2 * TELEM_COLS];
  if (threadIdx.x < 2 * TELEM_COLS) s_rows[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < TELEM_COLS; ++c) {
    const bool on = (tbits >> c) & 1u;
    const uint32_t b0 = __ballot_sync(0xFFFFFFFFu, on && row == 0);
    const uint32_t b1 = __ballot_sync(0xFFFFFFFFu, on && row == 1);
    if (lane == 0 && b0) atomicAdd(&s_rows[c], static_cast<uint32_t>(__popc(b0)));
    if (lane == 0 && b1)
      atomicAdd(&s_rows[TELEM_COLS + c], static_cast<uint32_t>(__popc(b1)));
  }
  __syncthreads();
  if (threadIdx.x < 2 * TELEM_COLS && s_rows[threadIdx.x])
    atomicAdd(telem + threadIdx.x, s_rows[threadIdx.x]);
}

// jax's scatter-add at [e, d, c] of an [n_eps, 2, cols] buffer: negative
// indices count from the end, an update still outside is dropped.
__device__ __forceinline__ void count_hit(uint32_t* buf, int n_eps,
                                          int64_t cols, int32_t ep,
                                          int32_t dir, int64_t c) {
  const int64_t e = ep < 0 ? static_cast<int64_t>(ep) + n_eps : ep;
  const int64_t d = dir < 0 ? static_cast<int64_t>(dir) + 2 : dir;
  if (c < 0) c += cols;
  if (e >= 0 && e < n_eps && d >= 0 && d < 2 && c >= 0 && c < cols)
    atomicAdd(buf + (e * 2 + d) * cols + c, 1u);
}

__global__ void __launch_bounds__(BLOCK) mesh_combine_kernel(
    const CombineArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = i < a.B;
  const size_t b = static_cast<size_t>(a.B);
  uint32_t tbits = 0, served = 0;
  int row = 0;
  if (active) {
    const int32_t ep = static_cast<int32_t>(__ldg(a.tuples + i));
    const int32_t dir = static_cast<int32_t>(__ldg(a.tuples + 4 * b + i));
    const bool frag = __ldg(a.tuples + 5 * b + i) != 0;
    const int32_t* head = a.parts[0];
    const bool mesh = a.mode == MODE_MESH;
    const uint32_t f0 = static_cast<uint32_t>(__ldg(head + i));
    uint32_t any = 0, val1 = 0;
    for (int t = 0; t < a.tp; ++t) {
      const uint32_t f = static_cast<uint32_t>(__ldg(a.parts[t] + i));
      any |= f;
      if (!mesh) val1 += static_cast<uint32_t>(__ldg(a.parts[t] + b + i));
      served += (f & F_REPLICA) ? 1u : 0u;
    }
    const bool p2 = any & F_P2;
    bool p1, p3;
    int32_t proxy, j;
    if (mesh) {
      p1 = any & F_P1;
      p3 = f0 & F_P3;
      proxy = __ldg(head + b + i);
      j = __ldg(head + 2 * b + i);
    } else {
      const Routed r = routed_decode(head, b, i, any, val1, a.meta, a.ew,
                                     a.n_eps, a.kg, ep, dir);
      p1 = r.p1;
      p3 = r.p3;
      proxy = r.proxy;
      j = r.j;
    }
    const cdp::Lattice v = cdp::combine(p1, p2, p3, proxy, j, frag);
    a.allowed[i] = v.allowed;
    a.proxy_port[i] = v.proxy;
    a.match_kind[i] = static_cast<uint8_t>(v.kind);

    const bool ok = a.valid == nullptr || __ldg(a.valid + i) != 0;
    if (!ok) served = 0;
    if (ok) {
      if (v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD)
        count_hit(a.l4, a.n_eps, a.kg, ep, dir, v.j);
      if (v.kind == cdp::MATCH_L3) {
        const int64_t cols = static_cast<int64_t>(a.l3_shards) * a.c_local;
        const size_t lrow = (mesh ? 3 : 4) * b;
        for (int t = 0; t < a.l3_shards; ++t) {
          if (__ldg(a.parts[t] + i) & F_P2)
            count_hit(a.l3, a.n_eps, cols, ep, dir,
                      static_cast<int64_t>(t) * a.c_local +
                          __ldg(a.parts[t] + lrow + i));
        }
      }
      tbits = telem_bits(v);
      row = dir == 0 ? 0 : 1;
    }
  }
  // the replica count: a warp sum, one atomicAdd per warp
  const uint32_t warp_served = __reduce_add_sync(0xFFFFFFFFu, served);
  if ((threadIdx.x & 31) == 0 && warp_served) atomicAdd(a.replica, warp_served);
  if (a.telem != nullptr) telem_block_sum(a.telem, tbits, row);
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
  const int32_t* rep_orig;
  const int32_t* n_unique;
  const uint32_t* tuples;  // [6, B]
  int32_t* rep;            // [4, rep_cap] out: hit, cv0, cv1, insert word
  uint32_t* flags;         // [rep_cap] scratch: missed
  uint32_t* prefix;        // [rep_cap] scratch: their exclusive scan
  uint32_t* sums;          // [ceil(rep_cap / SCAN_TILE)] scratch
  int32_t* n_elems;        // [1] scratch: rep_cap
  int32_t* miss_pos;       // [miss_cap] out
  int32_t* n_miss;         // [1] out
  int32_t* miss_pack;      // [6, miss_cap] out
  int32_t B;
  int32_t rep_cap;
  int32_t miss_cap;
  int32_t tp;
};

struct MemoBackArgs {
  const int32_t* parts[MAX_TP];  // ROUTED_PROBE's [5, miss_cap] records
  const int32_t* rep;
  const int32_t* miss_pos;
  const int32_t* n_miss;
  const int32_t* miss_pack;
  const int32_t* srow;  // MEMO_DEDUP's
  const int32_t* gid;
  const int32_t* n_unique;
  const int32_t* dedup_overflow;
  const uint32_t* tuples;  // [6, B]
  const uint32_t* keys;    // [3, B]
  const uint32_t* meta;    // l4_meta [E, 2, Kg]
  const uint8_t* valid;    // [B] (failover) or null
  const uint8_t* alive;    // [ntp] (failover) or null
  uint32_t* rv;            // [2, rep_cap] scratch: the reps' value words
  uint32_t* mv;            // [2, miss_cap] out: the misses' value words
  uint8_t* allowed;        // [B] outputs
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint8_t* hit;
  uint32_t* l4;        // [E, 2, Kg] zeroed
  uint32_t* l3;        // [E, 2, l3_shards * c_local] zeroed
  uint32_t* telem;     // [2, 20] zeroed, or null
  uint32_t* replica;   // [1] zeroed
  uint32_t* stats;     // [5] out
  uint32_t* counters;  // [3] zeroed: hits, inserts, valid tuples
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

// MESH_MEMO_COMBINE's front, stage 1: the records' sum, the hit masked
// by rep_valid, the missed flags
__global__ void __launch_bounds__(BLOCK) memo_front_sum(MemoFrontArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g == 0) *a.n_elems = a.rep_cap;
  if (g >= a.rep_cap) return;
  const size_t rc = static_cast<size_t>(a.rep_cap);
  uint32_t tot[4] = {0, 0, 0, 0};
  for (int t = 0; t < a.tp; ++t)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      tot[w] += static_cast<uint32_t>(__ldg(a.recs[t] + w * rc + g));
  const bool valid = g < valid_reps(a.n_unique, a.rep_cap);
  const bool hit = valid && tot[0] > 0;
  a.rep[g] = hit ? 1 : 0;
#pragma unroll
  for (int w = 1; w < 4; ++w) a.rep[w * rc + g] = static_cast<int32_t>(tot[w]);
  a.flags[g] = valid && !hit;
}

// stage 3: the missed positions, ascending, padded with rep_cap
__global__ void __launch_bounds__(BLOCK) memo_front_fill(MemoFrontArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s < a.miss_cap) a.miss_pos[s] = a.rep_cap;
}

__global__ void __launch_bounds__(BLOCK) memo_front_compact(MemoFrontArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= a.rep_cap || !a.flags[g]) return;
  const uint32_t pos = a.prefix[g];
  if (pos < static_cast<uint32_t>(a.miss_cap))
    a.miss_pos[pos] = g;
}

// stage 4: the missed representatives' tuples (padding: tuple
// rep_orig[rep_cap] = 0)
__global__ void __launch_bounds__(BLOCK) memo_front_pack(MemoFrontArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= a.miss_cap) return;
  const int orig = a.rep_orig[a.miss_pos[s]];
  const size_t b = static_cast<size_t>(a.B), mc = static_cast<size_t>(a.miss_cap);
#pragma unroll
  for (int w = 0; w < 6; ++w)
    a.miss_pack[w * mc + s] = static_cast<int32_t>(__ldg(a.tuples + w * b + orig));
}

// MESH_MEMO_COMBINE's back, stage 1, per miss slot: the routed records'
// lattice packed into value words (memo.pack_value_words), the replica
// gathers of the live slots (failover) and the inserts that will be done
__global__ void __launch_bounds__(BLOCK) memo_back_miss(MemoBackArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= a.miss_cap) return;
  const size_t mc = static_cast<size_t>(a.miss_cap);
  uint32_t any = 0, val1 = 0, served = 0;
  for (int t = 0; t < a.tp; ++t) {
    const uint32_t f = static_cast<uint32_t>(__ldg(a.parts[t] + s));
    any |= f;
    val1 += static_cast<uint32_t>(__ldg(a.parts[t] + mc + s));
    served += (f & F_REPLICA) ? 1u : 0u;
  }
  const int32_t ep = __ldg(a.miss_pack + s);
  const int32_t dir = __ldg(a.miss_pack + 4 * mc + s);
  const Routed r = routed_decode(a.parts[0], mc, s, any, val1, a.meta, a.ew,
                                 a.n_eps, a.kg, ep, dir);
  a.mv[s] = (static_cast<uint32_t>(r.j) << 16) |
            (static_cast<uint32_t>(r.proxy) & 0xFFFFu);
  a.mv[mc + s] = (r.p1 ? 1u : 0u) | (r.p2 ? 2u : 0u) | (r.p3 ? 4u : 0u);
  if (s >= *a.n_miss) return;
  if (a.failover && served) atomicAdd(a.replica, served);
  const int g = a.miss_pos[s];
  if (static_cast<uint32_t>(__ldg(a.rep + 3 * static_cast<size_t>(a.rep_cap) +
                                  g)) & INS_OK)
    atomicAdd(a.counters + 1, 1u);
}

// stage 2: each representative's value words, the cache's on a hit
__global__ void __launch_bounds__(BLOCK) memo_back_reps(MemoBackArgs a) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= a.rep_cap) return;
  const size_t rc = static_cast<size_t>(a.rep_cap);
  const bool hit = __ldg(a.rep + g) != 0;
  a.rv[g] = hit ? static_cast<uint32_t>(__ldg(a.rep + rc + g)) : 0u;
  a.rv[rc + g] = hit ? static_cast<uint32_t>(__ldg(a.rep + 2 * rc + g)) : 0u;
}

// stage 3: the missed representatives take the lattice's words
__global__ void __launch_bounds__(BLOCK) memo_back_misses(MemoBackArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= a.miss_cap) return;
  const int g = a.miss_pos[s];
  if (g >= a.rep_cap) return;
  const size_t rc = static_cast<size_t>(a.rep_cap),
               mc = static_cast<size_t>(a.miss_cap);
  a.rv[g] = a.mv[s];
  a.rv[rc + g] = a.mv[mc + s];
}

// stage 4, per sorted position: the tuple takes its group's words
// (memo.scatter_back), then the combine, the counters, the telemetry
__global__ void __launch_bounds__(BLOCK) memo_back_tuples(MemoBackArgs a) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = p < a.B;
  const size_t b = static_cast<size_t>(a.B), rc = static_cast<size_t>(a.rep_cap);
  uint32_t tbits = 0;
  int row = 0;
  bool counted_hit = false, ok = false;
  if (active) {
    const int i = a.srow[p];
    int gg = a.gid[p];
    gg = gg < a.rep_cap - 1 ? gg : a.rep_cap - 1;
    const uint32_t v0 = a.rv[gg], v1 = a.rv[rc + gg];
    const bool hit = __ldg(a.rep + gg) != 0;
    a.hit[i] = hit;
    const int32_t ep = static_cast<int32_t>(__ldg(a.tuples + i));
    const int32_t dir = static_cast<int32_t>(__ldg(a.tuples + 4 * b + i));
    const bool frag = __ldg(a.tuples + 5 * b + i) != 0;
    const bool p2 = v1 & 2u;
    const cdp::Lattice v =
        cdp::combine(v1 & 1u, p2, v1 & 4u, static_cast<int32_t>(v0 & 0xFFFFu),
                     static_cast<int32_t>(v0 >> 16), frag);
    a.allowed[i] = v.allowed;
    a.proxy_port[i] = v.proxy;
    a.match_kind[i] = static_cast<uint8_t>(v.kind);
    ok = !a.failover || a.valid == nullptr || __ldg(a.valid + i) != 0;
    counted_hit = hit && ok;
    if (ok) {
      if (v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD)
        count_hit(a.l4, a.n_eps, a.kg, ep, dir, v.j);
      if (v.kind == cdp::MATCH_L3 && p2) {
        // the word's serving owner and its local column
        const int64_t idx = __ldg(a.keys + i), word = idx >> 5;
        const int64_t cols = static_cast<int64_t>(a.l3_shards) * a.c_local;
        int64_t col = -1;
        if (!a.l3_sharded) {
          col = clamp64(idx, 0, a.c_local - 1);
        } else if (a.failover) {
          const int64_t g32 = static_cast<int64_t>(a.wn) * 32;
          const int64_t wp = word / a.wn;
          if (wp < a.tp) {
            const bool apw = a.alive[wp] != 0;
            const int64_t owner = apw ? wp : (wp + 1) % a.tp;
            col = owner * a.c_local + clamp64(idx - wp * g32, 0, g32 - 1) +
                  (apw ? 0 : g32);
          }
        } else {
          const int64_t owner = word / a.w_local;
          if (owner < a.tp)
            col = owner * a.c_local +
                  clamp64(idx - owner * a.c_local, 0, a.c_local - 1);
        }
        if (col >= 0 && col < cols) count_hit(a.l3, a.n_eps, cols, ep, dir, col);
      }
      tbits = telem_bits(v);
      row = dir == 0 ? 0 : 1;
    }
  }
  const uint32_t bh = __ballot_sync(0xFFFFFFFFu, counted_hit);
  const uint32_t bv = __ballot_sync(0xFFFFFFFFu, active && ok);
  if ((threadIdx.x & 31) == 0) {
    if (bh) atomicAdd(a.counters, static_cast<uint32_t>(__popc(bh)));
    if (bv) atomicAdd(a.counters + 2, static_cast<uint32_t>(__popc(bv)));
  }
  if (a.telem != nullptr) telem_block_sum(a.telem, tbits, row);
}

__global__ void memo_back_stats(MemoBackArgs a) {
  const uint32_t n_miss = static_cast<uint32_t>(*a.n_miss);
  const uint32_t over =
      static_cast<uint32_t>(*a.dedup_overflow) +
      (n_miss > static_cast<uint32_t>(a.miss_cap) ? n_miss - a.miss_cap : 0u);
  a.stats[STAT_UNIQUE] = static_cast<uint32_t>(*a.n_unique);
  a.stats[STAT_HIT] = a.counters[0];
  a.stats[STAT_INSERT] = over == 0 ? a.counters[1] : 0u;
  a.stats[STAT_OVERFLOW] = over;
  a.stats[STAT_TUPLES] = a.failover ? a.counters[2] : static_cast<uint32_t>(a.B);
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

// Launch MESH_COMBINE on `stream`; returns cudaGetLastError().
extern "C" int launch_mesh_combine(const cms::CombineArgs* args,
                                   void* stream) {
  return cms::launch(cms::mesh_combine_kernel, args, stream);
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

// MESH_MEMO_COMBINE's front on `stream`: the records' sum, the flag scan,
// the compaction and the miss pack; returns cudaGetLastError().
extern "C" int launch_mesh_memo_front(const cms::MemoFrontArgs* args,
                                      void* stream) {
  using namespace cms;
  const MemoFrontArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rep_cap <= 0 || a.miss_cap <= 0 || a.tp < 1 || a.tp > MAX_TP)
    return static_cast<int>(cudaErrorInvalidValue);
  memo_front_sum<<<grid_of(a.rep_cap), BLOCK, 0, st>>>(a);
  crx::flag_scan(a.flags, a.prefix, a.n_elems, a.rep_cap, a.sums, a.n_miss,
                 st);
  memo_front_fill<<<grid_of(a.miss_cap), BLOCK, 0, st>>>(a);
  memo_front_compact<<<grid_of(a.rep_cap), BLOCK, 0, st>>>(a);
  memo_front_pack<<<grid_of(a.miss_cap), BLOCK, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// MESH_MEMO_COMBINE's back on `stream`; returns cudaGetLastError().
extern "C" int launch_mesh_memo_back(const cms::MemoBackArgs* args,
                                     void* stream) {
  using namespace cms;
  const MemoBackArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.rep_cap <= 0 || a.miss_cap <= 0 || a.tp < 1 ||
      a.tp > MAX_TP)
    return static_cast<int>(cudaErrorInvalidValue);
  memo_back_miss<<<grid_of(a.miss_cap), BLOCK, 0, st>>>(a);
  memo_back_reps<<<grid_of(a.rep_cap), BLOCK, 0, st>>>(a);
  memo_back_misses<<<grid_of(a.miss_cap), BLOCK, 0, st>>>(a);
  memo_back_tuples<<<grid_of(a.B), BLOCK, 0, st>>>(a);
  memo_back_stats<<<1, 1, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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
