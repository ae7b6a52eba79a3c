// The fused IPv4 datapath on a (batch x table) mesh, two CUDA kernels for
// Hopper (sm_90a).  They replace the JAX package's fused failover
// datapath, cilium_tpu/engine/datapath_mesh.py: `_fused_core` (:231) run
// inside `make_failover_datapath_evaluator` (:596) and
// `make_failover_datapath_pair_evaluator` (:685) as one `shard_map` step
// with a table-axis psum after each routed gather (`_routed_rows`, :89).
// The port's step is a loop over the mesh coordinates
// (cilium_tpu_torch/engine/datapath_mesh.py): four rounds per batch row,
// one DP_MESH_PROBE launch per shard each, then one DP_MESH_COMBINE
// launch per batch row.
//
// DP_MESH_PROBE is one shard's step of one round (the owner-local part of
// one psum round of `_fused_core`, :300-496):
//   S  the CT bucket row of the original tuple (its FNV-1a hash, :304-316)
//      on its owner, probed for the service-scope key (:346-349);
//   L  the inline LB row on its owner, the backend chosen with the service
//      entry's slave from S (:353-392); the classic layout replicates and
//      is one full lb_select_classic (:393-404);
//   F  the flow-key CT probe against S's row (:411-413), the routed ipcache
//      bucket (:416-434) and one routed row per range class (:435-457), or
//      the [B, P] scan without range rows (:458-473);
//   P  the replica-aware lattice with idx and known from F (:474-496, the
//      body of cilium_tpu/engine/sharded.py failover_lattice_probes :917
//      with the index given): the exact key's row on its owner, the L3
//      word on its owner (l4_row_parts, verdict.cuh).
// It reads its batch row's tp records of the previous round, sums them
// (the psum: flags ORed, values added as u32), adds what it needs, and
// writes its own record.  An owner writes its plane's masked parts; shard
// 0 alone writes what every shard would compute alike (the stashes, the
// scan, the wildcard probe, the derived addresses and indices), and owns
// a plane the rules replicate, so the sum is the single-device result.
// Each record carries its shard's own F_REPLICA bit, ORed round to round.
// DP_MESH_COMBINE is the end of `_fused_core` (:497-575) with
// `failover_counts` (sharded.py :1063): the lattice sum and `_combine`,
// the bpf_lxc combine, the tunnel select (egress only), the 15
// DatapathVerdicts columns, the L4 and L3 counters (the owner's slice, in
// the augmented layout), the [2, 20] telemetry row with every datapath
// mask and the (tuple, shard) pairs served from a backup region, all
// masked by `valid`.
//
// Records, int32 [rows, B] (engine/datapath_mesh.py names the rows):
//   S [3]  flags (S_FWD, S_REV, F_REPLICA), fwd value, rev value
//   L [5]  flags (L_FOUND, F_REPLICA), slave, daddr, dport, rev_nat
//   F [12] flags (F_CT_FWD, F_CT_REV, F_REPLICA, F_EXACT, F_CLASS0 << c),
//          CT fwd value, CT rev value, exact value, 4 class values, and on
//          shard 0 the post-DNAT daddr, dport, rev_nat and slave
//   P [10] flags (P_P1, P_P2, F_REPLICA, P_P3, P_KNOWN, P_MISS), the exact
//          value, the wildcard value, the L3 column, and on shard 0 idx,
//          the CT result, daddr, dport, rev_nat, slave
//
// What bounds them on an H100: dependent row reads, as DATAPATH_PAIR
// (datapath.cu).  A probe streams its flow words (16 or 32 B) and the
// previous round's tp records in (the head rows of shard 0's only) and
// its record out, and reads on its owned tuples one CT row (S and F), one
// LB row (L), one ipcache row and the range-class rows (F), one hashed L4
// row and one L3 word (P); shard 0 reads the stashes, the scan's ranges
// and the wildcard row.  The combine reads the flags and owner value of
// tp records and the head rows of shard 0's, and writes 39 B a flow.  A
// tuple's rows are read on its owner only, so the rows per tuple are
// those of one DATAPATH_PAIR flow, but the records cost 4 B x rows x tp
// in and out per round, and every shard writes its record whole (zeros
// in the head rows of shards 1 .. tp - 1).  The probe is one tuple per
// thread with read-only loads.
//
// The combine (redesigned after a first version that took 0.1731 device
// ms per batch row of 2,097,152 flows, 4 records, its call's four zero
// fills included; PERF.md §5) is one flow a thread too, at
// COMBINE_BLOCKS_PER_SM blocks an SM.  Measured on config 5 there:
//   * its telemetry took 0.027 ms as 40 ballots a warp and 40 shared
//     atomics from lane 0; it is now one ballot a column, lane c keeping
//     column c's ingress and egress counts, and a block's sums committed
//     once, with the replica count (telem.cuh's telem_block_sum, which
//     MESH_COMBINE and the memo's back pass in mesh.cu share);
//   * the wrapper zeroes the four counter buffers as views of one
//     allocation, one fill in place of four (0.0175 -> 0.0111 ms; the l3
//     buffer, [E, 2, l3_shards x c_local], is about 34 MB on config 5's
//     (2, 4) mesh);
//   * the counted hits stay one global atomicAdd each: 1,075,758 L3 hits
//     over 21,827 cells (613 cells for L4) leave a block of 256 flows
//     nearly no equal cells, and the block's cell tables (common.cuh
//     cell_add), a warp's match, and 4 flows a thread with 16-byte loads
//     (more registers, fewer warps) each measured slower;
//   * the streaming hints measured slower: the records the probes have
//     just written are read from the L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ct.cuh"
#include "ipcache.cuh"
#include "lb.cuh"
#include "prefilter.cuh"
#include "telem.cuh"
#include "tunnel.cuh"
#include "verdict.cuh"

namespace cdm {

using cdp::DatapathArgs;

constexpr int BLOCK = 256;
constexpr int MAX_TP = 16;
using ctl::TELEM_COLS;
constexpr int ROUND_S = 0, ROUND_L = 1, ROUND_F = 2, ROUND_P = 3;
constexpr int REC_S = 3, REC_L = 5, REC_F = 12, REC_P = 10;
constexpr int HEAD_F = 8;  // F's rows 8 .. 11 are shard 0's alone
constexpr int FORM_WORDS = 0;  // flows [8, B] words; else packed4 [4, B]
constexpr uint32_t F_REPLICA = 4;
constexpr uint32_t S_FWD = 1, S_REV = 2;
constexpr uint32_t L_FOUND = 1;
constexpr uint32_t F_CT_FWD = 1, F_CT_REV = 2, F_EXACT = 8, F_CLASS0 = 16;
constexpr uint32_t P_P1 = 1, P_P2 = 2, P_P3 = 8, P_KNOWN = 16, P_MISS = 32;

// The field orders are the ctypes Structures' orders in kernels.py;
// dp_mesh_struct_sizes() lets the wrapper check that they agree.
struct DpMeshArgs {
  // the shard's tables: its local blocks of the sharded planes, the
  // replicated leaves whole (kernels.py _fill_shard)
  DatapathArgs dp;
  const uint32_t* flows;          // [8, B] words or packed4 [4, B]
  const int32_t* prev[MAX_TP];    // the previous round's records
  int32_t* out;                   // this shard's record
  const uint8_t* alive;           // [ntp] this batch row's chips
  int32_t B;
  int32_t flow_form;
  int32_t round;
  int32_t t;  // this shard's table index
  int32_t ntp;
  int32_t static_dir;  // -1 each flow's own, 0 ingress, 1 egress
  int32_t ct_sharded;
  int32_t lb_sharded;
  int32_t ipc_sharded;
  int32_t range_sharded;
  int32_t rows_sharded;
  int32_t l3_sharded;
  int32_t n_ct;  // global row counts of the hashed planes
  int32_t n_lb;
  int32_t n_ipc;
  int32_t n_range;
  int32_t n_rows_global;
  int32_t wn;         // un-augmented L3 words per shard (sharded L3)
  int32_t n_l3_ids;   // the L3 columns of a replicated plane
  int32_t scan;       // stage the [B, P] scan's ranges (round F, shard 0)
};

struct DpCombineArgs {
  // shard 0's tables (prefilter, tunnel, id_table, l4_meta) and the 15
  // output columns (dp.allowed ... dp.ipcache_miss)
  DatapathArgs dp;
  const uint32_t* flows;
  const int32_t* parts[MAX_TP];  // the row's round-P records
  const uint8_t* valid;          // [B] or null (all valid)
  uint32_t* l4;                  // [E, 2, Kg], zeroed
  uint32_t* l3;                  // [E, 2, l3_shards * c_local], zeroed
  uint32_t* telem;               // [2, 20] zeroed, or null
  uint32_t* replica;             // [1] zeroed
  int32_t B;
  int32_t flow_form;
  int32_t tp;
  int32_t static_dir;
  int32_t l3_shards;
  int32_t c_local;
};

struct Flow {
  uint32_t ep, saddr, daddr, sport, dport, proto, dir;
  bool frag;
};

// FLOW_COLUMNS words, or the packed4 unpack (engine/datapath.py)
__device__ __forceinline__ Flow load_flow(const uint32_t* f, size_t b, int i,
                                          int form) {
  Flow x;
  if (form == FORM_WORDS) {
    x.ep = __ldg(f + i);
    x.saddr = __ldg(f + b + i);
    x.daddr = __ldg(f + 2 * b + i);
    x.sport = __ldg(f + 3 * b + i);
    x.dport = __ldg(f + 4 * b + i);
    x.proto = __ldg(f + 5 * b + i);
    x.dir = __ldg(f + 6 * b + i);
    x.frag = __ldg(f + 7 * b + i) != 0;
  } else {
    const uint32_t w2 = __ldg(f + 2 * b + i), w3 = __ldg(f + 3 * b + i);
    x.saddr = __ldg(f + i);
    x.daddr = __ldg(f + b + i);
    x.sport = w2 >> 16;
    x.dport = w2 & 0xFFFFu;
    x.ep = w3 >> 16;
    x.proto = (w3 >> 8) & 0xFFu;
    x.dir = (w3 >> 1) & 1u;
    x.frag = (w3 & 1u) != 0;
  }
  return x;
}

__device__ __forceinline__ bool is_ingress(const Flow& x, int static_dir) {
  return static_dir < 0 ? x.dir == 0 : static_dir == 0;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// `_routed_rows` (:89): the bucket's owner (the backup owner, the next
// shard over, when the primary is dead) and its local row; a plane the
// rules replicate is owned by shard 0
struct Route {
  int64_t bl;
  bool owns, rep;
};

__device__ __forceinline__ Route route(uint32_t bucket, int sharded,
                                       int n_global, int ntp, int t,
                                       const uint8_t* alive) {
  Route r;
  if (!sharded) {
    r.bl = bucket;
    r.owns = t == 0;
    r.rep = false;
    return r;
  }
  const int64_t n = n_global / ntp;
  const int64_t p = bucket / n;
  const bool ap = __ldg(alive + p) != 0;
  r.owns = (ap ? p : (p + 1) % ntp) == t;
  r.bl = clamp64(bucket - p * n + (ap ? 0 : n), 0, 2 * n - 1);
  r.rep = r.owns && !ap;
  return r;
}

// the psum of the previous round's records: the flags ORed, each value
// row summed as u32 into v[0 .. ROWS - 2]; rows HEAD .. ROWS - 1, which
// shard 0 alone writes (the others write 0 there), are read from its
// record only
template <int ROWS, int HEAD = ROWS>
__device__ __forceinline__ uint32_t psum(const DpMeshArgs& a, size_t b, int i,
                                         uint32_t* v) {
  uint32_t any = 0;
#pragma unroll
  for (int r = 0; r < HEAD - 1; ++r) v[r] = 0;
  for (int t = 0; t < a.ntp; ++t) {
    const int32_t* p = a.prev[t];
    any |= static_cast<uint32_t>(__ldg(p + i));
#pragma unroll
    for (int r = 1; r < HEAD; ++r)
      v[r - 1] += static_cast<uint32_t>(__ldg(p + r * b + i));
  }
#pragma unroll
  for (int r = HEAD; r < ROWS; ++r)
    v[r - 1] = static_cast<uint32_t>(__ldg(a.prev[0] + r * b + i));
  return any;
}

__device__ __forceinline__ bool own_replica(const DpMeshArgs& a, int i) {
  return (static_cast<uint32_t>(__ldg(a.prev[a.t] + i)) & F_REPLICA) != 0;
}

__device__ __forceinline__ void put(const DpMeshArgs& a, size_t b, int i,
                                    int row, uint32_t v) {
  a.out[row * b + i] = static_cast<int32_t>(v);
}

__device__ __forceinline__ void add_ct(cdp::CTParts& p,
                                       const cdp::CTParts& q) {
  p.ff = p.ff || q.ff;
  p.rf = p.rf || q.rf;
  p.fv += q.fv;
  p.rv += q.rv;
}

// the routed CT probe of round S (the service key) or F (the flow key):
// the owner's row parts, shard 0's stash parts
__device__ __forceinline__ cdp::CTParts ct_parts(const DpMeshArgs& a,
                                                 const Flow& x,
                                                 const cdp::CTKeys& k,
                                                 Route* rc) {
  const DatapathArgs& d = a.dp;
  const uint32_t h =
      cdp::ct_row_hash(x.daddr, x.saddr, x.dport, x.sport, x.proto);
  *rc = route(h & static_cast<uint32_t>(a.n_ct - 1), a.ct_sharded, a.n_ct,
              a.ntp, a.t, a.alive);
  cdp::CTParts p{false, false, 0u, 0u};
  if (rc->owns)
    p = cdp::ct_row_parts(d.ct_buckets + rc->bl * d.ct_lanes, d.ct_lanes,
                          d.ct_ew, k);
  if (a.t == 0) add_ct(p, cdp::ct_stash_parts(d.ct_stash, d.ct_stash_n, k));
  return p;
}

__device__ __forceinline__ void round_s(const DpMeshArgs& a, const Flow& x,
                                        size_t b, int i) {
  const cdp::CTKeys k = cdp::ct_keys(x.daddr, x.saddr, x.dport, x.sport,
                                     x.proto, cdp::CT_DIR_SERVICE);
  Route rc;
  const cdp::CTParts p = ct_parts(a, x, k, &rc);
  put(a, b, i, 0,
      (p.ff ? S_FWD : 0u) | (p.rf ? S_REV : 0u) | (rc.rep ? F_REPLICA : 0u));
  put(a, b, i, 1, p.fv);
  put(a, b, i, 2, p.rv);
}

__device__ __forceinline__ void round_l(const DpMeshArgs& a, const Flow& x,
                                        size_t b, int i) {
  const DatapathArgs& d = a.dp;
  uint32_t v[REC_S - 1];
  const uint32_t any = psum<REC_S>(a, b, i, v);
  const cdp::CTResult svc =
      cdp::ct_combine(any & S_FWD, any & S_REV, v[0], v[1]);
  const uint32_t vip = x.daddr;
  const uint32_t w1 = ((x.dport & 0xFFFFu) << 16) | (x.proto & 0xFFu);
  const uint32_t fh =
      cdp::fnv1a4(x.saddr, x.daddr, (x.sport << 16) | x.dport, x.proto);
  cdp::LBOut o{false, 0, 0u, 0u, 0};
  bool rep = false;
  if (d.lb_backends == nullptr) {  // the inline layout
    const Route rl =
        route(cdp::fnv1a2(vip, w1) & static_cast<uint32_t>(a.n_lb - 1),
              a.lb_sharded, a.n_lb, a.ntp, a.t, a.alive);
    rep = rl.rep;
    if (rl.owns)
      o = cdp::lb_slot_outputs(d.lb_rows + rl.bl * 2 * cdp::LB_SLOT, 2, vip,
                               w1, fh, svc.slave);
    if (a.t == 0) {
      const cdp::LBOut s = cdp::lb_slot_outputs(d.lb_stash, d.lb_stash_n,
                                                vip, w1, fh, svc.slave);
      o.found = o.found || s.found;
      o.slave = static_cast<int32_t>(static_cast<uint32_t>(o.slave) +
                                     static_cast<uint32_t>(s.slave));
      o.daddr += s.daddr;
      o.dport += s.dport;
      o.rev_nat = static_cast<int32_t>(static_cast<uint32_t>(o.rev_nat) +
                                       static_cast<uint32_t>(s.rev_nat));
    }
  } else if (a.t == 0) {
    const cdp::LBResult r = cdp::lb_select_classic(
        d, x.saddr, x.daddr, x.sport, x.dport, x.proto, svc.slave);
    o = cdp::LBOut{r.found, r.slave, r.daddr, r.dport, r.rev_nat};
  }
  rep = rep || own_replica(a, i);
  put(a, b, i, 0, (o.found ? L_FOUND : 0u) | (rep ? F_REPLICA : 0u));
  put(a, b, i, 1, static_cast<uint32_t>(o.slave));
  put(a, b, i, 2, o.daddr);
  put(a, b, i, 3, o.dport);
  put(a, b, i, 4, static_cast<uint32_t>(o.rev_nat));
}

__device__ __forceinline__ void round_f(const DpMeshArgs& a, const Flow& x,
                                        size_t b, int i) {
  const DatapathArgs& d = a.dp;
  const bool ingress = is_ingress(x, a.static_dir);
  uint32_t eff_daddr = x.daddr, eff_dport = x.dport, rev = 0, slave = 0;
  bool rep = false;
  if (a.static_dir != 0) {  // round L ran
    uint32_t v[REC_L - 1];
    const uint32_t any = psum<REC_L>(a, b, i, v);
    rep = own_replica(a, i);
    if (!ingress && (any & L_FOUND)) {
      slave = v[0];
      eff_daddr = v[1];
      eff_dport = v[2];
      rev = v[3];
    }
  }
  // the flow key against the original tuple's row
  const cdp::CTKeys k = cdp::ct_keys(eff_daddr, x.saddr, eff_dport, x.sport,
                                     x.proto, x.dir);
  Route rc;
  const cdp::CTParts p = ct_parts(a, x, k, &rc);
  // the routed ipcache bucket and the stash
  const uint32_t sec = ingress ? x.saddr : eff_daddr;
  const Route ri = route(cdp::fnv1a1(sec) & static_cast<uint32_t>(a.n_ipc - 1),
                         a.ipc_sharded, a.n_ipc, a.ntp, a.t, a.alive);
  cdp::IPCParts bp{false, 0u};
  if (ri.owns)
    bp = cdp::ipc_bucket_parts(d.ipc_buckets + ri.bl * d.ipc_lanes,
                               d.ipc_per, d.ipc_vw, sec);
  if (a.t == 0) {
    const cdp::IPCParts s =
        cdp::ipc_stash_parts(d.ipc_stash, d.ipc_stash_n, d.ipc_stash_w, sec);
    bp.found = bp.found || s.found;
    bp.val += s.val;
  }
  // the range classes on their owners, or the [B, P] scan on shard 0
  uint32_t cls = 0, cv[4] = {0u, 0u, 0u, 0u};
  if (d.ipc_range_rows != nullptr) {
    for (int c = 0; c < d.n_classes; ++c) {
      const uint32_t sp = static_cast<uint32_t>(d.class_plens[c]);
      const uint32_t w0 = cdp::range_class_w0(sec, sp);
      const Route rr = route(
          cdp::fnv1a2(w0, sp) & static_cast<uint32_t>(a.n_range - 1),
          a.range_sharded, a.n_range, a.ntp, a.t, a.alive);
      rep = rep || rr.rep;
      if (rr.owns) {
        const cdp::IPCParts q = cdp::range_class_parts(
            d.ipc_range_rows + rr.bl * d.range_lanes, d.range_e,
            d.range_offs, d.range_widths, w0, sp);
        if (q.found) cls |= F_CLASS0 << c;
        cv[c] = q.val;
      }
    }
  } else if (a.scan) {
    const cdp::IPCParts q = cdp::range_scan_parts(d.n_ranges, sec);
    if (q.found) cls |= F_CLASS0;
    cv[0] = q.val;
  }
  rep = rep || rc.rep || ri.rep;
  put(a, b, i, 0,
      (p.ff ? F_CT_FWD : 0u) | (p.rf ? F_CT_REV : 0u) |
          (rep ? F_REPLICA : 0u) | (bp.found ? F_EXACT : 0u) | cls);
  put(a, b, i, 1, p.fv);
  put(a, b, i, 2, p.rv);
  put(a, b, i, 3, bp.val);
#pragma unroll
  for (int c = 0; c < 4; ++c) put(a, b, i, 4 + c, cv[c]);
  const bool head = a.t == 0;
  put(a, b, i, 8, head ? eff_daddr : 0u);
  put(a, b, i, 9, head ? eff_dport : 0u);
  put(a, b, i, 10, head ? rev : 0u);
  put(a, b, i, 11, head ? slave : 0u);
}

__device__ __forceinline__ void round_p(const DpMeshArgs& a, const Flow& x,
                                        size_t b, int i) {
  const DatapathArgs& d = a.dp;
  uint32_t v[REC_F - 1];
  const uint32_t any = psum<REC_F, HEAD_F>(a, b, i, v);
  bool rep = own_replica(a, i);
  const cdp::CTResult ct =
      cdp::ct_combine(any & F_CT_FWD, any & F_CT_REV, v[0], v[1]);
  // the identity index: the exact hit, else the longest range class
  const int n_cls = d.ipc_range_rows != nullptr ? d.n_classes : 1;
  bool rf = false;
  uint32_t rv = 0;
  for (int c = 0; c < n_cls; ++c) {
    if (!rf && (any & (F_CLASS0 << c))) {
      rf = true;
      rv = v[3 + c];
    }
  }
  const uint32_t looked = (any & F_EXACT) ? v[2] : (rf ? rv : 0u);
  const bool miss = looked == 0;
  const uint32_t vp = miss ? d.world_plus1 : looked;
  const bool known = vp != 0 && vp != cdp::UNKNOWN_IDX;
  const uint32_t idx = known ? vp - 1 : static_cast<uint32_t>(d.n_ids - 1);
  const uint32_t eff_daddr = v[7], eff_dport = v[8];

  // -- the exact key on its row's owner, the stash and wildcard on shard 0
  const cdp::L4Tables lt = cdp::l4_tables(d);
  const uint32_t dport = cdp::clip_u(static_cast<int32_t>(eff_dport), 65535);
  const uint32_t proto = cdp::clip_u(static_cast<int32_t>(x.proto), 255);
  uint32_t w0, w1;
  cdp::l4_keys(lt.ew, x.ep, x.dir, dport, proto, idx, &w0, &w1);
  const Route rl =
      route(cdp::fnv1a2(w0, w1) & static_cast<uint32_t>(a.n_rows_global - 1),
            a.rows_sharded, a.n_rows_global, a.ntp, a.t, a.alive);
  bool found = false;
  uint32_t val = 0;
  if (rl.owns) {
    const cdp::L4Probe ex = cdp::l4_row_parts(lt.rows + rl.bl * lt.lanes,
                                              lt.lanes, lt.ew, w0, w1);
    found = ex.hit;
    val = ex.val;
  }
  const bool head = a.t == 0;
  cdp::L4Probe wd{false, 0u};
  if (head) {
    const cdp::L4Probe st =
        cdp::l4_stash_parts(lt.stash, lt.stash_n, lt.ew, w0, w1);
    found = found || st.hit;
    val += st.val;
    uint32_t v0, v1;
    cdp::l4_keys(lt.ew, x.ep, x.dir, dport, proto, cdp::L4H_WILD_IDX, &v0,
                 &v1);
    wd = cdp::l4_probe_ew(lt.wrows, lt.wnrows, lt.wlanes, lt.wstash,
                          lt.wstash_n, lt.ew, v0, v1);
  }
  rep = rep || rl.rep;

  // -- the L3 word on its owner
  const int64_t word = idx >> 5;
  const uint32_t bit = idx & 31u;
  bool owns_w;
  int64_t wl, lcol;
  if (a.l3_sharded) {
    const int64_t wn = a.wn, g = static_cast<int64_t>(a.wn) * 32;
    const int64_t wp = clamp64(word / wn, 0, a.ntp - 1);
    const bool apw = __ldg(a.alive + wp) != 0;
    owns_w = (apw ? wp : (wp + 1) % a.ntp) == a.t;
    wl = clamp64(word - wp * wn + (apw ? 0 : wn), 0, 2 * wn - 1);
    rep = rep || (owns_w && !apw);
    lcol = clamp64(static_cast<int64_t>(idx) - wp * g, 0, g - 1) +
           (apw ? 0 : g);
  } else {
    owns_w = head;
    wl = word;
    lcol = clamp64(idx, 0, a.n_l3_ids - 1);
  }
  bool p2 = false;
  if (known && owns_w) {
    const size_t row =
        static_cast<size_t>(cdp::gather_ix(static_cast<int32_t>(x.ep),
                                           d.n_eps)) * 2 +
        cdp::gather_ix(static_cast<int32_t>(x.dir), 2);
    const uint32_t l3 = __ldg(
        d.l3_allow + row * d.n_words +
        cdp::gather_ix(static_cast<int32_t>(wl), d.n_words));
    p2 = (l3 >> bit) & 1u;
  }
  uint32_t flags = (found ? P_P1 : 0u) | (p2 ? P_P2 : 0u) |
                   (rep ? F_REPLICA : 0u);
  if (head)
    flags |= (wd.hit ? P_P3 : 0u) | (known ? P_KNOWN : 0u) |
             (miss ? P_MISS : 0u);
  put(a, b, i, 0, flags);
  put(a, b, i, 1, val);
  put(a, b, i, 2, head ? wd.val : 0u);
  put(a, b, i, 3, p2 ? static_cast<uint32_t>(lcol) : 0u);
  put(a, b, i, 4, head ? idx : 0u);
  put(a, b, i, 5, head ? ct.result : 0u);
  put(a, b, i, 6, head ? eff_daddr : 0u);
  put(a, b, i, 7, head ? eff_dport : 0u);
  put(a, b, i, 8, head ? v[9] : 0u);
  put(a, b, i, 9, head ? v[10] : 0u);
}

template <int ROUND>
__global__ void __launch_bounds__(BLOCK) dp_mesh_probe_kernel(
    const DpMeshArgs a) {
  // the scan's ranges, staged by every thread of the block
  if (ROUND == ROUND_F && a.scan) cdp::stage_ranges(a.dp);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B) return;
  const size_t b = static_cast<size_t>(a.B);
  const Flow x = load_flow(a.flows, b, i, a.flow_form);
  if (ROUND == ROUND_S) round_s(a, x, b, i);
  if (ROUND == ROUND_L) round_l(a, x, b, i);
  if (ROUND == ROUND_F) round_f(a, x, b, i);
  if (ROUND == ROUND_P) round_p(a, x, b, i);
}

// -- the combine -------------------------------------------------------------

constexpr int COMBINE_BLOCKS_PER_SM = 6;  // 40 registers; 5 and 4 slower

// jax's scatter-add at [e, d, c] of an [n_eps, 2, cols] buffer: negative
// indices count from the end, an update still outside is dropped
__device__ __forceinline__ void count_hit(uint32_t* buf, int n_eps,
                                          int64_t cols, int32_t ep,
                                          int32_t dir, int64_t c) {
  const int64_t e = ep < 0 ? static_cast<int64_t>(ep) + n_eps : ep;
  const int64_t dd = dir < 0 ? static_cast<int64_t>(dir) + 2 : dir;
  if (c < 0) c += cols;
  if (e >= 0 && e < n_eps && dd >= 0 && dd < 2 && c >= 0 && c < cols)
    atomicAdd(buf + (e * 2 + dd) * cols + c, 1u);
}

__global__ void __launch_bounds__(BLOCK, COMBINE_BLOCKS_PER_SM)
    dp_mesh_combine_kernel(const DpCombineArgs a) {
  const DatapathArgs& d = a.dp;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = i < a.B;
  const size_t b = static_cast<size_t>(a.B);
  uint32_t tbits = 0, served = 0;
  int row = 0;
  if (active) {
    const Flow x = load_flow(a.flows, b, i, a.flow_form);
    const int32_t ep = static_cast<int32_t>(x.ep);
    const int32_t dir = static_cast<int32_t>(x.dir);
    const int32_t* head = a.parts[0];
    const uint32_t f0 = static_cast<uint32_t>(__ldg(head + i));
    uint32_t any = 0, val1 = 0;
    for (int t = 0; t < a.tp; ++t) {
      const uint32_t f = static_cast<uint32_t>(__ldg(a.parts[t] + i));
      any |= f;
      val1 += static_cast<uint32_t>(__ldg(a.parts[t] + b + i));
      served += (f & F_REPLICA) ? 1u : 0u;
    }
    // the lattice: probe 1 known and found, the value of the first probe
    // that hit (3-word entries carry the proxy, 2-word ones the slot)
    const bool p1 = (f0 & P_KNOWN) && (any & P_P1);
    const bool p2 = any & P_P2;
    const bool p3 = f0 & P_P3;
    const uint32_t val =
        p1 ? val1 : static_cast<uint32_t>(__ldg(head + 2 * b + i));
    int32_t proxy, j;
    if (d.l4_ew == 3) {
      proxy = static_cast<int32_t>(val & 0xFFFFu);
      j = static_cast<int32_t>(val >> 16);
    } else {
      j = static_cast<int32_t>(val);
      const uint32_t m = __ldg(
          d.l4_meta + (static_cast<size_t>(cdp::gather_ix(ep, d.n_eps)) * 2 +
                       cdp::gather_ix(dir, 2)) * d.kg +
          cdp::gather_ix(j, d.kg));
      proxy = (p1 || p3) ? static_cast<int32_t>(m >> 1) : 0;
    }
    const cdp::Lattice v = cdp::combine(p1, p2, p3, proxy, j, x.frag);

    // the bpf_lxc combine with the CT result and the prefilter
    const uint32_t idx = static_cast<uint32_t>(__ldg(head + 4 * b + i));
    const uint32_t ct = static_cast<uint32_t>(__ldg(head + 5 * b + i));
    const uint32_t eff_daddr = static_cast<uint32_t>(__ldg(head + 6 * b + i));
    const int32_t eff_dport = __ldg(head + 7 * b + i);
    const int32_t rev_nat = __ldg(head + 8 * b + i);
    const int32_t lb_slave = __ldg(head + 9 * b + i);
    const bool miss = f0 & P_MISS;
    const bool ingress = is_ingress(x, a.static_dir);
    const bool pre = d.pf_l1 != nullptr
                         ? cdp::prefilter_drop<cdp::PF_LPM>(d, x.saddr)
                         : cdp::prefilter_drop<cdp::PF_RANGES>(d, x.saddr);
    const bool pass_ct = ct == cdp::CT_REPLY;  // RELATED is never probed
    const bool allowed = !pre && (pass_ct || v.allowed);
    const bool ct_delete =
        ct == cdp::CT_ESTABLISHED && !v.allowed && !pass_ct && !pre;
    const bool ct_create = ct == cdp::CT_NEW && allowed;
    const int32_t proxy_out =
        (v.allowed && (ct == cdp::CT_NEW || ct == cdp::CT_ESTABLISHED) &&
         allowed)
            ? v.proxy
            : 0;
    const uint32_t dst[1] = {eff_daddr};
    const uint32_t tunnel =
        (d.tun_base && a.static_dir != 0 && allowed && !ingress)
            ? cdp::tunnel_select<1>(d.tun_base, d.tun_mask, d.tun_endpoint,
                                    d.tun_n, dst, 0u)
            : 0u;
    d.allowed[i] = allowed;
    d.proxy_port[i] = proxy_out;
    d.match_kind[i] = static_cast<uint8_t>(v.kind);
    d.ct_result[i] = static_cast<uint8_t>(ct);
    d.pre_dropped[i] = pre;
    d.sec_id[i] = __ldg(d.id_table +
                        cdp::gather_ix(static_cast<int32_t>(idx), d.n_ids));
    d.final_daddr[i] = eff_daddr;
    d.final_dport[i] = eff_dport;
    d.rev_nat[i] = rev_nat;
    d.lb_slave[i] = lb_slave;
    d.ct_create[i] = ct_create;
    d.ct_delete[i] = ct_delete;
    d.tunnel_endpoint[i] = tunnel;
    d.l4_slot[i] = v.j;
    d.ipcache_miss[i] = miss;

    const bool ok = a.valid == nullptr || __ldg(a.valid + i) != 0;
    if (!ok) served = 0;
    if (ok) {
      if (v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD)
        count_hit(a.l4, d.n_eps, d.kg, ep, dir, v.j);
      if (v.kind == cdp::MATCH_L3) {
        const int64_t cols = static_cast<int64_t>(a.l3_shards) * a.c_local;
        for (int t = 0; t < a.l3_shards; ++t) {
          if (__ldg(a.parts[t] + i) & P_P2)
            count_hit(a.l3, d.n_eps, cols, ep, dir,
                      static_cast<int64_t>(t) * a.c_local +
                          __ldg(a.parts[t] + 3 * b + i));
        }
      }
      // engine/verdict.py telemetry_masks, one bit a column
      const uint32_t kind = v.kind;
      const bool post = !allowed && !pre;
      const bool m[TELEM_COLS] = {
          true,
          allowed,
          !allowed,
          pre,
          post && kind == cdp::MATCH_NONE,
          post && kind == cdp::MATCH_FRAG_DROP,
          kind == cdp::MATCH_L4,
          kind == cdp::MATCH_L3,
          kind == cdp::MATCH_L4_WILD,
          kind == cdp::MATCH_NONE,
          kind == cdp::MATCH_FRAG_DROP,
          lb_slave > 0,
          ct == cdp::CT_NEW,
          ct == cdp::CT_ESTABLISHED,
          ct == cdp::CT_REPLY,
          false,  // CT_RELATED: never probed
          pass_ct && !v.allowed && !pre,
          ct_delete,
          miss,
          proxy_out > 0 && allowed,
      };
#pragma unroll
      for (int c = 0; c < TELEM_COLS; ++c) tbits |= m[c] ? (1u << c) : 0u;
      row = ingress ? 0 : 1;
    }
  }
  ctl::telem_block_sum(a.telem, a.replica, tbits, row == 0, served);
}

}  // namespace cdm

extern "C" {

int dp_mesh_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cdp::DatapathArgs));
  out[1] = static_cast<int>(sizeof(cdm::DpMeshArgs));
  out[2] = static_cast<int>(sizeof(cdm::DpCombineArgs));
  return 3;
}

int launch_dp_mesh_probe(const cdm::DpMeshArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  const dim3 grid((a->B + cdm::BLOCK - 1) / cdm::BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = a->scan ? cdp::scan_smem_bytes(a->dp) : 0;
  switch (a->round) {
    case cdm::ROUND_S:
      cdm::dp_mesh_probe_kernel<cdm::ROUND_S><<<grid, cdm::BLOCK, 0, s>>>(*a);
      break;
    case cdm::ROUND_L:
      cdm::dp_mesh_probe_kernel<cdm::ROUND_L><<<grid, cdm::BLOCK, 0, s>>>(*a);
      break;
    case cdm::ROUND_F:
      cdm::dp_mesh_probe_kernel<cdm::ROUND_F>
          <<<grid, cdm::BLOCK, smem, s>>>(*a);
      break;
    case cdm::ROUND_P:
      cdm::dp_mesh_probe_kernel<cdm::ROUND_P><<<grid, cdm::BLOCK, 0, s>>>(*a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_dp_mesh_combine(const cdm::DpCombineArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  const dim3 grid((a->B + cdm::BLOCK - 1) / cdm::BLOCK);
  cdm::dp_mesh_combine_kernel<<<grid, cdm::BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
