// The fused IPv4 datapath, CUDA kernels for Hopper (sm_90a).
//
// PERSISTENT_PAIR replaces the JAX package's persistent fused-pair program
// `persistent_pair_program` (cilium_tpu/engine/datapath.py:922, jit :953:
// a lax.scan of the pair step over a [K, 2, 4, B] super-batch, the counter
// and telemetry carry threaded through): one launch for K pairs, the K
// pairs' columns stacked [K, 2, B], every hit into the one counter buffer
// and every half's telemetry into the one [2, 20] row pair.  DATAPATH_PAIR
// launches the same kernel at K = 1.  What bounds it is what bounds
// DATAPATH_PAIR (below): the stream of all K pairs (16 B in and 39 B out
// a flow) and each distinct table row the K pairs select, read once; at
// the headline's K = 4 and B = 2,097,152 at most 4 x 244,466,568 B, 0.29
// ms at 3.35 TB/s.
//
// DATAPATH_PAIR replaces the JAX package's jitted device program
// `datapath_step_accum_pair_telem_packed4_stacked`
// (cilium_tpu/engine/datapath.py:801: `_datapath_core` run once per
// direction-specialized half, with counters and telemetry).
// DATAPATH_STEP replaces the single-batch forms of
// cilium_tpu/engine/datapath.py: `datapath_step` (:604, `_datapath_core`
// with static_direction=None and emit_sec_id), as the churn program
// (cilium_tpu/replay.py:192 `_churn_fns`) runs it over a pool gather, and
// the accumulate forms `_datapath_kernel_with_counters` (:610),
// `_datapath_kernel_accum` (:622), `_accum_dir_kernel` (:643),
// `_datapath_kernel_telem` (:703) and `_datapath_kernel_accum_telem`
// (:711), as the record replay (cilium_tpu/replay.py:514) runs them.  The
// forms are runtime flags of the one kernel (DatapathArgs: static_dir,
// emit_sec_id, acc, telem, picks null for a direct [8, B] pack).
// DATAPATH_PAIR's memo mode (DatapathArgs.memo) is the pair step with the
// verdict memo of csrc/memo.cu in place of the lattice, as
// cilium_tpu/engine/memo.py:781 `memo_pair_packed4_kernel` runs
// `_datapath_core` with its `lattice_fn`: a front pass (stages 1-5, the
// columns that do not depend on the lattice and the policy-key words;
// `datapath_memo_front_kernel`) and a back pass (the combine, counters,
// telemetry and tunnel from the memo's value words).
// Both fuse the stages:
//   packed4 unpack      flow_batch_from_packed4       (engine/datapath.py)
//   pool gather         flow_batch_from_packed        (engine/datapath.py)
//   FNV-1a              fnv1a_device                  (engine/hashtable.py)
//   sub-word unpack     unpack_lanes                  (engine/subword.py)
//   prefilter           prefilter_drop                (prefilter.py)
//   conntrack           ct_fetch_rows, ct_probe_rows  (ct/device.py)
//   load balancer       lb_select_batch               (lb/device.py)
//   ipcache             ipcache_lookup_fused,         (ipcache/lpm.py)
//                       _lookup_kernel (generic form)
//   identity branch     _datapath_core :432-480       (engine/datapath.py)
//   lattice + combine   _probes, _index_identity,     (engine/verdict.py)
//                       _combine
//   counters            _counter_cols + the scatter-add (pair, forms)
//   telemetry           telemetry_masks + the per-direction sums
//   tunnel              tunnel_select, in overlay mode  (tunnel.py)
// over either entry layout: compact (2-word L4 entries, 4-word CT rows,
// sub-word ipcache planes) or wide (3-word L4 entries, 5-word 128-lane
// CT rows, u32 ipcache planes); and over every table layout the agent's
// builders pick (common.cuh): the range or DIR-24-8 prefilter, the
// inline or classic LB, the idx ipcache with or without L3 planes (past
// 32 endpoints probe 2 reads l3_allow_bits), or the generic one (raw
// identities, DIR-24-8 past 512 ranges: a miss is WORLD, the index comes
// from id_direct, sec_id is the identity in every form); its ranges by
// hashed classes or by the [B, P] scan.  Each kernel is a template over
// the three plane layouts, instantiated 12 times (launch_pair/step pick
// one by DatapathArgs.layout); the range lookup is a runtime branch, taken
// only on an exact miss.
//
// Shape of the single-batch step: one thread per flow, a grid of
// ceil(B / 256) blocks (the step's blocks stage the [B, P] ranges and the
// stashes as the pair kernel's do; the memo mode's passes run a block a
// unit of 256 flows of one half, as the pair kernel); each flow
// takes its own direction word (or the static one of a per-direction
// form): an ingress flow (direction 0) runs no LB, any other word goes
// through the service probe and LB; its telemetry block sums both rows.  The CT probe
// direction, the lattice direction and the counter row use each flow's
// own direction.  With a tunnel map (overlay mode, tun_base not null) an
// allowed flow that is not ingress (the egress half; a step flow whose
// direction is not 0) scans the map's ranges for its post-DNAT
// destination's node (tunnel.cuh); without one the column is 0 and the
// stage costs a null test.
//
// What bounds it on an H100: random row reads.  Per flow, at the config-5
// compact layouts (the wide ones read about twice the bytes), a flow
// reads one 256-byte CT row, one 256-byte ipcache row, up to three
// 136-byte range-class rows (only on an exact miss), two 128-byte L4
// rows, on egress part of one 512-byte LB row, and one l4_meta word:
// about 1 KB gathered from tables of tens of megabytes, of which 16 B of
// flow input and 39 B of output are streamed (the step kernel streams a
// 4 B pick and 39 B of output, and gathers its flow's 32 B of words from
// the pool, 1.6 MB at config 5).  The tables mostly fit the 50 MB L2, so
// the kernel is bound by its dependent row reads, not by arithmetic:
// cutting the CT, ipcache or L4 rows out of the pair kernel saved 0.51
// to 0.62 of its 2.7 ms a super-batch, the counter atomics and the
// column stores 0.02 and 0.08 (PERF.md).  Every kernel sums every match
// (no early exit, as the reference's masked sums).  The pair kernel and
// the single-batch step run one thread a flow (a group of lanes a flow
// measured 4-10 x slower: a flow's hashes, LB and index arithmetic
// repeat on every lane) and read each key plane in 16-byte loads
// (PairReads: a compact CT or L4 row's 16 keys in four, a sub-word
// ipcache row's 32 ips in eight, a wide CT row's 25 in six and a word);
// an egress flow walks its CT row once for its service-scope and its
// own direction's probes (the memo front pass shares this).  The step
// gathers a picked flow's 32 B from the pool's row-major copy in two
// 16-byte loads (pool_rows).  A pair kernel's block takes 256
// flows of one half of one pair (a grid of resident blocks looping over
// such units measured level on config 5 and 4 % slower on the node world),
// stages the [B, P] ranges and the four stashes in shared memory (up to
// STASH_SMEM bytes), reads the flow stream and stores the columns with
// the streaming hint, counts each hit with one atomicAdd (aggregating a
// warp's hits on a column measured level) and commits its telemetry
// once; its registers are fitted to PAIR_BLOCKS_PER_SM blocks an SM
// (the step's, with the same staging, streaming and store hints, to
// STEP_BLOCKS_PER_SM).
// The node-scale layouts add, per flow: PF_LPM one l1 word from a 64 MB
// table (most of it outside L2) and on a block cell an l2 word, in place
// of a compare per listed prefix; LB_CLASSIC a 512-byte bucket row and a
// dependent backend row on a service hit; IPC_IDX one l3_allow_bits word;
// IPC_GENERIC one id_direct word, or with DIR-24-8 the two reads in place
// of the bucket row; the [B, P] scan up to 512 compares from shared
// memory on an exact miss (8-12 KB of ranges a block).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ct.cuh"
#include "ipcache.cuh"
#include "lb.cuh"
#include "prefilter.cuh"
#include "tunnel.cuh"
#include "verdict.cuh"

namespace cdp {

constexpr int BLOCK = 256;
constexpr int TELEM_COLS = 20;
// the pair and step kernels' resident blocks an SM, their registers
// fitted to them (the step also measured at 4, 5 and 8, PERF.md)
constexpr int PAIR_BLOCKS_PER_SM = 6;
constexpr int STEP_BLOCKS_PER_SM = 6;
// the memo mode's passes, likewise (the front pass measured level at 8,
// slower at 4; the back pass slower at 6; PERF.md)
constexpr int MEMO_FRONT_BLOCKS_PER_SM = 6;
constexpr int MEMO_BACK_BLOCKS_PER_SM = 8;
// the stashes a block stages at most (more: they are read where they lie)
constexpr size_t STASH_SMEM = 64 * 1024;

struct FlowOut {
  bool pre, miss, allowed, ct_create, ct_delete;
  uint32_t eff_daddr, eff_dport, idx, ident, tunnel;
  int32_t rev_nat, lb_slave, proxy;
  CTResult ct;
  Lattice v;
};

// Where a kernel reads the four stashes: their global tensors, or the
// block's copies in shared memory (stage_stashes).
struct Stashes {
  const uint32_t* ct;
  const uint32_t* ipc;
  const uint32_t* l4;
  const uint32_t* l4w;
};

__device__ __forceinline__ Stashes global_stashes(const DatapathArgs& a) {
  return Stashes{a.ct_stash, a.ipc_stash, a.l4_stash, a.l4w_stash};
}

// Stages 1-5 of one flow: prefilter, conntrack, LB, ipcache and the
// identity index.  `ingress` is the flow's side: an ingress flow runs no
// service-scope CT probe and no LB (for the pair step that is its half,
// for the single-batch step its own direction == 0; skipping the LB of
// an ingress row gives what the reference's masked LB gives it).  `dir`
// is the direction word the CT probe and the lattice read.  Writes the
// lattice's `known` and L3 bit.  PF, LB and IPC are the table layouts,
// RD how the rows are read (common.cuh).
template <int PF, int LB, int IPC, typename RD = ThreadReads>
__device__ __forceinline__ FlowOut fused_front(const DatapathArgs& a,
                                               const Stashes& st,
                                               uint32_t saddr, uint32_t daddr,
                                               uint32_t sport, uint32_t dport,
                                               uint32_t proto, uint32_t ep,
                                               uint32_t dir, bool ingress,
                                               bool* known, bool* l3_bit) {
  FlowOut o;
  // -- prefilter, then ONE conntrack row for both probes
  o.pre = prefilter_drop<PF>(a, saddr);
  const uint32_t ct_ri = ct_row_hash(daddr, saddr, dport, sport, proto) &
                         static_cast<uint32_t>(a.ct_nb - 1);
  const uint32_t* ct_row =
      a.ct_buckets + static_cast<size_t>(ct_ri) * a.ct_lanes;
  o.eff_daddr = daddr;
  o.eff_dport = dport;
  o.rev_nat = 0;
  o.lb_slave = 0;
  if (!ingress) {
    // the service-scope probe and the flow direction's, one walk: the LB
    // keeps the tuple unless it finds the service
    const CTKeys keys[2] = {
        ct_keys(daddr, saddr, dport, sport, proto, CT_DIR_SERVICE),
        ct_keys(daddr, saddr, dport, sport, proto, dir)};
    CTResult r[2];
    ct_probe_n<RD, 2>(ct_row, a.ct_lanes, a.ct_ew, st.ct, a.ct_stash_n, keys,
                      r);
    const LBResult lb =
        LB == LB_CLASSIC
            ? lb_select_classic(a, saddr, daddr, sport, dport, proto,
                                r[0].slave)
            : lb_select(a, saddr, daddr, sport, dport, proto, r[0].slave);
    o.ct = r[1];
    if (lb.found) {
      o.eff_daddr = lb.daddr;
      o.eff_dport = lb.dport;
      o.rev_nat = lb.rev_nat;
      o.lb_slave = lb.slave;
      o.ct = ct_probe<RD>(
          ct_row, a.ct_lanes, a.ct_ew, st.ct, a.ct_stash_n,
          ct_keys(o.eff_daddr, saddr, o.eff_dport, sport, proto, dir));
    }
  } else {
    const CTKeys key = ct_keys(daddr, saddr, dport, sport, proto, dir);
    ct_probe_n<RD>(ct_row, a.ct_lanes, a.ct_ew, st.ct, a.ct_stash_n, &key,
                   &o.ct);
  }

  // -- identity: the peer's ipcache entry, WORLD on a miss
  const IPCResult ipc = ipcache_lookup<IPC, RD>(
      a, ingress ? saddr : o.eff_daddr, ingress, st.ipc);
  o.miss = ipc.value == 0;
  if (IPC == IPC_GENERIC) {
    // the raw identity (sec_id in every form), indexed through id_direct
    o.ident = o.miss ? RESERVED_WORLD : ipc.value;
    o.idx = index_identity(a.id_direct, a.direct_n, a.lo_len, a.n_ids,
                           o.ident, known);
  } else {
    const uint32_t vp = o.miss ? a.world_plus1 : ipc.value;
    *known = vp != 0 && vp != UNKNOWN_IDX;
    o.idx = *known ? vp - 1 : static_cast<uint32_t>(a.n_ids - 1);
    o.ident = 0;
  }
  if (IPC == IPC_IDX_PLANES) {
    const uint32_t l3w =
        o.miss ? (ingress ? a.world_l3_in : a.world_l3_out) : ipc.l3;
    *l3_bit = ep < 32 && ((l3w >> ep) & 1u);
  } else {
    *l3_bit = l3_allow_bit(a, ep, dir, o.idx);
  }
  return o;
}

// What follows the lattice: the combine with the CT result and the
// prefilter, and in overlay mode the tunnel endpoint of an allowed flow
// that is not ingress.  `o.v` holds the lattice's verdict.
__device__ __forceinline__ void fused_back(const DatapathArgs& a, FlowOut& o,
                                           bool ingress) {
  const bool pass_ct = o.ct.result == CT_REPLY;  // RELATED is never probed
  o.allowed = !o.pre && (pass_ct || o.v.allowed);
  o.ct_delete =
      o.ct.result == CT_ESTABLISHED && !o.v.allowed && !pass_ct && !o.pre;
  o.ct_create = o.ct.result == CT_NEW && o.allowed;
  o.proxy = (o.v.allowed &&
             (o.ct.result == CT_NEW || o.ct.result == CT_ESTABLISHED) &&
             o.allowed)
                ? o.v.proxy
                : 0;
  const uint32_t dst[1] = {o.eff_daddr};
  o.tunnel = (a.tun_base && o.allowed && !ingress)
                 ? tunnel_select<1>(a.tun_base, a.tun_mask, a.tun_endpoint,
                                    a.tun_n, dst, 0u)
                 : 0u;
}

// One flow through every stage: fused_front, the lattice, fused_back.
template <int PF, int LB, int IPC, typename RD = ThreadReads>
__device__ __forceinline__ FlowOut fused_flow(const DatapathArgs& a,
                                              const Stashes& st,
                                              uint32_t saddr, uint32_t daddr,
                                              uint32_t sport, uint32_t dport,
                                              uint32_t proto, uint32_t ep,
                                              uint32_t dir, bool frag,
                                              bool ingress) {
  bool known, l3_bit;
  FlowOut o = fused_front<PF, LB, IPC, RD>(a, st, saddr, daddr, sport, dport,
                                           proto, ep, dir, ingress, &known,
                                           &l3_bit);
  L4Tables t = l4_tables(a);
  t.stash = st.l4;
  t.wstash = st.l4w;
  o.v = lattice<RD>(a, t, ep, dir, o.eff_dport, proto, o.idx, known, l3_bit,
                    frag);
  fused_back(a, o, ingress);
  return o;
}

// A column store; STREAM marks its L2 line first to go.
template <bool STREAM, typename T>
__device__ __forceinline__ void st_stream(T* p, T v) {
  if constexpr (STREAM) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// The 15 columns of one flow at offset o; STREAM stores them with the
// streaming hint, so a batch's outputs do not push the tables out of L2.
template <bool STREAM = false>
__device__ __forceinline__ void write_flow(const DatapathArgs& a, size_t o,
                                           const FlowOut& f, uint32_t sec_id) {
  st_stream<STREAM>(a.allowed + o, static_cast<uint8_t>(f.allowed));
  st_stream<STREAM>(a.proxy_port + o, f.proxy);
  st_stream<STREAM>(a.match_kind + o, static_cast<uint8_t>(f.v.kind));
  st_stream<STREAM>(a.ct_result + o, static_cast<uint8_t>(f.ct.result));
  st_stream<STREAM>(a.pre_dropped + o, static_cast<uint8_t>(f.pre));
  st_stream<STREAM>(a.sec_id + o, sec_id);
  st_stream<STREAM>(a.final_daddr + o, f.eff_daddr);
  st_stream<STREAM>(a.final_dport + o, static_cast<int32_t>(f.eff_dport));
  st_stream<STREAM>(a.rev_nat + o, f.rev_nat);
  st_stream<STREAM>(a.lb_slave + o, f.lb_slave);
  st_stream<STREAM>(a.ct_create + o, static_cast<uint8_t>(f.ct_create));
  st_stream<STREAM>(a.ct_delete + o, static_cast<uint8_t>(f.ct_delete));
  st_stream<STREAM>(a.tunnel_endpoint + o, f.tunnel);
  st_stream<STREAM>(a.l4_slot + o, f.v.j);
  st_stream<STREAM>(a.ipcache_miss + o, static_cast<uint8_t>(f.miss));
}

// Bit c set = the flow counts in telemetry column c (engine/verdict.py
// telemetry_masks, in order).
__device__ __forceinline__ uint32_t telemetry_bits(const FlowOut& f) {
  const uint32_t kind = f.v.kind;
  const bool post = !f.allowed && !f.pre;
  const bool pass_ct = f.ct.result == CT_REPLY;
  const bool m[TELEM_COLS] = {
      true,
      f.allowed,
      !f.allowed,
      f.pre,
      post && kind == MATCH_NONE,
      post && kind == MATCH_FRAG_DROP,
      kind == MATCH_L4,
      kind == MATCH_L3,
      kind == MATCH_L4_WILD,
      kind == MATCH_NONE,
      kind == MATCH_FRAG_DROP,
      f.lb_slave > 0,
      f.ct.result == CT_NEW,
      f.ct.result == CT_ESTABLISHED,
      f.ct.result == CT_REPLY,
      false,  // CT_RELATED: the datapath never probes RELATED keys
      pass_ct && !f.v.allowed && !f.pre,
      f.ct_delete,
      f.miss,
      f.proxy > 0 && f.allowed,
  };
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < TELEM_COLS; ++c) bits |= m[c] ? (1u << c) : 0u;
  return bits;
}

// The single-batch step's telemetry epilogue, called by every thread of
// the block (its flows may fall in either row): warp ballots per row, a
// block sum in shared memory, then one atomicAdd per block, row and
// column.  `row` is the flow's telemetry row (0 ingress,
// 1 egress); `bits` is 0 for a thread past the batch.
__device__ __forceinline__ void telemetry_rows_epilogue(uint32_t* telem,
                                                   uint32_t bits, int row) {
  __shared__ uint32_t s_rows[2 * TELEM_COLS];
  if (threadIdx.x < 2 * TELEM_COLS) s_rows[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < TELEM_COLS; ++c) {
    const bool on = (bits >> c) & 1u;
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

// The memo mode's front pass (memo 1) of one pair flow: stages 1-5 over
// the block's stashes `st` (PairReads), its half's packed4 words at `p`
// read with the streaming hint, the columns that do not depend on the
// lattice and the three policy-key words of the verdict memo
// (engine/memo.py memo_key_words: k0 the index, k1 dport << 16 | proto
// << 8 | known << 1 | the L3 bit where the ipcache carries one, k2 ep << 1
// | dir) stored likewise.
template <int PF, int LB, int IPC>
__device__ __forceinline__ void memo_front_flow(const DatapathArgs& a,
                                                const Stashes& st,
                                                const uint32_t* p, int half,
                                                int i, bool ingress) {
  const uint32_t saddr = __ldcs(p + i);
  const uint32_t daddr = __ldcs(p + a.B + i);
  const uint32_t w2 = __ldcs(p + 2 * a.B + i);
  const uint32_t w3 = __ldcs(p + 3 * a.B + i);
  const uint32_t ep = w3 >> 16;
  const uint32_t dir = (w3 >> 1) & 1u;
  const uint32_t proto = (w3 >> 8) & 0xFFu;
  bool known, l3_bit;
  const FlowOut f = fused_front<PF, LB, IPC, PairReads>(
      a, st, saddr, daddr, w2 >> 16, w2 & 0xFFFFu, proto, ep, dir, ingress,
      &known, &l3_bit);
  const size_t o = static_cast<size_t>(half) * a.B + i;
  __stcs(a.ct_result + o, static_cast<uint8_t>(f.ct.result));
  __stcs(a.pre_dropped + o, static_cast<uint8_t>(f.pre));
  __stcs(a.sec_id + o, IPC == IPC_GENERIC ? f.ident : f.idx);
  __stcs(a.final_daddr + o, f.eff_daddr);
  __stcs(a.final_dport + o, static_cast<int32_t>(f.eff_dport));
  __stcs(a.rev_nat + o, f.rev_nat);
  __stcs(a.lb_slave + o, f.lb_slave);
  __stcs(a.ipcache_miss + o, static_cast<uint8_t>(f.miss));
  const size_t b = static_cast<size_t>(a.B);
  uint32_t* k = a.memo_keys + static_cast<size_t>(half) * 3 * b + i;
  __stcs(k, f.idx);
  __stcs(k + b, (clip_u(static_cast<int32_t>(f.eff_dport), 65535) << 16) |
                    (proto << 8) | (known ? 2u : 0u) |
                    (IPC == IPC_IDX_PLANES && l3_bit ? 1u : 0u));
  __stcs(k + 2 * b, (ep << 1) | dir);
}

// One flow of a pair step: its half's packed4 words at `p` (the [4, B]
// half, read with the streaming hint), its outputs at flat offset `o`
// (stored likewise).  Returns its telemetry bits and the counter cell
// its lattice hit counts in (-1: none).
struct PairFlow {
  uint32_t tmask;
  int64_t cell;
};

template <int PF, int LB, int IPC>
__device__ __forceinline__ PairFlow pair_flow(const DatapathArgs& a,
                                              const Stashes& st,
                                              const uint32_t* p, size_t o,
                                              int i, bool ingress) {
  // -- packed4 unpack
  const uint32_t saddr = __ldcs(p + i);
  const uint32_t daddr = __ldcs(p + a.B + i);
  const uint32_t w2 = __ldcs(p + 2 * a.B + i);
  const uint32_t w3 = __ldcs(p + 3 * a.B + i);
  const uint32_t ep = w3 >> 16;
  const uint32_t dir = (w3 >> 1) & 1u;
  const FlowOut f = fused_flow<PF, LB, IPC, PairReads>(
      a, st, saddr, daddr, w2 >> 16, w2 & 0xFFFFu, (w3 >> 8) & 0xFFu, ep, dir,
      (w3 & 1u) != 0, ingress);

  // -- counters: L4 hits at slot j, L3 hits at column kg + idx; an
  // out-of-range index drops its update, as an XLA scatter does
  PairFlow r{telemetry_bits(f), -1};
  const uint32_t kind = f.v.kind;
  const bool hit_l4 = kind == MATCH_L4 || kind == MATCH_L4_WILD;
  if (hit_l4 || kind == MATCH_L3) {
    const int cols = a.kg + a.n_ids;
    const int col = hit_l4 ? f.v.j : a.kg + static_cast<int32_t>(f.idx);
    if (ep < static_cast<uint32_t>(a.n_eps) && col >= 0 && col < cols)
      r.cell = (static_cast<int64_t>(ep) * 2 + dir) * cols + col;
  }

  // -- outputs: sec_id is the raw lattice index in the pair form (the
  // identity in the generic form)
  write_flow<true>(a, o, f, IPC == IPC_GENERIC ? f.ident : f.idx);
  return r;
}

// Stage the four stashes into the block's shared memory, after the
// ranges of the [B, P] scan (stage_ranges), where they fit STASH_SMEM
// bytes (pair_smem_bytes); returns where the block reads them.
__host__ __device__ inline int stash_words(const DatapathArgs& a) {
  return 5 * a.ct_stash_n + a.ipc_stash_w * a.ipc_stash_n +
         a.l4_ew * (a.l4_stash_n + a.l4w_stash_n);
}

__host__ __device__ inline bool stashes_staged(const DatapathArgs& a) {
  return static_cast<size_t>(stash_words(a)) * 4 <= STASH_SMEM;
}

inline size_t pair_smem_bytes(const DatapathArgs& a) {
  return scan_smem_bytes(a) +
         (stashes_staged(a) ? static_cast<size_t>(stash_words(a)) * 4 : 0);
}

__device__ __forceinline__ const uint32_t* stage_words(const uint32_t* src,
                                                       int n, uint32_t* dst) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
  return dst;
}

// Every thread of the block calls it (after stage_ranges).
__device__ __forceinline__ Stashes stage_stashes(const DatapathArgs& a) {
  if (!stashes_staged(a)) return global_stashes(a);
  uint32_t* w = s_ranges + scan_smem_bytes(a) / 4;
  Stashes st;
  const int n_ct = 5 * a.ct_stash_n, n_ipc = a.ipc_stash_w * a.ipc_stash_n;
  const int n_l4 = a.l4_ew * a.l4_stash_n, n_l4w = a.l4_ew * a.l4w_stash_n;
  st.ct = stage_words(a.ct_stash, n_ct, w);
  st.ipc = stage_words(a.ipc_stash, n_ipc, w + n_ct);
  st.l4 = stage_words(a.l4_stash, n_l4, w + n_ct + n_ipc);
  st.l4w = stage_words(a.l4w_stash, n_l4w, w + n_ct + n_ipc + n_l4);
  __syncthreads();
  return st;
}

// The memo mode's front pass (memo 1): no lattice, no counters, no
// telemetry.  The pair kernel's design: a block a unit of 256 flows of
// one half (units half by half), the [B, P] ranges and the stashes staged
// in shared memory (stage_stashes, pair_smem_bytes), the key planes in
// 16-byte loads, the stream read and the columns and key words stored
// with the streaming hints, registers fitted to MEMO_FRONT_BLOCKS_PER_SM
// blocks an SM, the body a grid-stride loop that runs once.
template <int PF, int LB, int IPC>
__global__ void __launch_bounds__(BLOCK, MEMO_FRONT_BLOCKS_PER_SM)
    datapath_memo_front_kernel(const __grid_constant__ DatapathArgs a) {
  stage_ranges(a);
  const Stashes st = stage_stashes(a);
  const int tiles = (a.B + BLOCK - 1) / BLOCK;
  for (int u = blockIdx.x; u < 2 * tiles; u += gridDim.x) {
    const int half = u >= tiles ? 1 : 0;
    const int i = (u - half * tiles) * BLOCK + threadIdx.x;
    if (i < a.B)
      memo_front_flow<PF, LB, IPC>(
          a, st, a.pair + static_cast<size_t>(half) * 4 * a.B, half, i,
          half == 0);
  }
}

// The pair step over K pairs in one launch: PERSISTENT_PAIR, and
// DATAPATH_PAIR as its K = 1 launch.  A unit is 256 flows of one half of
// one pair; the units run half by half, pair by pair, and the grid is
// one block a unit.  The body is a grid-stride loop over the units all
// the same, which runs once: so written, ptxas fits the flow into its 40
// registers with fewer spills than the same body written straight, and
// the kernel runs faster (PERF.md).  Pair k's columns go to [k,
// half, i] of the [K, 2, B] outputs.  Every pair's hits add into the one
// `acc` and every half's telemetry into the one `telem`: the pair body
// only adds to them (atomics, never a read), and integer adds commute,
// so K pairs at once give lax.scan's carry bit for bit.  The telemetry
// is a ballot per column into lane c's register, summed per block in
// shared memory and committed once.
template <int PF, int LB, int IPC>
__global__ void __launch_bounds__(BLOCK, PAIR_BLOCKS_PER_SM)
    datapath_persistent_kernel(const __grid_constant__ DatapathArgs a,
                               int k_pairs) {
  __shared__ uint32_t s_tel[2 * TELEM_COLS];
  if (threadIdx.x < 2 * TELEM_COLS) s_tel[threadIdx.x] = 0;
  stage_ranges(a);
  const Stashes st = stage_stashes(a);
  __syncthreads();
  const int tiles = (a.B + BLOCK - 1) / BLOCK;
  const int per_half = k_pairs * tiles;
  const int units = 2 * per_half;
  const int lane = threadIdx.x & 31;
  uint32_t tel = 0;  // lane c < TELEM_COLS: column c of half `cur`
  int cur = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int half = u >= per_half ? 1 : 0;
    if (half != cur) {
      if (lane < TELEM_COLS && tel)
        atomicAdd(&s_tel[cur * TELEM_COLS + lane], tel);
      tel = 0;
      cur = half;
    }
    const int r = u - half * per_half;
    const int k = r / tiles;
    const int i = (r - k * tiles) * BLOCK + threadIdx.x;
    const size_t ph = static_cast<size_t>(k) * 2 + half;
    PairFlow f{0u, -1};
    if (i < a.B)
      f = pair_flow<PF, LB, IPC>(a, st, a.pair + ph * 4 * a.B, ph * a.B + i,
                                 i, half == 0);
    if (f.cell >= 0) atomicAdd(a.acc + f.cell, 1u);
    const uint32_t tmask = f.tmask;
#pragma unroll
    for (int c = 0; c < TELEM_COLS; ++c) {
      const uint32_t b = __ballot_sync(0xFFFFFFFFu, (tmask >> c) & 1u);
      if (lane == c) tel += static_cast<uint32_t>(__popc(b));
    }
  }
  if (lane < TELEM_COLS && tel) atomicAdd(&s_tel[cur * TELEM_COLS + lane], tel);
  __syncthreads();
  if (threadIdx.x < 2 * TELEM_COLS && s_tel[threadIdx.x])
    atomicAdd(a.telem + threadIdx.x, s_tel[threadIdx.x]);
}

// The memo mode's back pass: the lattice-free columns the front pass
// wrote, the policy-key words and the memo's value words (v0 = j << 16 |
// proxy, v1 = the three probe bits, engine/memo.py pack_value_words) in
// place of the lattice, then the combine, fused_back, the counters and
// the telemetry, both skipped when the memo's summed stats show an
// overflow (the reference commits its carried state only then).  About
// 50 B a flow streamed in and out, read and stored with the streaming
// hints; a block a unit of 256 flows of one half (the grid is one block
// a unit); the counter hits aggregated a block (common.cuh cell_add: on
// a Zipf pair the hottest rows all count in one cell, whose atomics a
// hit serialise in the L2); the telemetry a ballot per column into lane
// c's register, summed per block in shared memory and committed once.
__global__ void __launch_bounds__(BLOCK, MEMO_BACK_BLOCKS_PER_SM)
    datapath_pair_memo_back_kernel(const __grid_constant__ DatapathArgs a) {
  __shared__ uint32_t s_tel[TELEM_COLS];
  __shared__ CellTable cells;
  if (threadIdx.x < TELEM_COLS) s_tel[threadIdx.x] = 0;
  cell_init(cells);
  const bool ok = __ldg(a.memo_stats + 3) == 0;  // STAT_OVERFLOW
  const size_t b = static_cast<size_t>(a.B);
  const int tiles = (a.B + BLOCK - 1) / BLOCK;
  const int half = static_cast<int>(blockIdx.x) >= tiles ? 1 : 0;
  const int i = (blockIdx.x - half * tiles) * BLOCK + threadIdx.x;
  uint32_t tmask = 0;
  int64_t cell = -1;
  if (i < a.B) {
    const size_t o = static_cast<size_t>(half) * b + i;
    const uint32_t* k = a.memo_keys + static_cast<size_t>(half) * 3 * b + i;
    const uint32_t* v = a.memo_vals + static_cast<size_t>(half) * 2 * b + i;
    const uint32_t idx = __ldcs(k), k2 = __ldcs(k + 2 * b);
    const uint32_t ep = k2 >> 1, dir = k2 & 1u;
    const uint32_t v0 = __ldcs(v), v1 = __ldcs(v + b);
    const bool frag =
        (__ldcs(a.pair + static_cast<size_t>(half) * 4 * b + 3 * b + i) &
         1u) != 0;
    FlowOut f;
    f.pre = __ldcs(a.pre_dropped + o) != 0;
    f.miss = __ldcs(a.ipcache_miss + o) != 0;
    f.ct.result = __ldcs(a.ct_result + o);
    f.eff_daddr = __ldcs(a.final_daddr + o);
    f.lb_slave = __ldcs(a.lb_slave + o);
    f.idx = idx;
    f.v = combine((v1 & 1u) != 0, (v1 & 2u) != 0, (v1 & 4u) != 0,
                  static_cast<int32_t>(v0 & 0xFFFFu),
                  static_cast<int32_t>(v0 >> 16), frag);
    fused_back(a, f, half == 0);
    const uint32_t kind = f.v.kind;
    const bool hit_l4 = kind == MATCH_L4 || kind == MATCH_L4_WILD;
    if (ok && (hit_l4 || kind == MATCH_L3)) {
      const int cols = a.kg + a.n_ids;
      const int col = hit_l4 ? f.v.j : a.kg + static_cast<int32_t>(idx);
      if (ep < static_cast<uint32_t>(a.n_eps) && col >= 0 && col < cols)
        cell = (static_cast<int64_t>(ep) * 2 + dir) * cols + col;
    }
    __stcs(a.allowed + o, static_cast<uint8_t>(f.allowed));
    __stcs(a.proxy_port + o, f.proxy);
    __stcs(a.match_kind + o, static_cast<uint8_t>(kind));
    __stcs(a.ct_create + o, static_cast<uint8_t>(f.ct_create));
    __stcs(a.ct_delete + o, static_cast<uint8_t>(f.ct_delete));
    __stcs(a.tunnel_endpoint + o, f.tunnel);
    __stcs(a.l4_slot + o, f.v.j);
    tmask = telemetry_bits(f);
  }
  cell_add(cells, a.acc, cell);
  const int lane = threadIdx.x & 31;
  uint32_t tel = 0;  // lane c < TELEM_COLS: column c of the warp's flows
#pragma unroll
  for (int c = 0; c < TELEM_COLS; ++c) {
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, (tmask >> c) & 1u);
    if (lane == c) tel = static_cast<uint32_t>(__popc(bal));
  }
  if (lane < TELEM_COLS && tel) atomicAdd(&s_tel[lane], tel);
  cell_flush(cells, a.acc);
  if (ok && threadIdx.x < TELEM_COLS && s_tel[threadIdx.x])
    atomicAdd(a.telem + half * TELEM_COLS + threadIdx.x, s_tel[threadIdx.x]);
}

// The counter scatter-add of the single-batch forms, with an XLA
// scatter's indexing: ep and dir are the flow's int32 words, the column
// slot j (an L4 hit) or kg + idx (an L3 hit); a negative index counts
// from the end of its axis, and an update still outside the buffer is
// dropped (engine/verdict.py _accumulate_counters).
__device__ __forceinline__ void count_hit(const DatapathArgs& a,
                                          const FlowOut& f, uint32_t ep_w,
                                          uint32_t dir_w) {
  const uint32_t kind = f.v.kind;
  const bool hit_l4 = kind == MATCH_L4 || kind == MATCH_L4_WILD;
  if (!hit_l4 && kind != MATCH_L3) return;
  const int64_t cols = static_cast<int64_t>(a.kg) + a.n_ids;
  int64_t e = static_cast<int32_t>(ep_w);
  int64_t d = static_cast<int32_t>(dir_w);
  int64_t c = hit_l4 ? static_cast<int64_t>(f.v.j)
                     : a.kg + static_cast<int64_t>(static_cast<int32_t>(f.idx));
  e += e < 0 ? a.n_eps : 0;
  d += d < 0 ? 2 : 0;
  c += c < 0 ? cols : 0;
  if (e < 0 || e >= a.n_eps || d < 0 || d >= 2 || c < 0 || c >= cols) return;
  atomicAdd(a.acc + (e * 2 + d) * cols + c, 1u);
}

// The single-batch step and its forms: flow i is pool[:, picks[i]] (the
// pick clamped as an XLA gather clamps its int32 index: past the pool
// the last row, negative the first) read from the row-major copy
// pool_rows [pool_n, 8], 32 B a row in two 16-byte loads; or pool[:, i],
// 8 planar words, without picks.
// The flow runs as its own direction (static_dir -1) or as the static
// one; sec_id is id_table[idx] or the raw index; with acc each lattice
// hit is counted, with telem each flow counts in its telemetry row: the
// ingress row when it runs as ingress, else the egress row (the
// reference's egress row is the column total minus the ingress row, so a
// direction word outside {0, 1} lands there).  The pair kernel's per-flow
// design: key planes in 16-byte loads (PairReads), the [B, P] ranges and
// the four stashes staged in shared memory, the picks read and the
// columns stored with the streaming hint, registers fitted to
// STEP_BLOCKS_PER_SM blocks an SM, and the body a grid-stride loop that
// runs once (grid = ceil(B / 256)), the form ptxas fits with the fewest
// spills (PERF.md, the pair kernel).
template <int PF, int LB, int IPC>
__global__ void __launch_bounds__(BLOCK, STEP_BLOCKS_PER_SM)
    datapath_step_kernel(const __grid_constant__ DatapathArgs a) {
  stage_ranges(a);
  const Stashes st = stage_stashes(a);
  const int tiles = (a.B + BLOCK - 1) / BLOCK;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = t * BLOCK + threadIdx.x;
    uint32_t tmask = 0;
    int row = 0;
    if (i < a.B) {
      uint32_t w[8];
      if (a.picks) {
        const int32_t q = static_cast<int32_t>(__ldcs(a.picks + i));
        const size_t p = q < 0 ? 0 : q < a.pool_n ? q : a.pool_n - 1;
        const uint4* r = reinterpret_cast<const uint4*>(a.pool_rows) + 2 * p;
        const uint4 lo = __ldg(r), hi = __ldg(r + 1);
        w[0] = lo.x;
        w[1] = lo.y;
        w[2] = lo.z;
        w[3] = lo.w;
        w[4] = hi.x;
        w[5] = hi.y;
        w[6] = hi.z;
        w[7] = hi.w;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          w[c] = __ldg(a.pool + static_cast<size_t>(c) * a.pool_n + i);
      }
      // FLOW_COLUMNS: ep_index saddr daddr sport dport proto direction frag
      const uint32_t dir = w[6];
      const bool ingress =
          a.static_dir < 0 ? dir == CT_DIR_INGRESS : a.static_dir == 0;
      const FlowOut f = fused_flow<PF, LB, IPC, PairReads>(
          a, st, w[1], w[2], w[3], w[4], w[5], w[0], dir, w[7] != 0, ingress);
      if (a.acc) count_hit(a, f, w[0], dir);
      write_flow<true>(a, static_cast<size_t>(i), f,
                       IPC == IPC_GENERIC ? f.ident
                       : a.emit_sec_id    ? __ldg(a.id_table + f.idx)
                                          : f.idx);
      if (a.telem) {
        tmask = telemetry_bits(f);
        row = ingress ? 0 : 1;
      }
    }
    if (a.telem) telemetry_rows_epilogue(a.telem, tmask, row);
  }
}

// One launcher per kernel and layout: LAYOUT = PF + 2 LB + 4 IPC.  The
// launchers and their tables have internal linkage: a static member of a
// class template, or a static local of a function template, is a
// process-wide unique symbol, and would make a second build of this file
// loaded into the same process (the parent commit's, for an A/B)
// launch the first one's kernels.
namespace {

template <int LAYOUT>
int launch_persistent(const DatapathArgs& a, int k, cudaStream_t stream) {
  auto kernel = datapath_persistent_kernel<LAYOUT & 1, (LAYOUT >> 1) & 1,
                                           (LAYOUT >> 2)>;
  const size_t smem = pair_smem_bytes(a);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long units = 2LL * k * ((a.B + BLOCK - 1) / BLOCK);
  if (units > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(units), BLOCK, smem, stream>>>(a, k);
  return 0;
}

// DATAPATH_PAIR: the pair step is PERSISTENT_PAIR's kernel at K = 1; the
// memo mode's front pass has its own.
template <int LAYOUT>
int launch_pair(const DatapathArgs& a, cudaStream_t stream) {
  if (a.memo == 1) {
    auto kernel = datapath_memo_front_kernel<LAYOUT & 1, (LAYOUT >> 1) & 1,
                                             (LAYOUT >> 2)>;
    const size_t smem = pair_smem_bytes(a);
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    kernel<<<2 * ((a.B + BLOCK - 1) / BLOCK), BLOCK, smem, stream>>>(a);
    return 0;
  }
  return launch_persistent<LAYOUT>(a, 1, stream);
}

template <int LAYOUT>
int launch_step(const DatapathArgs& a, cudaStream_t stream) {
  auto kernel =
      datapath_step_kernel<LAYOUT & 1, (LAYOUT >> 1) & 1, (LAYOUT >> 2)>;
  const size_t smem = pair_smem_bytes(a);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  kernel<<<(a.B + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(a);
  return 0;
}

using Launcher = int (*)(const DatapathArgs&, cudaStream_t);
using KLauncher = int (*)(const DatapathArgs&, int, cudaStream_t);

template <int... L>
struct Launchers {
  static constexpr Launcher pair[sizeof...(L)] = {launch_pair<L>...};
  static constexpr Launcher step[sizeof...(L)] = {launch_step<L>...};
  static constexpr KLauncher persistent[sizeof...(L)] = {
      launch_persistent<L>...};
};
using AllLayouts = Launchers<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11>;
static_assert(N_LAYOUTS == 12, "one launcher per layout");

}  // namespace

}  // namespace cdp

extern "C" int datapath_args_size() {
  return static_cast<int>(sizeof(cdp::DatapathArgs));
}

// Launch one pair step on `stream`; returns cudaGetLastError() (an
// unknown layout: cudaErrorInvalidValue).
// (memo 2, the memo mode's back pass, reads no table layout.)
extern "C" int launch_datapath_pair(const cdp::DatapathArgs* args,
                                    void* stream) {
  if (args->layout < 0 || args->layout >= cdp::N_LAYOUTS ||
      args->memo < 0 || args->memo > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (args->B > 0 && args->memo == 2) {
    cdp::datapath_pair_memo_back_kernel<<<
        2 * ((args->B + cdp::BLOCK - 1) / cdp::BLOCK), cdp::BLOCK, 0,
        static_cast<cudaStream_t>(stream)>>>(*args);
  } else if (args->B > 0) {
    err = cdp::AllLayouts::pair[args->layout](
        *args, static_cast<cudaStream_t>(stream));
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// Launch PERSISTENT_PAIR over `k` pairs (args->pair is [k, 2, 4, B], the
// columns [k, 2, B]) on `stream`; returns cudaGetLastError() (an unknown
// layout, the memo mode or k outside [1, 65535]: cudaErrorInvalidValue).
extern "C" int launch_datapath_persistent(const cdp::DatapathArgs* args,
                                          int k, void* stream) {
  if (args->layout < 0 || args->layout >= cdp::N_LAYOUTS ||
      args->memo != 0 || k < 1 || k > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (args->B > 0)
    err = cdp::AllLayouts::persistent[args->layout](
        *args, k, static_cast<cudaStream_t>(stream));
  return err ? err : static_cast<int>(cudaGetLastError());
}

// Launch one single-batch step on `stream`; returns cudaGetLastError().
extern "C" int launch_datapath_step(const cdp::DatapathArgs* args,
                                    void* stream) {
  if (args->layout < 0 || args->layout >= cdp::N_LAYOUTS)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (args->B > 0)
    err = cdp::AllLayouts::step[args->layout](
        *args, static_cast<cudaStream_t>(stream));
  return err ? err : static_cast<int>(cudaGetLastError());
}
