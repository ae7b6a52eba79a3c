// The fused IPv6 datapath, one CUDA kernel for Hopper (sm_90a).
//
// DATAPATH6 replaces the JAX package's jitted device program
// `datapath6_step` (cilium_tpu/engine/datapath6.py:452
// `_datapath6_kernel`, K15, the reference's ipv6_policy), with its
// stages and the v6 half of the tunnel stage (cilium_tpu/tunnel.py:310,
// K11).  One thread per flow runs, in order:
//   prefilter6      the source against the prefilter6 ranges
//   service CT6     ct6_probe at service scope on the original tuple,
//                   when a v6 LB table is present      (ct6.cuh)
//   LB6 + DNAT      lb6_select, applied when the flow's direction is
//                   not 0 (the program treats every other word as
//                   egress)                            (lb6.cuh)
//   CT6             ct6_probe on the post-DNAT tuple   (ct6.cuh)
//   ipcache6        the exact bucket row, the stash, the longest matching
//                   range, of the source on ingress and of the post-DNAT
//                   destination otherwise              (ipcache6.cuh)
//   sec_id          RESERVED_WORLD when ipcache6 finds nothing
//   lattice         tuple_verdict<PairReads>: _index_identity and the
//                   hashed or dense probes and combine, the hashed key
//                   planes in 16-byte loads            (verdict.cuh)
//   combine         with conntrack: REPLY passes, ESTABLISHED flows that
//                   policy now denies are deleted, NEW allowed flows
//                   created
//   tunnel6         with a tunnel map, the largest endpoint among the v6
//                   ranges that hold the post-DNAT destination of an
//                   allowed flow that is not ingress
// and writes the 13 Datapath6Verdicts columns.
//
// What bounds it on an H100: dependent reads.  A flow streams 53 B of
// columns in (two 16 B addresses and six words, a fragment byte) and
// writes 46 B; it reads part of a 512 B CT6 row (two on a non-ingress flow
// of a node with services, the service probe's and the flow's), part of a
// 512 B ipcache6 row, on a non-ingress flow an LB6 row's keys, an
// id_direct word, two hashed L4 rows and an l3_allow_bits word, and scans
// the broadcast lists (prefilter6, on a miss the ipcache6 ranges, with a
// map the tunnel's).  Config 6's tables are about 17 MB and fit the 50 MB
// L2, so the kernel is bound by L2 sector traffic of dependent gathers
// and by the instructions of the list scans, not by arithmetic.
//
// The design (the first version walked every lane and every stash row
// word by word through 4-byte loads, and each range through 8 of them; on
// config 6 it took 0.5087 device ms per 1,048,576 flows, 0.7150 with the
// 256-node tunnel map; PERF.md §5):
//   * row walks: a row's first key plane in the 16-byte words that cover
//     it, the later planes one word a lane still matching, in an order in
//     which a miss dies after the first plane (row6.cuh, ct6.cuh,
//     ipcache6.cuh); the LB6 slot keys as a 16-byte word and one word;
//   * staged in shared memory once a block where they fit (Stage6; the
//     launcher lays them out): the ipcache6 stash without its all-ones
//     rows, which become a count and a value sum (config 6's 128 stash
//     rows are all empty: walking them was 24 % of the first version's
//     time); the tunnel map with an index (TunnelIndex6) by which a
//     lookup walks one chain of ranges in place of all 256 (the scan was
//     29 % of the first version's tunnel runs).  The CT6 stash (one entry
//     in config 6) and the ipcache6 ranges (read after an exact miss
//     only) are read where they lie: staged, they measured slower.  The
//     prefilter6 ranges are read where they lie too, as 16-byte base and
//     mask words: staged, they gained 0.75 %, within the spread between
//     turns;
//   * the flow columns read and the outputs written with the streaming
//     hints; MIN_BLOCKS6 blocks an SM (64 registers; 5, 6 and 8 blocks
//     measured slower).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ct.cuh"
#include "ct6.cuh"
#include "ipcache6.cuh"
#include "lb6.cuh"
#include "row6.cuh"
#include "verdict.cuh"

namespace cdp {

constexpr int BLOCK6 = 256;
constexpr int MIN_BLOCKS6 = 4;
// shared memory a block may stage (below the 48 KB a launch takes without
// an attribute); a table past what is left is read where it lies
constexpr int STAGE6_BYTES = 40 * 1024;

// The field order is the ctypes Structure's order in kernels.py;
// datapath6_struct_sizes() lets the wrapper check that the two agree.
struct Datapath6Args {
  // flows, [B] columns; the addresses [B, 4] u32 limbs
  const int32_t* ep_index;
  const uint32_t* saddr;
  const uint32_t* daddr;
  const int32_t* sport;
  const int32_t* dport;
  const int32_t* proto;
  const int32_t* direction;
  const uint8_t* is_fragment;
  // prefilter6 ranges [pf_n, 4]
  const uint32_t* pf_base;
  const uint32_t* pf_mask;
  // tunnel6 ranges [tun_n, 4] and endpoints; tun_base null = no map
  const uint32_t* tun_base;
  const uint32_t* tun_mask;
  const uint32_t* tun_endpoint;
  IPCache6Table ipc;
  CT6Table ct;
  LB6Table lb;  // rows null = no v6 services
  PolicyView pol;
  // outputs [B] (final_daddr [B, 4])
  uint8_t* allowed;
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint8_t* ct_result;
  uint8_t* pre_dropped;
  uint32_t* sec_id;
  uint8_t* ct_create;
  uint8_t* ct_delete;
  uint32_t* tunnel_endpoint;
  uint32_t* final_daddr;
  int32_t* final_dport;
  int32_t* rev_nat;
  int32_t* lb_slave;
  int32_t B;
  int32_t pf_n;
  int32_t tun_n;
};

// Where a block stages each broadcast table: a byte offset into its
// dynamic shared memory, or -1 to read the table where it lies.
struct Stage6 {
  int32_t tun;        // the tunnel index (TunnelIndex6)
  int32_t ipc_stash;  // count, ones_n, ones_sum, 0 | rows [n, 5]
  int32_t bytes;
};

// The v6 tunnel map as a block stages it: its ranges (base, mask 16-byte
// words, endpoints) and an index over them.  A range whose limb-1 mask is
// full (a /64 or longer, as a node's pod CIDR) is chained under the hash
// of its limb-1 base: an address can lie in it only if its own limb 1
// equals that base, so a lookup walks one chain.  Every other range that
// can hold some address is in the `wide` list, which every lookup walks;
// a range with base bits outside its mask (the padding) holds none and is
// left out.  The result, the largest endpoint among the ranges that hold
// the address, does not depend on the order of either walk.
struct TunnelIndex6 {
  const uint4* base;
  const uint4* mask;
  const uint32_t* endpoint;
  const int32_t* head;  // [1 << bits] first range of a chain, -1 none
  const int32_t* next;  // [n] the chain's next range, -1 none
  const int32_t* wide;  // [n_wide]
  int n;
  int n_wide;
  int bits;
};

// chains of the tunnel index: a power of two, at least twice the ranges
__host__ __device__ __forceinline__ int tunnel_hash_bits(int n) {
  int bits = 4;
  while ((1 << bits) < 2 * n) ++bits;
  return bits;
}

__device__ __forceinline__ uint32_t tunnel_hash(uint32_t limb1, int bits) {
  return (limb1 * 2654435761u) >> (32 - bits);
}

// The tables as the flows of a block read them.
struct Views6 {
  Ranges6 pf, tun, rng;
  TunnelIndex6 tix;  // head null: the map read in place, every range
  IPC6Stash ipc;
};

__device__ __forceinline__ const uint4* vec4(const uint32_t* p) {
  return reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t lanes_below() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Stage the block's tables (Stage6) and return their views; every thread
// of the block, before any returns.
__device__ __forceinline__ Views6 stage6(const Datapath6Args& a,
                                         const Stage6& S,
                                         unsigned char* smem) {
  Views6 v;
  v.pf = Ranges6{vec4(a.pf_base), vec4(a.pf_mask), nullptr, nullptr, a.pf_n};
  v.tun = Ranges6{vec4(a.tun_base), vec4(a.tun_mask), a.tun_endpoint,
                  nullptr, a.tun_n};
  v.rng = Ranges6{vec4(a.ipc.range_base), vec4(a.ipc.range_mask),
                  a.ipc.range_plen, a.ipc.range_value, a.ipc.n_ranges};
  v.ipc = IPC6Stash{a.ipc.stash, a.ipc.stash_n, 0u, 0u};
  uint32_t* ih = S.ipc_stash >= 0
                     ? reinterpret_cast<uint32_t*>(smem + S.ipc_stash)
                     : nullptr;
  // the tunnel index: base | mask | endpoint | next | wide [n] | n_wide,
  // 0, 0, 0 | head [1 << bits]
  const int tn = a.tun_n, bits = tunnel_hash_bits(tn);
  uint4* tbase = nullptr;
  int32_t* th = nullptr;
  if (S.tun >= 0) {
    tbase = reinterpret_cast<uint4*>(smem + S.tun);
    th = reinterpret_cast<int32_t*>(tbase + 2 * tn) + 3 * tn;
    for (int k = threadIdx.x; k < (1 << bits); k += blockDim.x) th[4 + k] = -1;
  }
  uint4* tmask = tbase + tn;
  uint32_t* tend = reinterpret_cast<uint32_t*>(tmask + tn);
  int32_t* next = reinterpret_cast<int32_t*>(tend + tn);
  int32_t* wide = next + tn;
  v.tix = TunnelIndex6{tbase, tmask, tend, th ? th + 4 : nullptr, next, wide,
                       tn, 0, bits};
  if (threadIdx.x < 4) {
    if (ih) ih[threadIdx.x] = 0;
    if (th) th[threadIdx.x] = 0;
  }
  __syncthreads();
  if (th) {
    for (int k = threadIdx.x; k < tn; k += blockDim.x) {
      const uint4 b = __ldg(vec4(a.tun_base) + k);
      const uint4 m = __ldg(vec4(a.tun_mask) + k);
      tbase[k] = b;
      tmask[k] = m;
      tend[k] = __ldg(a.tun_endpoint + k);
      if ((b.x & ~m.x) | (b.y & ~m.y) | (b.z & ~m.z) | (b.w & ~m.w)) continue;
      if (m.y == 0xFFFFFFFFu)
        next[k] = atomicExch(&th[4 + tunnel_hash(b.y, bits)], k);
      else
        wide[atomicAdd(th, 1)] = k;
    }
  }
  // the stashes: a warp takes 32 rows a turn and adds its counts once
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x - lane;
  if (ih) {
    uint32_t* rows = ih + 4;
    for (int k0 = warp0; k0 < a.ipc.stash_n; k0 += blockDim.x) {
      const int k = k0 + lane;
      uint32_t e[IPC6_WORDS] = {0, 0, 0, 0, 0};
      if (k < a.ipc.stash_n) {
#pragma unroll
        for (int w = 0; w < IPC6_WORDS; ++w)
          e[w] = __ldg(a.ipc.stash + static_cast<size_t>(k) * IPC6_WORDS + w);
      }
      const bool ones =
          k < a.ipc.stash_n && (e[0] & e[1] & e[2] & e[3]) == 0xFFFFFFFFu;
      const bool keep = k < a.ipc.stash_n && !ones;
      const uint32_t kb = __ballot_sync(0xFFFFFFFFu, keep);
      const uint32_t ob = __ballot_sync(0xFFFFFFFFu, ones);
      const uint32_t osum = __reduce_add_sync(0xFFFFFFFFu, ones ? e[4] : 0u);
      uint32_t at = 0;
      if (lane == 0) {
        if (kb) at = atomicAdd(ih, static_cast<uint32_t>(__popc(kb)));
        if (ob) {
          atomicAdd(ih + 1, static_cast<uint32_t>(__popc(ob)));
          atomicAdd(ih + 2, osum);
        }
      }
      at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(kb & lanes_below());
      if (keep) {
#pragma unroll
        for (int w = 0; w < IPC6_WORDS; ++w) rows[at * IPC6_WORDS + w] = e[w];
      }
    }
  }
  __syncthreads();
  if (ih) v.ipc = IPC6Stash{ih + 4, static_cast<int>(ih[0]), ih[1], ih[2]};
  if (th) v.tix.n_wide = th[0];
  return v;
}

// tunnel6 (tunnel.py tunnel_select6): the largest endpoint among the
// ranges that hold `ip`, 0 where that is the local node (0)
__device__ __forceinline__ uint32_t tunnel6(const Views6& tv,
                                            const uint32_t* ip) {
  uint32_t best = 0;
  const TunnelIndex6& x = tv.tix;
  if (x.head) {
    for (int p = x.head[tunnel_hash(ip[1], x.bits)]; p >= 0; p = x.next[p])
      if (in_range6(x.base[p], x.mask[p], ip)) best = max(best, x.endpoint[p]);
    for (int w = 0; w < x.n_wide; ++w) {
      const int p = x.wide[w];
      if (in_range6(x.base[p], x.mask[p], ip)) best = max(best, x.endpoint[p]);
    }
  } else {
    for (int p = 0; p < tv.tun.n; ++p)
      if (in_range6(tv.tun.base[p], tv.tun.mask[p], ip))
        best = max(best, tv.tun.a[p]);
  }
  return best;
}

__global__ void __launch_bounds__(BLOCK6, MIN_BLOCKS6)
    datapath6_kernel(const Datapath6Args a, const Stage6 S) {
  extern __shared__ __align__(16) unsigned char smem6[];
  const Views6 tv = stage6(a, S, smem6);
  const int i = blockIdx.x * BLOCK6 + threadIdx.x;
  if (i >= a.B) return;
  const uint4 s4 = __ldcs(reinterpret_cast<const uint4*>(a.saddr) + i);
  const uint4 d4 = __ldcs(reinterpret_cast<const uint4*>(a.daddr) + i);
  const uint32_t s[4] = {s4.x, s4.y, s4.z, s4.w};
  const uint32_t d[4] = {d4.x, d4.y, d4.z, d4.w};
  const int32_t ep = __ldcs(a.ep_index + i);
  const int32_t sport = __ldcs(a.sport + i);
  const int32_t dport = __ldcs(a.dport + i);
  const int32_t proto = __ldcs(a.proto + i);
  const int32_t dir = __ldcs(a.direction + i);
  const bool frag = __ldcs(a.is_fragment + i) != 0;
  const bool ingress = dir == 0;

  // -- prefilter6, then the v6 service DNAT on every non-ingress flow
  bool pre = false;
  for (int p = 0; p < tv.pf.n && !pre; ++p)
    pre = in_range6(tv.pf.base[p], tv.pf.mask[p], s);
  uint32_t eff[4] = {d[0], d[1], d[2], d[3]};
  int32_t eff_dport = dport, rev_nat = 0, lb_slave = 0;
  if (a.lb.rows && !ingress) {
    const CTResult svc =
        ct6_probe(a.ct, d, s, static_cast<uint32_t>(dport),
                  static_cast<uint32_t>(sport), static_cast<uint32_t>(proto),
                  static_cast<int32_t>(CT_DIR_SERVICE));
    const LB6Result lb =
        lb6_select(a.lb, s, d, static_cast<uint32_t>(sport),
                   static_cast<uint32_t>(dport), static_cast<uint32_t>(proto),
                   svc.slave);
    if (lb.found) {
#pragma unroll
      for (int k = 0; k < 4; ++k) eff[k] = lb.daddr[k];
      eff_dport = lb.dport;
      rev_nat = lb.rev_nat;
      lb_slave = lb.slave;
    }
  }

  // -- CT6 on the post-DNAT tuple, then the peer's identity
  const CTResult ct = ct6_probe(
      a.ct, eff, s, static_cast<uint32_t>(eff_dport),
      static_cast<uint32_t>(sport), static_cast<uint32_t>(proto), dir);
  uint32_t peer[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) peer[k] = ingress ? s[k] : eff[k];
  const uint32_t looked = ipcache6_lookup(a.ipc, tv.ipc, tv.rng, peer);
  const uint32_t sec = looked == 0 ? RESERVED_WORLD : looked;

  // -- the lattice, key planes in 16-byte loads
  uint32_t idx;
  const Lattice v = tuple_verdict<PairReads>(
      a.pol, ep, dir, clip_u(eff_dport, 65535), clip_u(proto, 255), sec, frag,
      &idx);
  const bool pass_ct = ct.result == CT_REPLY;  // RELATED is never probed
  const bool allowed = !pre && (pass_ct || v.allowed);
  const bool ct_delete =
      ct.result == CT_ESTABLISHED && !v.allowed && !pass_ct && !pre;
  const bool ct_create = ct.result == CT_NEW && allowed;
  const int32_t proxy =
      (v.allowed && (ct.result == CT_NEW || ct.result == CT_ESTABLISHED) &&
       allowed)
          ? v.proxy
          : 0;
  const uint32_t tunnel =
      (a.tun_base && allowed && !ingress) ? tunnel6(tv, eff) : 0u;

  __stcs(a.allowed + i, static_cast<uint8_t>(allowed));
  __stcs(a.proxy_port + i, proxy);
  __stcs(a.match_kind + i, static_cast<uint8_t>(v.kind));
  __stcs(a.ct_result + i, static_cast<uint8_t>(ct.result));
  __stcs(a.pre_dropped + i, static_cast<uint8_t>(pre));
  __stcs(a.sec_id + i, sec);
  __stcs(a.ct_create + i, static_cast<uint8_t>(ct_create));
  __stcs(a.ct_delete + i, static_cast<uint8_t>(ct_delete));
  __stcs(a.tunnel_endpoint + i, tunnel);
  __stcs(reinterpret_cast<uint4*>(a.final_daddr) + i,
         make_uint4(eff[0], eff[1], eff[2], eff[3]));
  __stcs(a.final_dport + i, eff_dport);
  __stcs(a.rev_nat + i, rev_nat);
  __stcs(a.lb_slave + i, lb_slave);
}

// Lay out what a block stages: each table in turn (the ipcache6 stash,
// the tunnel index) where it fits STAGE6_BYTES, 16-byte aligned.
Stage6 stage_layout(const Datapath6Args& a) {
  Stage6 s{-1, -1, 0};
  auto place = [&s](int32_t* at, long bytes) {
    bytes = (bytes + 15) & ~15L;
    if (s.bytes + bytes <= STAGE6_BYTES) {
      *at = s.bytes;
      s.bytes += static_cast<int32_t>(bytes);
    }
  };
  place(&s.ipc_stash, 16 + 4L * IPC6_WORDS * a.ipc.stash_n);
  if (a.tun_base)
    place(&s.tun,
          44L * a.tun_n + 16 + (4L << tunnel_hash_bits(a.tun_n)));
  return s;
}

}  // namespace cdp

extern "C" int datapath6_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cdp::L4Tables));
  out[1] = static_cast<int>(sizeof(cdp::PolicyView));
  out[2] = static_cast<int>(sizeof(cdp::IPCache6Table));
  out[3] = static_cast<int>(sizeof(cdp::CT6Table));
  out[4] = static_cast<int>(sizeof(cdp::LB6Table));
  out[5] = static_cast<int>(sizeof(cdp::Datapath6Args));
  return 6;
}

// Launch one DATAPATH6 step on `stream`; returns cudaGetLastError().
extern "C" int launch_datapath6(const cdp::Datapath6Args* args, void* stream) {
  if (args->B > 0) {
    const cdp::Stage6 s = cdp::stage_layout(*args);
    const int grid = (args->B + cdp::BLOCK6 - 1) / cdp::BLOCK6;
    cdp::datapath6_kernel<<<grid, cdp::BLOCK6, s.bytes,
                            static_cast<cudaStream_t>(stream)>>>(*args, s);
  }
  return static_cast<int>(cudaGetLastError());
}
