// The fused IPv6 datapath, one CUDA kernel for Hopper (sm_90a).
//
// DATAPATH6 replaces the JAX package's jitted device program
// `datapath6_step` (cilium_tpu/engine/datapath6.py:452
// `_datapath6_kernel`, K15, the reference's ipv6_policy), with its
// stages and the v6 half of the tunnel stage (cilium_tpu/tunnel.py:310,
// K11).  One thread per flow runs, in order:
//   prefilter6      prefilter6_drop on the source     (prefilter.cuh)
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
//   lattice         tuple_verdict: _index_identity and the hashed or
//                   dense probes and combine, the code LATTICE runs
//                                                      (verdict.cuh)
//   combine         with conntrack: REPLY passes, ESTABLISHED flows that
//                   policy now denies are deleted, NEW allowed flows
//                   created
//   tunnel6         with a tunnel map, the node of an allowed flow that
//                   is not ingress, on its post-DNAT destination
//                                                      (tunnel.cuh)
// and writes the 13 Datapath6Verdicts columns.
//
// What bounds it on an H100: dependent reads.  A flow streams 53 B of
// columns in (two 16 B addresses and six words, a fragment byte) and
// writes 46 B; it then reads a 512 B CT6 row (two on a non-ingress flow
// of a node with services, the service probe's and the flow's), a 512 B
// ipcache6 row, on a non-ingress flow a 512 B LB6 row, an id_direct
// word, two hashed L4 rows and their stashes and an l3_allow_bits word,
// plus the small broadcast tables (prefilter6, the ipcache6 ranges and
// stash, the tunnel map) that stay in L1 and L2.  Config 6's tables are
// about 20 MB and fit the 50 MB L2, so the kernel is bound by L2 sector
// traffic of dependent gathers, not by arithmetic.  This first version
// does the simple thing: every thread walks its own rows' lanes with
// read-only loads and sums every match (no early exit, as the
// reference's masked sums); staging rows through shared memory is later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ct.cuh"
#include "ct6.cuh"
#include "ipcache6.cuh"
#include "lb6.cuh"
#include "prefilter.cuh"
#include "tunnel.cuh"
#include "verdict.cuh"

namespace cdp {

constexpr int BLOCK6 = 256;

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

__global__ void __launch_bounds__(BLOCK6)
    datapath6_kernel(const Datapath6Args a) {
  const int i = blockIdx.x * BLOCK6 + threadIdx.x;
  if (i >= a.B) return;
  const uint4 s4 = __ldg(reinterpret_cast<const uint4*>(a.saddr) + i);
  const uint4 d4 = __ldg(reinterpret_cast<const uint4*>(a.daddr) + i);
  const uint32_t s[4] = {s4.x, s4.y, s4.z, s4.w};
  const uint32_t d[4] = {d4.x, d4.y, d4.z, d4.w};
  const int32_t ep = __ldg(a.ep_index + i);
  const int32_t sport = __ldg(a.sport + i);
  const int32_t dport = __ldg(a.dport + i);
  const int32_t proto = __ldg(a.proto + i);
  const int32_t dir = __ldg(a.direction + i);
  const bool frag = __ldg(a.is_fragment + i) != 0;
  const bool ingress = dir == 0;

  // -- prefilter6, then the v6 service DNAT on every non-ingress flow
  const bool pre = prefilter6_drop(a.pf_base, a.pf_mask, a.pf_n, s);
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
  const CTResult ct = ct6_probe(a.ct, eff, s, static_cast<uint32_t>(eff_dport),
                                static_cast<uint32_t>(sport),
                                static_cast<uint32_t>(proto), dir);
  uint32_t peer[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) peer[k] = ingress ? s[k] : eff[k];
  const uint32_t looked = ipcache6_lookup(a.ipc, peer);
  const uint32_t sec = looked == 0 ? RESERVED_WORLD : looked;

  // -- the shared lattice and the combine
  uint32_t idx;
  const Lattice v = tuple_verdict(a.pol, ep, dir, clip_u(eff_dport, 65535),
                                  clip_u(proto, 255), sec, frag, &idx);
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
      (a.tun_base && allowed && !ingress)
          ? tunnel_select<4>(a.tun_base, a.tun_mask, a.tun_endpoint, a.tun_n,
                             eff, 0u)
          : 0u;

  a.allowed[i] = allowed;
  a.proxy_port[i] = proxy;
  a.match_kind[i] = static_cast<uint8_t>(v.kind);
  a.ct_result[i] = static_cast<uint8_t>(ct.result);
  a.pre_dropped[i] = pre;
  a.sec_id[i] = sec;
  a.ct_create[i] = ct_create;
  a.ct_delete[i] = ct_delete;
  a.tunnel_endpoint[i] = tunnel;
  reinterpret_cast<uint4*>(a.final_daddr)[i] =
      make_uint4(eff[0], eff[1], eff[2], eff[3]);
  a.final_dport[i] = eff_dport;
  a.rev_nat[i] = rev_nat;
  a.lb_slave[i] = lb_slave;
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
    const int grid = (args->B + cdp::BLOCK6 - 1) / cdp::BLOCK6;
    cdp::datapath6_kernel<<<grid, cdp::BLOCK6, 0,
                            static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
