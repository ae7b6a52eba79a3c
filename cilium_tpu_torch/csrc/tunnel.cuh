// Tunnel stage (tunnel.py tunnel_select, tunnel_select6): the overlay
// forwarding decision.  One masked-range scan serves both families: v4
// ranges are one limb (L = 1), v6 ranges four.  The result is the
// largest endpoint (u32) among the ranges the destination lies in, then
// 0 where it equals the local node's IP; 0 = direct or local.  The
// datapaths call it on an allowed flow that is not ingress, on its
// post-DNAT destination, with the local node's IP 0.
#pragma once

#include "common.cuh"

namespace cdp {

template <int L>
__device__ __forceinline__ uint32_t tunnel_select(const uint32_t* base,
                                                  const uint32_t* mask,
                                                  const uint32_t* endpoint,
                                                  int n, const uint32_t* ip,
                                                  uint32_t local_node_ip) {
  uint32_t best = 0;
  for (int p = 0; p < n; ++p) {
    if (range_match<L>(base, mask, p, ip)) {
      const uint32_t e = __ldg(endpoint + p);
      best = e > best ? e : best;
    }
  }
  return best == local_node_ip ? 0u : best;
}

}  // namespace cdp
