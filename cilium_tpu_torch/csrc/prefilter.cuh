// XDP prefilter stage (prefilter.py prefilter_drop): drop iff any
// (ip & mask) == base.  The list is a few entries; padding rows
// (mask 0, base 1) never match.  prefilter6_drop is the v6 form
// (engine/datapath6.py prefilter6_drop): ranges of 4 limbs.
#pragma once

#include "common.cuh"

namespace cdp {

__device__ __forceinline__ bool prefilter_drop(const DatapathArgs& a,
                                               uint32_t ip) {
  bool drop = false;
  for (int p = 0; p < a.pf_n; ++p)
    drop |= (ip & __ldg(a.pf_mask + p)) == __ldg(a.pf_base + p);
  return drop;
}

__device__ __forceinline__ bool prefilter6_drop(const uint32_t* base,
                                                const uint32_t* mask, int n,
                                                const uint32_t* ip) {
  bool drop = false;
  for (int p = 0; p < n; ++p) drop |= range_match<4>(base, mask, p, ip);
  return drop;
}

}  // namespace cdp
