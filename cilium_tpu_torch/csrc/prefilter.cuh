// XDP prefilter stage (prefilter.py prefilter_drop).  PF_RANGES: drop iff
// any (ip & mask) == base; the list is at most 128 entries, padding rows
// (mask 0, base 1) never match.  PF_LPM, a list past 128 CIDRs: drop iff
// the source's DIR-24-8 lookup is nonzero (two dependent reads, the l1
// word of a 64 MB table and for a block cell one l2 word).
// prefilter6_drop is the v6 form (engine/datapath6.py prefilter6_drop):
// ranges of 4 limbs.
#pragma once

#include "common.cuh"

namespace cdp {

template <int PF>
__device__ __forceinline__ bool prefilter_drop(const DatapathArgs& a,
                                               uint32_t ip) {
  if (PF == PF_LPM) return dir24_8(a.pf_l1, a.pf_l2, a.pf_blocks, ip) != 0;
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
