// How DATAPATH6 (csrc/datapath6.cu) reads the v6 tables: the planar
// 128-lane bucket rows of CT6, ipcache6 and LB6, and the limb-masked range
// lists of prefilter6, the ipcache6 ranges and the v6 tunnel map.  Only
// the v6 stages include it; the v4 kernels keep their own row walks.
//
// A row's plane k (PER entries from lane PER k) is first read in the
// aligned 16-byte words that cover it (the row is 512 B, the words stay
// inside it), which gives the lanes whose word equals the key as a bit
// mask; every later plane is read one word a lane still set, in an order
// that lets a miss die after the first plane.  Empty lanes are read as
// any other: the masked sums of the reference stay whole.
//
// A range list is one base and one mask of 4 limbs a range, read as two
// 16-byte words; a range holds an address when every (limb & mask) ==
// base.  Padding ranges (mask 0, base limb 0 = 1) hold none.
#pragma once

#include "common.cuh"

namespace cdp {

// The lanes of plane K of a planar row (PER entries a plane) whose word
// equals `key`: bit e for lane PER K + e.
template <int PER, int K>
__device__ __forceinline__ uint32_t plane_hits(const uint32_t* row,
                                               uint32_t key) {
  constexpr int lo = PER * K, hi = lo + PER, a0 = lo & ~3;
  uint32_t m = 0;
#pragma unroll
  for (int w = a0; w < hi; w += 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + w));
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (w + q >= lo && w + q < hi && x[q] == key) m |= 1u << (w + q - lo);
  }
  return m;
}

// The lanes of `m` whose word of `plane` equals `key`, one word a lane.
__device__ __forceinline__ uint32_t narrow_hits(const uint32_t* plane,
                                                uint32_t m, uint32_t key) {
  for (uint32_t r = m; r; r &= r - 1) {
    const int e = __ffs(r) - 1;
    if (__ldg(plane + e) != key) m &= ~(1u << e);
  }
  return m;
}

// The sum of `plane`'s words over the lanes of `m` (u32, wrapping).
__device__ __forceinline__ uint32_t sum_lanes(const uint32_t* plane,
                                              uint32_t m) {
  uint32_t v = 0;
  for (uint32_t r = m; r; r &= r - 1) v += __ldg(plane + __ffs(r) - 1);
  return v;
}

// A range list: n ranges, base and mask [n] 16-byte limb words, and one
// or two words a range beside them (an endpoint; a stored length and a
// value); in shared memory where the block staged it, else in place.
struct Ranges6 {
  const uint4* base;
  const uint4* mask;
  const uint32_t* a;
  const uint32_t* b;
  int n;
};

__device__ __forceinline__ bool in_range6(const uint4& base, const uint4& mask,
                                          const uint32_t* ip) {
  return (((ip[0] & mask.x) ^ base.x) | ((ip[1] & mask.y) ^ base.y) |
          ((ip[2] & mask.z) ^ base.z) | ((ip[3] & mask.w) ^ base.w)) == 0;
}

}  // namespace cdp
