// ipcache6 stage (ipcache/lpm6.py ipcache6_lookup): the exact /128s in one
// hashed bucket row (planar, 25 entries x 5 words: limbs 0-3, value) and
// the 128-row stash, else the longest matching range (stored length
// plen + 1; 0 marks padding).  Every match is summed, as the reference's
// masked sums are: the exact value over every matching lane and stash
// row, the range value over every matching range of the best length.
// Empty lanes and stash rows are all-ones limbs with value 0, so the
// all-ones address exact-hits them and finds 0.  Returns the identity,
// 0 = miss.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr int IPC6_PER = 25;  // entries of a 128-lane row

// The field order is the ctypes Structure's order in kernels.py.
struct IPCache6Table {
  const uint32_t* buckets;  // [nb, 128]
  const uint32_t* stash;    // [stash_n, 5]
  const uint32_t* range_base;   // [n_ranges, 4]
  const uint32_t* range_mask;   // [n_ranges, 4]
  const uint32_t* range_plen;   // [n_ranges]
  const uint32_t* range_value;  // [n_ranges]
  int32_t nb;
  int32_t stash_n;
  int32_t n_ranges;
};

__device__ __forceinline__ uint32_t ipcache6_lookup(const IPCache6Table& t,
                                                    const uint32_t* ip) {
  const uint32_t* row =
      t.buckets +
      static_cast<size_t>(fnv1a_n(ip, 4) & static_cast<uint32_t>(t.nb - 1)) *
          128;
  bool found = false;
  uint32_t val = 0;
  for (int e = 0; e < IPC6_PER; ++e) {
    bool m = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) m = m && __ldg(row + k * IPC6_PER + e) == ip[k];
    if (m) {
      found = true;
      val += __ldg(row + 4 * IPC6_PER + e);
    }
  }
  for (int s = 0; s < t.stash_n; ++s) {
    const uint32_t* e = t.stash + static_cast<size_t>(s) * 5;
    bool m = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) m = m && __ldg(e + k) == ip[k];
    if (m) {
      found = true;
      val += __ldg(e + 4);
    }
  }
  if (found) return val;
  // ranges: the best stored length and the sum over the ranges that have it
  uint32_t best = 0, sum = 0;
  for (int p = 0; p < t.n_ranges; ++p) {
    if (range_match<4>(t.range_base, t.range_mask, p, ip)) {
      const uint32_t len = __ldg(t.range_plen + p);
      const uint32_t v = __ldg(t.range_value + p);
      if (len > best) {
        best = len;
        sum = v;
      } else if (len == best) {
        sum += v;
      }
    }
  }
  return best > 0 ? sum : 0u;
}

}  // namespace cdp
