// ipcache6 stage (ipcache/lpm6.py ipcache6_lookup): the exact /128s in one
// hashed bucket row (planar, 25 entries x 5 words: limbs 0-3, value) and
// the 128-row stash, else the longest matching range (stored length
// plen + 1; 0 marks padding).  Every match is summed, as the reference's
// masked sums are: the exact value over every matching lane and stash
// row, the range value over every matching range of the best length.
// Empty lanes and stash rows are all-ones limbs with value 0, so the
// all-ones address exact-hits them and finds 0.  Returns the identity,
// 0 = miss.
//
// The limb planes are compared in the order 1, 3, 2, 0: limb 1 first
// (bits 32-63, where config 6's addresses and pods of different /48 or
// /64 subnets differ, one plane that leaves at most the key's own lanes),
// limb 3 (the interface identifier's low half), limb 2, and limb 0 (the
// /32 of the deployment, the same on every address) last.  The first
// plane is read in 16-byte words (row6.cuh), the others one word a lane
// still matching, the value plane for the lanes left.  A stash the block
// staged holds only its rows that are not all-ones; the all-ones rows
// are kept as their count and value sum (IPC6Stash), which the all-ones
// address alone matches.
#pragma once

#include "common.cuh"
#include "row6.cuh"

namespace cdp {

constexpr int IPC6_PER = 25;  // entries of a 128-lane row
constexpr int IPC6_WORDS = 5;  // a stash row: limbs 0-3, value

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

// The stash as the lookup reads it: n rows of 5 words, plus the all-ones
// rows that staging took out of them (their count and value sum).
struct IPC6Stash {
  const uint32_t* rows;
  int n;
  uint32_t ones_n;
  uint32_t ones_sum;
};

__device__ __forceinline__ bool limbs_match6(const uint32_t* e,
                                             const uint32_t* ip) {
  return e[1] == ip[1] && e[3] == ip[3] && e[2] == ip[2] && e[0] == ip[0];
}

// `rng` holds the ranges with their stored lengths (a) and values (b).
__device__ __forceinline__ uint32_t ipcache6_lookup(const IPCache6Table& t,
                                                    const IPC6Stash& st,
                                                    const Ranges6& rng,
                                                    const uint32_t* ip) {
  const uint32_t* row =
      t.buckets +
      static_cast<size_t>(fnv1a_n(ip, 4) & static_cast<uint32_t>(t.nb - 1)) *
          128;
  uint32_t m = plane_hits<IPC6_PER, 1>(row, ip[1]);
  if (m) m = narrow_hits(row + 3 * IPC6_PER, m, ip[3]);
  if (m) m = narrow_hits(row + 2 * IPC6_PER, m, ip[2]);
  if (m) m = narrow_hits(row, m, ip[0]);
  bool found = m != 0;
  uint32_t val = sum_lanes(row + 4 * IPC6_PER, m);
  for (int s = 0; s < st.n; ++s) {
    const uint32_t* e = st.rows + static_cast<size_t>(s) * IPC6_WORDS;
    if (limbs_match6(e, ip)) {
      found = true;
      val += e[4];
    }
  }
  if ((ip[0] & ip[1] & ip[2] & ip[3]) == 0xFFFFFFFFu && st.ones_n) {
    found = true;
    val += st.ones_sum;
  }
  if (found) return val;
  // ranges: the best stored length and the sum over the ranges that have it
  uint32_t best = 0, sum = 0;
  for (int p = 0; p < rng.n; ++p) {
    if (in_range6(rng.base[p], rng.mask[p], ip)) {
      const uint32_t len = rng.a[p];
      const uint32_t v = rng.b[p];
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
