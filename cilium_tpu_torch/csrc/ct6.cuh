// CT6 stage (engine/datapath6.py ct6_lookup_batch): one bucket row of the
// v6 conntrack, fetched by the direction-normalised hash, then the
// reverse key (REPLY) and the forward key (ESTABLISHED) compared against
// its lanes and the stash.  Rows are planar, 11 entries of 11 words (word
// k of entry e at lane 11 k + e, lanes 121-127 unused): lo limbs 0-3 |
// hi limbs 0-3 | lo_port << 16 | hi_port | proto << 8 | swapped << 7 |
// flags | rev_nat << 16 | slave; empty lanes carry 0xFFFFFFFF in the
// proto|flags word, which no probe key equals (a probe's is below 2^16),
// and 0 in the others.  The stash keeps whole 11-word entries (its
// occupied pow2 prefix).  The normalisation compares the addresses limb
// by limb, then the 16-bit ports; equal pairs never set the swapped bit.
// Direction words follow the reference: 0 probes as OUT, 1 as IN, every
// other value as SERVICE.  The value is the u32 sum over every matching
// lane, as the reference's masked sums are.
//
// The key planes are compared in the order ct6_key_plane gives: the ports
// word first (16 bits of each port, the word in which flows of one
// address pair differ and which an empty lane holds as 0), then limb 1
// and limb 3 of both addresses (where config 6's addresses differ; limb
// 0, the /32, is last).  The first plane is read in 16-byte words
// (row6.cuh), the rest one word a lane still matching, then the
// proto|flags and value planes for the lanes left; the stash entries
// likewise, where they lie (staging them in shared memory measured
// slower on config 6, whose stash is one entry).
#pragma once

#include "common.cuh"
#include "ct.cuh"
#include "row6.cuh"

namespace cdp {

constexpr int CT6_PER = 11;  // entries (and words) of a 128-lane row

// The field order is the ctypes Structure's order in kernels.py.
struct CT6Table {
  const uint32_t* buckets;  // [nb, 128]
  const uint32_t* stash;    // [stash_n, 11]
  int32_t nb;
  int32_t stash_n;
};

// key plane j of the compare order (j = 0 .. 8)
__device__ __forceinline__ constexpr int ct6_key_plane(int j) {
  return j == 0 ? 8 : j == 1 ? 1 : j == 2 ? 5 : j == 3 ? 3 : j == 4 ? 7
       : j == 5 ? 0 : j == 6 ? 4 : j == 7 ? 2 : 6;
}

__device__ __forceinline__ CTResult ct6_probe(const CT6Table& t,
                                              const uint32_t* daddr,
                                              const uint32_t* saddr,
                                              uint32_t dport, uint32_t sport,
                                              uint32_t proto, int32_t dir) {
  const uint32_t base = dir == 0 ? TUPLE_F_OUT
                        : dir == 1 ? TUPLE_F_IN
                                   : TUPLE_F_SERVICE;
  const uint32_t rev_flags = base ^ TUPLE_F_IN;
  const uint32_t dp = dport & 0xFFFFu, sp = sport & 0xFFFFu;
  bool gt = false, eq = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gt = gt || (eq && daddr[k] > saddr[k]);
    eq = eq && daddr[k] == saddr[k];
  }
  const bool sw = gt || (eq && dp > sp);
  const bool pairs_equal = eq && dp == sp;
  uint32_t key[10];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    key[k] = sw ? saddr[k] : daddr[k];
    key[4 + k] = sw ? daddr[k] : saddr[k];
  }
  key[8] = sw ? ((sp << 16) | dp) : ((dp << 16) | sp);
  key[9] = proto & 0xFFu;
  const uint32_t* row =
      t.buckets +
      static_cast<size_t>(fnv1a_n(key, 10) & static_cast<uint32_t>(t.nb - 1)) *
          128;
  const uint32_t pr = key[9] << 8;
  const uint32_t w9_fwd =
      pr | ((sw && !pairs_equal) ? SWAPPED_BIT : 0u) | base;
  const uint32_t w9_rev =
      pr | ((!sw && !pairs_equal) ? SWAPPED_BIT : 0u) | rev_flags;

  bool ff = false, rf = false;
  uint32_t fv = 0, rv = 0;
  uint32_t m = plane_hits<CT6_PER, 8>(row, key[8]);
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const int k = ct6_key_plane(j);
    if (m) m = narrow_hits(row + k * CT6_PER, m, key[k]);
  }
  for (uint32_t r = m; r; r &= r - 1) {
    const int e = __ffs(r) - 1;
    const uint32_t w9 = __ldg(row + 9 * CT6_PER + e);
    const uint32_t val = __ldg(row + 10 * CT6_PER + e);
    if (w9 == w9_fwd) { ff = true; fv += val; }
    if (w9 == w9_rev) { rf = true; rv += val; }
  }
  for (int s = 0; s < t.stash_n; ++s) {
    const uint32_t* e = t.stash + static_cast<size_t>(s) * CT6_PER;
    bool hit = true;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int k = ct6_key_plane(j);
      hit = hit && __ldg(e + k) == key[k];
    }
    if (hit) {
      const uint32_t w9 = __ldg(e + 9), val = __ldg(e + 10);
      if (w9 == w9_fwd) { ff = true; fv += val; }
      if (w9 == w9_rev) { rf = true; rv += val; }
    }
  }
  CTResult r;
  r.result = rf ? CT_REPLY : (ff ? CT_ESTABLISHED : CT_NEW);
  const uint32_t val = rf ? rv : fv;
  const bool hit = rf || ff;
  r.rev_nat = hit ? static_cast<int32_t>(val >> 16) : 0;
  r.slave = hit ? static_cast<int32_t>(val & 0xFFFFu) : 0;
  return r;
}

}  // namespace cdp
