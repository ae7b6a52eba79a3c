// LB6 stage (lb/device6.py lb6_select_batch, inline layout): the
// (vip limbs, dport << 16 | proto) probe of one 128-lane row of two
// 64-lane service slots plus the stash.  Matches are summed lane by lane,
// as the reference's masked sums are, so the slot is read through the set
// of hits.  Backend `flow_hash % count + 1` (the hash's port word is
// sport << 16 | dport with dport unmasked, the key's is masked), or the
// service-scope CT entry's slave when 0 < slave <= count; DNAT to the
// backend's limbs (limb-planar lanes 8 + 12 l + k) and port (the k & 1
// half of lane 56 + k / 2).  A backend index past the slot reads 0.  A
// slot's key (lanes 0-4 of its 64) is read as a 16-byte word and one
// word, the fifth only where the first four match.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr int LB6_SLOT = 64;
constexpr int LB6_MAX_BACKENDS = 12;

// The field order is the ctypes Structure's order in kernels.py.
struct LB6Table {
  const uint32_t* rows;   // [nb, 128]; null = no v6 services
  const uint32_t* stash;  // [stash_n, 64]
  int32_t nb;
  int32_t stash_n;
};

struct LB6Result {
  bool found;
  int32_t slave;
  uint32_t daddr[4];
  int32_t dport;
  int32_t rev_nat;
};

// one lane of the summed slot: every matching row half (bits 0, 1 of
// hits) and stash slot (bits 2 on)
__device__ __forceinline__ uint32_t lb6_lane(const LB6Table& t,
                                             const uint32_t* row,
                                             uint32_t hits, int lane) {
  uint32_t v = 0;
  for (int h = 0; h < 2; ++h)
    if (hits & (1u << h)) v += __ldg(row + h * LB6_SLOT + lane);
  for (int s = 0; s < t.stash_n; ++s)
    if (hits & (4u << s)) v += __ldg(t.stash + s * LB6_SLOT + lane);
  return v;
}

// whether a slot's key lanes hold `key` (a slot is 256 B: 16-byte aligned)
__device__ __forceinline__ bool lb6_key_is(const uint32_t* slot,
                                           const uint32_t* key) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(slot));
  return v.x == key[0] && v.y == key[1] && v.z == key[2] && v.w == key[3] &&
         __ldg(slot + 4) == key[4];
}

__device__ __forceinline__ LB6Result lb6_select(const LB6Table& t,
                                                const uint32_t* saddr,
                                                const uint32_t* daddr,
                                                uint32_t sport, uint32_t dport,
                                                uint32_t proto,
                                                int32_t ct_slave) {
  uint32_t key[5] = {daddr[0], daddr[1], daddr[2], daddr[3],
                     ((dport & 0xFFFFu) << 16) | (proto & 0xFFu)};
  const uint32_t* row =
      t.rows +
      static_cast<size_t>(fnv1a_n(key, 5) & static_cast<uint32_t>(t.nb - 1)) *
          128;
  uint32_t hits = 0;
  for (int h = 0; h < 2; ++h)
    hits |= lb6_key_is(row + h * LB6_SLOT, key) ? (1u << h) : 0u;
  for (int s = 0; s < t.stash_n; ++s)
    hits |= lb6_key_is(t.stash + s * LB6_SLOT, key) ? (4u << s) : 0u;
  const uint32_t meta = lb6_lane(t, row, hits, 5);
  const int32_t count = static_cast<int32_t>(meta & 0xFFFFu);
  LB6Result r;
  r.found = hits != 0 && count > 0;
  uint32_t hw[10];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hw[k] = saddr[k];
    hw[4 + k] = daddr[k];
  }
  hw[8] = (sport << 16) | dport;
  hw[9] = proto;
  const uint32_t fh = fnv1a_n(hw, 10);
  int32_t slave = static_cast<int32_t>(
                      fh % static_cast<uint32_t>(count > 1 ? count : 1)) + 1;
  if (ct_slave > 0 && ct_slave <= count) slave = ct_slave;
  const int32_t k_sel = slave - 1;
  const bool in_slot = k_sel >= 0 && k_sel < LB6_MAX_BACKENDS;
#pragma unroll
  for (int l = 0; l < 4; ++l)
    r.daddr[l] = in_slot ? lb6_lane(t, row, hits, 8 + 12 * l + k_sel) : 0u;
  const uint32_t pair = in_slot ? lb6_lane(t, row, hits, 56 + (k_sel >> 1)) : 0u;
  if (r.found) {
    r.slave = slave;
    r.dport = static_cast<int32_t>((pair >> (16 * (k_sel & 1))) & 0xFFFFu);
    r.rev_nat = static_cast<int32_t>(meta >> 16);
  } else {
    r.slave = 0;
#pragma unroll
    for (int l = 0; l < 4; ++l) r.daddr[l] = daddr[l];
    r.dport = static_cast<int32_t>(dport);
    r.rev_nat = 0;
  }
  return r;
}

}  // namespace cdp
