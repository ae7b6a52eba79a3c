// Conntrack stage (ct/device.py ct_fetch_rows + ct_probe_rows) over
// either bucket-row layout, planar (word k of entry i at lane k * E + i):
//   wide, 5 words (JAX ct/device.py:659-767): lo addr | hi addr | ports |
//     w3 = proto << 8 | swapped << 7 | flags | w4 = rev_nat << 16 | slave,
//     25 entries per 128-lane row (lanes 125-127 unused), empty lanes
//     w3 = 0xFFFFFFFF, which no probe key equals;
//   compact, 4 words: lo addr | hi addr | ports |
//     w3c = state16 << 16 | rev_nat8 << 8 | slave8, 16 entries per 64
//     lanes, empty lanes state16 = 0xFFFF;
// plus the 5-word stash (its pow2 prefix, one row or more).  Every
// matching lane is summed, as the reference's masked sums are; the probe
// never stops at a first hit.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr uint32_t CT_NEW = 0, CT_ESTABLISHED = 1, CT_REPLY = 2;
constexpr uint32_t CT_DIR_INGRESS = 0, CT_DIR_EGRESS = 1, CT_DIR_SERVICE = 2;
constexpr uint32_t TUPLE_F_OUT = 0, TUPLE_F_IN = 1, TUPLE_F_SERVICE = 4;
constexpr uint32_t SWAPPED_BIT = 1u << 7;

struct CTResult {
  uint32_t result;
  int32_t rev_nat;
  int32_t slave;
};

struct CTKey {
  uint32_t lo_a, hi_a, ports;
  bool swapped;
};

__device__ __forceinline__ CTKey ct_normalize(uint32_t daddr, uint32_t saddr,
                                              uint32_t dport, uint32_t sport) {
  dport &= 0xFFFFu;
  sport &= 0xFFFFu;
  const bool sw = daddr > saddr || (daddr == saddr && dport > sport);
  CTKey k;
  k.lo_a = sw ? saddr : daddr;
  k.hi_a = sw ? daddr : saddr;
  k.ports = sw ? ((sport << 16) | dport) : ((dport << 16) | sport);
  k.swapped = sw;
  return k;
}

// THE bucket row read: by the normalized hash of the original tuple
__device__ __forceinline__ const uint32_t* ct_fetch_row(
    const DatapathArgs& a, uint32_t daddr, uint32_t saddr, uint32_t dport,
    uint32_t sport, uint32_t proto) {
  const CTKey k = ct_normalize(daddr, saddr, dport, sport);
  const uint32_t h = fnv1a4(k.lo_a, k.hi_a, k.ports, proto & 0xFFu);
  return a.ct_buckets +
         static_cast<size_t>(h & static_cast<uint32_t>(a.ct_nb - 1)) *
             a.ct_lanes;
}

// probe a fetched row (and the stash) for one tuple and direction:
// the reverse key (REPLY) before the forward key (ESTABLISHED)
__device__ __forceinline__ CTResult ct_probe(const DatapathArgs& a,
                                             const uint32_t* row,
                                             uint32_t daddr, uint32_t saddr,
                                             uint32_t dport, uint32_t sport,
                                             uint32_t proto, uint32_t dir) {
  const uint32_t base = dir == CT_DIR_INGRESS  ? TUPLE_F_OUT
                        : dir == CT_DIR_EGRESS ? TUPLE_F_IN
                                               : TUPLE_F_SERVICE;
  const uint32_t rev_flags = base ^ TUPLE_F_IN;
  const CTKey k = ct_normalize(daddr, saddr, dport, sport);
  const bool pairs_equal =
      daddr == saddr && (dport & 0xFFFFu) == (sport & 0xFFFFu);
  const uint32_t pr = (proto & 0xFFu) << 8;
  const uint32_t w3_fwd =
      pr | ((k.swapped && !pairs_equal) ? SWAPPED_BIT : 0u) | base;
  const uint32_t w3_rev =
      pr | ((!k.swapped && !pairs_equal) ? SWAPPED_BIT : 0u) | rev_flags;

  bool ff = false, rf = false;
  uint32_t fv = 0, rv = 0;
  const bool wide = a.ct_ew == 5;
  const int ne = a.ct_lanes / a.ct_ew;
  for (int e = 0; e < ne; ++e) {
    if (__ldg(row + e) == k.lo_a && __ldg(row + ne + e) == k.hi_a &&
        __ldg(row + 2 * ne + e) == k.ports) {
      const uint32_t w3p = __ldg(row + 3 * ne + e);
      uint32_t w3, val;
      if (wide) {
        w3 = w3p;
        val = __ldg(row + 4 * ne + e);
      } else {
        w3 = w3p >> 16;
        val = (((w3p >> 8) & 0xFFu) << 16) | (w3p & 0xFFu);
      }
      if (w3 == w3_fwd) { ff = true; fv += val; }
      if (w3 == w3_rev) { rf = true; rv += val; }
    }
  }
  for (int s = 0; s < a.ct_stash_n; ++s) {
    const uint32_t* e = a.ct_stash + 5 * s;
    if (__ldg(e) == k.lo_a && __ldg(e + 1) == k.hi_a &&
        __ldg(e + 2) == k.ports) {
      const uint32_t w3 = __ldg(e + 3), val = __ldg(e + 4);
      if (w3 == w3_fwd) { ff = true; fv += val; }
      if (w3 == w3_rev) { rf = true; rv += val; }
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

// -- the row and stash halves (the routed mesh probe, csrc/datapath_mesh.cu)
// ct/device.py ct_probe_keys, ct_probe_row_parts and ct_probe_stash_parts:
// the same compares as ct_probe, split so that the row half runs on the
// shard that owns the row and the stash half once; their sums are
// ct_probe's.

struct CTKeys {
  uint32_t lo_a, hi_a, ports, w3_fwd, w3_rev;
};

struct CTParts {
  bool ff, rf;
  uint32_t fv, rv;
};

// the normalized-tuple hash of the bucket row (ct_fetch_row's)
__device__ __forceinline__ uint32_t ct_row_hash(uint32_t daddr,
                                                uint32_t saddr, uint32_t dport,
                                                uint32_t sport,
                                                uint32_t proto) {
  const CTKey k = ct_normalize(daddr, saddr, dport, sport);
  return fnv1a4(k.lo_a, k.hi_a, k.ports, proto & 0xFFu);
}

__device__ __forceinline__ CTKeys ct_keys(uint32_t daddr, uint32_t saddr,
                                          uint32_t dport, uint32_t sport,
                                          uint32_t proto, uint32_t dir) {
  const uint32_t base = dir == CT_DIR_INGRESS  ? TUPLE_F_OUT
                        : dir == CT_DIR_EGRESS ? TUPLE_F_IN
                                               : TUPLE_F_SERVICE;
  const CTKey k = ct_normalize(daddr, saddr, dport, sport);
  const bool pairs_equal =
      daddr == saddr && (dport & 0xFFFFu) == (sport & 0xFFFFu);
  const uint32_t pr = (proto & 0xFFu) << 8;
  CTKeys q;
  q.lo_a = k.lo_a;
  q.hi_a = k.hi_a;
  q.ports = k.ports;
  q.w3_fwd = pr | ((k.swapped && !pairs_equal) ? SWAPPED_BIT : 0u) | base;
  q.w3_rev = pr | ((!k.swapped && !pairs_equal) ? SWAPPED_BIT : 0u) |
             (base ^ TUPLE_F_IN);
  return q;
}

// one row of `lanes` words of ew-word planar entries
__device__ __forceinline__ CTParts ct_row_parts(const uint32_t* row,
                                                int lanes, int ew,
                                                const CTKeys& k) {
  CTParts p{false, false, 0u, 0u};
  const int ne = lanes / ew;
  for (int e = 0; e < ne; ++e) {
    if (__ldg(row + e) == k.lo_a && __ldg(row + ne + e) == k.hi_a &&
        __ldg(row + 2 * ne + e) == k.ports) {
      const uint32_t w3p = __ldg(row + 3 * ne + e);
      uint32_t w3, val;
      if (ew == 5) {
        w3 = w3p;
        val = __ldg(row + 4 * ne + e);
      } else {
        w3 = w3p >> 16;
        val = (((w3p >> 8) & 0xFFu) << 16) | (w3p & 0xFFu);
      }
      if (w3 == k.w3_fwd) { p.ff = true; p.fv += val; }
      if (w3 == k.w3_rev) { p.rf = true; p.rv += val; }
    }
  }
  return p;
}

// the 5-word stash of n entries
__device__ __forceinline__ CTParts ct_stash_parts(const uint32_t* stash,
                                                  int n, const CTKeys& k) {
  CTParts p{false, false, 0u, 0u};
  for (int s = 0; s < n; ++s) {
    const uint32_t* e = stash + 5 * s;
    if (__ldg(e) == k.lo_a && __ldg(e + 1) == k.hi_a &&
        __ldg(e + 2) == k.ports) {
      const uint32_t w3 = __ldg(e + 3), val = __ldg(e + 4);
      if (w3 == k.w3_fwd) { p.ff = true; p.fv += val; }
      if (w3 == k.w3_rev) { p.rf = true; p.rv += val; }
    }
  }
  return p;
}

// ct_probe_combine of summed parts (no RELATED probe)
__device__ __forceinline__ CTResult ct_combine(bool ff, bool rf, uint32_t fv,
                                               uint32_t rv) {
  CTResult r;
  r.result = rf ? CT_REPLY : (ff ? CT_ESTABLISHED : CT_NEW);
  const uint32_t val = rf ? rv : fv;
  const bool hit = rf || ff;
  r.rev_nat = hit ? static_cast<int32_t>(val >> 16) : 0;
  r.slave = hit ? static_cast<int32_t>(val & 0xFFFFu) : 0;
  return r;
}

}  // namespace cdp
