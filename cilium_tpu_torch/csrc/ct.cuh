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

// -- the probe, as row and stash halves: ct/device.py ct_probe_rows, and
// for the routed mesh probe (csrc/datapath_mesh.cu) ct_probe_keys,
// ct_probe_row_parts and ct_probe_stash_parts, which run the row half on
// the shard that owns the row and the stash half once; their sums are
// the probe's.  The reverse key (REPLY) wins over the forward key
// (ESTABLISHED).  RD: how the rows are read (common.cuh Reads).

struct CTKeys {
  uint32_t lo_a, hi_a, ports, w3_fwd, w3_rev;
};

struct CTParts {
  bool ff, rf;
  uint32_t fv, rv;
};

// THE bucket row: by the normalized hash of the original tuple
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

// a matching entry's flag word and value into one key's parts
__device__ __forceinline__ void ct_add(CTParts& p, const CTKeys& k,
                                       uint32_t w3, uint32_t val) {
  if (w3 == k.w3_fwd) { p.ff = true; p.fv += val; }
  if (w3 == k.w3_rev) { p.rf = true; p.rv += val; }
}

// one row of `lanes` words of ew-word planar entries against NK keys of
// one tuple (they differ in their flag words alone): the first plane (lo
// addr) walked whole, the other planes only where it matches, each key's
// parts into p[0 .. NK)
template <typename RD = ThreadReads, int NK = 1>
__device__ __forceinline__ void ct_row_parts_n(const uint32_t* row, int lanes,
                                               int ew, const CTKeys* k,
                                               CTParts* p) {
#pragma unroll
  for (int n = 0; n < NK; ++n) p[n] = CTParts{false, false, 0u, 0u};
  const int ne = lanes / ew;
  RD::keys(row, ne, [&](int e, uint32_t lo) {
    if (lo == k[0].lo_a && __ldg(row + ne + e) == k[0].hi_a &&
        __ldg(row + 2 * ne + e) == k[0].ports) {
      const uint32_t w3p = __ldg(row + 3 * ne + e);
      uint32_t w3, val;
      if (ew == 5) {
        w3 = w3p;
        val = __ldg(row + 4 * ne + e);
      } else {
        w3 = w3p >> 16;
        val = (((w3p >> 8) & 0xFFu) << 16) | (w3p & 0xFFu);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) ct_add(p[n], k[n], w3, val);
    }
  });
}

// the 5-word stash of n entries, the same NK keys
template <typename RD = ThreadReads, int NK = 1>
__device__ __forceinline__ void ct_stash_parts_n(const uint32_t* stash, int n,
                                                 const CTKeys* k,
                                                 CTParts* p) {
#pragma unroll
  for (int q = 0; q < NK; ++q) p[q] = CTParts{false, false, 0u, 0u};
  for (int s = 0; s < n; ++s) {
    const uint32_t* e = stash + 5 * s;
    if (RD::stash(e) == k[0].lo_a && RD::stash(e + 1) == k[0].hi_a &&
        RD::stash(e + 2) == k[0].ports) {
      const uint32_t w3 = RD::stash(e + 3), val = RD::stash(e + 4);
#pragma unroll
      for (int q = 0; q < NK; ++q) ct_add(p[q], k[q], w3, val);
    }
  }
}

__device__ __forceinline__ CTParts ct_row_parts(const uint32_t* row,
                                                int lanes, int ew,
                                                const CTKeys& k) {
  CTParts p;
  ct_row_parts_n(row, lanes, ew, &k, &p);
  return p;
}

__device__ __forceinline__ CTParts ct_stash_parts(const uint32_t* stash,
                                                  int n, const CTKeys& k) {
  CTParts p;
  ct_stash_parts_n(stash, n, &k, &p);
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

// NK probes of one tuple (flag words apart) in a fetched bucket row and
// the stash, one walk of each (ct/device.py ct_probe_rows without the
// RELATED key): r[n] is key n's result.
template <typename RD = ThreadReads, int NK = 1>
__device__ __forceinline__ void ct_probe_n(const uint32_t* row, int lanes,
                                           int ew, const uint32_t* stash,
                                           int stash_n, const CTKeys* k,
                                           CTResult* r) {
  CTParts rp[NK], sp[NK];
  ct_row_parts_n<RD, NK>(row, lanes, ew, k, rp);
  ct_stash_parts_n<RD, NK>(stash, stash_n, k, sp);
#pragma unroll
  for (int n = 0; n < NK; ++n)
    r[n] = ct_combine(rp[n].ff || sp[n].ff, rp[n].rf || sp[n].rf,
                      rp[n].fv + sp[n].fv, rp[n].rv + sp[n].rv);
}

template <typename RD = ThreadReads>
__device__ __forceinline__ CTResult ct_probe(const uint32_t* row, int lanes,
                                             int ew, const uint32_t* stash,
                                             int stash_n, const CTKeys& k) {
  CTResult r;
  ct_probe_n<RD>(row, lanes, ew, stash, stash_n, &k, &r);
  return r;
}

}  // namespace cdp
