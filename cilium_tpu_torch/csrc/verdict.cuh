// Policy lattice stage (engine/verdict.py _probes + _combine) over either
// hashed L4 entry layout, planar rows plus a stash:
//   compact, 2 words: cw0 = idx18 | (dport & 0x3FFF) << 18
//     cw1 = dport >> 14 | proto << 2 | ep << 10 | dir << 18 | j << 19;
//     the matched slot j rebuilds the proxy port from l4_meta[ep, dir, j];
//   wide, 3 words (JAX engine/verdict.py:189-288): l4h_key0 = idx |
//     dir << 22 | (ep & 0x1FF) << 23, l4h_key1 = dport << 16 | proto << 8
//     | ep >> 9, value j << 16 | proxy summed over hits.
// The exact and wildcard probes are one row read each plus the stash.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr uint32_t MATCH_NONE = 0, MATCH_L4 = 1, MATCH_L3 = 2,
                   MATCH_L4_WILD = 3, MATCH_FRAG_DROP = 4;
constexpr uint32_t L4H_WILD_IDX = (1u << 22) - 1;
constexpr uint32_t L4C_WILD_IDX18 = (1u << 18) - 1;
constexpr uint32_t L4C_CMP_MASK = ((1u << 19) - 1) | (1u << 31);

struct L4Probe {
  bool hit;
  uint32_t val;  // the summed slot index j of matching entries
};

__device__ __forceinline__ uint32_t l4c_key0(uint32_t idx, uint32_t dport) {
  const uint32_t idx18 = idx == L4H_WILD_IDX ? L4C_WILD_IDX18 : idx;
  return (idx18 & 0x3FFFFu) | ((dport & 0x3FFFu) << 18);
}

__device__ __forceinline__ uint32_t l4c_key1(uint32_t dport, uint32_t proto,
                                             uint32_t ep, uint32_t dir) {
  return (dport >> 14) | ((proto & 0xFFu) << 2) | ((ep & 0xFFu) << 10) |
         ((dir & 1u) << 18);
}

__device__ __forceinline__ L4Probe l4_probe(const uint32_t* rows, int nrows,
                                            int lanes, const uint32_t* stash,
                                            int stash_n, uint32_t w0,
                                            uint32_t w1) {
  const uint32_t h = fnv1a2(w0, w1);
  const uint32_t* row =
      rows + static_cast<size_t>(h & static_cast<uint32_t>(nrows - 1)) * lanes;
  const int e = lanes / 2;
  L4Probe p{false, 0u};
  for (int k = 0; k < e; ++k) {
    if (__ldg(row + k) == w0) {
      const uint32_t k1 = __ldg(row + e + k);
      if ((k1 & L4C_CMP_MASK) == w1) {
        p.hit = true;
        p.val += (k1 >> 19) & 0xFFFu;
      }
    }
  }
  for (int s = 0; s < stash_n; ++s) {
    if (__ldg(stash + 2 * s) == w0) {
      const uint32_t k1 = __ldg(stash + 2 * s + 1);
      if ((k1 & L4C_CMP_MASK) == w1) {
        p.hit = true;
        p.val += (k1 >> 19) & 0xFFFu;
      }
    }
  }
  return p;
}

__device__ __forceinline__ L4Probe l4_probe3(const uint32_t* rows, int nrows,
                                             int lanes, const uint32_t* stash,
                                             int stash_n, uint32_t w0,
                                             uint32_t w1) {
  const uint32_t h = fnv1a2(w0, w1);
  const uint32_t* row =
      rows + static_cast<size_t>(h & static_cast<uint32_t>(nrows - 1)) * lanes;
  const int e = lanes / 3;
  L4Probe p{false, 0u};
  for (int k = 0; k < e; ++k) {
    if (__ldg(row + k) == w0 && __ldg(row + e + k) == w1) {
      p.hit = true;
      p.val += __ldg(row + 2 * e + k);
    }
  }
  for (int s = 0; s < stash_n; ++s) {
    if (__ldg(stash + 3 * s) == w0 && __ldg(stash + 3 * s + 1) == w1) {
      p.hit = true;
      p.val += __ldg(stash + 3 * s + 2);
    }
  }
  return p;
}

struct Lattice {
  bool allowed;
  int32_t proxy;
  uint32_t kind;
  int32_t j;
};

// probes 1-3 and the combine (policy.h order; fragments skip the L4
// probes).  idx/known/l3_bit come from the idx-form ipcache.  dport and
// proto are clamped to their ranges, and every table index as an XLA
// gather clamps it.
__device__ __forceinline__ Lattice lattice(const DatapathArgs& a, uint32_t ep,
                                           uint32_t dir, uint32_t dport_w,
                                           uint32_t proto_w, uint32_t idx,
                                           bool known, bool l3_bit,
                                           bool frag) {
  const int32_t dp = static_cast<int32_t>(dport_w);
  const int32_t pr = static_cast<int32_t>(proto_w);
  const uint32_t dport = dp < 0 ? 0u : (dp > 65535 ? 65535u : dp);
  const uint32_t proto = pr < 0 ? 0u : (pr > 255 ? 255u : pr);
  bool probe1, probe3;
  int32_t j, proxy;
  if (a.l4_ew == 3) {
    const uint32_t k1 = (dport << 16) | (proto << 8) | (ep >> 9);
    const uint32_t dk = (dir << 22) | ((ep & 0x1FFu) << 23);
    const L4Probe p1 = l4_probe3(a.l4_rows, a.l4_nrows, a.l4_lanes,
                                 a.l4_stash, a.l4_stash_n, idx | dk, k1);
    const L4Probe p3 =
        l4_probe3(a.l4w_rows, a.l4w_nrows, a.l4w_lanes, a.l4w_stash,
                  a.l4w_stash_n, L4H_WILD_IDX | dk, k1);
    probe1 = known && p1.hit;
    probe3 = p3.hit;
    const uint32_t val = probe1 ? p1.val : p3.val;
    proxy = static_cast<int32_t>(val & 0xFFFFu);
    j = static_cast<int32_t>(val >> 16);
  } else {
    const uint32_t k1 = l4c_key1(dport, proto, ep, dir);
    const L4Probe p1 = l4_probe(a.l4_rows, a.l4_nrows, a.l4_lanes, a.l4_stash,
                                a.l4_stash_n, l4c_key0(idx, dport), k1);
    const L4Probe p3 =
        l4_probe(a.l4w_rows, a.l4w_nrows, a.l4w_lanes, a.l4w_stash,
                 a.l4w_stash_n, l4c_key0(L4H_WILD_IDX, dport), k1);
    probe1 = known && p1.hit;
    probe3 = p3.hit;
    j = static_cast<int32_t>(probe1 ? p1.val : p3.val);
    // the l4_meta read clamps its indices, as an XLA gather does
    const int jc = min(max(j, 0), a.kg - 1);
    const int epc = min(max(static_cast<int32_t>(ep), 0), a.n_eps - 1);
    const int32_t d = static_cast<int32_t>(dir);
    const int dc = d < 0 ? 0 : (d > 1 ? 1 : d);
    const uint32_t meta =
        __ldg(a.l4_meta + (static_cast<size_t>(epc) * 2 + dc) * a.kg + jc);
    proxy = (probe1 || probe3) ? static_cast<int32_t>(meta >> 1) : 0;
  }
  const bool probe2 = known && l3_bit;

  const bool q1 = probe1 && !frag;
  const bool q3 = probe3 && !frag;
  Lattice r;
  r.allowed = q1 || probe2 || q3;
  r.proxy = (r.allowed && (q1 || (!probe2 && q3))) ? proxy : 0;
  r.kind = q1       ? MATCH_L4
           : probe2 ? MATCH_L3
           : q3     ? MATCH_L4_WILD
           : frag   ? MATCH_FRAG_DROP
                    : MATCH_NONE;
  r.j = j;
  return r;
}

}  // namespace cdp
