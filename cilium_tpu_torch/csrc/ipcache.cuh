// ipcache stage (ipcache/lpm.py ipcache_lookup_fused; _lookup_kernel for
// the generic forms): the exact-/32 bucket row (planar ips | values at
// ipc_vw bits, then with L3 planes the L3-ingress | L3-egress words at
// ipc_lw bits) plus the stash, then on a miss the non-/32 ranges: at most
// 4 hashed range-class rows, longest prefix first, or without a class
// table the [B, P] scan of every range.  IPC_GENERIC reads raw
// identities, from such a table or from DIR-24-8 (ipc_l1 not null).
// Returns the value (the identity index + 1 in the idx forms, the
// identity in the generic one; 0 = miss) and, with L3 planes, the flow
// direction's per-endpoint L3 word.
//
// The scan keeps, per flow, the longest matching prefix and the u32 sums
// of the values (and L3 words) of the ranges at that length (stored
// plen + 1, so no padding row wins; ranges of one length never overlap,
// so a sum is one entry's value).  Its ranges (at most 512, 16 KB with
// the L3 words) are staged in shared memory once per block
// (stage_ranges), since every flow that misses the exact table reads all
// of them.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr uint32_t VAL16_UNKNOWN = 0xFFFFu;
constexpr uint32_t UNKNOWN_IDX = 0xFFFFFFFFu;
constexpr int MAX_SCAN_RANGES = 512;

// the block's staged [B, P] ranges: base | mask | plen | value
// [| l3_in | l3_out], n_ranges words each
extern __shared__ uint32_t s_ranges[];

struct IPCResult {
  uint32_t value;
  uint32_t l3;
};

// Bytes of shared memory the [B, P] scan stages per block (0 without it).
inline size_t scan_smem_bytes(const DatapathArgs& a) {
  if (!a.range_base) return 0;
  const int planes = a.range_l3_in ? 6 : 4;
  return static_cast<size_t>(planes) * a.n_ranges * sizeof(uint32_t);
}

// Every thread of the block calls this before its flow: the scan's
// ranges into s_ranges, then a barrier.  No-op without a scan.
__device__ __forceinline__ void stage_ranges(const DatapathArgs& a) {
  if (!a.range_base) return;
  const int n = a.n_ranges;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    s_ranges[k] = __ldg(a.range_base + k);
    s_ranges[n + k] = __ldg(a.range_mask + k);
    s_ranges[2 * n + k] = __ldg(a.range_plen + k);
    s_ranges[3 * n + k] = __ldg(a.range_value + k);
    if (a.range_l3_in) {
      s_ranges[4 * n + k] = __ldg(a.range_l3_in + k);
      s_ranges[5 * n + k] = __ldg(a.range_l3_out + k);
    }
  }
  __syncthreads();
}

template <bool PLANES>
__device__ __forceinline__ IPCResult range_scan(const DatapathArgs& a,
                                                uint32_t ip, bool ingress) {
  const int n = a.n_ranges;
  const uint32_t* base = s_ranges;
  const uint32_t* mask = s_ranges + n;
  const uint32_t* plen = s_ranges + 2 * n;
  const uint32_t* val = s_ranges + 3 * n;
  const uint32_t* l3 = s_ranges + (ingress ? 4 : 5) * n;
  uint32_t best = 0, v = 0, w = 0;
  for (int p = 0; p < n; ++p) {
    if ((ip & mask[p]) == base[p]) {
      const uint32_t pl = plen[p];
      if (pl > best) {
        best = pl;
        v = val[p];
        if (PLANES) w = l3[p];
      } else if (pl == best) {
        v += val[p];
        if (PLANES) w += l3[p];
      }
    }
  }
  IPCResult r;
  r.value = best ? v : 0u;
  r.l3 = best ? w : 0u;
  return r;
}

template <int IPC>
__device__ __forceinline__ IPCResult ipcache_lookup(const DatapathArgs& a,
                                                    uint32_t ip,
                                                    bool ingress) {
  constexpr bool planes = IPC == IPC_IDX_PLANES;
  IPCResult r;
  if (IPC == IPC_GENERIC && a.ipc_l1) {
    r.value = dir24_8(a.ipc_l1, a.ipc_l2, a.ipc_blocks, ip);
    r.l3 = 0;
    return r;
  }
  // exact /32: one bucket row
  const uint32_t h = fnv1a1(ip);
  const uint32_t* row =
      a.ipc_buckets +
      static_cast<size_t>(h & static_cast<uint32_t>(a.ipc_nb - 1)) *
          a.ipc_lanes;
  const int per = a.ipc_per;
  const int lanes_v = lanes_for(per, a.ipc_vw);
  const int lanes_l = planes ? lanes_for(per, a.ipc_lw) : 0;
  const uint32_t* vplane = row + per;
  const uint32_t* lplane = row + per + lanes_v + (ingress ? 0 : lanes_l);
  bool bf = false;
  uint32_t bv = 0, bl3 = 0;
  for (int k = 0; k < per; ++k) {
    if (__ldg(row + k) == ip) {
      bf = true;
      bv += unpack_lane(vplane, k, a.ipc_vw);
      if (planes) bl3 += unpack_lane(lplane, k, a.ipc_lw);
    }
  }
  // the halfword sentinel decodes back to UNKNOWN_IDX after the sum
  if (a.ipc_vw == 16 && bf && bv == VAL16_UNKNOWN) bv = UNKNOWN_IDX;
  bool sf = false;
  uint32_t sv = 0, sl3 = 0;
  for (int s = 0; s < a.ipc_stash_n; ++s) {
    const uint32_t* e = a.ipc_stash + a.ipc_stash_w * s;
    if (__ldg(e) == ip) {
      sf = true;
      sv += __ldg(e + 1);
      if (planes) sl3 += __ldg(e + (ingress ? 2 : 3));
    }
  }
  if (bf || sf) {
    r.value = bv + sv;
    r.l3 = bl3 + sl3;
    return r;
  }
  if (a.range_base) return range_scan<planes>(a, ip, ingress);

  // range classes, longest first: the first class that hits wins
  const int e_n = a.range_e;
  const int lw_i = ingress ? 3 : 4;
  for (int c = 0; c < a.n_classes; ++c) {
    const uint32_t sp = static_cast<uint32_t>(a.class_plens[c]);
    const uint32_t raw = sp - 1;
    // a /0 class masks everything (a shift by 32 is undefined in C)
    const uint32_t m = raw ? (0xFFFFFFFFu << (32 - raw)) : 0u;
    const uint32_t w0 = ip & m;
    const uint32_t rh = fnv1a2(w0, sp);
    const uint32_t* rrow =
        a.ipc_range_rows +
        static_cast<size_t>(rh & static_cast<uint32_t>(a.range_nrows - 1)) *
            a.range_lanes;
    bool hit = false;
    uint32_t v = 0, l3 = 0;
    for (int k = 0; k < e_n; ++k) {
      if (__ldg(rrow + a.range_offs[0] + k) == w0 &&
          unpack_lane(rrow + a.range_offs[1], k, a.range_widths[1]) == sp) {
        hit = true;
        v += unpack_lane(rrow + a.range_offs[2], k, a.range_widths[2]);
        if (planes)
          l3 += unpack_lane(rrow + a.range_offs[lw_i], k,
                            a.range_widths[lw_i]);
      }
    }
    if (hit) {
      if (a.range_widths[2] == 16 && v == VAL16_UNKNOWN) v = UNKNOWN_IDX;
      r.value = v;
      r.l3 = l3;
      return r;
    }
  }
  r.value = 0;
  r.l3 = 0;
  return r;
}

// -- the row and stash halves (the routed mesh probe, csrc/datapath_mesh.cu)
// ipcache/lpm.py ipcache_bucket_parts, ipcache_stash_parts and
// range_row_parts, the value only: the same compares as ipcache_lookup,
// split so that a row's half runs on the shard that owns it.

struct IPCParts {
  bool found;
  uint32_t val;
};

// one /32 bucket row: `per` ips, then the value plane at `vw` bits (the
// halfword sentinel decodes back to UNKNOWN_IDX after the sum)
__device__ __forceinline__ IPCParts ipc_bucket_parts(const uint32_t* row,
                                                     int per, int vw,
                                                     uint32_t ip) {
  IPCParts p{false, 0u};
  for (int k = 0; k < per; ++k) {
    if (__ldg(row + k) == ip) {
      p.found = true;
      p.val += unpack_lane(row + per, k, vw);
    }
  }
  if (vw == 16 && p.found && p.val == VAL16_UNKNOWN) p.val = UNKNOWN_IDX;
  return p;
}

// the stash of n entries of w columns (ip, value, ...)
__device__ __forceinline__ IPCParts ipc_stash_parts(const uint32_t* stash,
                                                    int n, int w,
                                                    uint32_t ip) {
  IPCParts p{false, 0u};
  for (int s = 0; s < n; ++s) {
    const uint32_t* e = stash + w * s;
    if (__ldg(e) == ip) {
      p.found = true;
      p.val += __ldg(e + 1);
    }
  }
  return p;
}

// the key of range class `sp` (stored plen + 1): the masked address
__device__ __forceinline__ uint32_t range_class_w0(uint32_t ip, uint32_t sp) {
  const uint32_t raw = sp - 1;
  // a /0 class masks everything (a shift by 32 is undefined in C)
  return ip & (raw ? (0xFFFFFFFFu << (32 - raw)) : 0u);
}

// one range-class row of e entries, its planes at offs[] of widths[]
__device__ __forceinline__ IPCParts range_class_parts(const uint32_t* rrow,
                                                      int e,
                                                      const int32_t* offs,
                                                      const int32_t* widths,
                                                      uint32_t w0,
                                                      uint32_t sp) {
  IPCParts p{false, 0u};
  for (int k = 0; k < e; ++k) {
    if (__ldg(rrow + offs[0] + k) == w0 &&
        unpack_lane(rrow + offs[1], k, widths[1]) == sp) {
      p.found = true;
      p.val += unpack_lane(rrow + offs[2], k, widths[2]);
    }
  }
  if (widths[2] == 16 && p.found && p.val == VAL16_UNKNOWN)
    p.val = UNKNOWN_IDX;
  return p;
}

// the [B, P] scan's longest match from the staged ranges (stage_ranges):
// found = a range matched, the value the u32 sum at the longest length
__device__ __forceinline__ IPCParts range_scan_parts(int n, uint32_t ip) {
  const uint32_t* base = s_ranges;
  const uint32_t* mask = s_ranges + n;
  const uint32_t* plen = s_ranges + 2 * n;
  const uint32_t* val = s_ranges + 3 * n;
  uint32_t best = 0, v = 0;
  for (int q = 0; q < n; ++q) {
    if ((ip & mask[q]) == base[q]) {
      const uint32_t pl = plen[q];
      if (pl > best) {
        best = pl;
        v = val[q];
      } else if (pl == best) {
        v += val[q];
      }
    }
  }
  return IPCParts{best > 0, best > 0 ? v : 0u};
}

}  // namespace cdp
