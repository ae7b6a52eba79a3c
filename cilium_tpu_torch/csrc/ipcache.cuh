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
__host__ __device__ inline size_t scan_smem_bytes(const DatapathArgs& a) {
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

// -- the lookup's parts: ipcache/lpm.py ipcache_lookup_fused's exact row,
// stash, range classes and scan, and for the routed mesh probe
// (csrc/datapath_mesh.cu) ipcache_bucket_parts, ipcache_stash_parts and
// range_row_parts, which run a row's part on the shard that owns it.
// With PLANES each also sums the flow direction's per-endpoint L3 words.
// RD: how the rows are read (common.cuh Reads).

struct IPCParts {
  bool found;
  uint32_t val;
  uint32_t l3;
};

// one /32 bucket row: `per` ips, then the value plane at `vw`
// bits and, with PLANES, the L3 plane `lplane` at `lw` bits (the halfword
// value sentinel decodes back to UNKNOWN_IDX after the sum)
template <typename RD = ThreadReads, bool PLANES = false>
__device__ __forceinline__ IPCParts ipc_bucket_parts(
    const uint32_t* row, int per, int vw, uint32_t ip,
    const uint32_t* lplane = nullptr, int lw = 32) {
  IPCParts p{false, 0u, 0u};
  RD::keys(row, per, [&](int k, uint32_t w) {
    if (w == ip) {
      p.found = true;
      p.val += unpack_lane(row + per, k, vw);
      if (PLANES) p.l3 += unpack_lane(lplane, k, lw);
    }
  });
  if (vw == 16 && p.found && p.val == VAL16_UNKNOWN) p.val = UNKNOWN_IDX;
  return p;
}

// the stash of n entries of w columns (ip, value[, l3_in, l3_out])
template <typename RD = ThreadReads, bool PLANES = false>
__device__ __forceinline__ IPCParts ipc_stash_parts(const uint32_t* stash,
                                                    int n, int w,
                                                    uint32_t ip,
                                                    bool ingress = true) {
  IPCParts p{false, 0u, 0u};
  for (int s = 0; s < n; ++s) {
    const uint32_t* e = stash + w * s;
    if (RD::stash(e) == ip) {
      p.found = true;
      p.val += RD::stash(e + 1);
      if (PLANES) p.l3 += RD::stash(e + (ingress ? 2 : 3));
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

// one range-class row of e entries: the key plane at off0, the plen,
// value and (with PLANES) L3 planes at off1, off2, offl of widths w1, w2,
// wl
template <bool PLANES = false>
__device__ __forceinline__ IPCParts range_class_row(
    const uint32_t* rrow, int e, int off0, int off1, int off2, int offl,
    int w1, int w2, int wl, uint32_t w0, uint32_t sp) {
  IPCParts p{false, 0u, 0u};
  for (int k = 0; k < e; ++k) {
    if (__ldg(rrow + off0 + k) == w0 && unpack_lane(rrow + off1, k, w1) == sp) {
      p.found = true;
      p.val += unpack_lane(rrow + off2, k, w2);
      if (PLANES) p.l3 += unpack_lane(rrow + offl, k, wl);
    }
  }
  if (w2 == 16 && p.found && p.val == VAL16_UNKNOWN) p.val = UNKNOWN_IDX;
  return p;
}

// one range-class row, its planes at offs[] of widths[] (the value only)
__device__ __forceinline__ IPCParts range_class_parts(const uint32_t* rrow,
                                                      int e,
                                                      const int32_t* offs,
                                                      const int32_t* widths,
                                                      uint32_t w0,
                                                      uint32_t sp) {
  return range_class_row(rrow, e, offs[0], offs[1], offs[2], 0, widths[1],
                         widths[2], 32, w0, sp);
}

// the [B, P] scan's longest match from the staged ranges (stage_ranges):
// found = a range matched, the value (and with PLANES the direction's L3
// word) the u32 sum at the longest length
template <bool PLANES = false>
__device__ __forceinline__ IPCParts range_scan_parts(int n, uint32_t ip,
                                                     bool ingress = true) {
  const uint32_t* base = s_ranges;
  const uint32_t* mask = s_ranges + n;
  const uint32_t* plen = s_ranges + 2 * n;
  const uint32_t* val = s_ranges + 3 * n;
  const uint32_t* l3 = s_ranges + (ingress ? 4 : 5) * n;
  uint32_t best = 0, v = 0, w = 0;
  for (int q = 0; q < n; ++q) {
    if ((ip & mask[q]) == base[q]) {
      const uint32_t pl = plen[q];
      if (pl > best) {
        best = pl;
        v = val[q];
        if (PLANES) w = l3[q];
      } else if (pl == best) {
        v += val[q];
        if (PLANES) w += l3[q];
      }
    }
  }
  return IPCParts{best > 0, best > 0 ? v : 0u, best > 0 ? w : 0u};
}

// The lookup of one address, its stash at `stash`.
template <int IPC, typename RD = ThreadReads>
__device__ __forceinline__ IPCResult ipcache_lookup(const DatapathArgs& a,
                                                    uint32_t ip, bool ingress,
                                                    const uint32_t* stash) {
  constexpr bool planes = IPC == IPC_IDX_PLANES;
  if (IPC == IPC_GENERIC && a.ipc_l1) {
    return IPCResult{dir24_8(a.ipc_l1, a.ipc_l2, a.ipc_blocks, ip), 0u};
  }
  // exact /32: one bucket row, then the stash
  const uint32_t* row =
      a.ipc_buckets +
      static_cast<size_t>(fnv1a1(ip) & static_cast<uint32_t>(a.ipc_nb - 1)) *
          a.ipc_lanes;
  const int per = a.ipc_per;
  const int lanes_v = lanes_for(per, a.ipc_vw);
  const int lanes_l = planes ? lanes_for(per, a.ipc_lw) : 0;
  const IPCParts b = ipc_bucket_parts<RD, planes>(
      row, per, a.ipc_vw, ip, row + per + lanes_v + (ingress ? 0 : lanes_l),
      a.ipc_lw);
  const IPCParts s = ipc_stash_parts<RD, planes>(stash, a.ipc_stash_n,
                                                a.ipc_stash_w, ip, ingress);
  if (b.found || s.found) return IPCResult{b.val + s.val, b.l3 + s.l3};
  if (a.range_base) {
    const IPCParts r = range_scan_parts<planes>(a.n_ranges, ip, ingress);
    return IPCResult{r.val, r.l3};
  }

  // range classes, longest first: the first class that hits wins
  const int offl = ingress ? a.range_offs[3] : a.range_offs[4];
  const int wl = ingress ? a.range_widths[3] : a.range_widths[4];
  for (int c = 0; c < a.n_classes; ++c) {
    const uint32_t sp = static_cast<uint32_t>(a.class_plens[c]);
    const uint32_t w0 = range_class_w0(ip, sp);
    const uint32_t rh = fnv1a2(w0, sp);
    const uint32_t* rrow =
        a.ipc_range_rows +
        static_cast<size_t>(rh & static_cast<uint32_t>(a.range_nrows - 1)) *
            a.range_lanes;
    const IPCParts r = range_class_row<planes>(
        rrow, a.range_e, a.range_offs[0], a.range_offs[1], a.range_offs[2],
        offl, a.range_widths[1], a.range_widths[2], wl, w0, sp);
    if (r.found) return IPCResult{r.val, r.l3};
  }
  return IPCResult{0u, 0u};
}

template <int IPC>
__device__ __forceinline__ IPCResult ipcache_lookup(const DatapathArgs& a,
                                                    uint32_t ip,
                                                    bool ingress) {
  return ipcache_lookup<IPC>(a, ip, ingress, a.ipc_stash);
}

}  // namespace cdp
