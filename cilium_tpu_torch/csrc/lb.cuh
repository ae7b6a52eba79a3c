// LB stage (lb/device.py lb_select_batch).  Inline layout (lb_select):
// the (vip, dport << 16 | proto) probe of one 128-lane row of two 64-lane
// service slots plus the stash.  Classic layout (lb_select_classic, any
// service past 40 backends): the probe of one bucket row of 32 planar
// 4-word entries plus the 4-word stash gives the summed meta and backend
// row, then one dependent backend row read at the clamped row index.
// Both: backend `flow_hash % count + 1`, or the service-scope CT entry's
// slave when 0 < slave <= count; DNAT to the backend's ip and port (the
// k & 1 half of a 32-bit port pair); a backend k past the row's lanes
// reads 0, as the reference's masked lane sums do.
#pragma once

#include "common.cuh"

namespace cdp {

constexpr int LB_SLOT = 64;
constexpr int LB_MAX_BACKENDS = 40;
constexpr int LB_PORT_LANE = 4 + LB_MAX_BACKENDS;
constexpr int LBC_PER = 32;         // classic entries per bucket row
constexpr int LBC_BACKENDS = 64;    // classic backend row: ips [0, 64)
constexpr int LBC_PORT_LANE = 64;   // ... port pairs [64, 96)

struct LBResult {
  bool found;
  int32_t slave;
  uint32_t daddr;
  uint32_t dport;
  int32_t rev_nat;
};

__device__ __forceinline__ LBResult lb_select(const DatapathArgs& a,
                                              uint32_t saddr, uint32_t daddr,
                                              uint32_t sport, uint32_t dport,
                                              uint32_t proto,
                                              int32_t ct_slave) {
  const uint32_t vip = daddr;
  const uint32_t w1 = ((dport & 0xFFFFu) << 16) | (proto & 0xFFu);
  const uint32_t h = fnv1a2(vip, w1);
  const uint32_t* row =
      a.lb_rows + static_cast<size_t>(h & static_cast<uint32_t>(a.lb_nb - 1)) *
                      (2 * LB_SLOT);
  // matching slots: the two halves of the row, then the stash
  const uint32_t* hits[2];
  int n_row_hits = 0;
  uint32_t meta = 0;
  for (int s = 0; s < 2; ++s) {
    const uint32_t* slot = row + s * LB_SLOT;
    if (__ldg(slot) == vip && __ldg(slot + 1) == w1) {
      hits[n_row_hits++] = slot;
      meta += __ldg(slot + 2);
    }
  }
  bool any = n_row_hits > 0;
  for (int s = 0; s < a.lb_stash_n; ++s) {
    const uint32_t* slot = a.lb_stash + s * LB_SLOT;
    if (__ldg(slot) == vip && __ldg(slot + 1) == w1) {
      any = true;
      meta += __ldg(slot + 2);
    }
  }
  const uint32_t count = meta & 0xFFFFu;
  LBResult r;
  r.found = any && count > 0;
  if (!r.found) {
    r.slave = 0;
    r.daddr = daddr;
    r.dport = dport;
    r.rev_nat = 0;
    return r;
  }
  const uint32_t fh = fnv1a4(saddr, daddr, (sport << 16) | dport, proto);
  int32_t slave = static_cast<int32_t>(fh % count) + 1;
  if (ct_slave > 0 && ct_slave <= static_cast<int32_t>(count))
    slave = ct_slave;
  const int k = slave - 1;
  uint32_t new_daddr = 0, port_pair = 0;
  for (int s = 0; s < n_row_hits; ++s) {
    if (k < LB_MAX_BACKENDS) new_daddr += __ldg(hits[s] + 4 + k);
    if ((k >> 1) < LB_MAX_BACKENDS / 2)
      port_pair += __ldg(hits[s] + LB_PORT_LANE + (k >> 1));
  }
  for (int s = 0; s < a.lb_stash_n; ++s) {
    const uint32_t* slot = a.lb_stash + s * LB_SLOT;
    if (__ldg(slot) == vip && __ldg(slot + 1) == w1) {
      if (k < LB_MAX_BACKENDS) new_daddr += __ldg(slot + 4 + k);
      if ((k >> 1) < LB_MAX_BACKENDS / 2)
        port_pair += __ldg(slot + LB_PORT_LANE + (k >> 1));
    }
  }
  r.slave = slave;
  r.daddr = new_daddr;
  r.dport = (port_pair >> (16 * (k & 1))) & 0xFFFFu;
  r.rev_nat = static_cast<int32_t>(meta >> 16);
  return r;
}

__device__ __forceinline__ LBResult lb_select_classic(
    const DatapathArgs& a, uint32_t saddr, uint32_t daddr, uint32_t sport,
    uint32_t dport, uint32_t proto, int32_t ct_slave) {
  const uint32_t vip = daddr;
  const uint32_t w1 = ((dport & 0xFFFFu) << 16) | (proto & 0xFFu);
  const uint32_t h = fnv1a2(vip, w1);
  const uint32_t* row =
      a.lb_rows + static_cast<size_t>(h & static_cast<uint32_t>(a.lb_nb - 1)) *
                      (4 * LBC_PER);
  // every matching entry's meta and backend row, summed (u32)
  bool any = false;
  uint32_t meta = 0, base = 0;
  for (int k = 0; k < LBC_PER; ++k) {
    if (__ldg(row + k) == vip && __ldg(row + LBC_PER + k) == w1) {
      any = true;
      meta += __ldg(row + 2 * LBC_PER + k);
      base += __ldg(row + 3 * LBC_PER + k);
    }
  }
  for (int s = 0; s < a.lb_stash_n; ++s) {
    const uint32_t* e = a.lb_stash + 4 * s;
    if (__ldg(e) == vip && __ldg(e + 1) == w1) {
      any = true;
      meta += __ldg(e + 2);
      base += __ldg(e + 3);
    }
  }
  const uint32_t count = meta & 0xFFFFu;
  LBResult r;
  r.found = any && count > 0;
  if (!r.found) {
    r.slave = 0;
    r.daddr = daddr;
    r.dport = dport;
    r.rev_nat = 0;
    return r;
  }
  const uint32_t fh = fnv1a4(saddr, daddr, (sport << 16) | dport, proto);
  int32_t slave = static_cast<int32_t>(fh % count) + 1;
  if (ct_slave > 0 && ct_slave <= static_cast<int32_t>(count))
    slave = ct_slave;
  const int k = slave - 1;
  // the row index is the sum as int32, clipped to the table
  const int32_t b32 = static_cast<int32_t>(base);
  const int32_t last = a.lb_backend_n - 1;
  const uint32_t* brow =
      a.lb_backends +
      static_cast<size_t>(b32 < 0 ? 0 : (b32 > last ? last : b32)) * 128;
  const uint32_t port_pair =
      (k >> 1) < LBC_BACKENDS / 2 ? __ldg(brow + LBC_PORT_LANE + (k >> 1)) : 0u;
  r.slave = slave;
  r.daddr = k < LBC_BACKENDS ? __ldg(brow + k) : 0u;
  r.dport = (port_pair >> (16 * (k & 1))) & 0xFFFFu;
  r.rev_nat = static_cast<int32_t>(meta >> 16);
  return r;
}

// -- the slot half (the routed mesh probe, csrc/datapath_mesh.cu) ----------
// lb/device.py lb_inline_slot + lb_slot_outputs over one source of inline
// slots (a bucket row's two, or the stash's): the matching slots' lanes
// summed, then the backend choice, every output zero where the service is
// not found (no pass-through: two sources' outputs add up).

struct LBOut {
  bool found;
  int32_t slave;
  uint32_t daddr, dport;
  int32_t rev_nat;
};

__device__ __forceinline__ LBOut lb_slot_outputs(const uint32_t* slots,
                                                 int n_slots, uint32_t vip,
                                                 uint32_t w1, uint32_t fh,
                                                 int32_t ct_slave) {
  LBOut o{false, 0, 0u, 0u, 0};
  uint32_t meta = 0;
  for (int s = 0; s < n_slots; ++s) {
    const uint32_t* slot = slots + s * LB_SLOT;
    if (__ldg(slot) == vip && __ldg(slot + 1) == w1) {
      o.found = true;
      meta += __ldg(slot + 2);
    }
  }
  const uint32_t count = meta & 0xFFFFu;
  if (!o.found || count == 0) {
    o.found = false;
    return o;
  }
  int32_t slave = static_cast<int32_t>(fh % count) + 1;
  if (ct_slave > 0 && ct_slave <= static_cast<int32_t>(count))
    slave = ct_slave;
  const int k = slave - 1;
  uint32_t new_daddr = 0, port_pair = 0;
  for (int s = 0; s < n_slots; ++s) {
    const uint32_t* slot = slots + s * LB_SLOT;
    if (__ldg(slot) == vip && __ldg(slot + 1) == w1) {
      if (k < LB_MAX_BACKENDS) new_daddr += __ldg(slot + 4 + k);
      if ((k >> 1) < LB_MAX_BACKENDS / 2)
        port_pair += __ldg(slot + LB_PORT_LANE + (k >> 1));
    }
  }
  o.slave = slave;
  o.daddr = new_daddr;
  o.dport = (port_pair >> (16 * (k & 1))) & 0xFFFFu;
  o.rev_nat = static_cast<int32_t>(meta >> 16);
  return o;
}

}  // namespace cdp
