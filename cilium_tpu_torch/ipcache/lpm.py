"""Device ipcache: IP -> identity, bucketized, and the plain lookup.

Replaces the kernel's `cilium_ipcache` LPM trie (bpf/lib/eps.h
ipcache_lookup4).  The /32 population (the bulk of a real ipcache)
lives in hash-bucket rows resolved by one row read plus a small
stash; the few hundred at most wider prefixes live in a hashed
range-class table: one row per (masked base, prefix length), probed
once per distinct length, longest first.  Past RANGE_CLASS_MAX
distinct lengths there is no class table (`range_rows` None) and the
lookup scans every range per address, keeping the longest match.

The fused datapath reads the idx form (`specialize_ipcache_to_idx`):
values are the dense policy identity index + 1 (0 = miss,
UNKNOWN_IDX = an identity outside the policy universe), and with at
most 32 endpoints each entry also carries per-endpoint L3-allow
bitmasks, one u32 per direction; past 32 endpoints it carries the
index alone and the lattice reads l3_allow_bits.  `subword_ipcache`
packs the value and L3 planes to the fewest bits their values need.

The DIR-24-8 form (`build_lpm`, `lpm_lookup`) is the standalone
IPv4 -> identity lookup of the CIDR path: two dependent reads per
address, `l1[ip >> 8]` and, when that entry points at a block,
`l2[block, ip & 0xFF]`.  `build_ipcache` falls back to it past
MAX_RANGES non-/32 prefixes, and the fused datapath then reads the
raw identity from it (`lookup_plain`).

`LPMBuilder` is the IPCache listener that mirrors the listener-visible
CIDR -> identity view into `build_ipcache` tables (host arrays).
"""

from __future__ import annotations

import dataclasses
import ipaddress
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import (
    narrow,
    require_on,
    resolve_device,
    tensor_on,
    widen,
)
from cilium_tpu_torch.engine import subword as sw
from cilium_tpu_torch.engine.hashtable import (
    _fnv1a_host,
    fnv1a,
    trim_pow2_prefix,
)

IP_ENTRIES_PER_BUCKET = 64
IP_STASH = 128
MAX_RANGES = 512
RANGE_CLASS_MAX = 4
RANGE_ENTRIES_PER_BUCKET = 8
SUBWORD_IP_ENTRIES = 32  # idx-only form
SUBWORD_IP_L3_ENTRIES = 16  # idx + l3-plane form
_VAL16_UNKNOWN = np.uint32(0xFFFF)
_EMPTY_IP = np.uint32(0xFFFFFFFF)
# idx-form sentinel: the entry exists but its identity is outside the
# policy universe — not a miss (which falls back to WORLD)
UNKNOWN_IDX = np.uint32(0xFFFFFFFF)


# -- DIR-24-8 ------------------------------------------------------------------
L1_BITS = 24
L1_SIZE = 1 << L1_BITS
BLOCK_FLAG = np.uint32(1 << 31)


@dataclass
class LPMTables:
    """DIR-24-8 tables: numpy u32 as built, int32 tensors (u32 bits)
    once moved with convert.lpm_to.

      l1  u32 [2^24]         indexed by ip >> 8: bit 31 clear is the
                             identity of the whole /24 cell, bit 31 set
                             a block index into l2
      l2  u32 [blocks, 256]  indexed by (block, ip & 0xFF)

    Identity 0 marks "no entry"."""

    l1: object
    l2: object


def build_lpm(prefix_to_id: Dict[str, int]) -> LPMTables:
    """Lower {ipv4 cidr -> identity} to DIR-24-8 tables.  Prefixes are
    painted shortest first (sorted as (plen, base, id) tuples, so of two
    strings that normalise to one network the larger id lands last);
    each /24 cell holding a longer prefix becomes a 256-entry block
    seeded with the cell's cover.  IPv6 prefixes are skipped; an
    identity of 2^31 or more raises."""
    parsed = []
    for cidr, num_id in prefix_to_id.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        if num_id >= 1 << 31:
            raise ValueError(f"identity {num_id} exceeds 31-bit LPM range")
        parsed.append((net.prefixlen, int(net.network_address), num_id))
    parsed.sort()

    l1 = np.zeros(L1_SIZE, dtype=np.uint32)
    blocks = []
    block_of_cell: Dict[int, int] = {}
    for plen, base, num_id in parsed:
        if plen <= L1_BITS:
            lo = base >> (32 - L1_BITS)
            cells = np.arange(lo, lo + (1 << (L1_BITS - plen)))
            # paint plain cells; descend into cells that are blocks
            ptr = (l1[cells] & BLOCK_FLAG) != 0
            l1[cells[~ptr]] = num_id
            for cell in cells[ptr]:
                blocks[int(l1[cell] & ~BLOCK_FLAG)][:] = num_id
        else:
            cell = base >> 8
            bi = block_of_cell.get(cell)
            if bi is None:
                bi = len(blocks)
                seed = l1[cell]
                if seed & BLOCK_FLAG:
                    raise AssertionError("cell already a block")
                blocks.append(np.full(256, seed, dtype=np.uint32))
                block_of_cell[cell] = bi
                l1[cell] = BLOCK_FLAG | np.uint32(bi)
            lo = base & 0xFF
            blocks[bi][lo : lo + (1 << (32 - plen))] = num_id
    l2 = np.stack(blocks) if blocks else np.zeros((1, 256), dtype=np.uint32)
    return LPMTables(l1=l1, l2=l2)


def lookup_host(prefix_to_id: Dict[str, int], ip: str) -> int:
    """Host reference LPM over the mapping itself (the oracle of
    build_lpm and lpm_lookup): the longest prefix holding `ip`, 0 when
    none does."""
    addr = ipaddress.ip_address(ip)
    best_len, best_id = -1, 0
    for cidr, num_id in prefix_to_id.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != addr.version:
            continue
        if addr in net and net.prefixlen > best_len:
            best_len, best_id = net.prefixlen, num_id
    return best_id


def lpm_lookup_plain(tables: LPMTables, ips: torch.Tensor) -> torch.Tensor:
    """Plain version of the DIR-24-8 lookup: ips [B] (u32 bits) ->
    identities int64 [B] holding u32 values.  The block read clamps
    its row, as an XLA gather does."""
    ips = widen(ips)
    v1 = widen(tables.l1[ips >> 8])
    is_block = (v1 & int(BLOCK_FLAG)) != 0
    block = torch.where(is_block, v1 & ~int(BLOCK_FLAG), 0)
    block = block.clamp(max=int(tables.l2.shape[0]) - 1)
    v2 = widen(tables.l2[block, ips & 0xFF])
    return torch.where(is_block, v2, v1)


def lpm_lookup(tables, ips, device=None) -> torch.Tensor:
    """Batched IPv4 -> value on `device` (None = the card): int32 [B]
    holding u32 values, 0 = no entry.  From DIR-24-8 LPMTables the
    value is the identity; from a bucketized IPCacheDevice it is what the
    table stores (the identity in the generic form, the identity index +
    1 in the idx forms; the ingress L3 plane is not returned).  `tables`
    lie on that device (convert.lpm_to, convert.plane_to); `ips` is a
    tensor there or a numpy array, uploaded.  A CUDA device launches
    LPM_LOOKUP (DIR-24-8) or IPCACHE_LOOKUP; the CPU runs the plain
    version."""
    dev = resolve_device(device)
    ips = tensor_on(ips, dev, "ips")
    if isinstance(tables, IPCacheDevice):
        require_on(tables.buckets, dev,
                   "the ipcache tables (convert.plane_to)")
    else:
        require_on(tables.l1, dev, "the LPM tables (convert.lpm_to)")
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        if isinstance(tables, IPCacheDevice):
            return kernels.IPCACHE_LOOKUP(tables, ips)
        return kernels.LPM_LOOKUP(tables, ips)
    return narrow(lookup_plain(tables, ips))


@dataclass
class IPCacheDevice:
    """Bucketized ipcache.  Bucket rows are planar: ips, then values,
    then (l3 planes) the ingress and egress L3 words.  The generic
    form has 64 entries x 2 words; the idx+l3 form 32 x 4; the
    sub-word form `bucket_entries` entries with the value plane at
    `value_width` and the L3 planes at `l3_width` bits.  The stash
    keeps u32 columns (ip, value[, l3_in, l3_out])."""

    buckets: object  # u32 [Cb, lanes]
    stash: object  # u32 [S, 2 or 4]
    range_base: object  # u32 [P]
    range_mask: object  # u32 [P]
    range_plen: object  # u32 [P] (stored +1; 0 = padding)
    range_value: object  # u32 [P]
    n_buckets: int
    values_are_idx: bool = False
    world_plus1: int = 0
    l3_planes: bool = False
    world_l3_in: int = 0
    world_l3_out: int = 0
    range_l3_in: object = None
    range_l3_out: object = None
    range_rows: object = None
    range_class_plens: tuple = ()
    bucket_entries: int = 0
    value_width: int = 32
    l3_width: int = 32
    range_widths: tuple = ()


def _build_range_rows(base, mask, plen, value, l3_in=None, l3_out=None):
    """Bucketize the non-/32 ranges by (masked base, stored plen).
    Planar rows of 8 entries x 3 planes (base, plen, value), or 5 with
    the L3 words.  Returns (rows, class_plens longest first), or
    (None, ()) past RANGE_CLASS_MAX distinct lengths."""
    live = plen > 0
    nlive = int(live.sum())
    planes = 3 if l3_in is None else 5
    e = RANGE_ENTRIES_PER_BUCKET
    if nlive == 0:
        return np.zeros((1, planes * e), np.uint32), ()
    plens = tuple(sorted({int(p) for p in plen[live]}, reverse=True))
    if len(plens) > RANGE_CLASS_MAX:
        return None, ()
    w0 = (base[live] & mask[live]).astype(np.uint32)
    w1 = plen[live].astype(np.uint32)
    cols = [w0, w1, value[live].astype(np.uint32)]
    if planes == 5:
        cols += [l3_in[live].astype(np.uint32), l3_out[live].astype(np.uint32)]
    h = _fnv1a_host(np.stack([w0, w1], axis=1))
    n_rows = 8
    while n_rows * e < 2 * nlive:
        n_rows <<= 1
    while True:
        b = (h & np.uint32(n_rows - 1)).astype(np.int64)
        if np.bincount(b, minlength=n_rows).max() <= e:
            break
        n_rows <<= 1
        if n_rows > (1 << 16):  # pathological collisions
            return None, ()
    rows = np.zeros((n_rows, planes * e), np.uint32)
    fill = np.zeros(n_rows, np.int64)
    for i in range(nlive):
        r = int(b[i])
        k = int(fill[r])
        fill[r] = k + 1
        for p, col in enumerate(cols):
            rows[r, p * e + k] = col[i]
    return rows, plens


def _trim_ip_stash(stash: np.ndarray, fill: int) -> np.ndarray:
    return trim_pow2_prefix(stash, fill)


def build_ipcache(prefix_to_id: Dict[str, int]):
    """Lower {ipv4 cidr -> identity} to the bucketized form, or to
    DIR-24-8 (LPMTables) past MAX_RANGES non-/32 prefixes."""
    exact_map: Dict[int, int] = {}
    range_map: Dict[Tuple[int, int], int] = {}
    for cidr, num_id in prefix_to_id.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        if num_id >= 1 << 31:
            raise ValueError(f"identity {num_id} exceeds 31-bit LPM range")
        base_addr = int(net.network_address)
        if net.prefixlen == 32:
            prev = exact_map.get(base_addr)
            exact_map[base_addr] = num_id if prev is None else max(prev, num_id)
        else:
            key = (net.prefixlen, base_addr)
            prev = range_map.get(key)
            range_map[key] = num_id if prev is None else max(prev, num_id)
    exact = sorted(exact_map.items())
    ranges = [
        (base_addr, int(0xFFFFFFFF << (32 - pl)) & 0xFFFFFFFF if pl else 0,
         pl, num_id)
        for (pl, base_addr), num_id in sorted(range_map.items())
    ]
    if len(ranges) > MAX_RANGES:
        return build_lpm(prefix_to_id)
    nb = 16
    while nb * 16 < max(len(exact), 1):
        nb *= 2
    buckets = np.zeros((nb, 128), dtype=np.uint32)
    buckets[:, :IP_ENTRIES_PER_BUCKET] = _EMPTY_IP
    stash = np.zeros((IP_STASH, 2), dtype=np.uint32)
    stash[:, 0] = _EMPTY_IP
    fill = [0] * nb
    stash_fill = 0
    if exact:
        ips = np.array([ip for ip, _ in exact], dtype=np.uint32)
        hashes = _fnv1a_host(ips[:, None])
        for (ip, num_id), h in zip(exact, hashes):
            b = int(h) & (nb - 1)
            if fill[b] < IP_ENTRIES_PER_BUCKET:
                buckets[b, fill[b]] = ip
                buckets[b, IP_ENTRIES_PER_BUCKET + fill[b]] = num_id
                fill[b] += 1
            elif stash_fill < IP_STASH:
                stash[stash_fill] = (ip, num_id)
                stash_fill += 1
            else:
                raise ValueError("ipcache bucket and stash overflow")
    p = 8
    while p < len(ranges):
        p *= 2
    base = np.ones(p, dtype=np.uint32)  # base 1 & mask 0: unmatchable
    mask = np.zeros(p, dtype=np.uint32)
    plen = np.zeros(p, dtype=np.uint32)
    value = np.zeros(p, dtype=np.uint32)
    for i, (b_, m_, l_, v_) in enumerate(ranges):
        base[i], mask[i], plen[i], value[i] = b_, m_, l_ + 1, v_
    rrows, rplens = _build_range_rows(base, mask, plen, value)
    return IPCacheDevice(
        buckets=buckets,
        stash=_trim_ip_stash(stash, stash_fill),
        range_base=base,
        range_mask=mask,
        range_plen=plen,
        range_value=value,
        n_buckets=nb,
        range_rows=rrows,
        range_class_plens=rplens,
    )


def specialize_ipcache_to_idx(dev, policy_tables):
    """Map every stored identity through the policy tables' direct
    index: values become idx + 1 (0 stays 0, identities outside the
    universe become UNKNOWN_IDX).  With at most 32 endpoints entries
    also carry per-endpoint L3-only allow bitmasks; past 32 the
    buckets keep the generic 64 x 2 layout with idx values.  A
    DIR-24-8 input is returned unchanged."""
    if not isinstance(dev, IPCacheDevice):
        return dev
    from cilium_tpu_torch.compiler.tables import (
        LOCAL_ID_BASE,
        NO_INDEX,
        RESERVED_WORLD,
    )

    id_direct = np.asarray(policy_tables.id_direct)
    lo_len = int(policy_tables.id_lo_len)
    l3_bits = np.asarray(policy_tables.l3_allow_bits)  # [E, 2, W]
    e_count = l3_bits.shape[0]
    with_l3 = e_count <= 32

    def to_idx_plus1(vals: np.ndarray) -> np.ndarray:
        v = vals.astype(np.int64)
        pos = np.where(v >= LOCAL_ID_BASE, lo_len + v - LOCAL_ID_BASE, v)
        ok = (pos >= 0) & (pos < len(id_direct)) & (v > 0)
        idx = np.full(vals.shape, UNKNOWN_IDX, dtype=np.uint32)
        idx[v == 0] = 0
        got = id_direct[np.clip(pos, 0, len(id_direct) - 1)]
        ok &= got != NO_INDEX
        idx[ok] = got[ok] + 1
        return idx

    def l3_words(idx_plus1: np.ndarray):
        idx_plus1 = np.where(idx_plus1 == UNKNOWN_IDX, 0, idx_plus1).astype(
            np.uint32
        )
        idx = np.maximum(idx_plus1.astype(np.int64), 1) - 1
        word = idx >> 5
        bit = (idx & 31).astype(np.uint32)
        bits = (l3_bits[:, :, word] >> bit) & 1
        weights = (np.uint32(1) << np.arange(e_count, dtype=np.uint32))[
            :, None, None
        ]
        packed = (bits.astype(np.uint32) * weights).sum(axis=0, dtype=np.uint32)
        known = idx_plus1 > 0
        return (
            np.where(known, packed[0], 0).astype(np.uint32),
            np.where(known, packed[1], 0).astype(np.uint32),
        )

    e = IP_ENTRIES_PER_BUCKET
    ips = np.concatenate([dev.buckets[:, :e].reshape(-1), dev.stash[:, 0]])
    vals = np.concatenate(
        [dev.buckets[:, e : 2 * e].reshape(-1), dev.stash[:, 1]]
    )
    live = ips != _EMPTY_IP
    ips, vals = ips[live], to_idx_plus1(vals[live])
    world = int(to_idx_plus1(np.array([RESERVED_WORLD], np.uint32))[0])
    if world == int(UNKNOWN_IDX):
        world = 0
    range_value = to_idx_plus1(dev.range_value)
    hs = _fnv1a_host(ips[:, None].astype(np.uint32))

    if not with_l3:
        buckets = np.zeros_like(dev.buckets)
        buckets[:, :e] = _EMPTY_IP
        stash = np.zeros((IP_STASH, 2), dtype=np.uint32)
        stash[:, 0] = _EMPTY_IP
        nb = dev.n_buckets
        fill = [0] * nb
        sfill = 0
        for ip, v, h in zip(ips, vals, hs):
            b = int(h) & (nb - 1)
            if fill[b] < e:
                buckets[b, fill[b]] = ip
                buckets[b, e + fill[b]] = v
                fill[b] += 1
            else:
                stash[sfill] = (ip, v)
                sfill += 1
        rrows, rplens = _build_range_rows(
            dev.range_base, dev.range_mask, dev.range_plen, range_value
        )
        return IPCacheDevice(
            buckets=buckets,
            stash=_trim_ip_stash(stash, sfill),
            range_base=dev.range_base,
            range_mask=dev.range_mask,
            range_plen=dev.range_plen,
            range_value=range_value,
            n_buckets=nb,
            values_are_idx=True,
            world_plus1=world,
            range_rows=rrows,
            range_class_plens=rplens,
        )

    l3i, l3o = l3_words(vals)
    per = 32
    nb = 16
    while nb * 8 < max(len(ips), 1):
        nb *= 2
    buckets = np.zeros((nb, 128), dtype=np.uint32)
    buckets[:, :per] = _EMPTY_IP
    stash = np.zeros((IP_STASH, 4), dtype=np.uint32)
    stash[:, 0] = _EMPTY_IP
    fill = [0] * nb
    sfill = 0
    for ip, v, li, lo, h in zip(ips, vals, l3i, l3o, hs):
        b = int(h) & (nb - 1)
        if fill[b] < per:
            i = fill[b]
            buckets[b, i] = ip
            buckets[b, per + i] = v
            buckets[b, 2 * per + i] = li
            buckets[b, 3 * per + i] = lo
            fill[b] += 1
        elif sfill < IP_STASH:
            stash[sfill] = (ip, v, li, lo)
            sfill += 1
        else:
            raise ValueError("ipcache bucket and stash overflow")
    r_l3i, r_l3o = l3_words(range_value)
    w_l3i, w_l3o = l3_words(np.array([world], np.uint32))
    rrows, rplens = _build_range_rows(
        dev.range_base, dev.range_mask, dev.range_plen, range_value,
        l3_in=r_l3i, l3_out=r_l3o,
    )
    return IPCacheDevice(
        buckets=buckets,
        stash=_trim_ip_stash(stash, sfill),
        range_base=dev.range_base,
        range_mask=dev.range_mask,
        range_plen=dev.range_plen,
        range_value=range_value,
        n_buckets=nb,
        values_are_idx=True,
        world_plus1=world,
        l3_planes=True,
        world_l3_in=int(w_l3i[0]),
        world_l3_out=int(w_l3o[0]),
        range_l3_in=r_l3i,
        range_l3_out=r_l3o,
        range_rows=rrows,
        range_class_plens=rplens,
    )


def subword_ipcache(dev: IPCacheDevice) -> IPCacheDevice:
    """Re-place an idx-form ipcache in the sub-word layout: values at
    16 bits when the universe allows (UNKNOWN_IDX remapped to 0xFFFF),
    L3 words at the narrowest width their values need, range rows
    repacked the same way.  The stash keeps u32 columns."""
    if not isinstance(dev, IPCacheDevice) or not dev.values_are_idx:
        return dev
    if dev.bucket_entries:
        return dev
    per_old = 32 if dev.l3_planes else IP_ENTRIES_PER_BUCKET
    ips = dev.buckets[:, :per_old].reshape(-1)
    vals = dev.buckets[:, per_old : 2 * per_old].reshape(-1)
    live = ips != _EMPTY_IP
    cols = [ips[live], vals[live]]
    if dev.l3_planes:
        cols.append(dev.buckets[:, 2 * per_old : 3 * per_old].reshape(-1)[live])
        cols.append(dev.buckets[:, 3 * per_old : 4 * per_old].reshape(-1)[live])
    s = dev.stash
    s_live = s[:, 0] != _EMPTY_IP
    cols[0] = np.concatenate([cols[0], s[s_live, 0]])
    cols[1] = np.concatenate([cols[1], s[s_live, 1]])
    if dev.l3_planes:
        cols[2] = np.concatenate([cols[2], s[s_live, 2]])
        cols[3] = np.concatenate([cols[3], s[s_live, 3]])

    real = cols[1] != UNKNOWN_IDX
    vmax = int(cols[1][real].max()) if real.any() else 0
    vmax = max(vmax, int(dev.world_plus1))
    rv_real = dev.range_value != UNKNOWN_IDX
    if rv_real.any():
        vmax = max(vmax, int(dev.range_value[rv_real].max()))
    value_width = 16 if vmax < int(_VAL16_UNKNOWN) else 32
    l3_width = 32
    if dev.l3_planes:
        l3_max = max(
            int(cols[2].max()) if len(cols[2]) else 0,
            int(cols[3].max()) if len(cols[3]) else 0,
            int(dev.world_l3_in), int(dev.world_l3_out),
            int(dev.range_l3_in.max()) if dev.range_l3_in is not None
            and len(dev.range_l3_in) else 0,
            int(dev.range_l3_out.max()) if dev.range_l3_out is not None
            and len(dev.range_l3_out) else 0,
        )
        l3_width = sw.width_for_max(l3_max, floor=4)

    def enc_val(v):
        if value_width == 32:
            return np.uint32(v)
        return _VAL16_UNKNOWN if v == UNKNOWN_IDX else np.uint32(v)

    per = SUBWORD_IP_L3_ENTRIES if dev.l3_planes else SUBWORD_IP_ENTRIES
    nb = 16
    while nb * 4 < max(len(cols[0]), 1):
        nb *= 2
    b_ips = np.full((nb, per), _EMPTY_IP, np.uint32)
    b_val = np.zeros((nb, per), np.uint32)
    b_l3i = np.zeros((nb, per), np.uint32)
    b_l3o = np.zeros((nb, per), np.uint32)
    stash = np.zeros((IP_STASH, 4 if dev.l3_planes else 2), np.uint32)
    stash[:, 0] = _EMPTY_IP
    fill = np.zeros(nb, np.int64)
    sfill = 0
    hs = _fnv1a_host(cols[0][:, None].astype(np.uint32))
    for i in range(len(cols[0])):
        b = int(hs[i]) & (nb - 1)
        k = int(fill[b])
        if k < per:
            b_ips[b, k] = cols[0][i]
            b_val[b, k] = enc_val(cols[1][i])
            if dev.l3_planes:
                b_l3i[b, k] = cols[2][i]
                b_l3o[b, k] = cols[3][i]
            fill[b] = k + 1
        elif sfill < IP_STASH:
            if dev.l3_planes:
                stash[sfill] = (cols[0][i], cols[1][i], cols[2][i], cols[3][i])
            else:
                stash[sfill] = (cols[0][i], cols[1][i])
            sfill += 1
        else:
            raise ValueError("sub-word ipcache bucket/stash overflow")
    planes = [b_ips, sw.pack_lanes(b_val, value_width)]
    if dev.l3_planes:
        planes.append(sw.pack_lanes(b_l3i, l3_width))
        planes.append(sw.pack_lanes(b_l3o, l3_width))
    buckets = np.concatenate(planes, axis=1)

    rrows = dev.range_rows
    rw: tuple = ()
    if rrows is not None and len(dev.range_class_plens):
        e = RANGE_ENTRIES_PER_BUCKET
        n_planes = 5 if dev.l3_planes else 3
        plane_widths = [32, 8, value_width] + (
            [l3_width, l3_width] if dev.l3_planes else []
        )
        packed = []
        for p in range(n_planes):
            plane = rrows[:, p * e : (p + 1) * e]
            if p == 2 and value_width == 16:
                plane = np.where(
                    plane == UNKNOWN_IDX, _VAL16_UNKNOWN, plane
                ).astype(np.uint32)
            packed.append(sw.pack_lanes(plane, plane_widths[p]))
        rrows = np.concatenate(packed, axis=1)
        rw = tuple(plane_widths)

    return dataclasses.replace(
        dev,
        buckets=buckets,
        stash=_trim_ip_stash(stash, sfill),
        n_buckets=nb,
        range_rows=rrows,
        bucket_entries=per,
        value_width=value_width,
        l3_width=l3_width,
        range_widths=rw,
    )


# -- plain device lookup (int64 tensors holding u32 values) ------------------


def _msum(hit, vals):
    return torch.where(hit, vals, 0).sum(dim=1) & 0xFFFFFFFF


def range_class_key(ips, sp: int):
    """(masked ips, row hash) of one range-length-class probe."""
    raw = int(sp) - 1
    m = (0xFFFFFFFF << (32 - raw)) & 0xFFFFFFFF if raw else 0
    w0 = ips & m
    h = fnv1a(torch.stack([w0, torch.full_like(w0, int(sp))], dim=1))
    return w0, h


def range_row_parts(row, w0, sp: int, planes: int, owns=None, widths=()):
    """Lane compares of one fetched range-class row of `planes` planes
    (base, plen, value, then with 5 the l3_in and l3_out words), with an
    optional ownership mask `owns` bool [B] (the routed mesh probe: a
    shard that does not own the row contributes zeros).  Returns (hit,
    val, l3_in, l3_out); the L3 sums are zero with 3."""
    zero = torch.zeros_like(w0)
    if not widths:
        e = row.shape[1] // planes
        r = widen(row)
        hit = (r[:, :e] == w0[:, None]) & (r[:, e : 2 * e] == int(sp))
        if owns is not None:
            hit = hit & owns[:, None]

        def msum(p):
            return _msum(hit, r[:, p * e : (p + 1) * e]) if p < planes else zero

        return hit.any(dim=1), msum(2), msum(3), msum(4)
    e = RANGE_ENTRIES_PER_BUCKET
    offs = []
    off = 0
    for wdt in widths:
        offs.append(off)
        off += sw.lanes_for(e, wdt)

    def plane(p):
        lanes = sw.lanes_for(e, widths[p])
        return sw.unpack_lanes(row[:, offs[p] : offs[p] + lanes], widths[p], e)

    hit = (widen(row[:, :e]) == w0[:, None]) & (plane(1) == int(sp))
    if owns is not None:
        hit = hit & owns[:, None]
    found = hit.any(dim=1)
    val = _msum(hit, plane(2))
    if widths[2] == 16:
        val = torch.where(
            found & (val == int(_VAL16_UNKNOWN)), int(UNKNOWN_IDX), val
        )
    if len(widths) < 5:
        return found, val, zero, zero
    return found, val, _msum(hit, plane(3)), _msum(hit, plane(4))


def range_take_fold(classes, like):
    """Longest-first selection over per-class (hit, val, l3i, l3o)."""
    found = torch.zeros_like(like, dtype=torch.bool)
    val = torch.zeros_like(like)
    l3i = torch.zeros_like(like)
    l3o = torch.zeros_like(like)
    for hitc, v, li, lo in classes:
        take = hitc & ~found
        val = torch.where(take, v, val)
        l3i = torch.where(take, li, l3i)
        l3o = torch.where(take, lo, l3o)
        found = found | hitc
    return found, val, l3i, l3o


def _range_hash_probe(dev: IPCacheDevice, ips):
    """One row read + lane compares per distinct prefix length,
    longest first.  Returns (found, value, l3_in, l3_out)."""
    n_rows = dev.range_rows.shape[0]
    planes = 5 if dev.l3_planes else 3
    classes = []
    for sp in dev.range_class_plens:
        w0, h = range_class_key(ips, sp)
        row = dev.range_rows[h & (n_rows - 1)]
        classes.append(range_row_parts(row, w0, sp, planes,
                                       widths=dev.range_widths))
    return range_take_fold(classes, ips)


def ipcache_bucket_parts(dev: IPCacheDevice, rows, ips, ingress=None,
                         owns=None):
    """Exact-/32 parts from fetched bucket rows, any layout: (found,
    val, l3 selected by `ingress`; zeros without L3 planes).  `owns`
    bool [B] masks the rows another shard owns (the routed mesh probe:
    their flows get zeros)."""
    sub = bool(dev.bucket_entries)
    per = (dev.bucket_entries if sub
           else (32 if dev.l3_planes else IP_ENTRIES_PER_BUCKET))
    hit = widen(rows[:, :per]) == ips[:, None]
    if owns is not None:
        hit = hit & owns[:, None]
    found = hit.any(dim=1)
    if not sub:
        val = _msum(hit, widen(rows[:, per : 2 * per]))
        if not dev.l3_planes:
            return found, val, torch.zeros_like(ips)
        l3_plane = torch.where(
            ingress[:, None],
            widen(rows[:, 2 * per : 3 * per]),
            widen(rows[:, 3 * per : 4 * per]),
        )
        return found, val, _msum(hit, l3_plane)
    vw, lw = dev.value_width, dev.l3_width
    lanes_v = sw.lanes_for(per, vw)
    val = _msum(hit, sw.unpack_lanes(rows[:, per : per + lanes_v], vw, per))
    if vw == 16:
        val = torch.where(
            found & (val == int(_VAL16_UNKNOWN)), int(UNKNOWN_IDX), val
        )
    if not dev.l3_planes:
        return found, val, torch.zeros_like(ips)
    off = per + lanes_v
    lanes_l = sw.lanes_for(per, lw)
    l3i = sw.unpack_lanes(rows[:, off : off + lanes_l], lw, per)
    l3o = sw.unpack_lanes(rows[:, off + lanes_l : off + 2 * lanes_l], lw, per)
    return found, val, _msum(hit, torch.where(ingress[:, None], l3i, l3o))


def ipcache_stash_parts(dev: IPCacheDevice, ips, ingress=None):
    stash = widen(dev.stash)
    s_hit = stash[None, :, 0] == ips[:, None]

    def ssum(col):
        return _msum(s_hit, stash[None, :, col])

    l3 = (torch.where(ingress, ssum(2), ssum(3)) if dev.l3_planes
          else torch.zeros_like(ips))
    return s_hit.any(dim=1), ssum(1), l3


# rows of one [B, P] scan chunk: at most 2^24 compares held at once
_SCAN_CELLS = 1 << 24


def _range_scan(dev: IPCacheDevice, ips):
    """The [B, P] scan of a table without range classes: every range
    compared, the longest match kept (plen stored + 1, so padding never
    wins) and the u32 masked sums taken at the winning length (ranges
    of one length never overlap).  Chunked over the addresses so the
    compares stay bounded.  Returns (found, value, l3_in, l3_out)."""
    base, mask = widen(dev.range_base), widen(dev.range_mask)
    plen, value = widen(dev.range_plen), widen(dev.range_value)
    l3 = dev.l3_planes
    if l3:
        r_l3i, r_l3o = widen(dev.range_l3_in), widen(dev.range_l3_out)
    step = max(1, _SCAN_CELLS // max(int(plen.shape[0]), 1))
    parts = []
    for s in range(0, max(int(ips.shape[0]), 1), step):
        x = ips[s : s + step]
        match = (x[:, None] & mask[None, :]) == base[None, :]
        best = torch.where(match, plen[None, :], 0).amax(dim=1)
        sel = match & (plen[None, :] == best[:, None])
        zero = torch.zeros_like(x)
        parts.append((
            best > 0,
            _msum(sel, value[None, :]),
            _msum(sel, r_l3i[None, :]) if l3 else zero,
            _msum(sel, r_l3o[None, :]) if l3 else zero,
        ))
    return tuple(torch.cat(c) for c in zip(*parts))


def ipcache_lookup_fused(dev: IPCacheDevice, ips, ingress=None):
    """One bucket row read + stash, then the range classes (or the
    [B, P] scan without them).  Returns (value int64 (0 = miss),
    l3_word int64 or None): the L3 word of the `ingress` (bool [B])
    plane where the table carries L3 planes, else None."""
    ips = widen(ips)
    h = fnv1a(ips[:, None])
    rows = dev.buckets[h & (dev.n_buckets - 1)]
    b_found, b_val, b_l3 = ipcache_bucket_parts(dev, rows, ips, ingress)
    s_found, s_val, s_l3 = ipcache_stash_parts(dev, ips, ingress)
    exact_found = b_found | s_found
    exact_val = (b_val + s_val) & 0xFFFFFFFF
    if dev.range_rows is not None:
        range_found, range_val, r_l3i, r_l3o = _range_hash_probe(dev, ips)
    else:
        range_found, range_val, r_l3i, r_l3o = _range_scan(dev, ips)
    value = torch.where(
        exact_found, exact_val, torch.where(range_found, range_val, 0)
    )
    if not dev.l3_planes:
        return value, None
    l3_exact = (b_l3 + s_l3) & 0xFFFFFFFF
    l3_range = torch.where(ingress, r_l3i, r_l3o)
    l3 = torch.where(
        exact_found, l3_exact, torch.where(range_found, l3_range, 0)
    )
    return value, l3


def lookup_plain(tables, ips) -> torch.Tensor:
    """Plain version of the reference's generic `_lookup_kernel`: ips
    [B] (u32 bits) -> values int64 [B] holding u32 (0 = no entry), from
    an IPCacheDevice of any form (the ingress L3 plane where there are
    planes; only the value is returned) or from DIR-24-8 LPMTables."""
    if isinstance(tables, IPCacheDevice):
        ips = widen(ips)
        ingress = torch.ones(ips.shape, dtype=torch.bool, device=ips.device)
        return ipcache_lookup_fused(tables, ips, ingress)[0]
    return lpm_lookup_plain(tables, ips)


class LPMBuilder:
    """IPCache listener accumulating the listener-visible CIDR→identity
    view and lowering it to device tables — the analog of the
    BPFListener keeping `cilium_ipcache` in sync
    (pkg/datapath/ipcache/listener.go:78)."""

    def __init__(self) -> None:
        self.mappings: Dict[str, int] = {}
        self._dirty = True
        self._tables: Optional[LPMTables] = None

    def __call__(
        self,
        modification: str,
        cidr: str,
        old_host_ip,
        new_host_ip,
        old_id,
        new_id: int,
    ) -> None:
        if modification == "upsert":
            self.mappings[cidr] = new_id
        else:
            self.mappings.pop(cidr, None)
        self._dirty = True

    def tables(self):
        if self._dirty or self._tables is None:
            self._tables = build_ipcache(self.mappings)
            self._dirty = False
        return self._tables
