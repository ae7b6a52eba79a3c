"""IPv6 ipcache: limb-masked longest-prefix match.

The reference's ipcache is dual-stack (bpf/lib/eps.h ipcache_lookup6);
rule_validation.go bounds the distinct prefix lengths at 40.  So the
v6 form keeps its ranges few: each prefix shorter than /128 is a
(base limbs, mask limbs, plen, value) row that every address compares
against, 4 u32 limb compares per range; the /128 population (the
endpoints) lives in hashed bucket rows, one row read per address, plus
a 128-row stash.

Bucket row layout (planar, 25 entries x 5 words): lanes [25k, 25k + 25)
hold word k, limbs 0..3 of each entry's address, then its value.  An
empty lane is all-ones in every limb plane (value 0), and so is an
empty stash row: the all-ones /128 cannot be cached, but a probe of
ff..ff exact-hits every empty lane with a value of 0, which shadows any
covering range.  `ffff:ffff::` does not.

Lookups sum, they do not stop at a first hit: the exact value is the
u32 sum over every matching lane and stash row, and the range value the
sum over every matching range whose stored length (plen + 1; 0 marks
padding) equals the best one.  `ipcache6_lookup` is the plain PyTorch
version; the DATAPATH6 kernel (csrc/ipcache6.cuh) runs the same
lookup on the card.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import MASK32, widen
from cilium_tpu_torch.engine.hashtable import _fnv1a_host, fnv1a

V6_ENTRIES_PER_BUCKET = 25
V6_STASH = 128
MAX_RANGES6 = 512
_EMPTY_LIMB = np.uint32(0xFFFFFFFF)


def limbs_of_int(raw: int) -> Tuple[int, int, int, int]:
    """128-bit int -> 4 big-endian u32 limbs (shared by every v6 table
    builder)."""
    return (
        (raw >> 96) & 0xFFFFFFFF,
        (raw >> 64) & 0xFFFFFFFF,
        (raw >> 32) & 0xFFFFFFFF,
        raw & 0xFFFFFFFF,
    )


def ip6_limbs(ip: str) -> Tuple[int, int, int, int]:
    """IPv6 address -> 4 big-endian u32 limbs."""
    return limbs_of_int(int(ipaddress.IPv6Address(ip)))


def int_of_limbs(limbs) -> int:
    """4 big-endian u32 limbs -> the 128-bit int."""
    v = 0
    for k in range(4):
        v = (v << 32) | (int(limbs[k]) & 0xFFFFFFFF)
    return v


def build_limb_ranges(nets):
    """[(base limbs, mask limbs)] -> pow2-padded (base, mask) u32
    [P, 4] arrays; padding rows (base limb0 = 1, mask 0) never match.
    Shared by the ipcache ranges, prefilter6 and the v6 tunnel map."""
    p = 8
    while p < len(nets):
        p *= 2
    base = np.zeros((p, 4), dtype=np.uint32)
    base[:, 0] = 1
    mask = np.zeros((p, 4), dtype=np.uint32)
    for i, (b, m) in enumerate(nets):
        base[i] = b
        mask[i] = m
    return base, mask


def _mask_limbs(plen: int) -> Tuple[int, int, int, int]:
    m = ((1 << plen) - 1) << (128 - plen) if plen else 0
    return limbs_of_int(m)


@dataclass
class IPCache6Device:
    """Bucketized /128 rows and the broadcast ranges."""

    buckets: object  # u32 [Cb, 128]
    stash: object  # u32 [S, 5] (limbs 0-3, value)
    range_base: object  # u32 [P, 4]
    range_mask: object  # u32 [P, 4]
    range_plen: object  # u32 [P] (stored +1; 0 = padding)
    range_value: object  # u32 [P]
    n_buckets: int


def build_ipcache6(prefix_to_id: Dict[str, int]) -> IPCache6Device:
    """Lower {ipv6 cidr -> identity}.  /128s bucket by address hash;
    shorter prefixes become broadcast ranges (the longest wins; a
    prefix given twice keeps the larger identity)."""
    exact: Dict[Tuple[int, int, int, int], int] = {}
    range_map: Dict[Tuple[int, Tuple[int, int, int, int]], int] = {}
    for cidr, num_id in prefix_to_id.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 6:
            continue
        if num_id >= 1 << 31:
            raise ValueError(f"identity {num_id} exceeds 31-bit range")
        limbs = ip6_limbs(str(net.network_address))
        if limbs == (_EMPTY_LIMB,) * 4:
            # the empty-lane marker; the reference never maps it either
            raise ValueError("ff..ff/128 cannot be cached")
        if net.prefixlen == 128:
            prev = exact.get(limbs)
            exact[limbs] = num_id if prev is None else max(prev, num_id)
        else:
            key = (net.prefixlen, limbs)
            prev = range_map.get(key)
            range_map[key] = num_id if prev is None else max(prev, num_id)
    if len(range_map) > MAX_RANGES6:
        raise ValueError(
            f"{len(range_map)} v6 ranges exceed MAX_RANGES6 "
            f"({MAX_RANGES6}); the reference bounds distinct prefix "
            f"lengths at 40 (rule_validation.go)"
        )

    nb = 16
    while nb * 8 < max(len(exact), 1):
        nb *= 2
    per = V6_ENTRIES_PER_BUCKET
    buckets = np.zeros((nb, 128), dtype=np.uint32)
    buckets[:, : 4 * per] = _EMPTY_LIMB
    stash = np.zeros((V6_STASH, 5), dtype=np.uint32)
    stash[:, :4] = _EMPTY_LIMB
    fill = [0] * nb
    sfill = 0
    for limbs, num_id in sorted(exact.items()):
        words = np.array([limbs], dtype=np.uint32)
        b = int(_fnv1a_host(words)[0]) & (nb - 1)
        if fill[b] < per:
            i = fill[b]
            for k in range(4):
                buckets[b, k * per + i] = limbs[k]
            buckets[b, 4 * per + i] = num_id
            fill[b] += 1
        elif sfill < V6_STASH:
            stash[sfill] = (*limbs, num_id)
            sfill += 1
        else:
            raise ValueError("v6 ipcache bucket and stash overflow")

    ranges = sorted(range_map.items())
    base, mask = build_limb_ranges(
        [(limbs, _mask_limbs(pl)) for (pl, limbs), _ in ranges]
    )
    plen = np.zeros(base.shape[0], dtype=np.uint32)
    value = np.zeros(base.shape[0], dtype=np.uint32)
    for i, ((pl, _), num_id) in enumerate(ranges):
        plen[i] = pl + 1
        value[i] = num_id
    return IPCache6Device(
        buckets=buckets, stash=stash, range_base=base, range_mask=mask,
        range_plen=plen, range_value=value, n_buckets=nb,
    )


def match_limb_ranges(base, mask, limbs) -> torch.Tensor:
    """Plain version: bool [B, P], the limb-masked prefix match of
    addresses `limbs` [B, 4] (u32 bits, any integer dtype) against
    ranges (base, mask) [P, 4]."""
    lw, rb, rm = widen(limbs), widen(base), widen(mask)
    match = torch.ones((lw.shape[0], rb.shape[0]), dtype=torch.bool,
                       device=lw.device)
    for k in range(4):
        match &= (lw[:, k : k + 1] & rm[None, :, k]) == rb[None, :, k]
    return match


def _msum(hit, vals) -> torch.Tensor:
    return torch.where(hit, vals, 0).sum(dim=1) & MASK32


def ipcache6_lookup(dev: IPCache6Device, limbs) -> torch.Tensor:
    """Plain version: addresses [B, 4] (u32 bits) -> identity, int64
    holding the u32 value (0 = miss).  One bucket row read, the stash,
    then the ranges."""
    lw = widen(limbs)
    h = fnv1a(lw)
    rows = widen(dev.buckets[h & (dev.n_buckets - 1)])  # [B, 128]
    per = V6_ENTRIES_PER_BUCKET
    hit = torch.ones((lw.shape[0], per), dtype=torch.bool, device=lw.device)
    for k in range(4):
        hit &= rows[:, k * per : (k + 1) * per] == lw[:, k : k + 1]
    stash = widen(dev.stash)
    s_hit = torch.ones((lw.shape[0], stash.shape[0]), dtype=torch.bool,
                       device=lw.device)
    for k in range(4):
        s_hit &= stash[None, :, k] == lw[:, k : k + 1]
    exact_found = hit.any(dim=1) | s_hit.any(dim=1)
    exact_val = (
        _msum(hit, rows[:, 4 * per : 5 * per])
        + _msum(s_hit, stash[None, :, 4])
    ) & MASK32

    match = match_limb_ranges(dev.range_base, dev.range_mask, lw)
    plen = widen(dev.range_plen)
    best = torch.where(match, plen[None, :], 0).max(dim=1).values
    range_val = _msum(
        match & (plen[None, :] == best[:, None]),
        widen(dev.range_value)[None, :],
    )
    return torch.where(
        exact_found, exact_val, torch.where(best > 0, range_val, 0)
    )


def lookup_host6(prefix_to_id: Dict[str, int], ip: str) -> int:
    """Host reference LPM for v6 (the oracle): the longest matching
    prefix, the larger identity between equals; 0 when none."""
    addr = ipaddress.ip_address(ip)
    best_len, best_id = -1, 0
    for cidr, num_id in prefix_to_id.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 6:
            continue
        if addr in net and (
            net.prefixlen > best_len
            or (net.prefixlen == best_len and num_id > best_id)
        ):
            best_len, best_id = net.prefixlen, num_id
    return best_id
