"""Device load balancer for IPv6: the inline rows and the plain select.

The v4 inline layout (lb/device.py) generalised limb for limb, as
bpf/lib/lb.h's lb6_* functions mirror lb4_*: one 128-lane row per
bucket holds two 64-lane service slots, each carrying the service key
and its backends, so one row read resolves the service and the chosen
backend.

Slot layout (64 lanes):
  lanes [0, 4)    vip limbs (big-endian u32 limbs)
  lane  4         dport << 16 | proto
  lane  5         rev_nat << 16 | backend count
  lanes [6, 8)    pad
  lanes [8, 56)   backend address limbs, limb-planar: lanes
                  [8 + 12k, 8 + 12k + 12) hold limb k of backends 0..11
  lanes [56, 62)  backend ports, two per lane (low half = even)
At most 12 backends a service (INLINE6_MAX_BACKENDS); a small stash of
slots takes the rows' overflow, shipped at its occupied pow2 prefix.

The select sums, it does not stop at a first hit: the slot is the u32
sum, lane by lane, of every matching row half and stash slot.  The
flow hash builds its port word as `sport << 16 | dport` without
masking dport, while the service key masks it; the host oracle
`slave_for_host` masks both, so the two disagree for ports of 65,536
or more, and the device select is the one the datapath follows.
`lb6_select_batch` is the plain PyTorch version; DATAPATH6
(csrc/lb6.cuh) runs it on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cilium_tpu_torch.device import MASK32, widen
from cilium_tpu_torch.engine.hashtable import (
    _fnv1a_host,
    fnv1a,
    trim_pow2_prefix,
)
from cilium_tpu_torch.ipcache.lpm6 import ip6_limbs
from cilium_tpu_torch.lb.service import L3n4Addr, ServiceManager

INLINE6_MAX_BACKENDS = 12
INLINE6_SLOT = 64
INLINE6_STASH = 8
_EMPTY_KEY = np.uint32(0xFFFFFFFF)  # dport << 16 | proto plane marker


@dataclass
class LB6Inline:
    """v6 inline service rows and their small stash."""

    rows: object  # u32 [R, 128]
    stash: object  # u32 [S, 64]
    n_buckets: int


def _is_v6(ip: str) -> bool:
    return ":" in ip


def _svc_slot6(svc) -> np.ndarray:
    slot = np.zeros(INLINE6_SLOT, dtype=np.uint32)
    slot[0:4] = ip6_limbs(svc.frontend.ip)
    slot[4] = ((svc.frontend.port & 0xFFFF) << 16) | (
        svc.frontend.protocol & 0xFF
    )
    slot[5] = ((svc.id & 0xFFFF) << 16) | (len(svc.backends) & 0xFFFF)
    for j, backend in enumerate(svc.backends):
        limbs = ip6_limbs(backend.addr.ip)
        for k in range(4):
            slot[8 + 12 * k + j] = limbs[k]
        slot[56 + (j >> 1)] |= np.uint32(
            (backend.addr.port & 0xFFFF) << (16 * (j & 1))
        )
    return slot


def compile_lb6(mgr: ServiceManager) -> LB6Inline:
    """Compile the manager's v6 services (v4 frontends are
    compile_lb_inline's, as the reference keeps lb4 and lb6 maps
    apart).  Raises on a service with more than 12 backends or a v4
    backend."""
    services = sorted(
        (s for s in mgr.by_frontend.values() if _is_v6(s.frontend.ip)),
        key=lambda s: s.id,
    )
    for svc in services:
        if len(svc.backends) > INLINE6_MAX_BACKENDS:
            raise ValueError(
                f"v6 service {svc.frontend} exceeds "
                f"{INLINE6_MAX_BACKENDS} backends"
            )
        if any(not _is_v6(b.addr.ip) for b in svc.backends):
            raise ValueError("v6 service with v4 backend (NAT46 scope)")
    nb = 16
    while nb < len(services):
        nb *= 2
    nb_cap = max(nb * 64, 1 << 12)
    while nb <= nb_cap:
        rows = np.zeros((nb, 128), dtype=np.uint32)
        rows[:, 4] = _EMPTY_KEY
        rows[:, INLINE6_SLOT + 4] = _EMPTY_KEY
        stash = np.zeros((INLINE6_STASH, INLINE6_SLOT), dtype=np.uint32)
        stash[:, 4] = _EMPTY_KEY
        fill = [0] * nb
        sfill = 0
        ok = True
        for svc in services:
            w4 = ((svc.frontend.port & 0xFFFF) << 16) | (
                svc.frontend.protocol & 0xFF
            )
            words = np.array([[*ip6_limbs(svc.frontend.ip), w4]],
                             dtype=np.uint32)
            b = int(_fnv1a_host(words)[0]) & (nb - 1)
            if fill[b] < 2:
                lo = fill[b] * INLINE6_SLOT
                rows[b, lo : lo + INLINE6_SLOT] = _svc_slot6(svc)
                fill[b] += 1
            elif sfill < INLINE6_STASH:
                stash[sfill] = _svc_slot6(svc)
                sfill += 1
            else:
                ok = False
                break
        if ok:
            return LB6Inline(rows=rows, stash=trim_pow2_prefix(stash, sfill),
                             n_buckets=nb)
        nb *= 2
    raise ValueError("LB6 bucket overflow (pathological collisions)")


def flow_hash6(saddr, daddr, sport, dport, proto) -> torch.Tensor:
    """Plain version of the v6 flow hash (FNV-1a over the limb tuple,
    `sport << 16 | dport` with dport unmasked, and the proto word),
    int64 holding the u32 hash."""
    words = torch.cat([
        widen(saddr),
        widen(daddr),
        (((widen(sport) << 16) & MASK32) | widen(dport))[:, None],
        widen(proto)[:, None],
    ], dim=1)
    return fnv1a(words)


def lb6_select_batch(tables: LB6Inline, saddr, daddr, sport, dport, proto,
                     ct_slave=None):
    """Plain version of the v6 service select.  saddr, daddr [B, 4]
    (u32 bits); sport, dport, proto [B] as int32 values.  Returns
    (is_service bool, slave int64, new_daddr int64 [B, 4] holding u32
    limbs, new_dport int64, rev_nat int64).  A flow that finds no
    service (or one with no backends) keeps its daddr and dport, with
    slave and rev_nat 0."""
    vip = widen(daddr)
    w4 = ((widen(dport) & 0xFFFF) << 16) | (widen(proto) & 0xFF)
    h = fnv1a(torch.cat([vip, w4[:, None]], dim=1))
    half = widen(tables.rows[h & (tables.n_buckets - 1)]).reshape(
        -1, 2, INLINE6_SLOT)
    hit2 = half[:, :, 4] == w4[:, None]
    for k in range(4):
        hit2 &= half[:, :, k] == vip[:, k : k + 1]
    stash = widen(tables.stash)  # [S, 64]
    s_hit = stash[None, :, 4] == w4[:, None]
    for k in range(4):
        s_hit &= stash[None, :, k] == vip[:, k : k + 1]
    slot = (
        torch.where(hit2[:, :, None], half, 0).sum(dim=1)
        + torch.where(s_hit[:, :, None], stash[None, :, :], 0).sum(dim=1)
    ) & MASK32  # [B, 64]
    found = hit2.any(dim=1) | s_hit.any(dim=1)

    meta = slot[:, 5]
    count = meta & 0xFFFF
    rev_nat = meta >> 16
    found = found & (count > 0)
    fh = flow_hash6(saddr, daddr, sport, dport, proto)
    slave = fh % count.clamp(min=1) + 1
    if ct_slave is not None:
        ct_slave = ct_slave.to(torch.int64)
        reuse = (ct_slave > 0) & (ct_slave <= count)
        slave = torch.where(reuse, ct_slave, slave)

    k_sel = slave - 1
    lane = torch.arange(INLINE6_MAX_BACKENDS, device=slot.device)
    pick = lane[None, :] == k_sel[:, None]  # [B, 12]
    new_daddr = torch.stack([
        torch.where(pick, slot[:, 8 + 12 * k : 20 + 12 * k], 0).sum(dim=1)
        & MASK32
        for k in range(4)
    ], dim=1)
    plane = torch.arange(INLINE6_MAX_BACKENDS // 2, device=slot.device)
    port_pick = plane[None, :] == (k_sel >> 1)[:, None]
    port_pair = torch.where(port_pick, slot[:, 56:62], 0).sum(dim=1) & MASK32
    new_dport = (port_pair >> (16 * (k_sel & 1))) & 0xFFFF

    new_daddr = torch.where(found[:, None], new_daddr, vip)
    new_dport = torch.where(found, new_dport, dport.to(torch.int64))
    rev_nat = torch.where(found, rev_nat, 0)
    slave = torch.where(found, slave, 0)
    return found, slave, new_daddr, new_dport, rev_nat


def lb6_lookup_host(mgr: ServiceManager, daddr: str, dport: int,
                    proto: int):
    """Host lb6_lookup_service (the oracle)."""
    return mgr.lookup(L3n4Addr(daddr, dport, proto))


def slave_for_host(svc, saddr: str, daddr: str, sport: int, dport: int,
                   proto: int) -> int:
    """Host hashed slave selection (the oracle; it masks both ports)."""
    words = np.array(
        [[
            *ip6_limbs(saddr),
            *ip6_limbs(daddr),
            ((sport & 0xFFFF) << 16) | (dport & 0xFFFF),
            proto & 0xFF,
        ]],
        dtype=np.uint32,
    )
    return (int(_fnv1a_host(words)[0]) % len(svc.backends)) + 1
