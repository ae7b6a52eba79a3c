"""Device load balancer: the service layouts and the plain select.

Semantics of bpf/lib/lb.h: an exact (vip, dport, proto) service match
(lb4_lookup_service), backend `slave = flow_hash % count + 1`
(lb4_select_slave) unless the flow's service-scope conntrack entry
already names a backend (lb4_local), and DNAT of daddr/dport to it;
rev_nat_index is returned for the CT entry.

Inline layout: each 128-lane row holds two 64-lane service slots,
  lane 0 = vip, lane 1 = dport << 16 | proto,
  lane 2 = rev_nat << 16 | backend count, lane 3 = pad,
  lanes [4, 44)  = backend ips (40),
  lanes [44, 64) = backend ports, two per lane (low half = even),
so one row read resolves the service and its backends.  A small stash
of 64-lane slots takes the rows' overflow.

Classic layout (`LBTables`), which `compile_lb` takes for every service
once one has more than INLINE_MAX_BACKENDS backends: bucket rows of
SVC_PER_BUCKET four-word service entries, planar (lanes [32k, 32k+32)
hold word k of entries 0..31),
  w0 vip, w1 dport << 16 | proto, w2 rev_nat << 16 | backend count,
  w3 the service's backend row,
plus a stash of SVC_STASH entries, and one 128-lane backend row per
service: lanes [0, 64) backend ips, lanes [64, 96) backend ports two
per lane (low half = even backend).  A flow reads its bucket row, then
the backend row the entry names: two dependent row reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cilium_tpu_torch.device import widen
from cilium_tpu_torch.engine.hashtable import (
    _fnv1a_host,
    fnv1a,
    trim_pow2_prefix,
)
from cilium_tpu_torch.lb.service import ServiceManager

MAX_BACKENDS = 64
SVC_ENTRY_WORDS = 4
BUCKET_LANES = 128
SVC_PER_BUCKET = BUCKET_LANES // SVC_ENTRY_WORDS  # 32
SVC_STASH = 64
_EMPTY_W1 = np.uint32(0xFFFFFFFF)  # dport<<16|proto can't be all-ones
INLINE_MAX_BACKENDS = 40
INLINE_SLOT = 64
INLINE_STASH = 8


@dataclass
class LBInline:
    """Inline service rows + small stash."""

    rows: object  # u32 [R, 128] — two 64-lane service slots per row
    stash: object  # u32 [S, 64]
    n_buckets: int


@dataclass
class LBTables:
    """Classic layout: service bucket rows + stash + backend rows."""

    buckets: object  # u32 [Cs, 128]
    stash: object  # u32 [SVC_STASH, 4]
    backend_rows: object  # u32 [S, 128]
    n_buckets: int


def _svc_slot(svc) -> np.ndarray:
    """Pack one service into a 64-lane inline slot."""
    slot = np.zeros(INLINE_SLOT, dtype=np.uint32)
    slot[0] = svc.frontend.ip_u32()
    slot[1] = ((svc.frontend.port & 0xFFFF) << 16) | (
        svc.frontend.protocol & 0xFF
    )
    slot[2] = ((svc.id & 0xFFFF) << 16) | (len(svc.backends) & 0xFFFF)
    for j, backend in enumerate(svc.backends):
        slot[4 + j] = backend.addr.ip_u32()
        slot[4 + INLINE_MAX_BACKENDS + (j >> 1)] |= np.uint32(
            (backend.addr.port & 0xFFFF) << (16 * (j & 1))
        )
    return slot


def compile_lb_inline(mgr: ServiceManager) -> "LBInline | None":
    """Inline single-read layout; None if any service exceeds the
    inline backend budget or the hash cannot separate the frontends
    (compile_lb then takes the classic layout)."""
    services = sorted(mgr.by_frontend.values(), key=lambda s: s.id)
    if any(len(s.backends) > INLINE_MAX_BACKENDS for s in services):
        return None
    nb = 16
    while nb < len(services):
        nb *= 2
    nb_cap = max(nb * 64, 1 << 12)
    while nb <= nb_cap:
        rows = np.zeros((nb, BUCKET_LANES), dtype=np.uint32)
        rows[:, 1] = _EMPTY_W1
        rows[:, INLINE_SLOT + 1] = _EMPTY_W1
        stash = np.zeros((INLINE_STASH, INLINE_SLOT), dtype=np.uint32)
        stash[:, 1] = _EMPTY_W1
        fill = [0] * nb
        stash_fill = 0
        ok = True
        for svc in services:
            vip = svc.frontend.ip_u32()
            w1 = ((svc.frontend.port & 0xFFFF) << 16) | (
                svc.frontend.protocol & 0xFF
            )
            words = np.array([[vip, w1]], dtype=np.uint32)
            b = int(_fnv1a_host(words)[0]) & (nb - 1)
            if fill[b] < 2:
                rows[b, fill[b] * INLINE_SLOT : (fill[b] + 1) * INLINE_SLOT] = (
                    _svc_slot(svc)
                )
                fill[b] += 1
            elif stash_fill < INLINE_STASH:
                stash[stash_fill] = _svc_slot(svc)
                stash_fill += 1
            else:
                ok = False
                break
        if ok:
            return LBInline(
                rows=rows,
                stash=trim_pow2_prefix(stash, stash_fill),
                n_buckets=nb,
            )
        nb *= 2
    return None


def compile_lb(mgr: ServiceManager):
    """The service map for the datapath: the inline single-read layout
    when every service fits its backend budget, else the classic
    layout for all services."""
    inline = compile_lb_inline(mgr)
    if inline is not None:
        return inline
    return compile_lb_classic(mgr)


def compile_lb_classic(mgr: ServiceManager) -> LBTables:
    """The classic two-read layout (module docstring).  Raises past
    MAX_BACKENDS backends for one service, or when a bucket and the
    stash overflow."""
    services = sorted(mgr.by_frontend.values(), key=lambda s: s.id)
    nb = 16
    while nb * 8 < max(len(services), 1):
        nb *= 2
    buckets = np.zeros((nb, BUCKET_LANES), dtype=np.uint32)
    buckets[:, SVC_PER_BUCKET : 2 * SVC_PER_BUCKET] = _EMPTY_W1
    stash = np.zeros((SVC_STASH, SVC_ENTRY_WORDS), dtype=np.uint32)
    stash[:, 1] = _EMPTY_W1
    fill = [0] * nb
    stash_fill = 0
    backend_rows = np.zeros(
        (max(len(services), 1), BUCKET_LANES), dtype=np.uint32
    )
    for row_idx, svc in enumerate(services):
        if len(svc.backends) > MAX_BACKENDS:
            raise ValueError(
                f"service {svc.frontend} has more than {MAX_BACKENDS} "
                f"backends"
            )
        vip = svc.frontend.ip_u32()
        w1 = ((svc.frontend.port & 0xFFFF) << 16) | (
            svc.frontend.protocol & 0xFF
        )
        for j, backend in enumerate(svc.backends):
            backend_rows[row_idx, j] = backend.addr.ip_u32()
            backend_rows[row_idx, 64 + (j >> 1)] |= np.uint32(
                (backend.addr.port & 0xFFFF) << (16 * (j & 1))
            )
        entry = (
            vip,
            w1,
            ((svc.id & 0xFFFF) << 16) | (len(svc.backends) & 0xFFFF),
            row_idx,
        )
        words = np.array([[vip, w1]], dtype=np.uint32)
        b = int(_fnv1a_host(words)[0]) & (nb - 1)
        if fill[b] < SVC_PER_BUCKET:
            for k in range(SVC_ENTRY_WORDS):
                buckets[b, k * SVC_PER_BUCKET + fill[b]] = entry[k]
            fill[b] += 1
        elif stash_fill < SVC_STASH:
            stash[stash_fill] = entry
            stash_fill += 1
        else:
            raise ValueError("LB service bucket and stash overflow")
    return LBTables(buckets=buckets, stash=stash, backend_rows=backend_rows,
                    n_buckets=nb)


# -- plain device select (int64 tensors holding u32 values) ------------------


def flow_hash(saddr, daddr, sport, dport, proto):
    """The flow hash of backend selection (FNV-1a over 4 words)."""
    return fnv1a(
        torch.stack(
            [
                widen(saddr),
                widen(daddr),
                ((widen(sport) << 16) | widen(dport)) & 0xFFFFFFFF,
                widen(proto),
            ],
            dim=1,
        )
    )


def lb_service_key(daddr, dport, proto):
    """(vip, w1) compare words of the service probe."""
    return widen(daddr), ((widen(dport) & 0xFFFF) << 16) | (widen(proto) & 0xFF)


def lb_inline_slot(rows, vip, w1, owns=None):
    """The matching 64-lane slot of fetched rows (masked sum over the
    two halves), with an optional ownership mask `owns` bool [B] (the
    routed mesh probe: a flow whose row another shard owns gets slot 0
    and found False).  Returns (slot int64 [B, 64], found [B])."""
    half = widen(rows).reshape(-1, 2, INLINE_SLOT)
    hit2 = (half[:, :, 0] == vip[:, None]) & (half[:, :, 1] == w1[:, None])
    if owns is not None:
        hit2 = hit2 & owns[:, None]
    slot = torch.where(hit2[:, :, None], half, 0).sum(dim=1) & 0xFFFFFFFF
    return slot, hit2.any(dim=1)


def lb_inline_stash_slot(tables: LBInline, vip, w1):
    stash = widen(tables.stash)  # [S, 64]
    s_hit = (stash[None, :, 0] == vip[:, None]) & (
        stash[None, :, 1] == w1[:, None]
    )
    slot = torch.where(s_hit[:, :, None], stash[None, :, :], 0).sum(
        dim=1
    ) & 0xFFFFFFFF
    return slot, s_hit.any(dim=1)


def lb_slot_outputs(slot, found, fh, ct_slave=None):
    """Backend choice from a resolved slot: (found, slave, new_daddr,
    new_dport, rev_nat), each zero where not found."""
    meta = slot[:, 2]
    count = meta & 0xFFFF
    rev_nat = meta >> 16
    found = found & (count > 0)
    slave = fh % torch.clamp(count, min=1) + 1
    if ct_slave is not None:
        ct_slave = ct_slave.to(torch.int64)
        reuse = (ct_slave > 0) & (ct_slave <= count)
        slave = torch.where(reuse, ct_slave, slave)
    k = slave - 1
    lane = torch.arange(INLINE_MAX_BACKENDS, device=slot.device)
    ip_mask = lane[None, :] == k[:, None]
    new_daddr = torch.where(
        ip_mask, slot[:, 4 : 4 + INLINE_MAX_BACKENDS], 0
    ).sum(dim=1) & 0xFFFFFFFF
    plane = torch.arange(INLINE_MAX_BACKENDS // 2, device=slot.device)
    port_mask = plane[None, :] == (k >> 1)[:, None]
    lo = 4 + INLINE_MAX_BACKENDS
    port_pair = torch.where(
        port_mask, slot[:, lo : lo + INLINE_MAX_BACKENDS // 2], 0
    ).sum(dim=1) & 0xFFFFFFFF
    new_dport = (port_pair >> (16 * (k & 1))) & 0xFFFF
    return (
        found,
        torch.where(found, slave, 0),
        torch.where(found, new_daddr, 0),
        torch.where(found, new_dport, 0),
        torch.where(found, rev_nat, 0),
    )


def _lb_select_classic(tables: LBTables, saddr, daddr, sport, dport, proto,
                       ct_slave=None):
    """Classic-layout select: the bucket row and the stash give the
    entry's meta and backend row (u32 masked sums over the hits), then
    one backend row read at the clamped row and a masked lane sum over
    its MAX_BACKENDS address lanes and port-pair lanes."""
    vip, w1 = lb_service_key(daddr, dport, proto)
    h = fnv1a(torch.stack([vip, w1], dim=1))
    rows = widen(tables.buckets[h & (tables.n_buckets - 1)])
    p = SVC_PER_BUCKET
    ent = [rows[:, k * p : (k + 1) * p] for k in range(SVC_ENTRY_WORDS)]
    hit = (ent[0] == vip[:, None]) & (ent[1] == w1[:, None])
    stash = widen(tables.stash)
    s_hit = (stash[None, :, 0] == vip[:, None]) & (
        stash[None, :, 1] == w1[:, None]
    )

    def pick(col):
        return (
            torch.where(hit, ent[col], 0).sum(dim=1)
            + torch.where(s_hit, stash[None, :, col], 0).sum(dim=1)
        ) & 0xFFFFFFFF

    found = hit.any(dim=1) | s_hit.any(dim=1)
    meta = pick(2)
    base = pick(3)
    count = meta & 0xFFFF
    rev_nat = meta >> 16
    found = found & (count > 0)
    fh = flow_hash(saddr, daddr, sport, dport, proto)
    slave = fh % torch.clamp(count, min=1) + 1
    if ct_slave is not None:
        ct_slave = ct_slave.to(torch.int64)
        reuse = (ct_slave > 0) & (ct_slave <= count)
        slave = torch.where(reuse, ct_slave, slave)
    # the reference's row index is the sum as int32, then clipped
    base32 = torch.where(base >= 1 << 31, base - (1 << 32), base)
    row_idx = base32.clamp(0, int(tables.backend_rows.shape[0]) - 1)
    brow = widen(tables.backend_rows[row_idx])
    k = slave - 1
    lane = torch.arange(MAX_BACKENDS, device=brow.device)
    new_daddr = torch.where(
        lane[None, :] == k[:, None], brow[:, :MAX_BACKENDS], 0
    ).sum(dim=1) & 0xFFFFFFFF
    plane = torch.arange(MAX_BACKENDS // 2, device=brow.device)
    port_pair = torch.where(
        plane[None, :] == (k >> 1)[:, None],
        brow[:, MAX_BACKENDS : MAX_BACKENDS + MAX_BACKENDS // 2], 0,
    ).sum(dim=1) & 0xFFFFFFFF
    new_dport = (port_pair >> (16 * (k & 1))) & 0xFFFF
    new_daddr = torch.where(found, new_daddr, widen(daddr))
    new_dport = torch.where(found, new_dport, dport.to(torch.int64))
    rev_nat = torch.where(found, rev_nat, 0)
    slave = torch.where(found, slave, 0)
    return found, slave, new_daddr, new_dport, rev_nat


def lb_select_batch(tables, saddr, daddr, sport, dport, proto,
                    ct_slave=None):
    """Returns (is_service bool, slave i64, new_daddr i64 (u32),
    new_dport i64, rev_nat i64).  Non-service flows pass through with
    their original daddr/dport and rev_nat 0.  Dispatches on the
    layout: LBInline (one row read) or LBTables (two)."""
    if isinstance(tables, LBTables):
        return _lb_select_classic(tables, saddr, daddr, sport, dport, proto,
                                  ct_slave)
    if not isinstance(tables, LBInline):
        raise ValueError(f"unknown LB layout {type(tables).__name__}")
    vip, w1 = lb_service_key(daddr, dport, proto)
    h = fnv1a(torch.stack([vip, w1], dim=1))
    rows = tables.rows[h & (tables.n_buckets - 1)]
    slot, row_found = lb_inline_slot(rows, vip, w1)
    s_slot, s_found = lb_inline_stash_slot(tables, vip, w1)
    slot = (slot + s_slot) & 0xFFFFFFFF
    found = row_found | s_found
    fh = flow_hash(saddr, daddr, sport, dport, proto)
    found, slave, new_daddr, new_dport, rev_nat = lb_slot_outputs(
        slot, found, fh, ct_slave
    )
    new_daddr = torch.where(found, new_daddr, widen(daddr))
    new_dport = torch.where(found, new_dport, dport.to(torch.int64))
    return found, slave, new_daddr, new_dport, rev_nat
