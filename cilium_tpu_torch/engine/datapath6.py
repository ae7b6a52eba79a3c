"""The fused IPv6 datapath program (the reference's `ipv6_policy`).

The reference datapath is dual-stack with a separate program per
family (bpf_lxc.c ipv6_policy beside ipv4_policy; eps.h
ipcache_lookup6; conntrack.h ct_lookup6).  Every flow of the v6
family takes this program, never the v4 one.  Per flow:

  1. prefilter6 on the source address (limb-masked ranges);
  2. with v6 services: a CT6 probe at service scope on the original
     tuple, then the LB6 row, its hashed (or CT-pinned) backend and the
     DNAT, applied to every flow whose direction is not ingress (0);
  3. a CT6 probe on the post-DNAT tuple: one bucket row of 11-word
     entries (two 4-limb addresses, ports, proto|flags, value), read by
     the direction-normalised hash, and the stash;
  4. ipcache6 of the peer (the source on ingress, the post-DNAT
     destination otherwise), RESERVED_WORLD when it finds nothing;
  5. the policy lattice shared with v4 (engine/verdict.py _probes and
     _combine), on the identity and the post-DNAT port;
  6. the combine with conntrack, and with a tunnel map the overlay
     decision for an allowed non-ingress flow on its post-DNAT
     destination.

CT6 follows the reference's direction words: 0 probes as OUT, 1 as IN,
every other value as SERVICE.  Its lookups sum every matching lane and
stash row, as the reference's masked sums do.

`datapath6_step(tables, flows, device=None)` is the entry point: on
the card it launches DATAPATH6 (kernels.py, csrc/datapath6.cu), on the
CPU it runs `datapath6_plain`, the plain PyTorch version of the same
program.  `apply_ct_writeback6` is the host side of the CT write-back.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass

import numpy as np
import torch

from cilium_tpu_torch.compiler.tables import RESERVED_WORLD
from cilium_tpu_torch.ct.table import (
    CT_EGRESS,
    CT_ESTABLISHED,
    CT_INGRESS,
    CT_NEW,
    CT_RELATED,
    CT_REPLY,
    CT_SERVICE,
    TUPLE_F_IN,
    TUPLE_F_OUT,
    TUPLE_F_RELATED,
    TUPLE_F_SERVICE,
    CTMap,
    CTTuple,
)
from cilium_tpu_torch.device import (
    MASK32,
    array_tensor,
    narrow,
    require_on,
    resolve_device,
    u32_tensor,
    widen,
)
from cilium_tpu_torch.engine.hashtable import (
    _fnv1a_host,
    fnv1a,
    trim_pow2_prefix,
)
from cilium_tpu_torch.engine.verdict import _combine, _probes
from cilium_tpu_torch.ipcache.lpm6 import (
    _mask_limbs,
    build_limb_ranges,
    int_of_limbs,
    ip6_limbs,
    ipcache6_lookup,
    limbs_of_int,
    match_limb_ranges,
)
from cilium_tpu_torch.maps.policymap import INGRESS

CT6_ENTRY_WORDS = 11
CT6_PER_BUCKET = 128 // CT6_ENTRY_WORDS  # 11
CT6_BUCKET_LOAD = 2
CT6_STASH = 128
SWAPPED_BIT = 1 << 7
_EMPTY_W = np.uint32(0xFFFFFFFF)  # marker in the proto|flags plane


@dataclass
class FlowBatch6:
    """Raw v6 5-tuples: int32 [B] columns, the addresses int32 [B, 4]
    holding u32 limbs (big-endian), is_fragment bool."""

    ep_index: torch.Tensor
    saddr: torch.Tensor
    daddr: torch.Tensor
    sport: torch.Tensor
    dport: torch.Tensor
    proto: torch.Tensor
    direction: torch.Tensor
    is_fragment: torch.Tensor

    @staticmethod
    def from_numpy(ep_index, saddr, daddr, sport, dport, proto, direction,
                   is_fragment=None, device=None) -> "FlowBatch6":
        """Upload numpy columns to `device` (None = the card): the
        addresses cast through u32, the other words through int32 (as
        the reference's batch casts them), any nonzero fragment word
        True."""
        dev = resolve_device(device)
        b = len(ep_index)
        if is_fragment is None:
            is_fragment = np.zeros(b, dtype=bool)

        def i32(x):
            return array_tensor(np.asarray(x).astype(np.int32), dev)

        def limbs(x):
            a = np.asarray(x).astype(np.uint32).reshape(b, 4)
            return u32_tensor(a, dev)

        return FlowBatch6(
            ep_index=i32(ep_index), saddr=limbs(saddr), daddr=limbs(daddr),
            sport=i32(sport), dport=i32(dport), proto=i32(proto),
            direction=i32(direction),
            is_fragment=array_tensor(np.asarray(is_fragment).astype(bool),
                                     dev),
        )


@dataclass
class Prefilter6:
    """Limb-masked deny ranges (the v6 face of prefilter.py)."""

    base: object  # u32 [P, 4]
    mask: object  # u32 [P, 4]


@dataclass
class CT6Snapshot:
    """v6 conntrack bucket rows (planar, 11 entries of 11 words) and
    the stash (its occupied pow2 prefix, one row or more)."""

    buckets: object  # u32 [Cb, 128]
    stash: object  # u32 [S, 11]
    n_buckets: int


def build_prefilter6(cidrs) -> Prefilter6:
    nets = []
    for c in sorted(cidrs):
        net = ipaddress.ip_network(c, strict=False)
        if net.version != 6:
            continue
        nets.append((ip6_limbs(str(net.network_address)),
                     _mask_limbs(net.prefixlen)))
    base, mask = build_limb_ranges(nets)
    return Prefilter6(base=base, mask=mask)


def prefilter6_drop(pf: Prefilter6, limbs) -> torch.Tensor:
    """Plain version: bool [B], True = drop before policy."""
    return match_limb_ranges(pf.base, pf.mask, limbs).any(dim=1)


# -- CT6 -----------------------------------------------------------------------


def _normalize_host6(daddr: int, saddr: int, dport: int, sport: int):
    if (daddr, dport) > (saddr, sport):
        return saddr, daddr, sport, dport, 1
    return daddr, saddr, dport, sport, 0


def compile_ct6(ct: CTMap) -> CT6Snapshot:
    """Host CT (CTTuple addresses as 128-bit ints) -> v6 bucket rows.
    The shape is pinned by ct.max_entries (2 entries a row on
    average, so the spill into the fixed stash stays small)."""
    per = CT6_PER_BUCKET
    nb = 16
    while nb * CT6_BUCKET_LOAD < max(ct.max_entries, 1):
        nb *= 2
    buckets = np.zeros((nb, 128), dtype=np.uint32)
    buckets[:, 9 * per : 10 * per] = _EMPTY_W
    stash = np.zeros((CT6_STASH, CT6_ENTRY_WORDS), dtype=np.uint32)
    stash[:, 9] = _EMPTY_W
    fill = [0] * nb
    sfill = 0
    for key, entry in ct.entries.items():
        lo_a, hi_a, lo_p, hi_p, swapped = _normalize_host6(
            key.daddr, key.saddr, key.dport, key.sport
        )
        lo, hi = limbs_of_int(lo_a), limbs_of_int(hi_a)
        ports = ((lo_p & 0xFFFF) << 16) | (hi_p & 0xFFFF)
        words = np.array([[*lo, *hi, ports, key.nexthdr & 0xFF]],
                         dtype=np.uint32)
        packed = (
            *lo, *hi, ports,
            ((key.nexthdr & 0xFF) << 8) | (swapped * SWAPPED_BIT)
            | (key.flags & 0x7F),
            ((entry.rev_nat_index & 0xFFFF) << 16) | (entry.slave & 0xFFFF),
        )
        b = int(_fnv1a_host(words)[0]) & (nb - 1)
        if fill[b] < per:
            i = fill[b]
            for k in range(CT6_ENTRY_WORDS):
                buckets[b, k * per + i] = packed[k]
            fill[b] += 1
        elif sfill < CT6_STASH:
            stash[sfill] = packed
            sfill += 1
        else:
            raise ValueError("CT6 bucket and stash overflow")
    return CT6Snapshot(buckets=buckets, stash=trim_pow2_prefix(stash, sfill),
                       n_buckets=nb)


def ct6_lookup_batch(snapshot: CT6Snapshot, daddr, saddr, dport, sport, proto,
                     direction, related_icmp=None):
    """Plain version of ct_lookup6: one bucket row read, then the
    reverse key (REPLY) and the forward key (ESTABLISHED) compared
    against its lanes and the stash.  Addresses [B, 4] (u32 bits),
    the rest [B] as int32 values.  Returns (result uint8, rev_nat
    int64, slave int64)."""
    base_flags = torch.where(
        direction == CT_INGRESS, TUPLE_F_OUT,
        torch.where(direction == CT_EGRESS, TUPLE_F_IN, TUPLE_F_SERVICE),
    ).to(torch.int64)
    if related_icmp is not None:
        base_flags = base_flags | torch.where(
            related_icmp.bool(), TUPLE_F_RELATED, 0)
    rev_flags = base_flags ^ TUPLE_F_IN

    d, s = widen(daddr), widen(saddr)
    dport_u = widen(dport) & 0xFFFF
    sport_u = widen(sport) & 0xFFFF
    # lexicographic address-pair normalisation over limbs, then ports
    d_gt = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    d_eq = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    for k in range(4):
        d_gt = d_gt | (d_eq & (d[:, k] > s[:, k]))
        d_eq = d_eq & (d[:, k] == s[:, k])
    swapped = d_gt | (d_eq & (dport_u > sport_u))
    pairs_equal = d_eq & (dport_u == sport_u)
    lo = torch.where(swapped[:, None], s, d)
    hi = torch.where(swapped[:, None], d, s)
    ports = torch.where(swapped, (sport_u << 16) | dport_u,
                        (dport_u << 16) | sport_u)
    proto_u = widen(proto) & 0xFF

    h = fnv1a(torch.cat([lo, hi, ports[:, None], proto_u[:, None]], dim=1))
    rows = widen(snapshot.buckets[h & (snapshot.n_buckets - 1)])
    per = CT6_PER_BUCKET

    def plane(k):
        return rows[:, k * per : (k + 1) * per]

    stash = widen(snapshot.stash)
    key_eq = plane(8) == ports[:, None]
    s_key = stash[None, :, 8] == ports[:, None]
    for k in range(4):
        key_eq &= (plane(k) == lo[:, k : k + 1]) & (
            plane(4 + k) == hi[:, k : k + 1])
        s_key &= (stash[None, :, k] == lo[:, k : k + 1]) & (
            stash[None, :, 4 + k] == hi[:, k : k + 1])
    w9_fwd = (proto_u << 8) | torch.where(
        swapped & ~pairs_equal, SWAPPED_BIT, 0) | base_flags
    w9_rev = (proto_u << 8) | torch.where(
        ~swapped & ~pairs_equal, SWAPPED_BIT, 0) | rev_flags
    fwd_hit = key_eq & (plane(9) == w9_fwd[:, None])
    rev_hit = key_eq & (plane(9) == w9_rev[:, None])
    s_fwd = s_key & (stash[None, :, 9] == w9_fwd[:, None])
    s_rev = s_key & (stash[None, :, 9] == w9_rev[:, None])

    def pick(hits, s_hits):
        return (
            torch.where(hits, plane(10), 0).sum(dim=1)
            + torch.where(s_hits, stash[None, :, 10], 0).sum(dim=1)
        ) & MASK32

    fwd_found = fwd_hit.any(dim=1) | s_fwd.any(dim=1)
    rev_found = rev_hit.any(dim=1) | s_rev.any(dim=1)
    related = (base_flags & TUPLE_F_RELATED) != 0
    result = torch.where(
        rev_found, torch.where(related, CT_RELATED, CT_REPLY),
        torch.where(fwd_found, torch.where(related, CT_RELATED,
                                           CT_ESTABLISHED), CT_NEW),
    ).to(torch.uint8)
    val = torch.where(rev_found, pick(rev_hit, s_rev), pick(fwd_hit, s_fwd))
    hit = rev_found | fwd_found
    return (result, torch.where(hit, val >> 16, 0),
            torch.where(hit, val & 0xFFFF, 0))


# -- the fused v6 program ---------------------------------------------------------


@dataclass
class Datapath6Tables:
    """Everything the v6 program reads; `policy` is the PolicyTables
    shared with v4 (identities are family-agnostic).  `tunnel` None is
    the no-overlay program, `lb` None a node with no v6 services."""

    prefilter: object  # Prefilter6
    ipcache: object  # IPCache6Device
    ct: object  # CT6Snapshot
    policy: object  # PolicyTables
    tunnel: object = None  # TunnelTables6
    lb: object = None  # LB6Inline


VERDICT6_COLUMNS = (
    "allowed", "proxy_port", "match_kind", "ct_result", "pre_dropped",
    "sec_id", "ct_create", "ct_delete", "tunnel_endpoint", "final_daddr",
    "final_dport", "rev_nat", "lb_slave",
)
# dtype of each column; u32 columns carry their bits in int32
VERDICT6_DTYPES = {
    "allowed": torch.uint8,
    "proxy_port": torch.int32,
    "match_kind": torch.uint8,
    "ct_result": torch.uint8,
    "pre_dropped": torch.bool,
    "sec_id": torch.int32,
    "ct_create": torch.bool,
    "ct_delete": torch.bool,
    "tunnel_endpoint": torch.int32,
    "final_daddr": torch.int32,  # [B, 4]
    "final_dport": torch.int32,
    "rev_nat": torch.int32,
    "lb_slave": torch.int32,
}
U32_COLUMNS6 = ("sec_id", "tunnel_endpoint", "final_daddr")


@dataclass
class Datapath6Verdicts:
    """Per-flow outcome of the v6 program and its CT write-back
    intents.  `tunnel_endpoint` is the v4 underlay node IP to
    encapsulate to (0 = direct or local; all zero without a tunnel
    map); `final_daddr` / `final_dport` the post-DNAT destination."""

    allowed: torch.Tensor  # u8
    proxy_port: torch.Tensor  # i32
    match_kind: torch.Tensor  # u8 MATCH_*
    ct_result: torch.Tensor  # u8 CT_*
    pre_dropped: torch.Tensor  # bool
    sec_id: torch.Tensor  # u32 bits in i32
    ct_create: torch.Tensor  # bool
    ct_delete: torch.Tensor  # bool
    tunnel_endpoint: torch.Tensor  # u32 bits in i32
    final_daddr: torch.Tensor  # u32 bits in i32, [B, 4]
    final_dport: torch.Tensor  # i32
    rev_nat: torch.Tensor  # i32
    lb_slave: torch.Tensor  # i32


def datapath6_plain(tables: Datapath6Tables,
                    flows: FlowBatch6) -> Datapath6Verdicts:
    """Plain PyTorch version of the v6 program (see the module
    docstring), on the flows' device."""
    from cilium_tpu_torch.lb.device6 import lb6_select_batch
    from cilium_tpu_torch.tunnel import tunnel_select6

    f = flows
    ingress = f.direction == INGRESS
    pre_drop = prefilter6_drop(tables.prefilter, f.saddr)
    zero = torch.zeros(f.dport.shape, dtype=torch.int64, device=f.dport.device)
    eff_daddr, eff_dport = widen(f.daddr), f.dport.to(torch.int64)
    rev_nat = lb_slave = zero
    if tables.lb is not None:
        _, _, svc_slave = ct6_lookup_batch(
            tables.ct, f.daddr, f.saddr, f.dport, f.sport, f.proto,
            torch.full_like(f.direction, CT_SERVICE),
        )
        svc_found, slave, lb_daddr, lb_dport, lb_rev = lb6_select_batch(
            tables.lb, f.saddr, f.daddr, f.sport, f.dport, f.proto,
            ct_slave=svc_slave,
        )
        do_lb = ~ingress & svc_found
        eff_daddr = torch.where(do_lb[:, None], lb_daddr, eff_daddr)
        eff_dport = torch.where(do_lb, lb_dport, eff_dport)
        rev_nat = torch.where(do_lb, lb_rev, 0)
        lb_slave = torch.where(do_lb, slave, 0)

    ct_res, _, _ = ct6_lookup_batch(
        tables.ct, eff_daddr, f.saddr, eff_dport, f.sport, f.proto,
        f.direction,
    )
    looked = ipcache6_lookup(
        tables.ipcache, torch.where(ingress[:, None], widen(f.saddr), eff_daddr)
    )
    sec_id = torch.where(looked == 0, RESERVED_WORLD, looked)

    probe1, probe2, probe3, proxy, _, _ = _probes(
        tables.policy, f.ep_index.to(torch.int64),
        f.direction.to(torch.int64), eff_dport, f.proto.to(torch.int64),
        identity=sec_id,
    )
    pol_allow, v_proxy, kind = _combine(probe1, probe2, probe3, proxy,
                                        f.is_fragment.bool())
    pass_ct = (ct_res == CT_REPLY) | (ct_res == CT_RELATED)
    allowed = ~pre_drop & (pass_ct | pol_allow)
    ct_delete = (ct_res == CT_ESTABLISHED) & ~pol_allow & ~pass_ct & ~pre_drop
    ct_create = (ct_res == CT_NEW) & allowed
    proxy_out = torch.where(
        pol_allow & ((ct_res == CT_NEW) | (ct_res == CT_ESTABLISHED))
        & allowed, v_proxy, 0,
    )
    if tables.tunnel is not None:
        tunnel_ep = torch.where(allowed & ~ingress,
                                tunnel_select6(tables.tunnel, eff_daddr), 0)
    else:
        tunnel_ep = zero
    return Datapath6Verdicts(
        allowed=allowed.to(torch.uint8),
        proxy_port=proxy_out.to(torch.int32),
        match_kind=kind,
        ct_result=ct_res,
        pre_dropped=pre_drop,
        sec_id=narrow(sec_id),
        ct_create=ct_create,
        ct_delete=ct_delete,
        tunnel_endpoint=narrow(tunnel_ep),
        final_daddr=narrow(eff_daddr),
        final_dport=eff_dport.to(torch.int32),
        rev_nat=rev_nat.to(torch.int32),
        lb_slave=lb_slave.to(torch.int32),
    )


def datapath6_step(tables: Datapath6Tables, flows: FlowBatch6,
                   device=None) -> Datapath6Verdicts:
    """The v6 program on `device` (None = the card), where `tables`
    (convert.datapath6_tables_to) and `flows` (FlowBatch6.from_numpy)
    must already lie.  A CUDA device launches DATAPATH6; the CPU runs
    the plain version."""
    dev = resolve_device(device)
    require_on(flows.saddr, dev,
               "the flows (FlowBatch6.from_numpy(..., device))")
    require_on(tables.ct.buckets, dev,
               "the tables (convert.datapath6_tables_to)")
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DATAPATH6(tables, flows)
    return datapath6_plain(tables, flows)


def _host(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if u32 else a


def apply_ct_writeback6(ct: CTMap, out: Datapath6Verdicts, flows: FlowBatch6,
                        now: int = 0) -> tuple:
    """Host v6 CT mutation after a batch (outputs and flows on any
    device): NEW and allowed flows create their entry on the post-DNAT
    tuple, and a load-balanced flow (rev_nat > 0) its service-scope
    entry carrying the backend; ESTABLISHED flows that policy now
    denies are deleted.  Flows are taken in batch order.  Returns
    (created, deleted) counts; addresses stay 128-bit ints in the host
    map, as compile_ct6 reads them."""
    create, delete = _host(out.ct_create), _host(out.ct_delete)
    fdaddr, fdport = _host(out.final_daddr, True), _host(out.final_dport)
    saddr, odaddr = _host(flows.saddr, True), _host(flows.daddr, True)
    odport, sport = _host(flows.dport), _host(flows.sport)
    proto, direction = _host(flows.proto), _host(flows.direction)
    rev, slave = _host(out.rev_nat), _host(out.lb_slave)
    created = deleted = 0
    for i in np.nonzero(create | delete)[0]:
        d_int, s_int = int_of_limbs(fdaddr[i]), int_of_limbs(saddr[i])
        dirv = int(direction[i])
        flags = TUPLE_F_OUT if dirv == CT_INGRESS else TUPLE_F_IN
        tup = (d_int, s_int, int(fdport[i]), int(sport[i]), int(proto[i]))
        if create[i]:
            if CTTuple(*tup, flags) not in ct.entries and ct.create_best_effort(
                CTTuple(*tup), dirv, now=now, rev_nat_index=int(rev[i]),
                slave=int(slave[i]),
            ):
                created += 1
            if int(rev[i]) > 0:
                svc = (int_of_limbs(odaddr[i]), s_int, int(odport[i]),
                       int(sport[i]), int(proto[i]))
                if CTTuple(*svc, TUPLE_F_SERVICE) not in ct.entries and (
                    ct.create_best_effort(
                        CTTuple(*svc), CT_SERVICE, now=now,
                        rev_nat_index=int(rev[i]), slave=int(slave[i]),
                    )
                ):
                    created += 1
        elif ct.entries.pop(CTTuple(*tup, flags), None) is not None:
            deleted += 1
    return created, deleted
