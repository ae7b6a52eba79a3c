"""Host-side oracle pieces of the datapath: the fast host LPM (the
oracle of the DIR-24-8 lookup and of the CIDR path's identity
derivation), the host backend selection `lb_select_host`, and
`composed_oracle`, the per-tuple host evaluation of the whole fused
pipeline that the fused step is held against: prefilter, LB/DNAT with
service-scope stickiness, conntrack, ipcache identity, the policy
lattice and the combine, in the order the device step fuses them; and
`lattice_fold_host`, the host fold of the bare lattice that the mesh
failover router (engine/failover.py) serves a batch through when no
mesh row has a usable chip.
"""

from __future__ import annotations

import ipaddress
from typing import Dict

import numpy as np


class HostLPM:
    """Fast host LPM: /32s in a dict, the other prefixes scanned
    longest first (their count stays small in the bench worlds, unlike
    the /32 population).  IPv6 prefixes are skipped; a miss is 0."""

    def __init__(self, mapping: Dict[str, int]):
        self.exact = {}
        self.ranges = []
        for cidr, num_id in mapping.items():
            net = ipaddress.ip_network(cidr, strict=False)
            if net.version != 4:
                continue
            if net.prefixlen == 32:
                self.exact[int(net.network_address)] = num_id
            else:
                self.ranges.append((
                    net.prefixlen, int(net.network_address),
                    int(net.netmask), num_id,
                ))
        self.ranges.sort(key=lambda r: -r[0])

    def lookup(self, ip: int) -> int:
        hit = self.exact.get(ip)
        if hit is not None:
            return hit
        for _, base, mask, num_id in self.ranges:
            if (ip & mask) == base:
                return num_id
        return 0


def ct_lookup_host(ct, tup, direction: int) -> int:
    """The result of the reference's host `CTMap.lookup` (ct_lookup4)
    of an on-wire tuple, without its side effects (the probe refreshes
    a hit's lifetime and counters, which no oracle output reads):
    REPLY when the reversed key is present, else ESTABLISHED when the
    key is, else NEW.  The key's flags follow `direction` (ingress OUT,
    egress IN, else SERVICE); reversing flips the IN flag."""
    from cilium_tpu_torch.ct.table import (
        CT_ESTABLISHED,
        CT_INGRESS,
        CT_EGRESS,
        CT_NEW,
        CT_REPLY,
        TUPLE_F_IN,
        TUPLE_F_OUT,
        TUPLE_F_SERVICE,
        CTTuple,
    )

    if direction == CT_INGRESS:
        flags = TUPLE_F_OUT
    elif direction == CT_EGRESS:
        flags = TUPLE_F_IN
    else:
        flags = TUPLE_F_SERVICE
    rev = CTTuple(tup.saddr, tup.daddr, tup.sport, tup.dport, tup.nexthdr,
                  flags ^ TUPLE_F_IN)
    if rev in ct.entries:
        return CT_REPLY
    base = CTTuple(tup.daddr, tup.saddr, tup.dport, tup.sport, tup.nexthdr,
                   flags)
    return CT_ESTABLISHED if base in ct.entries else CT_NEW


def lb_select_host(ct, svc, saddr, daddr, sport, dport, proto):
    """Host backend selection for one flow to a service: the CT
    service-scope stickiness probe first (lb4_local's ct lookup over both
    key layouts), else the FNV-1a hash of the flow.  Returns (slave,
    1-based, and whether it was sticky)."""
    from cilium_tpu_torch.ct.table import (
        CT_ESTABLISHED,
        CT_REPLY,
        CT_SERVICE,
        TUPLE_F_SERVICE,
        CTTuple,
    )
    from cilium_tpu_torch.engine.hashtable import _fnv1a_host

    slave = 0
    sticky = False
    st_res = ct_lookup_host(
        ct, CTTuple(daddr, saddr, dport, sport, proto), CT_SERVICE
    )
    if st_res in (CT_ESTABLISHED, CT_REPLY):
        for key in (
            CTTuple(saddr, daddr, sport, dport, proto, TUPLE_F_SERVICE | 1),
            CTTuple(daddr, saddr, dport, sport, proto, TUPLE_F_SERVICE),
            CTTuple(saddr, daddr, sport, dport, proto, TUPLE_F_SERVICE),
            CTTuple(daddr, saddr, dport, sport, proto, TUPLE_F_SERVICE | 1),
        ):
            e = ct.entries.get(key)
            if e is not None:
                slave = e.slave
                sticky = True
                break
    if not (0 < slave <= len(svc.backends)):
        words = np.array([[saddr, daddr, (sport << 16) | dport, proto]],
                         dtype=np.uint32)
        slave = int(_fnv1a_host(words)[0]) % len(svc.backends) + 1
        sticky = False
    return slave, sticky


def lattice_fold_host(states, ep_index, identity, dport, proto, direction,
                      is_fragment=None, pad_to: int = 0):
    """The degraded mode's host fold of the bare verdict lattice: the
    oracle's policy_can_access (without hit counting: the device path
    it stands in for carries no entry counters) per tuple over the
    per-endpoint realized map states, so the verdicts equal
    engine.verdict.evaluate_batch's on any input.  A missing endpoint
    (None state) evaluates against an empty map: default deny.

    Returns a Verdicts-shaped namespace (allowed u8, proxy_port i32,
    match_kind u8 numpy columns), zero-padded to `pad_to` when given."""
    from types import SimpleNamespace

    from cilium_tpu_torch.engine.oracle import policy_can_access

    b = len(ep_index)
    n = max(b, pad_to)
    allowed = np.zeros(n, np.uint8)
    proxy = np.zeros(n, np.int32)
    kind = np.zeros(n, np.uint8)
    if is_fragment is None:
        is_fragment = np.zeros(b, bool)
    empty: Dict = {}
    for i in range(b):
        state = states[int(ep_index[i])]
        v = policy_can_access(
            empty if state is None else state, int(identity[i]),
            int(dport[i]), int(proto[i]), int(direction[i]),
            bool(is_fragment[i]), count_hits=False)
        allowed[i] = 1 if v.allowed else 0
        proxy[i] = v.proxy_port
        kind[i] = v.match_kind
    return SimpleNamespace(allowed=allowed, proxy_port=proxy,
                           match_kind=kind)


def composed_oracle(ctx, states, flows_dict, idx_list,
                    return_stages: bool = False):
    """Per-tuple host evaluation of the whole fused pipeline.  `ctx`
    holds {"prefilter": HostLPM, "ipcache": HostLPM, "ct": CTMap,
    "mgr": ServiceManager}; `states` the per-endpoint policy map states
    in endpoint-axis order; `flows_dict` the FLOW_COLUMNS arrays, of
    which the rows `idx_list` are evaluated.  Returns (allowed u8,
    proxy i32, sec_id u32) arrays, and with `return_stages` a dict
    {pre_drop, ct_res, match_kind, lb_hit, ipcache_miss} of each
    stage's decision.  The lattice counts its hits in the states'
    entries, as the reference's does."""
    from cilium_tpu_torch.compiler.tables import RESERVED_WORLD
    from cilium_tpu_torch.ct.table import (
        CT_EGRESS,
        CT_ESTABLISHED,
        CT_INGRESS,
        CT_NEW,
        CT_RELATED,
        CT_REPLY,
        CTTuple,
    )
    from cilium_tpu_torch.engine.oracle import policy_can_access
    from cilium_tpu_torch.lb.service import L3n4Addr
    from cilium_tpu_torch.maps.policymap import INGRESS

    pre, ipc, ct, mgr = (ctx["prefilter"], ctx["ipcache"], ctx["ct"],
                         ctx["mgr"])
    n = len(idx_list)
    out_allow = np.zeros(n, np.uint8)
    out_proxy = np.zeros(n, np.int32)
    out_sec = np.zeros(n, np.uint32)
    st_pre = np.zeros(n, bool)
    st_ct = np.zeros(n, np.uint8)
    st_kind = np.zeros(n, np.uint8)
    st_lb = np.zeros(n, bool)
    st_miss = np.zeros(n, bool)
    f = flows_dict
    for row, i in enumerate(idx_list):
        ep = int(f["ep_index"][i])
        saddr, daddr = int(f["saddr"][i]), int(f["daddr"][i])
        sport, dport = int(f["sport"][i]), int(f["dport"][i])
        proto = int(f["proto"][i])
        direction = int(f["direction"][i])
        frag = bool(f["is_fragment"][i])

        pre_drop = pre.lookup(saddr) != 0

        eff_daddr, eff_dport = daddr, dport
        if direction != INGRESS:
            svc = mgr.lookup(
                L3n4Addr(str(ipaddress.ip_address(daddr)), dport, proto)
            )
            if svc is not None and svc.backends:
                slave, _ = lb_select_host(ct, svc, saddr, daddr, sport,
                                          dport, proto)
                b = svc.backends[slave - 1]
                eff_daddr = b.addr.ip_u32()
                eff_dport = b.addr.port
                st_lb[row] = True

        ct_res = ct_lookup_host(
            ct, CTTuple(eff_daddr, saddr, eff_dport, sport, proto),
            CT_INGRESS if direction == INGRESS else CT_EGRESS,
        )

        sec_ip = saddr if direction == INGRESS else eff_daddr
        sec_id = ipc.lookup(sec_ip)
        if sec_id == 0:
            sec_id = RESERVED_WORLD
            st_miss[row] = True

        v = policy_can_access(states[ep], sec_id, eff_dport, proto,
                              direction, frag)
        pass_ct = ct_res in (CT_REPLY, CT_RELATED)
        allowed = (not pre_drop) and (pass_ct or v.allowed)
        proxy = (v.proxy_port if v.allowed and ct_res in (
            CT_NEW, CT_ESTABLISHED) and allowed else 0)
        out_allow[row] = 1 if allowed else 0
        out_proxy[row] = proxy
        out_sec[row] = sec_id
        st_pre[row] = pre_drop
        st_ct[row] = ct_res
        st_kind[row] = v.match_kind
    if return_stages:
        return out_allow, out_proxy, out_sec, {
            "pre_drop": st_pre,
            "ct_res": st_ct,
            "match_kind": st_kind,
            "lb_hit": st_lb,
            "ipcache_miss": st_miss,
        }
    return out_allow, out_proxy, out_sec
