"""CIDR arithmetic helpers.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-implements the semantics of pkg/ip/ip.go
(RemoveCIDRs) and the Go-stdlib-specific parsing quirks that the policy
layer depends on (classful default masks in CIDRPolicyMap.Insert,
pkg/policy/l3.go:66-103).
"""

from __future__ import annotations

import ipaddress
from typing import List, Optional, Tuple, Union

IPNetwork = Union[ipaddress.IPv4Network, ipaddress.IPv6Network]


def parse_cidr(s: str) -> IPNetwork:
    """Like Go net.ParseCIDR: returns the *masked* network."""
    return ipaddress.ip_network(s, strict=False)


def go_default_mask_v4(ip: ipaddress.IPv4Address) -> Optional[int]:
    """Go net.IP.DefaultMask: classful A/8, B/16, C/24; else None."""
    first = int(ip) >> 24
    if first < 0x80:
        return 8
    if first < 0xC0:
        return 16
    if first < 0xE0:
        return 24
    return None


def parse_cidr_or_ip_classful(s: str) -> IPNetwork:
    """The exact parse performed by CIDRPolicyMap.Insert (l3.go:66-85).

    Try CIDR parse; else parse as bare IP.  Bare IPv6 gets /128.  Bare
    IPv4 gets its *classful default mask* if the host bits under that
    mask are zero, else /32.  This Go-stdlib behavior is load-bearing
    for key construction in the CIDR policy map.
    """
    # Go net.ParseCIDR only accepts "ip/len" strings; Python's
    # ip_network also accepts bare IPs (as /32), which would shadow the
    # classful path — so branch on the slash explicitly.
    if "/" in s:
        return ipaddress.ip_network(s, strict=False)
    ip = ipaddress.ip_address(s)
    if ip.version == 6:
        return ipaddress.ip_network((ip, 128))
    plen = go_default_mask_v4(ip)
    if plen is not None:
        masked = int(ip) & (((1 << plen) - 1) << (32 - plen))
        if masked == int(ip):
            return ipaddress.ip_network((ip, plen))
    return ipaddress.ip_network((ip, 32))


def remove_cidrs(allow: List[IPNetwork],
                 remove: List[IPNetwork]) -> List[IPNetwork]:
    """pkg/ip RemoveCIDRs: subtract 'remove' nets from 'allow' nets,
    splitting the allowed prefixes minimally.

    Result ordering: for each allowed CIDR (input order), the surviving
    fragments sorted ascending — a deterministic canonical order (the
    reference's ordering is an implementation detail of its splitting
    recursion; only set-equality is observable in verdicts).
    """
    out: List[IPNetwork] = []
    for a in allow:
        fragments = [a]
        for r in remove:
            if r.version != a.version:
                continue
            next_fragments: List[IPNetwork] = []
            for f in fragments:
                if r.overlaps(f):
                    if r.prefixlen <= f.prefixlen:
                        # fully removed
                        continue
                    next_fragments.extend(f.address_exclude(r))
                else:
                    next_fragments.append(f)
            fragments = next_fragments
        out.extend(sorted(fragments))
    return out


def ip_to_u32(ip: str) -> int:
    return int(ipaddress.IPv4Address(ip))


def ip6_to_ints(ip: str) -> Tuple[int, int]:
    v = int(ipaddress.IPv6Address(ip))
    return (v >> 64) & ((1 << 64) - 1), v & ((1 << 64) - 1)
