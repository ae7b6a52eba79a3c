"""XDP-style CIDR prefilter: deny by source CIDR before policy.

Model of pkg/policy/prefilter.go and bpf/bpf_xdp.c (the CIDR4 deny
maps XDP consults).  Small deny lists compile to (base, mask) range
arrays that every flow compares against: drop iff any
(ip & mask) == base.  Past MAX_BROADCAST prefixes (a DDoS blocklist)
the list compiles to the DIR-24-8 tables of ipcache/lpm.py instead,
and a flow drops iff its source's lookup is nonzero: two dependent
reads per flow in place of a compare per listed prefix.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass

import numpy as np
import torch

from cilium_tpu_torch.device import widen
from cilium_tpu_torch.ipcache.lpm import LPMTables, build_lpm, lpm_lookup_plain

# the marker identity of a listed prefix (any nonzero value: a DIR-24-8
# miss reads 0)
_LISTED = 1

MAX_BROADCAST = 128


@dataclass
class PrefilterRanges:
    """Arrays padded to a pow2 (padding rows have mask 0, base 1 —
    unmatchable)."""

    base: object  # u32 [P]
    mask: object  # u32 [P]


def build_prefilter(cidrs) -> "PrefilterRanges | LPMTables":
    """Lower a prefilter CIDR set (iterable of v4 cidr strings, or a
    {cidr: marker} dict) to the range form, or to DIR-24-8 past
    MAX_BROADCAST v4 prefixes."""
    cidr_list = sorted(cidrs)
    v4 = []
    for c in cidr_list:
        net = ipaddress.ip_network(c, strict=False)
        if net.version != 4:
            continue
        v4.append((int(net.network_address), int(net.netmask)))
    if len(v4) > MAX_BROADCAST:
        return build_lpm({c: _LISTED for c in cidr_list})
    p = 8
    while p < len(v4):
        p *= 2
    base = np.ones(p, dtype=np.uint32)
    mask = np.zeros(p, dtype=np.uint32)
    for i, (b, m) in enumerate(v4):
        base[i] = b
        mask[i] = m
    return PrefilterRanges(base=base, mask=mask)


def prefilter_drop(tables, src_ips) -> torch.Tensor:
    """Plain version: bool [B], True = drop before policy.  Dispatches
    on the compiled form."""
    if isinstance(tables, LPMTables):
        return lpm_lookup_plain(tables, src_ips) != 0
    if not isinstance(tables, PrefilterRanges):
        raise ValueError(
            f"unknown prefilter form {type(tables).__name__}"
        )
    ips = widen(src_ips)
    return (
        (ips[:, None] & widen(tables.mask)[None, :])
        == widen(tables.base)[None, :]
    ).any(dim=1)
