"""Host-side oracle pieces of the datapath.  Only the fast host LPM is
ported so far: the oracle of the DIR-24-8 lookup and of the CIDR
path's identity derivation."""

from __future__ import annotations

import ipaddress
from typing import Dict


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
