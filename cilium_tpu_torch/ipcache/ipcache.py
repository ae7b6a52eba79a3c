"""Host-side IP↔identity cache.

The port's own copy of the JAX package's ipcache/ipcache.py.

Behavioral port of pkg/ipcache/ipcache.go:
  - source-priority overwrite rules (allowOverwrite, ipcache.go:183):
    k8s < kvstore < agent-local;
  - endpoint-IP shadows equivalent full-prefix CIDR (Upsert
    ipcache.go:247-289, deleteLocked ipcache.go:372-405): listeners
    never hear about a CIDR mapping hidden behind an endpoint IP, and
    the CIDR mapping is revived when the endpoint IP goes away;
  - per-prefix-length refcounts (the datapath's LPM probe schedule);
  - listener fan-out (OnIPIdentityCacheChange) — the seam the device
    LPM table builder subscribes to (cilium_tpu_torch.ipcache.lpm.LPMBuilder,
    analog of pkg/datapath/ipcache/listener.go:78).
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

# ipcache.go:40-51
FROM_K8S = "k8s"
FROM_KVSTORE = "kvstore"
FROM_AGENT_LOCAL = "agent-local"

# Modification kinds passed to listeners (ipcache.go Upsert/Delete).
UPSERT = "upsert"
DELETE = "delete"


@dataclass(frozen=True)
class IPIdentity:
    """ipcache.go:57 Identity{ID, Source}."""

    id: int
    source: str


def allow_overwrite(existing: str, new: str) -> bool:
    """ipcache.go:183."""
    if existing == FROM_K8S:
        return True
    if existing == FROM_KVSTORE:
        return new in (FROM_KVSTORE, FROM_AGENT_LOCAL)
    if existing == FROM_AGENT_LOCAL:
        return new == FROM_AGENT_LOCAL
    return True


def _parse(ip: str):
    """Returns (canonical_cidr_str, is_full_prefix, version, bare_ip).

    Mirrors the reference's net.ParseCIDR-then-ParseIP branching: a
    bare IP is an endpoint IP (full-prefix CIDR equivalent,
    endpointIPToCIDR ipcache.go:196); a "x/len" string is a CIDR.
    """
    if "/" in ip:
        net = ipaddress.ip_network(ip, strict=False)
        full = net.prefixlen == net.max_prefixlen
        return str(net), full, net.version, str(net.network_address), False
    addr = ipaddress.ip_address(ip)
    net = ipaddress.ip_network(ip)
    return str(net), True, addr.version, str(addr), True


# listener signature:
# fn(modification, cidr_str, old_host_ip, new_host_ip, old_id, new_id)
Listener = Callable[[str, str, Optional[str], Optional[str],
                     Optional[int], int], None]


class IPCache:
    """ipcache.go:66 IPCache."""

    def __init__(self) -> None:
        self.ip_to_identity: Dict[str, IPIdentity] = {}
        self.identity_to_ip: Dict[int, Set[str]] = {}
        self.ip_to_host_ip: Dict[str, Optional[str]] = {}
        self.v4_prefix_lengths: Dict[int, int] = {}
        self.v6_prefix_lengths: Dict[int, int] = {}
        self.listeners: List[Listener] = []

    # -- listeners -----------------------------------------------------------

    def add_listener(self, listener: Listener) -> None:
        self.listeners.append(listener)
        self.dump_to_listener(listener)

    def dump_to_listener(self, listener: Listener) -> None:
        """DumpToListenerLocked (ipcache.go:327)."""
        for ip, ident in self.ip_to_identity.items():
            cidr_str, _, _, _, bare = _parse(ip)
            listener(
                UPSERT, cidr_str, None, self.ip_to_host_ip.get(ip),
                None, ident.id,
            )

    def _notify(self, *args) -> None:
        for listener in list(self.listeners):
            listener(*args)

    # -- upsert (ipcache.go:217) --------------------------------------------

    def upsert(
        self,
        ip: str,
        new_identity: IPIdentity,
        host_ip: Optional[str] = None,
    ) -> bool:
        cidr_str, full, version, bare_ip, is_bare = _parse(ip)
        old_host_ip = self.ip_to_host_ip.get(ip)
        callback = True
        old_identity: Optional[int] = None

        cached = self.ip_to_identity.get(ip)
        if cached is not None:
            if not allow_overwrite(cached.source, new_identity.source):
                return False
            if cached == new_identity and old_host_ip == host_ip:
                return True
            old_identity = cached.id

        if not is_bare:
            # CIDR form: count the prefix length.
            net = ipaddress.ip_network(ip, strict=False)
            lengths = (
                self.v4_prefix_lengths
                if version == 4
                else self.v6_prefix_lengths
            )
            lengths[net.prefixlen] = lengths.get(net.prefixlen, 0) + 1
            if full and bare_ip in self.ip_to_identity:
                # Full-prefix CIDR shadowed by an endpoint IP
                # (ipcache.go:258-265): update the cache, don't tell
                # the listeners.
                callback = False
        else:
            # Endpoint IP: does it start shadowing an equivalent CIDR?
            if cached is None:
                cidr_ident = self.ip_to_identity.get(cidr_str)
                if cidr_ident is not None and cidr_str != ip:
                    cidr_host = self.ip_to_host_ip.get(cidr_str)
                    old_host_ip = cidr_host
                    if (
                        cidr_ident.id != new_identity.id
                        or cidr_host != host_ip
                    ):
                        old_identity = cidr_ident.id
                    else:
                        callback = False

        if cached is not None:
            ips = self.identity_to_ip.get(cached.id)
            if ips is not None:
                ips.discard(ip)
                if not ips:
                    del self.identity_to_ip[cached.id]
        self.ip_to_identity[ip] = new_identity
        self.identity_to_ip.setdefault(new_identity.id, set()).add(ip)
        if host_ip is None:
            self.ip_to_host_ip.pop(ip, None)
        else:
            self.ip_to_host_ip[ip] = host_ip

        if callback:
            self._notify(
                UPSERT, cidr_str, old_host_ip, host_ip,
                old_identity, new_identity.id,
            )
        return True

    # -- delete (ipcache.go:340 deleteLocked) -------------------------------

    def delete(self, ip: str) -> None:
        cached = self.ip_to_identity.get(ip)
        if cached is None:
            return

        cidr_str, full, version, bare_ip, is_bare = _parse(ip)
        modification = DELETE
        old_host_ip = self.ip_to_host_ip.get(ip)
        new_host_ip: Optional[str] = None
        old_identity: Optional[int] = None
        new_identity = cached
        callback = True

        if not is_bare:
            net = ipaddress.ip_network(ip, strict=False)
            lengths = (
                self.v4_prefix_lengths
                if version == 4
                else self.v6_prefix_lengths
            )
            cnt = lengths.get(net.prefixlen, 0)
            if cnt <= 1:
                lengths.pop(net.prefixlen, None)
            else:
                lengths[net.prefixlen] = cnt - 1
            # CIDR shadowed by an endpoint IP: listeners never knew.
            # NB: the reference checks the network address for ANY
            # prefix length here (deleteLocked ipcache.go:376 has no
            # ones==bits guard, unlike Upsert) — reproduced as-is.
            if bare_ip in self.ip_to_identity and bare_ip != ip:
                callback = False
        else:
            # Was this endpoint IP shadowing an equivalent CIDR?
            cidr_ident = self.ip_to_identity.get(cidr_str)
            if cidr_ident is not None and cidr_str != ip:
                new_host_ip = self.ip_to_host_ip.get(cidr_str)
                if cidr_ident.id != cached.id or old_host_ip != new_host_ip:
                    # Revive the CIDR mapping (ipcache.go:393-399).
                    modification = UPSERT
                    old_identity = cached.id
                    new_identity = cidr_ident
                else:
                    callback = False

        del self.ip_to_identity[ip]
        ips = self.identity_to_ip.get(cached.id)
        if ips is not None:
            ips.discard(ip)
            if not ips:
                del self.identity_to_ip[cached.id]
        self.ip_to_host_ip.pop(ip, None)

        if callback:
            self._notify(
                modification, cidr_str, old_host_ip, new_host_ip,
                old_identity, new_identity.id,
            )

    # -- lookups (ipcache.go:438-489) ---------------------------------------

    def lookup_by_ip(self, ip: str) -> Tuple[Optional[IPIdentity], bool]:
        ident = self.ip_to_identity.get(ip)
        return ident, ident is not None

    def lookup_by_prefix(self, prefix: str) -> Tuple[Optional[IPIdentity], bool]:
        """Full prefixes also try the bare endpoint IP first
        (LookupByPrefixRLocked ipcache.go:458)."""
        if "/" in prefix:
            net = ipaddress.ip_network(prefix, strict=False)
            if net.prefixlen == net.max_prefixlen:
                ident = self.ip_to_identity.get(str(net.network_address))
                if ident is not None:
                    return ident, True
        ident = self.ip_to_identity.get(prefix)
        return ident, ident is not None

    def lookup_by_identity(self, num_id: int) -> Tuple[Optional[Set[str]], bool]:
        ips = self.identity_to_ip.get(num_id)
        return ips, ips is not None
