"""CIDR → local identity allocation.

The port's own copy of the JAX package's ipcache/cidr.py.

Behavioral port of pkg/ipcache/cidr.go (AllocateCIDRs
cidr.go:29, ReleaseCIDRs cidr.go:58) and
pkg/identity/cidr/identity.go (AllocateCIDRIdentities): every CIDR
referenced by policy gets a *local* identity (never published to the
cluster store, allocator.go:112) labeled with its full prefix ladder
(labels.get_cidr_labels), and an ipcache mapping so the datapath can
resolve flows hitting that prefix.
"""

from __future__ import annotations

import ipaddress
from typing import Iterable, List, Tuple

from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.identity import Identity, IdentityAllocator
from cilium_tpu_torch.ipcache.ipcache import FROM_AGENT_LOCAL, IPCache, IPIdentity
from cilium_tpu_torch.labels import Labels


def allocate_cidr_identities(
    allocator: IdentityAllocator, prefixes: Iterable[str]
) -> List[Identity]:
    """identity/cidr/identity.go:32 — one local identity per prefix,
    keyed by the CIDR label set."""
    out = []
    for prefix in prefixes:
        net = ipaddress.ip_network(prefix, strict=False)
        arr = lbl.get_cidr_labels(net)
        labels_map = Labels({l.key: l for l in arr})
        ident, _ = allocator.allocate(labels_map, local_only=True)
        out.append(ident)
    return out


def allocate_cidrs(
    ipcache: IPCache,
    allocator: IdentityAllocator,
    prefixes: Iterable[str],
) -> List[Identity]:
    """ipcache/cidr.go:29 AllocateCIDRs: labels→ID mappings, then
    CIDR→ID ipcache mappings (kvstore upsert in the reference; local
    upsert here — the kvstore layer replays it cluster-wide)."""
    prefixes = list(prefixes)
    identities = allocate_cidr_identities(allocator, prefixes)
    for prefix, ident in zip(prefixes, identities):
        net = ipaddress.ip_network(prefix, strict=False)
        ipcache.upsert(str(net), IPIdentity(ident.id, FROM_AGENT_LOCAL))
    return identities


def release_cidrs(
    ipcache: IPCache,
    allocator: IdentityAllocator,
    prefixes: Iterable[str],
) -> None:
    """ipcache/cidr.go:58 ReleaseCIDRs."""
    for prefix in prefixes:
        net = ipaddress.ip_network(prefix, strict=False)
        arr = lbl.get_cidr_labels(net)
        labels_map = Labels({l.key: l for l in arr})
        ident = allocator.lookup_by_labels(labels_map)
        if ident is None:
            continue
        if allocator.release(ident):
            ipcache.delete(str(net))
