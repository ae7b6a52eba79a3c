"""Tunnel (overlay) map: the encap forwarding decision.

The reference keeps a prefix -> tunnel-endpoint map (pkg/maps/tunnel,
SetTunnelEndpoint), fed from node discovery, that bpf_overlay.c and
lib/encap.h consult: a packet whose destination falls in a remote
node's pod CIDR is encapsulated to that node's IP, with the source
identity in the tunnel metadata; local and unknown destinations go
direct.

The map lowers to masked ranges, one per remote pod CIDR (there are
one or two per node): `TunnelTables` for v4 prefixes, `TunnelTables6`
(limb-masked, as ipcache/lpm6.build_limb_ranges builds them) for v6
prefixes, both with a v4 underlay node IP per range.  The per-flow
decision is a scan over the ranges that keeps the largest endpoint
among the matches (the pod CIDRs are disjoint, so any match wins), then
0 where it equals the local node's IP: 0 means no encapsulation.
Padding rows never match (v4: base 1, mask 0; v6: limb0 base 1, mask
0).

`tunnel_select` and `tunnel_select6` are the plain PyTorch versions;
on the card the datapath kernels run the same scan (csrc/tunnel.cuh).
The node-discovery feed (`on_node` in the reference package) needs the
kvstore and the control plane, which the port does not carry yet.
"""

from __future__ import annotations

import ipaddress
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from cilium_tpu_torch.device import widen
from cilium_tpu_torch.ipcache.lpm6 import (
    _mask_limbs,
    build_limb_ranges,
    limbs_of_int,
    match_limb_ranges,
)


@dataclass
class TunnelTables:
    """v4 (base, mask) ranges -> tunnel endpoint."""

    base: object  # u32 [P]
    mask: object  # u32 [P]
    endpoint: object  # u32 [P] node IP (0 = padding)


@dataclass
class TunnelTables6:
    """v6 pod CIDRs -> tunnel endpoint: limb-masked ranges with a v4
    underlay node IP per range."""

    base: object  # u32 [P, 4] limb base
    mask: object  # u32 [P, 4] limb mask
    endpoint: object  # u32 [P] node IP (0 = padding)


class TunnelMap:
    """prefix -> tunnel endpoint (the reference's TunnelMap).  Both
    families key one map; `tables()` and `tables6()` lower each half."""

    MAX_PREFIXES = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._prefixes: Dict[str, int] = {}
        self._dirty = True
        self._tables: Optional[TunnelTables] = None
        self._tables6: Optional[TunnelTables6] = None

    def set_tunnel_endpoint(self, prefix: str,
                            endpoint_ip: str) -> Optional[int]:
        """SetTunnelEndpoint.  Returns the stored endpoint u32, or None
        when skipped: the underlay is v4 by design, so a v6 endpoint IP
        is skipped.  Raises when the map is full."""
        try:
            ep = int(ipaddress.IPv4Address(endpoint_ip))
        except (ipaddress.AddressValueError, ValueError):
            return None
        with self._lock:
            if (prefix not in self._prefixes
                    and len(self._prefixes) >= self.MAX_PREFIXES):
                raise ValueError(
                    f"tunnel map exceeds {self.MAX_PREFIXES} prefixes"
                )
            self._prefixes[prefix] = ep
            self._dirty = True
            return ep

    def delete_tunnel_endpoint(self, prefix: str) -> None:
        with self._lock:
            self._prefixes.pop(prefix, None)
            self._dirty = True

    def snapshot(self) -> Dict[str, str]:
        """prefix -> dotted node IP (the `cilium bpf tunnel list`
        shape)."""
        with self._lock:
            return {
                prefix: str(ipaddress.ip_address(ep))
                for prefix, ep in self._prefixes.items()
            }

    def _refresh_locked(self) -> None:
        """Drop both lowered forms after a mutation (under _lock); each
        rebuilds when next asked for."""
        if self._dirty:
            self._tables = None
            self._tables6 = None
            self._dirty = False

    def tables(self) -> TunnelTables:
        """The v4 half of the map (host numpy)."""
        with self._lock:
            self._refresh_locked()
            if self._tables is not None:
                return self._tables
            nets = []
            for cidr, ep in sorted(self._prefixes.items()):
                net = ipaddress.ip_network(cidr, strict=False)
                if net.version == 4:
                    nets.append(
                        (int(net.network_address), int(net.netmask), ep)
                    )
            p = 8
            while p < len(nets):
                p *= 2
            base = np.ones(p, dtype=np.uint32)
            mask = np.zeros(p, dtype=np.uint32)
            endpoint = np.zeros(p, dtype=np.uint32)
            for i, (b, m, e) in enumerate(nets):
                base[i], mask[i], endpoint[i] = b, m, e
            self._tables = TunnelTables(base=base, mask=mask,
                                        endpoint=endpoint)
            return self._tables

    def tables6(self) -> TunnelTables6:
        """The v6 half of the map (host numpy)."""
        with self._lock:
            self._refresh_locked()
            if self._tables6 is not None:
                return self._tables6
            nets, eps = [], []
            for cidr, ep in sorted(self._prefixes.items()):
                net = ipaddress.ip_network(cidr, strict=False)
                if net.version != 6:
                    continue
                nets.append((limbs_of_int(int(net.network_address)),
                             _mask_limbs(net.prefixlen)))
                eps.append(ep)
            base, mask = build_limb_ranges(nets)
            endpoint = np.zeros(base.shape[0], dtype=np.uint32)
            endpoint[: len(eps)] = eps
            self._tables6 = TunnelTables6(base=base, mask=mask,
                                          endpoint=endpoint)
            return self._tables6


def _pick_endpoint(match, endpoint, local_node_ip: int) -> torch.Tensor:
    """The largest endpoint (u32) among each row's matches, 0 where
    none matches or it is the local node's."""
    ep = torch.where(match, widen(endpoint)[None, :], 0).max(dim=1).values
    return torch.where(ep == (local_node_ip & 0xFFFFFFFF), 0, ep)


def tunnel_select(tables: TunnelTables, daddr,
                  local_node_ip: int = 0) -> torch.Tensor:
    """Plain version: destination u32 [B] -> tunnel endpoint, int64
    holding the u32 value (0 = direct or local)."""
    ips = widen(daddr)
    match = (ips[:, None] & widen(tables.mask)[None, :]) == (
        widen(tables.base)[None, :]
    )
    return _pick_endpoint(match, tables.endpoint, local_node_ip)


def tunnel_select6(tables: TunnelTables6, daddr_limbs,
                   local_node_ip: int = 0) -> torch.Tensor:
    """Plain version: destination limbs u32 [B, 4] -> tunnel endpoint,
    int64 holding the u32 value (0 = direct or local)."""
    match = match_limb_ranges(tables.base, tables.mask, daddr_limbs)
    return _pick_endpoint(match, tables.endpoint, local_node_ip)
