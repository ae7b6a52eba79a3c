"""Per-endpoint policy map state: the datapath's policy input.

Cilium's agent writes one BPF hash map per endpoint, keyed by
(identity, dport, proto, direction) (pkg/maps/policymap PolicyKey)
with a PolicyEntry value carrying the proxy port; the datapath probes
it in `__policy_can_access` (bpf/lib/policy.h).  Here a map state is
a dict of those keys and entries, or the same state as sorted packed
key arrays (`MapStateArrays`, what the daemon's endpoints hold), the
input of compiler.tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

# Traffic direction (pkg/maps/policymap: Ingress=0, Egress=1).
INGRESS = 0
EGRESS = 1

# policymap.go: max entries of the per-endpoint verdict table.
MAX_ENTRIES = 16384

# policymap.go: port 0 means "all ports" (the L3-only slot).
ALL_PORTS = 0


@dataclass(frozen=True)
class PolicyKey:
    identity: int  # u32 source (ingress) / dest (egress) security id
    dest_port: int = 0  # u16, host byte order; 0 = all ports
    nexthdr: int = 0  # u8 IP protocol; 0 = any
    traffic_direction: int = INGRESS  # u8

    def is_l3_only(self) -> bool:
        return self.dest_port == 0 and self.nexthdr == 0


@dataclass
class PolicyMapStateEntry:
    """proxy_port > 0 means the verdict is redirect-to-proxy; packets
    and bytes are the per-entry counters the datapath accumulates."""

    proxy_port: int = 0  # u16, host byte order
    packets: int = 0
    bytes: int = 0


PolicyMapState = Dict[PolicyKey, PolicyMapStateEntry]


def sort_keys(state: PolicyMapState) -> List[PolicyKey]:
    """Deterministic dump order (PolicyEntriesDump.Less,
    policymap.go:96: direction then identity)."""
    return sorted(
        state.keys(),
        key=lambda k: (k.traffic_direction, k.identity, k.dest_port, k.nexthdr),
    )


def diff_map_state(
    realized: PolicyMapState, desired: PolicyMapState
) -> Tuple[List[PolicyKey], List[PolicyKey]]:
    """syncPolicyMap's delta (pkg/endpoint/endpoint.go:2572): returns
    (keys_to_add_or_update, keys_to_delete)."""
    to_add = [
        k
        for k, v in desired.items()
        if k not in realized or realized[k].proxy_port != v.proxy_port
    ]
    to_delete = [k for k in realized if k not in desired]
    return to_add, to_delete


# ---------------------------------------------------------------------------
# Array-backed map state
# ---------------------------------------------------------------------------
#
# At config 5's scale a map state holds tens of thousands of entries per
# endpoint; building and lowering them as dicts of PolicyKey dataclasses
# is per-entry Python.  MapStateArrays keeps the same state as sorted
# packed u64 keys with parallel value arrays, so FleetCompiler lowers it
# with array operations, while reads stay dict-compatible (get, [], in,
# items, len, ==).

_KEY_DTYPE = np.uint64


def pack_keys(identity, dest_port, nexthdr, direction) -> np.ndarray:
    """PolicyKey columns -> u64: identity<<32 | dport<<16 | proto<<8 | dir."""
    return (
        (np.asarray(identity, np.uint64) << np.uint64(32))
        | (np.asarray(dest_port, np.uint64) << np.uint64(16))
        | (np.asarray(nexthdr, np.uint64) << np.uint64(8))
        | np.asarray(direction, np.uint64)
    )


def _pack_one(key: PolicyKey) -> np.uint64:
    return np.uint64(
        (key.identity << 32)
        | (key.dest_port << 16)
        | (key.nexthdr << 8)
        | key.traffic_direction
    )


def unpack_keys(packed: np.ndarray):
    """u64 array -> (identity u32, dest_port, nexthdr, direction) arrays."""
    packed = np.asarray(packed, np.uint64)
    identity = (packed >> np.uint64(32)).astype(np.uint32)
    dport = ((packed >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.int32)
    proto = ((packed >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int32)
    direction = (packed & np.uint64(0xFF)).astype(np.int32)
    return identity, dport, proto, direction


class _EntryView:
    """A PolicyMapStateEntry view into the arrays: counter writes land
    in the backing store."""

    __slots__ = ("_state", "_pos")

    def __init__(self, state: "MapStateArrays", pos: int) -> None:
        self._state = state
        self._pos = pos

    @property
    def proxy_port(self) -> int:
        return int(self._state.proxy[self._pos])

    @property
    def packets(self) -> int:
        return int(self._state.packets[self._pos])

    @packets.setter
    def packets(self, v: int) -> None:
        self._state.packets[self._pos] = v

    @property
    def bytes(self) -> int:
        return int(self._state.bytes[self._pos])

    @bytes.setter
    def bytes(self, v: int) -> None:
        self._state.bytes[self._pos] = v

    def __eq__(self, other) -> bool:
        if isinstance(other, (PolicyMapStateEntry, _EntryView)):
            return (
                self.proxy_port == other.proxy_port
                and self.packets == other.packets
                and self.bytes == other.bytes
            )
        return NotImplemented

    def __repr__(self) -> str:
        return (f"_EntryView(proxy_port={self.proxy_port}, "
                f"packets={self.packets}, bytes={self.bytes})")


class MapStateArrays:
    """A map state as sorted packed keys: `keys_packed` strictly
    increasing u64; `proxy` (u32), `packets` and `bytes` (i64)
    parallel.  Counters mutate in place through _EntryView; the key set
    is immutable (a change builds a new instance, so a compile that
    holds one keeps a stable snapshot)."""

    __slots__ = ("keys_packed", "proxy", "packets", "bytes")

    def __init__(self, keys_packed, proxy, packets=None, bytes_=None) -> None:
        m = len(keys_packed)
        self.keys_packed = np.asarray(keys_packed, _KEY_DTYPE)
        self.proxy = np.asarray(proxy, np.uint32)
        self.packets = np.zeros(m, np.int64) if packets is None else packets
        self.bytes = np.zeros(m, np.int64) if bytes_ is None else bytes_

    # -- construction ---------------------------------------------------------

    @staticmethod
    def build(keys_packed, proxy) -> "MapStateArrays":
        """Sort and dedupe unsorted key/proxy arrays.  A duplicate key
        takes its LAST occurrence's value, as sequential dict insertion
        does."""
        keys_packed = np.asarray(keys_packed, _KEY_DTYPE)
        proxy = np.asarray(proxy, np.uint32)
        uniq, first_rev = np.unique(keys_packed[::-1], return_index=True)
        last = len(keys_packed) - 1 - first_rev
        return MapStateArrays(uniq, proxy[last])

    @staticmethod
    def from_dict(state: PolicyMapState) -> "MapStateArrays":
        if isinstance(state, MapStateArrays):
            return state
        items = sorted((int(_pack_one(k)), v) for k, v in state.items())
        keys = np.asarray([k for k, _ in items], _KEY_DTYPE)
        proxy = np.asarray([v.proxy_port for _, v in items], np.uint32)
        packets = np.asarray([v.packets for _, v in items], np.int64)
        bytes_ = np.asarray([v.bytes for _, v in items], np.int64)
        return MapStateArrays(keys, proxy, packets, bytes_)

    def to_dict(self) -> PolicyMapState:
        return {
            key: PolicyMapStateEntry(
                proxy_port=int(self.proxy[i]),
                packets=int(self.packets[i]),
                bytes=int(self.bytes[i]),
            )
            for i, key in enumerate(self._iter_keys())
        }

    # -- dict-compatible read access ------------------------------------------

    def _find(self, key: PolicyKey) -> int:
        packed = _pack_one(key)
        pos = int(np.searchsorted(self.keys_packed, packed))
        if pos < len(self.keys_packed) and self.keys_packed[pos] == packed:
            return pos
        return -1

    def get(self, key: PolicyKey, default=None):
        pos = self._find(key)
        return _EntryView(self, pos) if pos >= 0 else default

    def __getitem__(self, key: PolicyKey) -> _EntryView:
        pos = self._find(key)
        if pos < 0:
            raise KeyError(key)
        return _EntryView(self, pos)

    def __contains__(self, key: PolicyKey) -> bool:
        return self._find(key) >= 0

    def __len__(self) -> int:
        return len(self.keys_packed)

    def _iter_keys(self) -> Iterable[PolicyKey]:
        ident, dport, proto, direction = unpack_keys(self.keys_packed)
        for i in range(len(self.keys_packed)):
            yield PolicyKey(int(ident[i]), int(dport[i]), int(proto[i]),
                            int(direction[i]))

    def __iter__(self):
        return self._iter_keys()

    def keys(self):
        return list(self._iter_keys())

    def values(self):
        return [_EntryView(self, i) for i in range(len(self))]

    def items(self):
        return [(key, _EntryView(self, i))
                for i, key in enumerate(self._iter_keys())]

    def __eq__(self, other) -> bool:
        if isinstance(other, MapStateArrays):
            return (
                np.array_equal(self.keys_packed, other.keys_packed)
                and np.array_equal(self.proxy, other.proxy)
                and np.array_equal(self.packets, other.packets)
                and np.array_equal(self.bytes, other.bytes)
            )
        if isinstance(other, dict):
            if len(other) != len(self):
                return False
            for key, entry in other.items():
                mine = self.get(key)
                if mine is None or mine != entry:
                    return False
            return True
        return NotImplemented

    def __bool__(self) -> bool:
        return len(self.keys_packed) > 0

    def __repr__(self) -> str:
        return f"MapStateArrays({len(self)} entries)"


def sync_map_arrays(
    realized: "MapStateArrays", desired: "MapStateArrays"
) -> Tuple["MapStateArrays", int, int]:
    """Vectorized syncPolicyMap (endpoint.go:2572): returns
    (new_realized, n_added_or_updated, n_deleted).  Counters of keys
    present in both states carry over (including proxy-port changes,
    matching the dict path's old.packets preservation)."""
    nd, nr = len(desired.keys_packed), len(realized.keys_packed)
    if nr:
        pos = np.searchsorted(realized.keys_packed, desired.keys_packed)
        pos_c = np.minimum(pos, nr - 1)
        present = realized.keys_packed[pos_c] == desired.keys_packed
        changed = ~present | (
            present & (realized.proxy[pos_c] != desired.proxy)
        )
        packets = np.where(present, realized.packets[pos_c], 0)
        bytes_ = np.where(present, realized.bytes[pos_c], 0)
    else:
        changed = np.ones(nd, bool)
        packets = np.zeros(nd, np.int64)
        bytes_ = np.zeros(nd, np.int64)
    n_add = int(changed.sum())
    # deletions: realized keys absent from desired
    if nd and nr:
        rpos = np.searchsorted(desired.keys_packed, realized.keys_packed)
        rpos_c = np.minimum(rpos, nd - 1)
        still = desired.keys_packed[rpos_c] == realized.keys_packed
        n_del = int((~still).sum())
    else:
        n_del = nr
    new = MapStateArrays(
        desired.keys_packed, desired.proxy.copy(), packets, bytes_
    )
    return new, n_add, n_del
