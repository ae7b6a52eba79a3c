"""Numeric security identities and the local identity allocator.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/identity/{numericidentity.go,identity.go,
allocator.go,cache.go}.  In the reference, identities are allocated
cluster-wide through a kvstore CAS allocator; here the allocator is an
in-process store with the same semantics (sorted-label key -> id,
refcounted), pluggable onto a distributed backend (the JAX package's
kvstore allocator, cilium_tpu/kvstore/allocator.py, not ported yet) for
multi-host operation.

The identity *universe* (id -> LabelArray) is the object the policy
compiler consumes: every table tensor is indexed by NumericIdentity, so
the universe snapshot (reference getLabelsMap, pkg/endpoint/policy.go:194)
is the shape-defining input of a compilation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.labels import Label, LabelArray, Labels

# numericidentity.go:20-35
MINIMAL_NUMERIC_IDENTITY = 256
USER_RESERVED_NUMERIC_IDENTITY = 128
INVALID_IDENTITY = 0

# numericidentity.go:38-58
IDENTITY_UNKNOWN = 0
RESERVED_HOST = 1
RESERVED_WORLD = 2
RESERVED_CLUSTER = 3
RESERVED_HEALTH = 4
RESERVED_INIT = 5

RESERVED_IDENTITIES: Dict[str, int] = {
    lbl.ID_NAME_HOST: RESERVED_HOST,
    lbl.ID_NAME_WORLD: RESERVED_WORLD,
    lbl.ID_NAME_HEALTH: RESERVED_HEALTH,
    lbl.ID_NAME_CLUSTER: RESERVED_CLUSTER,
    lbl.ID_NAME_INIT: RESERVED_INIT,
}

RESERVED_IDENTITY_NAMES: Dict[int, str] = {
    v: k for k, v in RESERVED_IDENTITIES.items()
}

# ClusterID partitioning (numericidentity.go:162): identity 24-bit local
# id + 8-bit cluster id.
CLUSTER_ID_SHIFT = 16


def get_reserved_id(name: str) -> int:
    return RESERVED_IDENTITIES.get(name, IDENTITY_UNKNOWN)


def is_user_reserved_identity(num_id: int) -> bool:
    return USER_RESERVED_NUMERIC_IDENTITY <= num_id < MINIMAL_NUMERIC_IDENTITY

def is_reserved_identity(num_id: int) -> bool:
    return num_id < MINIMAL_NUMERIC_IDENTITY


@dataclass
class Identity:
    """identity.go:27: numeric id + the labels that produced it."""

    id: int
    labels: Labels

    @property
    def label_array(self) -> LabelArray:
        # labels never mutate after allocation, so the array form is
        # computed once — identity_cache() walks every identity per
        # snapshot and the conversion dominated control-plane latency
        arr = self.__dict__.get("_label_array")
        if arr is None:
            arr = self.labels.to_label_array()
            self.__dict__["_label_array"] = arr
        return arr

    @property
    def sha256(self) -> str:
        return self.labels.sha256sum()

    def __repr__(self) -> str:
        return f"Identity({self.id}, {sorted(self.labels)})"


def reserved_identity(num_id: int) -> Identity:
    name = RESERVED_IDENTITY_NAMES[num_id]
    return Identity(
        id=num_id,
        labels=Labels(
            {name: Label(key=name, value="", source=lbl.SOURCE_RESERVED)}
        ),
    )


# id -> LabelArray; the compiler's shape-defining input.
IdentityCache = Dict[int, LabelArray]


class IdentityAllocator:
    """Label-set -> numeric identity allocator (allocator.go:122,534).

    Same contract as the reference's kvstore allocator: the key is the
    canonical sorted-label serialization; allocation is idempotent and
    refcounted; ids start at MINIMAL_NUMERIC_IDENTITY.  `local_only`
    allocations (CIDR identities, allocator.go:112) live in a disjoint
    id range so they never collide with cluster-scope ids.
    """

    # Local (CIDR) identities: the reference marks them with the top bit
    # of the 32-bit space via identity.LocalIdentityFlag in later
    # versions; v1.2 allocates them from the shared pool but never
    # publishes them.  We use a dedicated high range for clarity.
    LOCAL_IDENTITY_BASE = 1 << 24

    def __init__(self, backend=None):
        self._lock = threading.RLock()
        self._by_key: Dict[bytes, Identity] = {}
        self._by_id: Dict[int, Identity] = {}
        self._refs: Dict[int, int] = {}
        self._next_id = MINIMAL_NUMERIC_IDENTITY
        self._next_local = self.LOCAL_IDENTITY_BASE
        self._listeners: List = []
        # universe version: bumps whenever the id → labels map
        # changes; identity_cache() snapshots are cached against it
        # and the fleet compiler uses it as its universe_token
        self._version = 0
        self._cache_snapshot = None
        # Optional distributed backend (the kvstore allocator's
        # IdentityBackendAdapter, kvstore/allocator.py).
        self._backend = backend

    # -- allocation ----------------------------------------------------------

    def allocate(self, labels_in: Labels,
                 local_only: bool = False) -> (Identity, bool):
        """AllocateIdentity (identity/allocator.go:122).

        Reserved label sets resolve to reserved identities without
        touching the allocator (allocator.go:131-140).  Returns
        (identity, is_new).
        """
        reserved = self._lookup_reserved(labels_in)
        if reserved is not None:
            return reserved, False

        key = Labels(labels_in).sorted_list()
        with self._lock:
            existing = self._by_key.get(key)
            if existing is not None:
                self._refs[existing.id] += 1
                return existing, False
            if self._backend is not None and not local_only:
                num = self._backend.allocate(key)
            elif local_only:
                num = self._next_local
                self._next_local += 1
            else:
                num = self._next_id
                self._next_id += 1
            ident = Identity(id=num, labels=Labels(labels_in))
            self._by_key[key] = ident
            self._by_id[num] = ident
            self._refs[num] = 1
            self._version += 1
            self._notify("upsert", ident)
            return ident, True

    def release(self, ident: Identity) -> bool:
        """Refcounted release; True when the last ref is gone."""
        if is_reserved_identity(ident.id) and ident.id < USER_RESERVED_NUMERIC_IDENTITY:
            return False
        key = ident.labels.sorted_list()
        with self._lock:
            if ident.id not in self._refs:
                return False
            self._refs[ident.id] -= 1
            if self._refs[ident.id] > 0:
                return False
            del self._refs[ident.id]
            self._by_key.pop(key, None)
            self._by_id.pop(ident.id, None)
            self._version += 1
            if self._backend is not None:
                self._backend.release(key)
            self._notify("delete", ident)
            return True

    # -- lookup --------------------------------------------------------------

    def _lookup_reserved(self, labels_in: Labels) -> Optional[Identity]:
        """Reserved-source label -> reserved identity (allocator.go:250)."""
        if len(labels_in) != 1:
            return None
        (only,) = labels_in.values()
        if only.source != lbl.SOURCE_RESERVED:
            return None
        num = get_reserved_id(only.key)
        if num == IDENTITY_UNKNOWN:
            return None
        return reserved_identity(num)

    def lookup_by_id(self, num_id: int) -> Optional[Identity]:
        if num_id in RESERVED_IDENTITY_NAMES:
            return reserved_identity(num_id)
        with self._lock:
            return self._by_id.get(num_id)

    def lookup_by_labels(self, labels_in: Labels) -> Optional[Identity]:
        reserved = self._lookup_reserved(labels_in)
        if reserved is not None:
            return reserved
        with self._lock:
            return self._by_key.get(Labels(labels_in).sorted_list())

    # -- universe snapshot ---------------------------------------------------

    @property
    def version(self) -> int:
        """Universe version — pairs with identity_cache() snapshots
        (the fleet compiler's universe_token)."""
        with self._lock:
            return self._version

    def identity_cache(self) -> IdentityCache:
        """GetIdentityCache + reserved ids (endpoint getLabelsMap,
        pkg/endpoint/policy.go:194-211): snapshot of all known identities
        including the reserved ones.

        Cached against the allocator version: rebuilding this map is
        O(universe) and used to dominate every regeneration sweep.
        Consumers treat the returned dict as read-only."""
        with self._lock:
            cached = self._cache_snapshot
            if cached is not None and cached[0] == self._version:
                return cached[1]
            cache: IdentityCache = {
                num: ident.label_array
                for num, ident in self._by_id.items()
            }
            for num in RESERVED_IDENTITY_NAMES:
                cache[num] = reserved_identity(num).label_array
            self._cache_snapshot = (self._version, cache)
            return cache

    def identity_cache_versioned(self) -> Tuple[IdentityCache, int]:
        """(identity_cache(), version) read under one lock."""
        with self._lock:
            return self.identity_cache(), self._version

    # -- events (identity/cache.go:82 identityWatcher) -----------------------

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def _notify(self, kind: str, ident: Identity) -> None:
        for fn in list(self._listeners):
            fn(kind, ident)
