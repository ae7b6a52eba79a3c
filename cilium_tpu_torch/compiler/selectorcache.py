"""SelectorCache: bulk selector → identity-set resolution.

The port's own copy of the JAX package's compiler/selectorcache.py.

The reference's computeDesiredPolicyMapState walks every known
identity per endpoint per selector (pkg/endpoint/policy.go:92,318 —
O(identities × selectors) calls into k8s LabelSelector matching).
That is fine in Go at small scale; at the 50k-rule / 64k-identity
envelope it dominates control-plane latency.

TPU-first control plane treats selector resolution as set algebra over
inverted indexes instead of per-pair predicate calls:

  * per identity, the *effective* label view is two first-occurrence
    maps (LabelArray.get returns the first matching label in array
    order, labels.py has/get):
      - ``any.<key>``    → value of the first label with that key
      - ``<src>.<key>``  → value of the first label with that exact
                           extended key
  * the cache maintains postings  (key_form, value) → {ids}  and
    key_form → {ids}  (exists), so a selector's match set is exactly:
      - match_labels:      ∩ val_index[(k, v)]
      - In(k, vs):         ∩ ⋃ val_index[(k, v) for v in vs]
      - NotIn(k, vs):      − ⋃ val_index[(k, v) for v in vs]
      - Exists(k):         ∩ exists_index[k]
      - DoesNotExist(k):   − exists_index[k]
    which reproduces Requirement.matches / EndpointSelector.matches
    (policy/api/selector.py) exactly, because those are defined purely
    in terms of has/get.

Results are memoized per selector object (selectors hash by identity,
matching the reference's pointer-keyed L7DataMap) and invalidated by a
universe version bump.  Incremental identity add/remove updates the
postings in O(labels of that identity) and re-validates memoized
selectors lazily.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, FrozenSet, List, Set, Tuple

from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.identity import IdentityCache
from cilium_tpu_torch.labels import PATH_DELIMITER, SOURCE_ANY, LabelArray
from cilium_tpu_torch.policy.api.selector import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    EndpointSelector,
)


def _effective_views(labels: LabelArray) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(any_first, ext_first): first-occurrence value maps mirroring
    LabelArray.get's array-order semantics."""
    any_first: Dict[str, str] = {}
    ext_first: Dict[str, str] = {}
    for l in labels:
        if l.key not in any_first:
            any_first[l.key] = l.value
        ek = l.get_extended_key()
        if ek not in ext_first:
            ext_first[ek] = l.value
    return any_first, ext_first


def _split_key_form(ext_key: str) -> Tuple[bool, str]:
    """ext_key → (is_any_source, canonical form).  Mirrors
    labels.get_cilium_key_from + parse_label: a missing source prefix
    means the any source."""
    parts = ext_key.split(PATH_DELIMITER, 1)
    if len(parts) == 2:
        return parts[0] == SOURCE_ANY, ext_key
    return True, SOURCE_ANY + PATH_DELIMITER + parts[0]


class SelectorCache:
    """Identity-universe index + memoized selector match sets."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._universe: Dict[int, LabelArray] = {}
        self._val_index: Dict[Tuple[str, str], Set[int]] = {}
        self._exists_index: Dict[str, Set[int]] = {}
        # per-id undo lists: the index keys this id was posted under
        self._postings: Dict[int, List[Tuple[str, str]]] = {}
        self._all: Set[int] = set()
        self.version = 0
        # (allocator cache version, own version) of the last full sync
        self._synced: Tuple[int, int] = (-1, -1)
        self._memo: "weakref.WeakKeyDictionary[EndpointSelector, Tuple[int, FrozenSet[int]]]" = (
            weakref.WeakKeyDictionary()
        )

    # -- universe maintenance ------------------------------------------------

    def _index_identity(self, num_id: int, labels: LabelArray) -> None:
        any_first, ext_first = _effective_views(labels)
        posted: List[Tuple[str, str]] = []
        for k, v in any_first.items():
            form = SOURCE_ANY + PATH_DELIMITER + k
            self._val_index.setdefault((form, v), set()).add(num_id)
            self._exists_index.setdefault(form, set()).add(num_id)
            posted.append((form, v))
        for ek, v in ext_first.items():
            # The 'any.<key>' index form is fed ONLY by the bare-key
            # first-occurrence map above: LabelArray.get('any.<key>')
            # returns the first bare-key value in array order, so an
            # any-source label shadowed by an earlier same-key label of
            # another source must not post under 'any.<key>'.
            if ek.split(PATH_DELIMITER, 1)[0] == SOURCE_ANY:
                continue
            self._val_index.setdefault((ek, v), set()).add(num_id)
            self._exists_index.setdefault(ek, set()).add(num_id)
            posted.append((ek, v))
        self._postings[num_id] = posted
        self._all.add(num_id)

    def _unindex_identity(self, num_id: int) -> None:
        for form, v in self._postings.pop(num_id, []):
            s = self._val_index.get((form, v))
            if s is not None:
                s.discard(num_id)
                if not s:
                    del self._val_index[(form, v)]
            e = self._exists_index.get(form)
            if e is not None:
                e.discard(num_id)
                if not e:
                    del self._exists_index[form]
        self._all.discard(num_id)

    def upsert_identity(self, num_id: int, labels: LabelArray) -> None:
        with self._lock:
            old = self._universe.get(num_id)
            if old is not None:
                if old == labels:
                    return
                self._unindex_identity(num_id)
            self._universe[num_id] = labels
            self._index_identity(num_id, labels)
            self.version += 1

    def remove_identity(self, num_id: int) -> None:
        with self._lock:
            if self._universe.pop(num_id, None) is not None:
                self._unindex_identity(num_id)
                self.version += 1

    def sync(
        self, identity_cache: IdentityCache, cache_version=None
    ) -> int:
        """Diff the universe against a full identity-cache snapshot
        (getLabelsMap, policy.go:194) and apply adds/changes/removes
        incrementally.  Returns the resulting version.

        `cache_version` is the allocator's version stamp for this
        snapshot: when it matches the previously synced stamp (and no
        out-of-band upsert/remove moved the cache since), the
        O(universe) diff is skipped entirely — the hot path for
        rule-only churn, where the identity universe is untouched."""
        with self._lock:
            if (
                cache_version is not None
                and self._synced == (cache_version, self.version)
            ):
                return self.version
            for num_id in list(self._universe):
                if num_id not in identity_cache:
                    self.remove_identity(num_id)
            for num_id, labels in identity_cache.items():
                self.upsert_identity(num_id, labels)
            if cache_version is not None:
                self._synced = (cache_version, self.version)
            return self.version

    def identities(self) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._all)

    # -- selector resolution -------------------------------------------------

    def _resolve(self, selector: EndpointSelector) -> FrozenSet[int]:
        # reserved.all short-circuit (selector.go:277 via matches())
        for k in selector.match_labels:
            if k == lbl.SOURCE_RESERVED_KEY_PREFIX + lbl.ID_NAME_ALL:
                return frozenset(self._all)
        # Gather positive constraint sets first and seed from the
        # smallest, so resolving a narrow selector (the common case:
        # one match_labels pair selecting a handful of ids) never
        # copies the whole universe — intersection and subtraction
        # commute, so positives-first is order-equivalent to the
        # requirement walk.
        positive: List[Set[int]] = []
        negative: List[Set[int]] = []
        fallback_reqs = []
        for ext_key, value in selector.match_labels.items():
            _, form = _split_key_form(ext_key)
            positive.append(self._val_index.get((form, value), set()))
        for req in selector.match_expressions:
            _, form = _split_key_form(req.key)
            if req.operator == OP_IN:
                hit: Set[int] = set()
                for v in req.values:
                    hit |= self._val_index.get((form, v), set())
                positive.append(hit)
            elif req.operator == OP_NOT_IN:
                miss: Set[int] = set()
                for v in req.values:
                    miss |= self._val_index.get((form, v), set())
                negative.append(miss)
            elif req.operator == OP_EXISTS:
                positive.append(self._exists_index.get(form, set()))
            elif req.operator == OP_DOES_NOT_EXIST:
                negative.append(self._exists_index.get(form, set()))
            else:  # pragma: no cover - sanitize rejects unknown ops
                fallback_reqs.append(req)
        if positive:
            seed = min(positive, key=len)
            candidates = set(seed)
            for s in positive:
                if s is seed:
                    continue
                candidates &= s
                if not candidates:
                    return frozenset()
        else:
            candidates = set(self._all)
        for s in negative:
            candidates -= s
            if not candidates:
                return frozenset()
        for req in fallback_reqs:  # pragma: no cover
            candidates = {
                i for i in candidates if req.matches(self._universe[i])
            }
        return frozenset(candidates)

    def matches(self, selector: EndpointSelector) -> FrozenSet[int]:
        """All identity ids the selector selects, memoized."""
        with self._lock:
            hit = self._memo.get(selector)
            if hit is not None and hit[0] == self.version:
                return hit[1]
            result = self._resolve(selector)
            self._memo[selector] = (self.version, result)
            return result


class RuleIndex:
    """identity id → the ordered sublist of repo rules whose
    endpoint_selector selects that identity's labels.

    Every per-endpoint resolution walk (resolve_l4_*, resolve_cidr,
    the L3 label loop) is a no-op for rules not selecting the
    endpoint, so restricting the walk to this sublist is semantics-
    preserving and turns O(rules) per endpoint into O(relevant rules)
    — the control-plane analog of the per-endpoint PROG_ARRAY
    dispatch.  Rebuilt lazily when the repo revision or the selector-
    cache universe version moves.
    """

    def __init__(self) -> None:
        self._key: Tuple[int, int] = (-1, -1)
        self._map: Dict[int, List] = {}
        self._seen: List = []  # rule refs in repo order, for delta builds
        self._lock = threading.Lock()

    def build(self, repo, selector_cache: SelectorCache) -> None:
        key = (repo.get_revision(), selector_cache.version)
        with self._lock:
            if key == self._key:
                return
            rules = list(repo.rules)
            # append-only fast path: same universe, previous rules an
            # identical prefix of the new list → index only the suffix
            append_only = (
                self._key[1] == key[1]
                and len(rules) >= len(self._seen)
                and all(
                    a is b for a, b in zip(self._seen, rules)
                )
            )
            if append_only:
                new_rules = rules[len(self._seen):]
                m = self._map
            else:
                new_rules = rules
                m = {}
            for r in new_rules:
                for num_id in selector_cache.matches(r.endpoint_selector):
                    m.setdefault(num_id, []).append(r)
            self._map = m
            self._seen = rules
            self._key = key

    def relevant(self, identity_id: int) -> List:
        with self._lock:
            return self._map.get(identity_id, [])
