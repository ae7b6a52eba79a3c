"""Desired policy-map-state computation (the compiler frontend).

The port's own copy of the JAX package's compiler/mapstate.py.

Behavioral port of pkg/endpoint/policy.go:
  - resolveL4Policy (policy.go:222)
  - convertL4FilterToPolicyMapKeys (policy.go:110)
  - computeDesiredL4PolicyMapEntries (policy.go:143)
  - determineAllowLocalhost / determineAllowFromWorld (policy.go:285,306)
  - computeDesiredL3PolicyMapEntries (policy.go:318)

This host-side pass is the *semantic spec* of the verdict tables: the
engine's device output must be bit-identical to evaluating the map
state returned here with the 3-probe lattice (engine.oracle).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cilium_tpu_torch import option
from cilium_tpu_torch.identity import (
    RESERVED_HOST,
    RESERVED_WORLD,
    IdentityCache,
)
from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.maps.policymap import (
    EGRESS,
    INGRESS,
    MapStateArrays,
    PolicyKey,
    PolicyMapState,
    PolicyMapStateEntry,
)
from cilium_tpu_torch.policy.l4 import L4Filter, L4Policy, proxy_id
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.search import Decision, SearchContext

# policy.go:49-60: unconditional ingress L3 allows.
LOCALHOST_KEY = PolicyKey(identity=RESERVED_HOST, traffic_direction=INGRESS)
WORLD_KEY = PolicyKey(identity=RESERVED_WORLD, traffic_direction=INGRESS)


def _get_security_identities(labels_map: IdentityCache, selector) -> list:
    """policy.go:92: all identity ids whose labels the selector selects."""
    return [
        num_id
        for num_id, labels in labels_map.items()
        if selector.matches(labels)
    ]


def _convert_l4_filter_to_keys(
    labels_map: IdentityCache, f: L4Filter, direction: int
) -> list:
    """policy.go:110: one PolicyKey per (selected identity, port, proto)."""
    keys = []
    for sel in f.endpoints:
        for num_id in _get_security_identities(labels_map, sel):
            keys.append(
                PolicyKey(
                    identity=num_id,
                    dest_port=f.port,
                    nexthdr=f.u8proto,
                    traffic_direction=direction,
                )
            )
    return keys


def resolve_l4_policy(
    repo: Repository,
    ep_labels: LabelArray,
    ingress_enabled: bool = True,
    egress_enabled: bool = True,
    rules=None,
) -> L4Policy:
    """policy.go:222 resolveL4Policy.  `rules` restricts the walk to
    the endpoint's relevant sublist (RuleIndex invariant)."""
    from cilium_tpu_torch.policy.l4 import L4PolicyMap

    ingress = (
        repo.resolve_l4_ingress_policy(
            SearchContext(to_labels=ep_labels), rules
        )
        if ingress_enabled
        else L4PolicyMap()
    )
    egress = (
        repo.resolve_l4_egress_policy(
            SearchContext(from_labels=ep_labels), rules
        )
        if egress_enabled
        else L4PolicyMap()
    )
    return L4Policy(ingress=ingress, egress=egress)


def _l3_allowed_identities(
    repo: Repository,
    selector_cache,
    ep_labels: LabelArray,
    ingress: bool,
    rules=None,
) -> frozenset:
    """The set of identities whose label-only verdict is ALLOWED,
    computed with set algebra over the SelectorCache instead of the
    per-identity can_reach walk.

    Derivation from the reference lattice (repository.go:80 +
    rule.go:352-391): iterating rules, the first DENIED (an unmet
    FromRequires of any rule selecting the endpoint) terminates with
    Denied, and ALLOWED (an L3-only allow match) is remembered
    otherwise — so the final label verdict for an identity is ALLOWED
    iff (a) no relevant rule's requires reject it, and (b) some
    relevant rule's L3-only (no ToPorts) block selects it.  Both are
    unions/intersections of selector match sets.
    """
    universe = selector_cache.identities()
    allowed: set = set()
    denied: set = set()
    for r in repo.rules if rules is None else rules:
        if not r.endpoint_selector.matches(ep_labels):
            continue
        blocks = r.rule.ingress if ingress else r.rule.egress
        for b in blocks:
            requires = b.from_requires if ingress else b.to_requires
            for sel in requires:
                denied |= universe - selector_cache.matches(sel)
        for b in blocks:
            if len(b.to_ports) != 0:
                continue
            sels = (
                b.get_source_endpoint_selectors()
                if ingress
                else b.get_destination_endpoint_selectors()
            )
            for sel in sels:
                allowed |= selector_cache.matches(sel)
    return frozenset(allowed - denied)


def compute_desired_policy_map_state(
    repo: Repository,
    identity_cache: IdentityCache,
    ep_labels: LabelArray,
    *,
    endpoint_id: int = 0,
    ingress_enabled: bool = True,
    egress_enabled: bool = True,
    realized_redirects: Optional[Dict[str, int]] = None,
    l4_policy: Optional[L4Policy] = None,
    selector_cache=None,
    rules=None,
) -> PolicyMapState:
    """computeDesiredPolicyMapState (policy.go:273), phase-ordered as the
    reference: L4 entries, then localhost/world overrides, then the
    identity × label-verdict L3 loop.

    `realized_redirects` maps proxy-id strings to allocated proxy ports;
    redirect filters with no allocated port are skipped
    (policy.go:157-166), exactly as the reference defers them to
    addNewRedirectsFromMap.

    `selector_cache` (a synced compiler.selectorcache.SelectorCache)
    switches selector→identity resolution and the L3 loop to indexed
    set algebra — same results, O(selectors) instead of
    O(identities × selectors).
    """
    if l4_policy is None:
        l4_policy = resolve_l4_policy(
            repo, ep_labels, ingress_enabled, egress_enabled, rules
        )
    redirects = realized_redirects or {}
    if selector_cache is not None:
        if len(selector_cache.identities()) != len(identity_cache):
            # cheap guard only — full sync is the caller's contract
            raise ValueError(
                "selector_cache universe is out of sync with "
                "identity_cache; call selector_cache.sync(identity_cache) "
                "first"
            )
        return _compute_desired_arrays(
            repo,
            identity_cache,
            ep_labels,
            endpoint_id,
            ingress_enabled,
            egress_enabled,
            redirects,
            l4_policy,
            selector_cache,
            rules,
        )

    desired: PolicyMapState = {}
    # --- computeDesiredL4PolicyMapEntries (policy.go:143) -------------------
    for direction, l4map in (
        (INGRESS, l4_policy.ingress),
        (EGRESS, l4_policy.egress),
    ):
        for f in l4map.values():
            proxy_port = 0
            if f.is_redirect():
                pid = proxy_id(endpoint_id, f.ingress, f.protocol, f.port)
                proxy_port = redirects.get(pid, 0)
                if proxy_port == 0:
                    continue
            for key in _convert_l4_filter_to_keys(
                identity_cache, f, direction
            ):
                desired[key] = PolicyMapStateEntry(
                    proxy_port=proxy_port
                )

    # --- determineAllowLocalhost (policy.go:285) ----------------------------
    if option.Config.always_allow_localhost() or l4_policy.has_redirect():
        desired[LOCALHOST_KEY] = PolicyMapStateEntry()

    # --- determineAllowFromWorld (policy.go:306) ----------------------------
    if option.Config.host_allows_world and LOCALHOST_KEY in desired:
        desired[WORLD_KEY] = PolicyMapStateEntry()

    # --- computeDesiredL3PolicyMapEntries (policy.go:318) -------------------
    for num_id, labels in identity_cache.items():
        if ingress_enabled:
            ctx = SearchContext(from_labels=labels, to_labels=ep_labels)
            ingress_access = repo.allows_ingress_label_access(ctx)
        else:
            ingress_access = Decision.ALLOWED
        if ingress_access == Decision.ALLOWED:
            desired[
                PolicyKey(identity=num_id, traffic_direction=INGRESS)
            ] = PolicyMapStateEntry()

        if egress_enabled:
            ctx = SearchContext(from_labels=ep_labels, to_labels=labels)
            egress_access = repo.allows_egress_label_access(ctx)
        else:
            egress_access = Decision.ALLOWED
        if egress_access == Decision.ALLOWED:
            desired[
                PolicyKey(identity=num_id, traffic_direction=EGRESS)
            ] = PolicyMapStateEntry()

    return desired


def _ids_to_keys(
    ids, dest_port: int, nexthdr: int, direction: int
) -> np.ndarray:
    """identity set → packed u64 PolicyKeys (one np op per filter
    instead of one PolicyKey object per identity)."""
    from cilium_tpu_torch.maps.policymap import pack_keys

    return pack_keys(
        np.fromiter(ids, np.uint64, count=len(ids)),
        dest_port,
        nexthdr,
        direction,
    )


def _compute_desired_arrays(
    repo,
    identity_cache,
    ep_labels,
    endpoint_id,
    ingress_enabled,
    egress_enabled,
    redirects,
    l4_policy,
    selector_cache,
    rules,
) -> MapStateArrays:
    """The vectorized computeDesiredPolicyMapState (policy.go:273):
    selector match sets come from the SelectorCache postings and the
    per-(identity, filter) key expansion is array math — O(selectors +
    output entries) with no per-entry Python objects.  Entry order
    (and therefore duplicate-key overwrite) mirrors the dict path:
    L4, localhost, world, then L3; MapStateArrays.build keeps the
    last occurrence."""
    key_chunks = []
    proxy_chunks = []

    # --- computeDesiredL4PolicyMapEntries (policy.go:143) -------------------
    for direction, l4map in (
        (INGRESS, l4_policy.ingress),
        (EGRESS, l4_policy.egress),
    ):
        for f in l4map.values():
            proxy_port = 0
            if f.is_redirect():
                pid = proxy_id(endpoint_id, f.ingress, f.protocol, f.port)
                proxy_port = redirects.get(pid, 0)
                if proxy_port == 0:
                    continue
            ids: set = set()
            for sel in f.endpoints:
                ids |= selector_cache.matches(sel)
            if not ids:
                continue
            keys = _ids_to_keys(ids, f.port, f.u8proto, direction)
            key_chunks.append(keys)
            proxy_chunks.append(
                np.full(len(keys), proxy_port, np.uint32)
            )

    # --- determineAllowLocalhost / AllowFromWorld (policy.go:285,306) -------
    allow_localhost = (
        option.Config.always_allow_localhost() or l4_policy.has_redirect()
    )
    if allow_localhost:
        key_chunks.append(
            _ids_to_keys([RESERVED_HOST], 0, 0, INGRESS)
        )
        proxy_chunks.append(np.zeros(1, np.uint32))
        if option.Config.host_allows_world:
            key_chunks.append(
                _ids_to_keys([RESERVED_WORLD], 0, 0, INGRESS)
            )
            proxy_chunks.append(np.zeros(1, np.uint32))

    # --- computeDesiredL3PolicyMapEntries (policy.go:318) -------------------
    ing_allowed = (
        _l3_allowed_identities(repo, selector_cache, ep_labels, True, rules)
        if ingress_enabled
        else frozenset(identity_cache)
    )
    eg_allowed = (
        _l3_allowed_identities(repo, selector_cache, ep_labels, False, rules)
        if egress_enabled
        else frozenset(identity_cache)
    )
    if ing_allowed:
        key_chunks.append(_ids_to_keys(ing_allowed, 0, 0, INGRESS))
        proxy_chunks.append(np.zeros(len(ing_allowed), np.uint32))
    if eg_allowed:
        key_chunks.append(_ids_to_keys(eg_allowed, 0, 0, EGRESS))
        proxy_chunks.append(np.zeros(len(eg_allowed), np.uint32))

    if not key_chunks:
        return MapStateArrays(
            np.zeros(0, np.uint64), np.zeros(0, np.uint32)
        )
    return MapStateArrays.build(
        np.concatenate(key_chunks), np.concatenate(proxy_chunks)
    )
