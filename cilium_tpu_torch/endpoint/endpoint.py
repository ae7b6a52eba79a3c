"""The Endpoint object and its policy regeneration pipeline.

The port's own copy of the JAX package's endpoint/endpoint.py.

Re-design of pkg/endpoint/{endpoint.go,policy.go}:
  - state machine (endpoint.go:227-258, SetStateLocked endpoint.go:1983
    transition matrix reproduced verbatim);
  - regeneratePolicy (policy.go:506): identity snapshot, revision-gated
    skip, ComputePolicyEnforcement (policy.go:643), resolveL4Policy,
    ResolveCIDRPolicy, computeDesiredPolicyMapState;
  - syncPolicyMap (endpoint.go:2572): desired→realized diffing, with
    per-entry counters preserved across updates.

What the reference realizes into a per-endpoint BPF map + compiled C
program, we realize into the endpoint's `realized_map_state`; the
EndpointManager lowers all realized states into one stacked
PolicyTables (manager.py) — the datapath "reload".
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Tuple

from cilium_tpu_torch import option
from cilium_tpu_torch.compiler.mapstate import (
    compute_desired_policy_map_state,
    resolve_l4_policy,
)
from cilium_tpu_torch.identity import Identity, IdentityCache
from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.maps.policymap import (
    MapStateArrays,
    PolicyMapState,
    PolicyMapStateEntry,
    diff_map_state,
    sync_map_arrays,
)
from cilium_tpu_torch.policy.l3 import CIDRPolicy
from cilium_tpu_torch.policy.l4 import L4Policy
from cilium_tpu_torch.policy.search import SearchContext

# endpoint.go:227-258
STATE_CREATING = "creating"
STATE_WAITING_FOR_IDENTITY = "waiting-for-identity"
STATE_READY = "ready"
STATE_WAITING_TO_REGENERATE = "waiting-to-regenerate"
STATE_REGENERATING = "regenerating"
STATE_DISCONNECTING = "disconnecting"
STATE_DISCONNECTED = "disconnected"
STATE_RESTORING = "restoring"

# SetStateLocked transition matrix (endpoint.go:1983-2037).
_TRANSITIONS = {
    "": {STATE_WAITING_FOR_IDENTITY, STATE_RESTORING},
    STATE_CREATING: {
        STATE_DISCONNECTING,
        STATE_WAITING_FOR_IDENTITY,
        STATE_RESTORING,
    },
    STATE_WAITING_FOR_IDENTITY: {STATE_READY, STATE_DISCONNECTING},
    STATE_READY: {
        STATE_WAITING_FOR_IDENTITY,
        STATE_DISCONNECTING,
        STATE_WAITING_TO_REGENERATE,
        STATE_RESTORING,
    },
    STATE_DISCONNECTING: {STATE_DISCONNECTED},
    STATE_DISCONNECTED: set(),
    STATE_WAITING_TO_REGENERATE: {
        STATE_WAITING_FOR_IDENTITY,
        STATE_DISCONNECTING,
        STATE_RESTORING,
    },
    STATE_REGENERATING: {
        STATE_WAITING_FOR_IDENTITY,
        STATE_DISCONNECTING,
        STATE_WAITING_TO_REGENERATE,
        STATE_RESTORING,
    },
    STATE_RESTORING: {
        STATE_DISCONNECTING,
        STATE_WAITING_TO_REGENERATE,
        STATE_RESTORING,
    },
}

# BuilderSetStateLocked (endpoint.go:2077): only the builder moves an
# endpoint into/out of regenerating.
_BUILDER_TRANSITIONS = {
    STATE_WAITING_TO_REGENERATE: {STATE_REGENERATING},
    STATE_REGENERATING: {STATE_READY, STATE_WAITING_TO_REGENERATE},
}


_ENDPOINT_NONCE = itertools.count(1)


class Endpoint:
    """pkg/endpoint.Endpoint, reduced to the policy-relevant core."""

    def __init__(
        self,
        endpoint_id: int,
        ipv4: Optional[str] = None,
        name: str = "",
    ) -> None:
        self.id = endpoint_id
        self.ipv4 = ipv4
        self.name = name
        self.state = ""
        self.security_identity: Optional[Identity] = None

        # policy computation state (endpoint.go:265 + policy.go:506)
        self.policy_revision = 0
        self.next_policy_revision = 0
        self.prev_identity_cache: Optional[IdentityCache] = None
        self.prev_universe_version: Optional[int] = None
        self.force_policy_compute = False
        # did the last regeneration change this endpoint's desired
        # policy?  (gates redirect re-resolution per sweep)
        self.last_policy_changed = True
        self.ingress_policy_enabled = False
        self.egress_policy_enabled = False
        self.desired_l4_policy: Optional[L4Policy] = None
        self.l3_policy: Optional[CIDRPolicy] = None
        self.desired_map_state: PolicyMapState = {}
        self.realized_map_state: PolicyMapState = {}
        # bumped whenever realized_map_state content changes; combined
        # with the per-instance nonce it forms the content token the
        # incremental fleet compiler keys cached rows on (the nonce
        # keeps tokens unique across endpoint re-creation with a
        # recycled id)
        self.map_state_revision = 0
        self.instance_nonce = next(_ENDPOINT_NONCE)
        self.realized_redirects: Dict[str, int] = {}

        # per-endpoint runtime options (pkg/endpoint applyOptsLocked;
        # `cilium endpoint config`): overlay on the global option set.
        # Consulted by the monitor fold (per-endpoint
        # PolicyVerdictNotification) and any per-endpoint toggles.
        from cilium_tpu_torch.option import OptionMap

        self.opts = OptionMap()

        self.lock = threading.RLock()
        self.build_lock = threading.Lock()

    # -- state machine -------------------------------------------------------

    @staticmethod
    def _count_state_change(old: str, new: str) -> None:
        # endpoint_state gauge, kept on transitions; the reference
        # deliberately does NOT count the terminal disconnected state
        # (endpoint.go:2065-2069: "the final state, after which the
        # endpoint is gone") — counting it would grow unboundedly as
        # endpoints come and go
        from cilium_tpu_torch.metrics import registry as metrics

        if old:  # the initial "" pseudo-state is not a series
            metrics.endpoint_state_count.dec(old)
        if new != STATE_DISCONNECTED:
            metrics.endpoint_state_count.inc(new)

    def set_state(self, to_state: str, reason: str = "") -> bool:
        """SetStateLocked (endpoint.go:1983): invalid transitions are
        skipped, not raised."""
        with self.lock:
            if to_state in _TRANSITIONS.get(self.state, set()):
                self._count_state_change(self.state, to_state)
                self.state = to_state
                return True
            return False

    def builder_set_state(self, to_state: str, reason: str = "") -> bool:
        """BuilderSetStateLocked (endpoint.go:2077)."""
        with self.lock:
            if to_state in _BUILDER_TRANSITIONS.get(self.state, set()):
                self._count_state_change(self.state, to_state)
                self.state = to_state
                return True
            return False

    # -- identity ------------------------------------------------------------

    def set_identity(self, identity: Identity) -> None:
        with self.lock:
            self.security_identity = identity

    def is_init(self) -> bool:
        """IsInit (reserved:init label present, policy.go:655)."""
        if self.security_identity is None:
            return False
        return any(
            l.source == "reserved" and l.key == "init"
            for l in self.security_identity.label_array
        )

    # -- policy computation (policy.go:506 regeneratePolicy) ----------------

    def compute_policy_enforcement(
        self, repo, rules=None
    ) -> Tuple[bool, bool]:
        """ComputePolicyEnforcement (policy.go:643)."""
        mode = option.Config.policy_enforcement
        if mode == option.ALWAYS_ENFORCE:
            return True, True
        if mode == option.DEFAULT_ENFORCEMENT:
            if self.is_init():
                return True, True
            return repo.get_rules_matching(
                self.security_identity.label_array, rules
            )
        return False, False

    def regenerate_policy(
        self,
        repo,
        identity_cache: IdentityCache,
        selector_cache=None,
        rule_index=None,
        universe_version=None,
        affected_identities=None,
        affected_revision=None,
    ) -> bool:
        """regeneratePolicy (policy.go:506).  Returns whether the
        desired state may have changed (False = revision-gated skip).

        With `universe_version` (the SelectorCache version at snapshot
        time) the identity-snapshot comparison is O(1) instead of a
        full dict compare.  With `affected_identities` (the union of
        changed rules' endpoint-selector matches) an endpoint whose
        identity is unaffected skips recomputation entirely and just
        fast-forwards its revision — the precise form of the
        reference's revision gating (policy.go:540-552): a rule can
        only change an endpoint's policy if its endpoint_selector
        selects it."""
        if self.security_identity is None:
            return False

        if universe_version is not None:
            universe_unchanged = (
                self.prev_universe_version == universe_version
            )
        else:
            # Use the previous snapshot object when contents are equal
            # (policy.go:530-533) so the skip below can compare by "is".
            if (
                self.prev_identity_cache is not None
                and self.prev_identity_cache == identity_cache
            ):
                identity_cache = self.prev_identity_cache
            universe_unchanged = identity_cache is self.prev_identity_cache

        revision = repo.get_revision()
        if (
            not self.force_policy_compute
            and self.next_policy_revision >= revision
            and universe_unchanged
        ):
            return False

        if (
            affected_identities is not None
            and universe_unchanged
            and not self.force_policy_compute
            and self.desired_l4_policy is not None
            and self.security_identity.id not in affected_identities
        ):
            # No changed rule selects this endpoint: the desired state
            # cannot have moved — realize the revision without work.
            # Fast-forward only to the revision snapshotted WITH the
            # pending-selector swap: a rule added concurrently after
            # the swap isn't in `affected_identities` and must not be
            # marked realized here.
            self.next_policy_revision = (
                min(revision, affected_revision)
                if affected_revision is not None
                else revision
            )
            return False

        self.prev_identity_cache = identity_cache
        self.prev_universe_version = universe_version
        rules = (
            rule_index.relevant(self.security_identity.id)
            if rule_index is not None
            else None
        )
        (
            self.ingress_policy_enabled,
            self.egress_policy_enabled,
        ) = self.compute_policy_enforcement(repo, rules)

        ep_labels = self.security_identity.label_array
        self.desired_l4_policy = resolve_l4_policy(
            repo,
            ep_labels,
            self.ingress_policy_enabled,
            self.egress_policy_enabled,
            rules,
        )

        # regenerateL3Policy (policy.go:392)
        new_l3 = repo.resolve_cidr_policy(
            SearchContext(to_labels=ep_labels), rules
        )
        new_l3.validate()
        self.l3_policy = new_l3

        self.desired_map_state = compute_desired_policy_map_state(
            repo,
            identity_cache,
            ep_labels,
            endpoint_id=self.id,
            ingress_enabled=self.ingress_policy_enabled,
            egress_enabled=self.egress_policy_enabled,
            realized_redirects=self.realized_redirects,
            l4_policy=self.desired_l4_policy,
            selector_cache=selector_cache,
            rules=rules,
        )

        self.force_policy_compute = False
        # When computing from a rule_index sublist, the sublist was
        # frozen when the index was built; a rule added concurrently
        # between the build and our get_revision() read is absent from
        # the sublist and must not be marked realized (the next sweep's
        # revision gate would silently skip it).  Cap at the revision
        # snapshotted with the index build.
        if rules is not None and affected_revision is not None:
            self.next_policy_revision = min(revision, affected_revision)
        else:
            self.next_policy_revision = revision
        return True

    # -- realization (endpoint.go:2572 syncPolicyMap) ------------------------

    def sync_policy_map(self) -> Tuple[int, int]:
        """Apply desired→realized delta; preserves counters of entries
        that stay.  Returns (n_added_or_updated, n_deleted)."""
        with self.lock:
            if isinstance(self.desired_map_state, MapStateArrays) or (
                isinstance(self.realized_map_state, MapStateArrays)
            ):
                # vectorized sync: counters carry over for persisting
                # keys into a FRESH instance — counter writers must
                # re-read realized_map_state under self.lock (see
                # replay.sync_counters_to_endpoints) or their
                # increments land in the superseded snapshot
                realized = MapStateArrays.from_dict(
                    self.realized_map_state
                )
                desired = MapStateArrays.from_dict(self.desired_map_state)
                new_realized, n_add, n_del = sync_map_arrays(
                    realized, desired
                )
                if n_add == 0 and n_del == 0:
                    return 0, 0
                self.realized_map_state = new_realized
                self.map_state_revision += 1
                return n_add, n_del
            to_add, to_delete = diff_map_state(
                self.realized_map_state, self.desired_map_state
            )
            if not to_add and not to_delete:
                return 0, 0
            # Copy-on-write: the fleet compiler (and any stale-table
            # consumer) may be iterating the current dict from another
            # thread; publish a fresh dict atomically instead of
            # mutating in place.
            realized = dict(self.realized_map_state)
            for key in to_delete:
                del realized[key]
            for key in to_add:
                old = realized.get(key)
                entry = PolicyMapStateEntry(
                    proxy_port=self.desired_map_state[key].proxy_port,
                    packets=old.packets if old else 0,
                    bytes=old.bytes if old else 0,
                )
                realized[key] = entry
            self.realized_map_state = realized
            # content token for the incremental fleet compiler:
            # rows relower only when this changes
            self.map_state_revision += 1
            return len(to_add), len(to_delete)

    def bump_policy_revision(self) -> None:
        """policy.go:790-804: realized revision catches up after a
        successful regeneration."""
        with self.lock:
            self.policy_revision = self.next_policy_revision
