"""The daemon's policy plane: endpoints, identities, ipcache, rules and
the regeneration sweep.

The port's own copy of the policy plane of the JAX package's daemon.py
(NewDaemon, daemon/daemon.go:1084, and the policy API handlers of
daemon/policy.go):

  PolicyAdd (daemon/policy.go:167): collect CIDR prefixes -> prefix-
  length refcount -> AllocateCIDRs (local identities + ipcache) ->
  repo.AddList (revision++) -> regenerate all endpoints -> publish
  fresh fleet tables.

  PolicyDelete (daemon/policy.go:240): delete by label, release CIDR
  identities.

  CreateEndpoint (daemon/endpoint.go:138): allocate the identity from
  labels, publish the IP into the local ipcache.

Policy sweeps are explicit: `regenerate_all` runs one, as the
reference daemon does with its policy trigger closed (bench.py's
`build_config5`); `trigger_policy_updates` only records whether the
next sweep must be full.  `Daemon(device=None)` means the card: the
proxy's redirects and the endpoint manager's device epochs live on
`device` (pass "cpu" for CPU tensors).

Not here yet, each with the ROADMAP item it waits for (queue 1 items
4-5): IPAM (`create_endpoint` takes its `ipv4` from the caller), the
kvstore and its identity and ip publish, clustermesh, the FQDN poller,
the policy trigger and controllers, endpoint restore from a state
directory, the REST API, the serving plane and its dispatch, the
shadow plane's wiring and `trace_tuple`.  The regeneration sweep runs
under a `daemon.regenerate` span of `tracing.tracer` (`Daemon.tracer`),
the proxy's upcalls and the endpoint manager's compile spans nested
under it, and the proxy's access records go to `Daemon.monitor` (a
MonitorBus).  It keeps its SpanStats phases ("policy", "proxy",
"policy_redirects", "total"; "total" through a StatSpan, one clock with
its span) in `last_regen_spans` and accumulates them in `regen_spans`.
"""

from __future__ import annotations

import ipaddress
import threading
from collections import Counter as _Counter
from typing import List, Optional, Tuple

from cilium_tpu_torch import logging as logfields
from cilium_tpu_torch import option, tracing
from cilium_tpu_torch.compiler.selectorcache import RuleIndex, SelectorCache
from cilium_tpu_torch.endpoint import Endpoint, EndpointManager
from cilium_tpu_torch.endpoint.endpoint import (
    STATE_READY,
    STATE_WAITING_FOR_IDENTITY,
)
from cilium_tpu_torch.identity import IdentityAllocator
from cilium_tpu_torch.ipcache.cidr import allocate_cidrs, release_cidrs
from cilium_tpu_torch.ipcache.ipcache import (
    FROM_AGENT_LOCAL,
    IPCache,
    IPIdentity,
)
from cilium_tpu_torch.ipcache.lpm import LPMBuilder
from cilium_tpu_torch.logging import get_logger
from cilium_tpu_torch.metrics import registry as metrics
from cilium_tpu_torch.monitor.bus import MonitorBus
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.proxy import Proxy
from cilium_tpu_torch.spanstat import SpanStats
from cilium_tpu_torch.utils.completion import WaitGroup

log = get_logger("daemon")


class EndpointConflict(ValueError):
    """Endpoint id already in use by a different workload."""


def get_cidr_prefixes(rules) -> List[str]:
    """policy.GetCIDRPrefixes: every CIDR string the rules reference."""
    out: List[str] = []
    for rule in rules:
        for ingress in rule.ingress:
            out.extend(str(c) for c in ingress.from_cidr)
            out.extend(str(c.cidr) for c in ingress.from_cidr_set)
        for egress in rule.egress:
            out.extend(str(c) for c in egress.to_cidr)
            out.extend(str(c.cidr) for c in egress.to_cidr_set)
    return out


class Daemon:
    def __init__(self, num_workers: int = 4, device=None) -> None:
        self.lock = threading.RLock()
        # policy.NewPolicyRepository (daemon.go:1100)
        self.repo = Repository()
        # builder pool (daemon.go:235)
        self.endpoint_manager = EndpointManager(
            num_workers=num_workers, device=device
        )
        self.identity_allocator = IdentityAllocator()
        # ipcache + device LPM listener (§3.5 tail)
        self.ipcache = IPCache()
        self.lpm_builder = LPMBuilder()
        self.ipcache.add_listener(self.lpm_builder)
        # indexed selector -> identity-set resolution for the compiler
        self.selector_cache = SelectorCache()
        self.rule_index = RuleIndex()
        # Serializes whole regeneration sweeps.  The selector cache and
        # rule index are shared, version-keyed caches: a second sweep
        # starting mid-flight would re-sync them to a NEWER identity
        # universe than the first sweep's snapshot, so in-flight builds
        # could resolve selectors against identities absent from the
        # universe their tables are lowered onto (universe/table skew —
        # the reference serializes the equivalent via the trigger +
        # per-endpoint regeneration.Lock, policy.go:540-552).
        self._regen_lock = threading.Lock()
        # endpoint selectors of rules changed since the last sweep;
        # None = a non-policy reason forced a full sweep
        self._pending_rule_selectors: Optional[list] = []
        # the monitor bus (the proxy's access records land there) and
        # the process-global tracer: the regeneration sweep's root span
        # parents the proxy upcalls, and the compile and publish spans
        # of the endpoint manager nest under whatever span is active
        self.monitor = MonitorBus()
        self.proxy = Proxy(monitor=self.monitor, device=device)
        self.tracer = tracing.tracer
        # accumulated per-phase regeneration spans (pkg/spanstat; the
        # reference logs one SpanStat per phase, policy.go:689-699)
        self.regen_spans = SpanStats()
        self.last_regen_spans = SpanStats()
        # CIDR prefix-length refcounts (daemon.go createPrefixLengthCounter)
        self.prefix_lengths: _Counter = _Counter()

    # -- identity snapshot ---------------------------------------------------

    def identity_cache(self):
        return self.identity_allocator.identity_cache()

    # -- policy API (daemon/policy.go) --------------------------------------

    def policy_add(self, rules, replace: bool = False) -> int:
        """PolicyAdd (daemon/policy.go:167).  Returns the new revision."""
        with self.lock:
            try:
                for rule in rules:
                    rule.sanitize()
            except Exception:
                metrics.policy_import_errors.inc()
                raise
            prefixes = get_cidr_prefixes(rules)
            for prefix in prefixes:
                self.prefix_lengths[
                    ipaddress.ip_network(prefix, strict=False).prefixlen
                ] += 1
            if prefixes:
                allocate_cidrs(
                    self.ipcache, self.identity_allocator, prefixes
                )
            if replace:
                for rule in rules:
                    for old in self.repo.search(rule.labels):
                        self._note_rule_change(old.endpoint_selector)
                    self.repo.delete_by_labels(rule.labels)
            for rule in rules:
                self._note_rule_change(rule.endpoint_selector)
            revision = self.repo.add_list(list(rules))
            metrics.policy_count.set(value=self.repo.num_rules())
            metrics.policy_revision.set(value=revision)
            log.info(
                "policy rules imported",
                extra={"fields": {
                    logfields.POLICY_REVISION: revision,
                    "count": len(rules),
                }},
            )
        self.trigger_policy_updates("policy rules added")
        return revision

    def policy_delete(self, labels) -> Tuple[int, int]:
        """PolicyDelete (daemon/policy.go:240)."""
        with self.lock:
            deleted_rules = self.repo.search(labels)
            for old in deleted_rules:
                self._note_rule_change(old.endpoint_selector)
            prefixes = get_cidr_prefixes(deleted_rules)
            revision, n_deleted = self.repo.delete_by_labels(labels)
            if n_deleted:
                for prefix in prefixes:
                    plen = ipaddress.ip_network(
                        prefix, strict=False
                    ).prefixlen
                    self.prefix_lengths[plen] -= 1
                    if self.prefix_lengths[plen] <= 0:
                        del self.prefix_lengths[plen]
                release_cidrs(
                    self.ipcache, self.identity_allocator, prefixes
                )
            metrics.policy_count.set(value=self.repo.num_rules())
        if n_deleted:
            self.trigger_policy_updates("policy rules deleted")
        return revision, n_deleted

    # -- regeneration (daemon/policy.go:47 TriggerPolicyUpdates) ------------

    def _note_rule_change(self, endpoint_selector) -> None:
        """Record a changed rule's endpoint selector for delta-scoped
        regeneration (a rule affects only endpoints it selects)."""
        if self._pending_rule_selectors is not None:
            self._pending_rule_selectors.append(endpoint_selector)

    def trigger_policy_updates(self, reason: str, full: bool = False) -> None:
        """TriggerPolicyUpdates with the trigger closed: the sweep itself
        is the caller's `regenerate_all`; a non-policy reason
        (endpoint, identity or config change) makes it a full one."""
        if full:
            self._pending_rule_selectors = None

    def _accumulate_regen_span(self, stats: SpanStats) -> None:
        """Fold one run's spans into the lifetime accumulators
        (pkg/spanstat's success/failure split) and mirror them into the
        metrics registry."""
        for name, span in stats.items():
            acc = self.regen_spans.span(name)
            acc.success_total += span.success_total
            acc.failure_total += span.failure_total
            acc.num_success += span.num_success
            acc.num_failure += span.num_failure
        for name, span in self.regen_spans.items():
            metrics.spanstat_seconds.set(
                "regeneration", name, value=span.total()
            )
        self.last_regen_spans = stats

    def regenerate_all(self, reason: str = "") -> int:
        with self._regen_lock:
            # the sweep's root span: proxy upcalls and the compile
            # spans of the sweep nest under it
            with self.tracer.span("daemon.regenerate", site="daemon",
                                  attrs={"reason": reason}):
                return self._regenerate_all_locked(reason)

    def _regenerate_all_locked(self, reason: str = "") -> int:
        stats = SpanStats()  # fresh per run: the histogram observes
        # THIS run's duration; regen_spans accumulates across runs
        total_span = tracing.stat_span(
            stats, "total", site="daemon.regenerate", trc=self.tracer
        ).start()
        cache, cache_version = (
            self.identity_allocator.identity_cache_versioned()
        )
        prev_version = self.selector_cache.version
        universe_version = self.selector_cache.sync(
            cache, cache_version=cache_version
        )
        # Swap the pending set and snapshot the repo revision under
        # the daemon lock: a concurrent policy_add after the swap must
        # not be fast-forwarded past (its selector isn't in `pending`).
        with self.lock:
            pending, self._pending_rule_selectors = (
                self._pending_rule_selectors,
                [],
            )
            affected_revision = self.repo.get_revision()
        affected = None
        if pending is not None and universe_version == prev_version:
            affected = frozenset().union(
                *(
                    self.selector_cache.matches(sel)
                    for sel in pending
                ),
            ) if pending else frozenset()
        self.rule_index.build(self.repo, self.selector_cache)
        stats.span("policy").start()
        n = self.endpoint_manager.regenerate_all(
            self.repo,
            cache,
            reason,
            selector_cache=self.selector_cache,
            rule_index=self.rule_index,
            universe_version=universe_version,
            affected_identities=affected,
            affected_revision=affected_revision,
            identity_cache_token=cache_version,
        )
        stats.span("policy").end()
        # Two-phase redirect realization (pkg/endpoint/bpf.go:488 +
        # policy.go:157-166): the first pass computes desired L4
        # policy; redirects then get proxy ports allocated; endpoints
        # whose redirects changed recompute so the L4 entries carry
        # the allocated ports.  The L7 tables' identity axis MUST be
        # the fleet compiler's index space (the published tables'
        # id_direct), not a sorted rebuild.
        proxy_span = stats.span("proxy").start()
        id_index, n_identities = self.endpoint_manager.identity_index()
        wait_group = WaitGroup()
        dirty = False
        attempted = []  # (endpoint, realized map before this attempt)
        universe_unchanged = universe_version == prev_version
        upcall_failed = False
        for endpoint in self.endpoint_manager.endpoints():
            l4 = endpoint.desired_l4_policy
            if l4 is None or not l4.has_redirect():
                if endpoint.realized_redirects:
                    try:
                        self.proxy.update_endpoint_redirects(
                            endpoint, cache, id_index, n_identities,
                            self.selector_cache,
                        )
                    except Exception as exc:
                        # a failed proxy upcall must not crash the
                        # sweep: the endpoint keeps its old redirects
                        # and retries next trigger
                        upcall_failed = True
                        endpoint.force_policy_compute = True
                        log.warning(
                            "proxy upcall failed; keeping old "
                            "redirects",
                            extra={"fields": {
                                logfields.ENDPOINT_ID: endpoint.id,
                                "error": str(exc),
                            }},
                        )
                continue
            if (
                universe_unchanged
                and not endpoint.last_policy_changed
                and endpoint.realized_redirects
            ):
                # unchanged policy + unchanged identity universe ⇒ the
                # resolved matcher inputs are identical to the live
                # redirects' — skip even the re-resolution (the
                # fingerprint check would skip only the compile)
                continue
            before = dict(endpoint.realized_redirects)
            try:
                realized = self.proxy.update_endpoint_redirects(
                    endpoint, cache, id_index, n_identities,
                    self.selector_cache, wait_group=wait_group,
                )
            except Exception as exc:
                # same containment as above: roll this endpoint back
                # to its pre-attempt redirects, flag the retry, let
                # every other endpoint's regeneration proceed
                upcall_failed = True
                endpoint.realized_redirects = before
                endpoint.force_policy_compute = True
                log.warning(
                    "proxy upcall failed; keeping old redirects",
                    extra={"fields": {
                        logfields.ENDPOINT_ID: endpoint.id,
                        "error": str(exc),
                    }},
                )
                continue
            attempted.append((endpoint, before))
            if realized != before:
                endpoint.force_policy_compute = True
                dirty = True
        if upcall_failed:
            metrics.endpoint_regenerations.inc("fail")
        # ACK gate (pkg/completion + pkg/envoy/xds/ack.go): the table
        # flip below happens only once EVERY submitted matcher
        # compile — port change or not — has ACKed its version; on
        # timeout or NACK the regeneration FAILS: realized redirect
        # state rolls back so old redirects and old published tables
        # keep serving, and the retry flag makes the next trigger
        # re-attempt (pkg/endpoint/bpf.go:442, policy.go:770-775)
        if wait_group.pending and not wait_group.wait(
            timeout=option.Config.redirect_ack_timeout
        ):
            metrics.endpoint_regenerations.inc("fail")
            for endpoint, before in attempted:
                endpoint.realized_redirects = before
                endpoint.force_policy_compute = True
            proxy_span.end(success=False)
            total_span.end(success=False)
            self._accumulate_regen_span(stats)
            return n
        proxy_span.end()
        if dirty:
            stats.span("policy_redirects").start()
            self.endpoint_manager.regenerate_all(
                self.repo,
                cache,
                reason + " (redirects realized)",
                selector_cache=self.selector_cache,
                rule_index=self.rule_index,
                universe_version=universe_version,
                affected_revision=affected_revision,
                identity_cache_token=cache_version,
            )
            stats.span("policy_redirects").end()
        metrics.policy_regeneration_count.inc(value=n)
        total_span.end()
        metrics.endpoint_regeneration_seconds.observe(
            stats.span("total").total()
        )
        self._accumulate_regen_span(stats)
        return n

    # -- endpoint API (daemon/endpoint.go) ----------------------------------

    def create_endpoint(
        self, endpoint_id: int, labels, ipv4: Optional[str] = None,
        name: str = "",
    ) -> Endpoint:
        """PUT /endpoint/{id} (daemon/endpoint.go:138): allocate the
        identity from labels, publish the IP into the local ipcache.

        Idempotent for runtime retries: re-creating an id with the
        SAME name returns the existing endpoint untouched; the same id
        under a DIFFERENT name is a conflict.  The address is the
        caller's (IPAM is not ported yet)."""
        with self.lock:
            existing = self.endpoint_manager.lookup(endpoint_id)
            if existing is not None:
                if name and existing.name == name:
                    return existing
                raise EndpointConflict(
                    f"endpoint id {endpoint_id} in use by "
                    f"{existing.name!r}"
                )
            endpoint = Endpoint(endpoint_id, ipv4=ipv4, name=name)
            endpoint.set_state(STATE_WAITING_FOR_IDENTITY, "creating")
            ident, _ = self.identity_allocator.allocate(labels)
            endpoint.set_identity(ident)
            endpoint.set_state(STATE_READY, "identity resolved")
            self.endpoint_manager.insert(endpoint)
            if ipv4:
                self.ipcache.upsert(
                    ipv4, IPIdentity(ident.id, FROM_AGENT_LOCAL)
                )
        self.trigger_policy_updates(
            f"endpoint {endpoint_id} created", full=True
        )
        return endpoint
