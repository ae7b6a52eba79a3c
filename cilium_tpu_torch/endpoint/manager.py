"""Endpoint registry, parallel build queue, fleet table compilation.

The port's own copy of the JAX package's endpoint/manager.py, with the
device PyTorch needs: `EndpointManager(device=None)` hands `device`
(None = the card) to the DeviceTableStore it creates at the first
`published_device()` call, which raises without a card; pass
device="cpu" to hold the epochs as CPU tensors.

Re-design of pkg/endpointmanager/manager.go (registry,
RegenerateAllEndpoints manager.go:271) and the daemon's builder pool
(daemon/daemon.go:209 QueueEndpointBuild, daemon.go:235
StartEndpointBuilders: builds serialize per endpoint via the build
lock, N run in parallel fleet-wide).

The TPU twist: realization is fleet-wide — after endpoints sync their
realized map states, `compile_fleet` lowers ALL of them into one
stacked PolicyTables (the endpoint axis replaces per-endpoint BPF
programs + the tail-call PROG_ARRAY) and publishes it with a
double-buffered version flip, the device analog of the realized/
backup/pending map shuffle in pkg/datapath/ipcache/listener.go:167.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Tuple

from cilium_tpu_torch import logging as logfields
from cilium_tpu_torch.compiler.tables import FleetCompiler, PolicyTables
from cilium_tpu_torch.logging import get_logger
from cilium_tpu_torch.metrics import registry as metrics
from cilium_tpu_torch.endpoint.endpoint import (
    STATE_READY,
    STATE_REGENERATING,
    STATE_WAITING_TO_REGENERATE,
    Endpoint,
)
from cilium_tpu_torch.identity import IdentityCache

log = get_logger("endpoint-manager")


class EndpointManager:
    """pkg/endpointmanager: lookup by id / name / IP + regeneration."""

    def __init__(self, num_workers: int = 4, device=None) -> None:
        self._device = device
        self._lock = threading.RLock()
        self.by_id: Dict[int, Endpoint] = {}
        self.by_ip: Dict[str, Endpoint] = {}
        self.by_name: Dict[str, Endpoint] = {}
        self._pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        # published tables: (version, tables, ep_id → endpoint axis idx)
        self._published: Tuple[int, Optional[PolicyTables], Dict[int, int]] = (
            0,
            None,
            {},
        )
        # incremental lowering: caches identity/slot tables and
        # per-endpoint rows across publishes (delta compilation)
        self._fleet_compiler = FleetCompiler()
        # device-resident table epochs (engine/publish.py): created
        # lazily on the first published_device() call so control-plane
        #-only users never pay a device upload; publishes after that
        # apply delta scatters instead of re-uploading the world
        self._device_store = None
        self._device_lock = threading.RLock()
        # optional store factory (e.g. engine.sharded's
        # make_partitioned_store bound to a mesh): set before the
        # first published_device() call to serve the daemon's
        # dispatch from identity-SHARDED epochs — the same delta
        # publish path then scatters each payload into the owning
        # chip's shard only
        self.device_store_factory = None
        self.last_publish_stats = None
        # optional listener fired after every device-epoch publish
        # with the HOST tables just installed: the daemon wires the
        # attached ChipFailoverRouter here so the router's published
        # tables track regenerates AUTOMATICALLY (no operator
        # publish).  Called outside the manager's main lock but
        # under the device lock; must not call back into
        # published_device.
        self.on_device_publish = None
        # builder failure bookkeeping (endpoint.go's bpf.go:442 retry
        # counter analog): (endpoint_id, reason, repr(exc)) of the
        # most recent failed builds, surfaced via daemon status
        self.build_failures = 0
        self.last_build_failures: List[Tuple[int, str, str]] = []

    # -- registry (manager.go Insert/Lookup*) --------------------------------

    def insert(self, endpoint: Endpoint) -> None:
        with self._lock:
            self.by_id[endpoint.id] = endpoint
            if endpoint.ipv4:
                self.by_ip[endpoint.ipv4] = endpoint
            if endpoint.name:
                self.by_name[endpoint.name] = endpoint

    def remove(self, endpoint: Endpoint) -> None:
        with self._lock:
            self.by_id.pop(endpoint.id, None)
            if endpoint.ipv4:
                self.by_ip.pop(endpoint.ipv4, None)
            if endpoint.name:
                self.by_name.pop(endpoint.name, None)

    def lookup(self, endpoint_id: int) -> Optional[Endpoint]:
        with self._lock:
            return self.by_id.get(endpoint_id)

    def lookup_name(self, name: str) -> Optional[Endpoint]:
        with self._lock:
            return self.by_name.get(name)

    def lookup_ip(self, ipv4: str) -> Optional[Endpoint]:
        with self._lock:
            return self.by_ip.get(ipv4)

    def endpoints(self) -> List[Endpoint]:
        with self._lock:
            return list(self.by_id.values())

    # -- regeneration (manager.go:271 RegenerateAllEndpoints) ---------------

    def regenerate_endpoint(
        self,
        endpoint: Endpoint,
        repo,
        identity_cache: IdentityCache,
        selector_cache=None,
        rule_index=None,
        universe_version=None,
        affected_identities=None,
        affected_revision=None,
    ) -> bool:
        """One build: the regenerate→regenerateBPF tail of §3.2 (CT
        scrub and proxy ACKs are owned by their subsystems; here:
        policy calc + map sync + revision bump).  Serialized per
        endpoint via build_lock (QueueEndpointBuild daemon.go:209)."""
        with endpoint.build_lock:
            if not endpoint.builder_set_state(
                STATE_REGENERATING, "regenerating"
            ):
                # not queued for regeneration (e.g. disconnecting)
                return False
            metrics.endpoint_count_regenerating.inc()
            try:
                changed = endpoint.regenerate_policy(
                    repo,
                    identity_cache,
                    selector_cache=selector_cache,
                    rule_index=rule_index,
                    universe_version=universe_version,
                    affected_identities=affected_identities,
                    affected_revision=affected_revision,
                )
                endpoint.last_policy_changed = bool(changed)
                if changed:
                    endpoint.sync_policy_map()
                endpoint.bump_policy_revision()
                endpoint.builder_set_state(STATE_READY, "regenerated")
                return True
            except Exception:
                # failed builds fall back to waiting-to-regenerate
                # (policy.go:770-775 keeps old state, retries later)
                endpoint.builder_set_state(
                    STATE_WAITING_TO_REGENERATE, "regeneration failed"
                )
                raise
            finally:
                metrics.endpoint_count_regenerating.dec()

    def regenerate_all(
        self,
        repo,
        identity_cache: IdentityCache,
        reason: str = "",
        selector_cache=None,
        rule_index=None,
        universe_version=None,
        affected_identities=None,
        affected_revision=None,
        identity_cache_token=None,
    ) -> int:
        """RegenerateAllEndpoints: mark + rebuild every endpoint (N
        builders in parallel), then publish fresh fleet tables."""
        eps = self.endpoints()
        for endpoint in eps:
            endpoint.set_state(STATE_WAITING_TO_REGENERATE, reason)
        futures = [
            self._pool.submit(
                self.regenerate_endpoint,
                endpoint,
                repo,
                identity_cache,
                selector_cache,
                rule_index,
                universe_version,
                affected_identities,
                affected_revision,
            )
            for endpoint in eps
        ]
        wait(futures)
        n = 0
        failures = []
        for endpoint, f in zip(eps, futures):
            exc = f.exception()
            if exc is None:
                n += 1 if f.result() else 0
            else:
                failures.append((endpoint.id, reason, repr(exc)))
        metrics.endpoint_regenerations.inc("success", value=n)
        if failures:
            # a failed build must be LOUD, not a swallowed pool
            # exception: count it, keep the last batch for status,
            # and log — the endpoint itself already fell back to
            # waiting-to-regenerate inside regenerate_endpoint
            for ep_id, rsn, err in failures:
                metrics.endpoint_regenerations.inc("fail")
                log.error(
                    "endpoint build failed",
                    extra={"fields": {
                        logfields.ENDPOINT_ID: ep_id,
                        "reason": rsn,
                        "error": err,
                    }},
                )
            with self._lock:
                self.build_failures += len(failures)
                self.last_build_failures = failures
        self.publish_tables(
            identity_cache, universe_token=identity_cache_token
        )
        return n

    # -- fleet realization ---------------------------------------------------

    def compile_fleet(
        self, identity_cache: IdentityCache
    ) -> Tuple[PolicyTables, Dict[int, int]]:
        """Lower every endpoint's REALIZED map state into one stacked
        PolicyTables; returns (tables, ep_id → endpoint-axis index).

        Incremental: unchanged endpoints (by map_state_revision) reuse
        their cached rows; identity/slot tables rebuild only when the
        universe or key set changes (SURVEY §7 hard part 4)."""
        return self._fleet_compiler.compile(
            self._capture_entries(), list(identity_cache)
        )

    def _capture_entries(self) -> list:
        """Per-endpoint (id, realized state, cache token) snapshot.
        (state, token) must be read atomically: sync_policy_map
        publishes a fresh dict and bumps the revision under the same
        lock; pairing a new dict with an old token would wrongly
        reuse cached rows."""
        entries = []
        for e in sorted(self.endpoints(), key=lambda ep: ep.id):
            with e.lock:
                entries.append(
                    (
                        e.id,
                        e.realized_map_state,
                        (e.instance_nonce, e.map_state_revision),
                    )
                )
        return entries

    def publish_tables(
        self,
        identity_cache: IdentityCache,
        universe_token=None,
    ) -> int:
        """Double-buffered flip: compile the new version, then swap the
        published pointer atomically (consumers holding the old tables
        keep a consistent snapshot — the ACK-gated versioned flip of
        SURVEY §5).

        `universe_token` is the identity-allocator version stamp of
        `identity_cache` (see FleetCompiler.compile): matching tokens
        skip the O(universe) identity diff inside the compiler.

        The EXACT map states the tables were compiled from are
        published alongside (endpoint-axis order): the daemon's
        degraded host fold evaluates against these, so its verdicts
        stay bit-identical to the device tables no matter what
        regenerations land mid-stream."""
        entries = self._capture_entries()
        tables, index = self._fleet_compiler.compile(
            entries, list(identity_cache), universe_token=universe_token
        )
        states_by_id = {eid: state for eid, state, _ in entries}
        states: list = [None] * (max(index.values(), default=-1) + 1)
        for ep_id, idx in index.items():
            states[idx] = states_by_id.get(ep_id)
        with self._lock:
            # retain the outgoing publish (the world the standby
            # epoch slot still holds after the flip): the shadow
            # plane's standby-arm source.  Valid for exactly one
            # further publish — the compiler's ping-pong reuses the
            # buffers after that, which is why the shadow plane
            # HOST-COPIES these arrays at arm time and closes the
            # window stale the moment the live stamp moves again.
            prev_version, prev_tables, prev_index = self._published
            if prev_tables is not None:
                self._previous_published = (
                    prev_version,
                    prev_tables,
                    prev_index,
                    getattr(self, "_published_states", []),
                )
            version = prev_version + 1
            self._published = (version, tables, index)
            self._published_states = states
            return version

    def published(self) -> Tuple[int, Optional[PolicyTables], Dict[int, int]]:
        with self._lock:
            return self._published

    def published_with_states(self):
        """(version, tables, index, states) read under ONE lock —
        `states` is the per-axis realized-map-state snapshot the
        published tables were compiled from (the host fold's
        substrate)."""
        with self._lock:
            version, tables, index = self._published
            return version, tables, index, getattr(
                self, "_published_states", []
            )

    def published_previous(self):
        """The PREVIOUS publish — (version, tables, index, states) of
        the world the standby epoch slot held before the last flip,
        or None.  One-publish-deep by construction (the compiler's
        ping-pong buffer pair): the shadow plane copies what it needs
        at arm time and stamp-guards everything after."""
        with self._lock:
            return getattr(self, "_previous_published", None)

    # -- device-resident epochs (engine/publish.py) ---------------------------

    def _ensure_device_store(self):
        from cilium_tpu_torch.engine.publish import DeviceTableStore

        with self._device_lock:
            if self._device_store is None:
                factory = self.device_store_factory
                self._device_store = (
                    factory() if factory is not None
                    else DeviceTableStore(device=self._device)
                )
            return self._device_store

    def published_device(self):
        """(version, device-epoch PolicyTables, index): the published
        tables RESIDENT on device.  The first call pays a full upload;
        later calls return the live epoch, and a publish that landed
        since is installed as a delta-scoped scatter into the standby
        epoch (FleetCompiler.delta_for) — in-flight batches finish on
        the previous epoch untouched."""
        with self._lock:
            version, tables, index = self._published
        if tables is None:
            return version, None, index
        return version, self._device_tables(tables), index

    def delta_for(self, base_stamp, tables):
        """TableDelta from `base_stamp` to `tables`
        (FleetCompiler.delta_for passthrough) — lets a SECOND device
        store (the failover router's replica store) compute its own
        delta against ITS standby epoch's stamp instead of reusing
        the manager store's delta, whose base differs."""
        return self._fleet_compiler.delta_for(base_stamp, tables)

    def device_tables_for(self, tables):
        """Device-resident epoch for an EXACT published host snapshot
        (the daemon's serving path reads tables + host states under
        one lock and must dispatch against those same tables);
        installs it into the store when not yet resident."""
        return self._device_tables(tables)

    def _device_tables(self, tables):
        import numpy as np

        store = self._ensure_device_store()
        stamp = int(np.asarray(tables.generation))
        with self._device_lock:
            got = store.get(stamp)
            if got is not None:
                return got
            delta = self._fleet_compiler.delta_for(
                store.spare_stamp(), tables
            )
            dev, stats = store.publish(tables, delta)
            self.last_publish_stats = stats
            metrics.table_publish_total.inc(stats.mode)
            metrics.table_publish_bytes.inc(
                stats.mode, value=stats.bytes_h2d
            )
            metrics.table_publish_seconds.set(value=stats.seconds)
            listener = self.on_device_publish
            if listener is not None:
                try:
                    listener(tables)
                except Exception as exc:  # noqa: BLE001 — a router
                    # sync failure must not take down the publish
                    log.warning(
                        "on_device_publish listener failed",
                        extra={"fields": {"error": str(exc)}},
                    )
            log.info(
                "device table epoch published",
                extra={"fields": {
                    "epoch": stats.epoch,
                    "mode": stats.mode,
                    "bytes_h2d": stats.bytes_h2d,
                    "seconds": round(stats.seconds, 4),
                }},
            )
            return dev

    def build_failure_snapshot(self) -> Tuple[int, List[Tuple[int, str, str]]]:
        """(total count, last batch) read atomically — the two fields
        are updated together under the manager lock."""
        with self._lock:
            return self.build_failures, list(self.last_build_failures)

    def check_tables_current(self, tables) -> None:
        """Raises if `tables` is no longer a valid snapshot: a HOST
        compile more than one publish old (its stacked buffers have
        been reused — FleetCompiler.check_tables_current), or a device
        epoch that is no longer one of the two LIVE epochs (its
        buffers were donated to a newer publish)."""
        import numpy as np

        store = self._device_store
        if store is not None:
            raw = getattr(tables, "generation", None)
            stamp = int(np.asarray(raw)) if raw is not None else 0
            if stamp:
                if store.holds(tables):
                    return
                if (stamp >> 32) == 0 and store.live_stamps():
                    # a device round trip without x64 truncates the
                    # stamp to the publish counter — the store owns
                    # the staleness verdict for such tables
                    store.check_current(tables)
                    return
        self._fleet_compiler.check_tables_current(tables)

    def identity_index(self) -> Tuple[Dict[int, int], int]:
        """Identity index space of the (last-compiled) fleet tables —
        see FleetCompiler.identity_index."""
        return self._fleet_compiler.identity_index()
