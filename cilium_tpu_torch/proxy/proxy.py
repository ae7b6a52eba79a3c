"""Redirect manager + batched L7 request verdicts.

The port's own copy of the JAX package's proxy/proxy.py, with the
explicit device PyTorch needs: `Proxy(..., device=None)` compiles every
redirect's tables on the host and moves them to `device` (None = the
card; without one the constructor raises), so every verdict call of
its redirects runs there: HTTP_MATCH, KAFKA_MATCH and MEMCACHE_MATCH
on CUDA tensors, their plain versions on CPU tensors.  The monitor is
a monitor.MonitorBus (or any object with `publish`), which receives
one LogRecordNotify per logged request.  `update_endpoint_redirects`
runs under the `proxy.upcall` span; its fault seam waits for the fault
plane.

Port of pkg/proxy/proxy.go:
  - proxy-port allocation from a fixed range with reuse per proxy ID
    (allocatePort; the range comes from StartProxySupport,
    daemon/daemon.go:236: 10000-20000);
  - CreateOrUpdateRedirect (proxy.go:153,217-225): parser type picks
    the implementation — kafka → Kafka matcher, http & default →
    HTTP/DFA matcher (where the reference spawns Envoy), any other
    l7proto → the generic proxylib parser registered under that name;
  - RemoveRedirect releases the port;
  - the REQUEST-VERDICT path: a flow the datapath marked
    `proxy_port>0` lands on its Redirect (lookup by proxy port, like
    the proxymap orig-dst recovery in envoy/cilium_bpf_metadata.cc),
    the parser-specific matcher produces per-request allow/deny
    (403-close / Kafka error response in the reference,
    envoy/cilium_l7policy.cc + pkg/proxy/kafka.go:116-151), and each
    request emits an access-log record
    (pkg/proxy/logger / accesslog_server.go:174);
  - access records → the monitor's LogRecordNotify (pkg/proxy/logger).

The returned proxy ports feed the endpoint's realized_redirects, which
computeDesiredPolicyMapState writes into L4 entries (the redirect
loop of pkg/endpoint/bpf.go:488).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from cilium_tpu_torch.convert import l7_tables_to
from cilium_tpu_torch.device import resolve_device
from cilium_tpu_torch.identity import IdentityCache
from cilium_tpu_torch.l7 import http as l7_http
from cilium_tpu_torch.l7 import kafka as l7_kafka
from cilium_tpu_torch.l7 import proxylib
from cilium_tpu_torch.l7.http import (
    HTTPPolicy,
    compile_http_rules,
    resolve_selector_indices,
    specs_from_filter,
)
from cilium_tpu_torch.l7.kafka import (
    KafkaRuleSpec,
    KafkaTables,
    compile_kafka_rules,
    rule_spec_from_port_rule,
)
from cilium_tpu_torch.l7.proxylib import GenericL7Tables
from cilium_tpu_torch.metrics import registry as metrics
from cilium_tpu_torch.monitor.bus import MonitorBus
from cilium_tpu_torch.monitor.events import LogRecordNotify
from cilium_tpu_torch.policy.l4 import L4Filter, proxy_id
from cilium_tpu_torch.proxy.xds import Cache as XDSCache

PORT_MIN = 10000  # daemon/daemon.go:236
PORT_MAX = 20000

PARSER_HTTP = "http"
PARSER_KAFKA = "kafka"


@dataclass
class _PidState:
    """Per-proxy-id bookkeeping (see Proxy._pids)."""

    port: int
    endpoint_id: int
    gen: int = 0


@dataclass
class Redirect:
    """proxy.go Redirect."""

    id: str  # proxy ID string (epID:direction:proto:port)
    proxy_port: int
    parser: str
    endpoint_id: int
    ingress: bool
    http_policy: Optional[HTTPPolicy] = None
    kafka_tables: Optional[KafkaTables] = None
    generic_tables: Optional[GenericL7Tables] = None
    # fingerprint of the resolved matcher inputs the compiled tables
    # reflect — an unchanged redirect skips the tensor recompile on
    # the next regeneration sweep (the xDS cache's version-unchanged
    # no-op; recompiling every redirect per sweep dominated
    # incremental policy updates)
    resolved_fp: object = None


def _resolved_fingerprint(parser: str, resolved, n_identities: int):
    """Hashable digest of a redirect's resolved matcher inputs: equal
    fingerprints ⇒ the compiled tables would be identical (table
    shapes include the identity axis, so n_identities participates)."""
    if parser == PARSER_KAFKA:
        body = tuple(
            (
                tuple(sorted(s.api_keys)),
                s.api_version,
                s.client_id,
                s.topic,
                s.scope_key,
                tuple(sorted(s.identity_indices)),
            )
            for s in resolved
        )
    elif parser not in (PARSER_HTTP, ""):
        body = tuple(
            (tuple(sorted(indices)), tuple(repr(r) for r in rules))
            for indices, rules in resolved
        )
    else:
        body = tuple(
            (
                s.method,
                s.path,
                s.host,
                tuple(s.headers),
                s.scope_key,
                tuple(sorted(s.identity_indices)),
            )
            for s in resolved
        )
    return (parser, n_identities, body)


class Proxy:
    def __init__(
        self,
        monitor: Optional[MonitorBus] = None,
        port_min: int = PORT_MIN,
        port_max: int = PORT_MAX,
        device=None,
    ) -> None:
        # where every compiled table and verdict call of the redirects
        # lives; None = the card (raises without one)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.redirects: Dict[str, Redirect] = {}
        self.monitor = monitor
        self._port_min = port_min
        self._port_max = port_max
        self._next_port = port_min
        self._ports_in_use: set = set()
        # pid → (stable port, compile generation, endpoint) — a pid
        # owns its port from first allocation to remove_redirect,
        # even while a compile is pending, and only the NEWEST
        # generation's result may be installed
        self._pids: Dict[str, _PidState] = {}
        # matcher compiles ACK asynchronously (the NPDS push → Envoy
        # ACK shape, pkg/envoy/xds/ack.go): one worker keeps update
        # order per the reference's serialized xDS stream
        self._compiler = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="proxy-compile"
        )
        # versioned view of installed redirects (pkg/envoy/xds cache:
        # every install/remove is one cache transaction; NPDS-style
        # consumers observe versions and long-poll get_resources)
        self.xds = XDSCache()

    # -- port allocation (proxy.go allocatePort) ----------------------------

    def _allocate_port(self) -> int:
        for _ in range(self._port_max - self._port_min + 1):
            port = self._next_port
            self._next_port += 1
            if self._next_port > self._port_max:
                self._next_port = self._port_min
            if port not in self._ports_in_use:
                self._ports_in_use.add(port)
                return port
        raise RuntimeError("no available proxy ports")

    # -- redirects -----------------------------------------------------------

    def create_or_update_redirect(
        self,
        l4: L4Filter,
        pid: str,
        endpoint_id: int,
        identity_cache: IdentityCache,
        id_index: Dict[int, int],
        n_identities: int,
        selector_cache=None,
        wait_group=None,
    ) -> Redirect:
        """proxy.go:153: compile (or recompile) the L7 matcher for one
        redirect; the proxy port is stable across updates (including
        pending ones — the pid owns its port until remove_redirect).

        Rule/selector resolution happens SYNCHRONOUSLY on the caller
        (no shared control-plane state crosses threads); with
        `wait_group` (a utils.completion.WaitGroup) the tensor compile
        runs ASYNC and the new redirect is swapped in — and its
        completion ACKed — only when the compile finishes AND this
        call has not been superseded or removed: the xDS version-ACK
        contract (pkg/envoy/xds/ack.go).  A failed compile NACKs, so
        the waiter fails fast; the OLD redirect keeps serving either
        way — a timed-out regeneration keeps old state
        (pkg/endpoint/bpf.go:442)."""
        with self._lock:
            state = self._pids.get(pid)
            if state is None:
                state = _PidState(
                    port=self._allocate_port(),
                    endpoint_id=endpoint_id,
                )
                self._pids[pid] = state
            state.gen += 1
            gen = state.gen
            port = state.port
        redirect = Redirect(
            id=pid,
            proxy_port=port,
            parser=l4.l7_parser or PARSER_HTTP,
            endpoint_id=endpoint_id,
            ingress=l4.ingress,
        )
        # resolve the rules here, on the regeneration thread — the
        # async job must not read live selector/identity caches
        resolved = self._resolve_matcher_inputs(
            redirect, l4, identity_cache, id_index, selector_cache
        )
        redirect.resolved_fp = _resolved_fingerprint(
            redirect.parser, resolved, n_identities
        )
        with self._lock:
            prev = self.redirects.get(pid)
        if (
            prev is not None
            and prev.parser == redirect.parser
            and prev.resolved_fp == redirect.resolved_fp
        ):
            # inputs unchanged: reuse the compiled tables (the xDS
            # cache's version-unchanged no-op) — no compile job, the
            # completion ACKs immediately
            redirect.http_policy = prev.http_policy
            redirect.kafka_tables = prev.kafka_tables
            redirect.generic_tables = prev.generic_tables
            with self._lock:
                if self._pids.get(pid) is state and state.gen == gen:
                    self.redirects[pid] = redirect
            self._publish_xds(redirect, prev)
            self._update_redirect_gauge()
            if wait_group is not None:
                wait_group.add_completion().complete()
            return redirect
        if wait_group is None:
            self._compile_tables(redirect, resolved, n_identities)
            with self._lock:
                if self._pids.get(pid) is state and state.gen == gen:
                    installed = True
                    self.redirects[pid] = redirect
                else:
                    installed = False
            if installed:
                self._publish_xds(redirect, prev)
            self._update_redirect_gauge()
            return redirect

        completion = wait_group.add_completion()

        def job() -> None:
            try:
                self._compile_tables(redirect, resolved, n_identities)
            except Exception:
                completion.fail()  # NACK: the waiter fails fast
                return
            with self._lock:
                # superseded by a newer compile, or removed: do not
                # resurrect — the newest generation wins
                if self._pids.get(pid) is state and state.gen == gen:
                    installed = True
                    self.redirects[pid] = redirect
                else:
                    installed = False
            if installed:
                self._publish_xds(redirect, prev)
            self._update_redirect_gauge()
            completion.complete()

        self._compiler.submit(job)
        return redirect

    def _resolve_matcher_inputs(
        self,
        redirect: Redirect,
        l4: L4Filter,
        identity_cache: IdentityCache,
        id_index: Dict[int, int],
        selector_cache=None,
    ):
        """Selector → identity-index resolution (control-plane state;
        must run on the regeneration thread)."""
        if redirect.parser == PARSER_KAFKA:
            specs = []
            for selector, l7 in l4.l7_rules_per_ep.items():
                indices = resolve_selector_indices(
                    selector, identity_cache, id_index, selector_cache
                )
                if not (l7.kafka or []):
                    # empty rules = L7 allow-all: wildcard spec
                    specs.append(
                        KafkaRuleSpec(identity_indices=indices)
                    )
                for rule in l7.kafka or []:
                    specs.append(
                        rule_spec_from_port_rule(rule, indices)
                    )
            return specs
        if redirect.parser not in (PARSER_HTTP, ""):
            # generic proxylib parser, dispatched by l7proto name
            # (proxy.go:217 createOrUpdateRedirect → proxylib);
            # bundled parsers register at cilium_tpu_torch.l7 import time
            per_selector = []
            for selector, l7 in l4.l7_rules_per_ep.items():
                indices = resolve_selector_indices(
                    selector, identity_cache, id_index, selector_cache
                )
                per_selector.append((indices, list(l7.l7 or [])))
            return per_selector
        return specs_from_filter(
            l4, identity_cache, id_index, selector_cache
        )

    def _compile_tables(
        self, redirect: Redirect, resolved, n_identities: int
    ) -> None:
        """Tensor compile from pre-resolved inputs (pure; safe off
        the control-plane thread): the host compile, then the tables'
        leaves onto the proxy's device."""
        if redirect.parser == PARSER_KAFKA:
            redirect.kafka_tables = l7_tables_to(
                compile_kafka_rules(resolved, n_identities), self.device
            )
        elif redirect.parser not in (PARSER_HTTP, ""):
            generic = proxylib.compile_generic_rules(
                redirect.parser, resolved, n_identities
            )
            if generic.device is not None:
                generic = dataclasses.replace(
                    generic, device=l7_tables_to(generic.device, self.device)
                )
            redirect.generic_tables = generic
        else:
            redirect.http_policy = l7_tables_to(
                compile_http_rules(resolved, n_identities), self.device
            )

    def remove_redirect(self, pid: str) -> bool:
        """proxy.go RemoveRedirect: releases the pid's port and
        invalidates any in-flight compile for it."""
        with self._lock:
            state = self._pids.pop(pid, None)
            removed = self.redirects.pop(pid, None)
            if state is None:
                return False
            self._ports_in_use.discard(state.port)
        if removed is not None:
            self.xds.delete(
                self._xds_typeurl(removed.parser), removed.id
            )
        self._update_redirect_gauge()
        return True

    @staticmethod
    def _xds_typeurl(parser: str) -> str:
        return f"type.cilium.io/{parser}NetworkPolicy"

    def _publish_xds(
        self, redirect: "Redirect", prev: "Optional[Redirect]" = None
    ) -> None:
        if prev is not None and prev.parser != redirect.parser:
            # a pid whose parser changed must not linger under the
            # old type URL for long-polling consumers
            self.xds.delete(self._xds_typeurl(prev.parser), prev.id)
        self.xds.upsert(
            self._xds_typeurl(redirect.parser), redirect.id, redirect
        )

    def _update_redirect_gauge(self) -> None:
        """proxy_redirects{protocol} (metrics.go): installed
        redirects by parser."""
        with self._lock:
            by_parser = Counter(r.parser for r in self.redirects.values())
            # zero every label ever seen, then set current counts —
            # a parser whose last redirect vanished must not stay
            # stale in the exposition.  Snapshot under the lock:
            # concurrent installs mutate the seen-set.
            seen = self._gauge_parsers = getattr(
                self, "_gauge_parsers", set()
            )
            seen.update(by_parser)
            seen.update((PARSER_HTTP, PARSER_KAFKA))
            snapshot = tuple(seen)
        for parser in snapshot:
            metrics.proxy_redirects.set(
                parser, value=float(by_parser.get(parser, 0))
            )

    def redirect_for(
        self, endpoint_id: int, ingress: bool, protocol: str, port: int
    ) -> Optional[Redirect]:
        return self.redirects.get(
            proxy_id(endpoint_id, ingress, protocol, port)
        )

    def redirect_by_port(self, proxy_port: int) -> Optional[Redirect]:
        """The proxymap recovery step: a datapath verdict carries only
        the proxy port (policy.h proxy_port>0); map it back to the
        redirect whose matcher owns the flow."""
        for redirect in self.redirects.values():
            if redirect.proxy_port == proxy_port:
                return redirect
        return None

    # -- request verdicts (the L7 hot path) ----------------------------------

    def _verdict_batch(
        self,
        redirect: Redirect,
        tables,
        evaluate,
        requests,
        ident_idx,
        known,
        log: bool,
        parser_label: str,
        info_fn,
    ):
        """Shared skeleton of the per-parser verdict methods: guard,
        known default, batched evaluate, per-request access log."""
        if tables is None:
            raise ValueError(
                f"redirect {redirect.id} has no {parser_label} tables"
            )
        if known is None:
            known = np.ones(len(requests), dtype=bool)
        allowed = evaluate(tables, requests, ident_idx, known)
        n_fwd = int(np.asarray(allowed).sum())
        metrics.policy_l7_total.inc("received", value=len(requests))
        metrics.policy_l7_total.inc("forwarded", value=n_fwd)
        metrics.policy_l7_total.inc(
            "denied", value=len(requests) - n_fwd
        )
        if log and self.monitor is not None:
            for i, request in enumerate(requests):
                self.log_record(
                    redirect.endpoint_id,
                    parser_label,
                    "Forwarded" if allowed[i] else "Denied",
                    info=info_fn(request),
                )
        return allowed

    def verdict_http(
        self,
        redirect: Redirect,
        requests,  # [(method, path, host) bytes]
        ident_idx,  # i32 [B] identity index into the compiled universe
        known=None,  # bool [B]; default all-known
        headers=None,  # optional per-request {name: value} dicts
        log: bool = True,
    ):
        """Batched HTTP request verdicts through this redirect's
        compiled policy (device DFAs + host fallback for header rules
        and over-length fields).  Returns allowed bool [B]; emits one
        access-log record per request (verdict Forwarded/Denied, like
        cilium_l7policy.cc's 403 + accesslog)."""
        return self._verdict_batch(
            redirect,
            redirect.http_policy,
            lambda t, r, i, k: l7_http.evaluate_with_host_fallback(
                t, r, i, k, headers
            ),
            requests,
            ident_idx,
            known,
            log,
            PARSER_HTTP,
            lambda req: b" ".join([req[0], req[1]]).decode(
                "latin-1", "replace"
            ),
        )

    def verdict_kafka(
        self,
        redirect: Redirect,
        requests,  # [KafkaRequest]
        ident_idx,
        known=None,
        log: bool = True,
    ):
        """Batched Kafka request verdicts (pkg/proxy/kafka.go:116
        canAccess).  Returns allowed bool [B]."""
        return self._verdict_batch(
            redirect,
            redirect.kafka_tables,
            l7_kafka.evaluate_with_host_fallback,
            requests,
            ident_idx,
            known,
            log,
            PARSER_KAFKA,
            lambda req: f"key={req.kind} topics={list(req.topics)}",
        )

    def verdict_generic(
        self,
        redirect: Redirect,
        requests,  # [l7.proxylib.L7Request]
        ident_idx,
        known=None,
        log: bool = True,
    ):
        """Batched verdicts through a generic proxylib parser's
        compiled rules (proxylib policymap matching,
        proxylib/proxylib/policymap.go:150).  Returns
        allowed bool [B]."""
        return self._verdict_batch(
            redirect,
            redirect.generic_tables,
            proxylib.evaluate_requests,
            requests,
            ident_idx,
            known,
            log,
            redirect.parser,
            lambda req: " ".join(f"{k}={v}" for k, v in req.fields),
        )

    # -- endpoint integration (pkg/endpoint/bpf.go:488) ---------------------

    def update_endpoint_redirects(
        self,
        endpoint,
        identity_cache: IdentityCache,
        id_index: Dict[int, int],
        n_identities: int,
        selector_cache=None,
        wait_group=None,
    ) -> Dict[str, int]:
        """addNewRedirects/removeOldRedirects for one endpoint; returns
        the realized proxy-id → port map to feed back into the next
        computeDesiredPolicyMapState.  The endpoint is any object with
        `id`, `desired_l4_policy` and `realized_redirects`.  Runs under a
        `proxy.upcall` span (error status on a failure), so a traced
        regeneration shows which endpoint's redirect realization cost or
        failed the sweep.  An armed `proxy.upcall` fault site fails the
        realization at the start of the span, as a dead proxy fails the
        upcall."""
        from cilium_tpu_torch import faultinject, tracing

        with tracing.tracer.span(
            "proxy.upcall", site="proxy.upcall",
            attrs={"endpoint": endpoint.id},
        ) as sp:
            faultinject.fire("proxy.upcall")
            realized: Dict[str, int] = {}
            l4_policy = endpoint.desired_l4_policy
            wanted = set()
            if l4_policy is not None:
                for l4map in (l4_policy.ingress, l4_policy.egress):
                    for f in l4map.values():
                        if not f.is_redirect():
                            continue
                        pid = proxy_id(endpoint.id, f.ingress, f.protocol,
                                       f.port)
                        redirect = self.create_or_update_redirect(
                            f, pid, endpoint.id, identity_cache,
                            id_index, n_identities, selector_cache,
                            wait_group=wait_group,
                        )
                        realized[pid] = redirect.proxy_port
                        wanted.add(pid)
            with self._lock:
                stale = [
                    p
                    for p, st in self._pids.items()
                    if st.endpoint_id == endpoint.id and p not in wanted
                ]
            for pid in stale:
                self.remove_redirect(pid)
            endpoint.realized_redirects = realized
            sp.attrs["redirects"] = len(realized)
            return realized

    # -- access logging (pkg/proxy/logger) -----------------------------------

    def log_record(
        self, endpoint_id: int, l7_proto: str, verdict: str, info: str = ""
    ) -> None:
        if self.monitor is not None:
            self.monitor.publish(
                LogRecordNotify(
                    endpoint_id=endpoint_id,
                    l7_proto=l7_proto,
                    verdict=verdict,
                    info=info,
                )
            )
