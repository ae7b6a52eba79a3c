"""L4 filters and policy maps.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/l4.go.  An L4PolicyMap keyed by
"port/proto" is the host-side intermediate representation the compiler
lowers into dense per-endpoint filter tensors (port/proto arrays +
identity bitmask rows); see cilium_tpu_torch.compiler.tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.policy import api
from cilium_tpu_torch.policy.api.rule import (
    L7Rules,
    PROTO_TCP,
    PortProtocol,
    PortRule,
    U8PROTO,
    l7rules_is_empty,
    l7rules_len,
)
from cilium_tpu_torch.policy.api.selector import (
    EndpointSelector,
    WILDCARD_SELECTOR,
    selects_all_endpoints,
)
from cilium_tpu_torch.policy.search import Decision, Port, SearchContext

# L7 parser types (l4.go:80-87)
PARSER_TYPE_NONE = ""
PARSER_TYPE_HTTP = "http"
PARSER_TYPE_KAFKA = "kafka"


class L7DataMap(dict):
    """selector -> L7Rules, keyed by selector identity (l4.go:31).

    The reference's map key is the EndpointSelector struct whose
    embedded pointers give pointer-equality keying; our selectors hash
    by object identity, matching that (see api.selector docstring).
    """

    def get_relevant_rules(self, identity_labels: Optional[LabelArray]) -> L7Rules:
        """l4.go:118: union of rules whose selector matches the identity,
        with wildcard-selector rules always appended."""
        rules = L7Rules(http=[], kafka=[], l7proto="", l7=[])
        if identity_labels is not None:
            # NB: the wildcard entry both matches in this loop and is
            # appended again below — reproducing the reference's
            # double-append quirk (l4.go:122-138) exactly.
            for selector, ep_rules in self.items():
                if selector.matches(identity_labels):
                    rules.http.extend(ep_rules.http or [])
                    rules.kafka.extend(ep_rules.kafka or [])
                    rules.l7proto = ep_rules.l7proto
                    rules.l7.extend(ep_rules.l7 or [])
        wild = self.get(WILDCARD_SELECTOR)
        if wild is not None:
            rules.http.extend(wild.http or [])
            rules.kafka.extend(wild.kafka or [])
            rules.l7proto = wild.l7proto
            rules.l7.extend(wild.l7 or [])
        return rules

    def add_rules_for_endpoints(self, rules: L7Rules,
                                endpoints: List[EndpointSelector]) -> None:
        """l4.go:143."""
        if l7rules_len(rules) == 0:
            return
        # Store a copy per key (Go stores struct copies by value,
        # l4.go:150-154) so later merge appends don't corrupt the
        # originating api.Rule or sibling keys.
        if endpoints:
            for epsel in endpoints:
                self[epsel] = rules.copy()
        else:
            self[WILDCARD_SELECTOR] = rules.copy()


@dataclass
class L4Filter:
    """l4.go:89: the per-(port,proto) allow filter."""

    port: int
    protocol: str
    u8proto: int
    endpoints: List[EndpointSelector] = field(default_factory=list)
    l7_parser: str = PARSER_TYPE_NONE
    l7_rules_per_ep: L7DataMap = field(default_factory=L7DataMap)
    ingress: bool = True
    derived_from_rules: List[LabelArray] = field(default_factory=list)

    def allows_all_at_l3(self) -> bool:
        """l4.go:112."""
        return selects_all_endpoints(self.endpoints)

    def is_redirect(self) -> bool:
        """l4.go:236."""
        return self.l7_parser != PARSER_TYPE_NONE

    def matches_labels(self, labels: Optional[LabelArray]) -> bool:
        """l4.go:258."""
        if self.allows_all_at_l3():
            return True
        if not labels:
            return False
        return any(sel.matches(labels) for sel in self.endpoints)


def create_l4_filter(
    peer_endpoints: List[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
    ingress: bool,
) -> L4Filter:
    """l4.go:162."""
    p = port.numeric_port()
    u8p = U8PROTO.get(protocol, 0)

    filter_endpoints = peer_endpoints
    if selects_all_endpoints(peer_endpoints):
        filter_endpoints = [WILDCARD_SELECTOR]

    l4 = L4Filter(
        port=p,
        protocol=protocol,
        u8proto=u8p,
        endpoints=list(filter_endpoints),
        derived_from_rules=[rule_labels],
        ingress=ingress,
    )

    if protocol == PROTO_TCP and rule.rules is not None:
        if rule.rules.http:
            l4.l7_parser = PARSER_TYPE_HTTP
        elif rule.rules.kafka:
            l4.l7_parser = PARSER_TYPE_KAFKA
        elif rule.rules.l7proto != "":
            l4.l7_parser = rule.rules.l7proto
        if not l7rules_is_empty(rule.rules):
            l4.l7_rules_per_ep.add_rules_for_endpoints(
                rule.rules, list(filter_endpoints)
            )
    return l4


def create_l4_ingress_filter(
    from_endpoints: List[EndpointSelector],
    endpoints_with_l3_override: List[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
) -> L4Filter:
    """l4.go:209: host/world L3 overrides become L7 allow-all."""
    f = create_l4_filter(
        from_endpoints, rule, port, protocol, rule_labels, True
    )
    if not l7rules_is_empty(rule.rules):
        for selector in endpoints_with_l3_override:
            f.l7_rules_per_ep[selector] = L7Rules()
    return f


def create_l4_egress_filter(
    to_endpoints: List[EndpointSelector],
    rule: PortRule,
    port: PortProtocol,
    protocol: str,
    rule_labels: LabelArray,
) -> L4Filter:
    """l4.go:229."""
    return create_l4_filter(
        to_endpoints, rule, port, protocol, rule_labels, False
    )


class L4PolicyMap(dict):
    """"port/proto" -> L4Filter (l4.go:276)."""

    def has_redirect(self) -> bool:
        return any(f.is_redirect() for f in self.values())

    def contains_all_l3l4(self, labels: Optional[LabelArray],
                          ports: List[Port]) -> Decision:
        """l4.go:300: the L4 coverage verdict."""
        if len(self) == 0:
            return Decision.ALLOWED
        if len(ports) == 0:
            return Decision.DENIED
        for l4ctx in ports:
            proto = l4ctx.protocol
            if proto in ("", "ANY"):
                tcp_filter = self.get(f"{l4ctx.port}/TCP")
                tcp_match = tcp_filter is not None and tcp_filter.matches_labels(labels)
                udp_filter = self.get(f"{l4ctx.port}/UDP")
                udp_match = udp_filter is not None and udp_filter.matches_labels(labels)
                if not tcp_match and not udp_match:
                    return Decision.DENIED
            else:
                f = self.get(f"{l4ctx.port}/{proto}")
                if f is None or not f.matches_labels(labels):
                    return Decision.DENIED
        return Decision.ALLOWED

    def ingress_covers_context(self, ctx: SearchContext) -> Decision:
        """l4.go:355."""
        return self.contains_all_l3l4(ctx.from_labels, ctx.dports)

    def egress_covers_context(self, ctx: SearchContext) -> Decision:
        """l4.go:361."""
        return self.contains_all_l3l4(ctx.to_labels, ctx.dports)


@dataclass
class L4Policy:
    """l4.go:337."""

    ingress: L4PolicyMap = field(default_factory=L4PolicyMap)
    egress: L4PolicyMap = field(default_factory=L4PolicyMap)
    revision: int = 0

    def has_redirect(self) -> bool:
        return self.ingress.has_redirect() or self.egress.has_redirect()

    def requires_conntrack(self) -> bool:
        return len(self.ingress) > 0 or len(self.egress) > 0


def proxy_id(endpoint_id: int, ingress: bool, protocol: str, port: int) -> str:
    """proxyid.go: unique redirect key."""
    direction = "ingress" if ingress else "egress"
    return f"{endpoint_id}:{direction}:{protocol}:{port}"


def parse_proxy_id(pid: str):
    comps = pid.split(":")
    if len(comps) != 4:
        raise ValueError(f"invalid proxy ID structure: {pid}")
    return int(comps[0]), comps[1] == "ingress", comps[2], int(comps[3])
