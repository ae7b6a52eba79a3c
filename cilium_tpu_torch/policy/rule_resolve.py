"""Per-rule resolution: label verdicts, L4 merge, CIDR merge.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/rule.go.  All the precedence
subtleties live here:

  * FromRequires/ToRequires deny-precedence: an unmet Requires denies
    immediately and overrides any Allow (rule.go:352-391, 399-440);
  * L3-only match => Allowed, ToPorts present => defer to L4
    (rule.go:374-389);
  * per-(port,proto) L4 merge with wildcard-L3 absorption and
    L7-parser/type conflict errors (rule.go:36-109);
  * ANY protocol expanding to TCP+UDP (rule.go:191-210);
  * requirements injection into FromEndpoints/ToEndpoints
    (rule.go:247-257, 541-551).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from cilium_tpu_torch import option
from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.policy.api.rule import (
    EgressRule,
    IngressRule,
    PROTO_ANY,
    PROTO_TCP,
    PROTO_UDP,
    PortRule,
    PortRuleKafka,
    L7Rules,
    Rule,
    compute_resultant_cidr_set,
    l7rules_is_empty,
)
from cilium_tpu_torch.policy.api.selector import (
    EndpointSelector,
    RESERVED_ENDPOINT_SELECTORS,
    Requirement,
    WILDCARD_SELECTOR,
    slice_matches,
)
from cilium_tpu_torch.policy.l3 import CIDRPolicy, CIDRPolicyMap
from cilium_tpu_torch.policy.l4 import (
    L4Filter,
    L4Policy,
    L4PolicyMap,
    PARSER_TYPE_HTTP,
    PARSER_TYPE_KAFKA,
    PARSER_TYPE_NONE,
    create_l4_egress_filter,
    create_l4_ingress_filter,
)
from cilium_tpu_torch.policy.search import Decision, SearchContext


class L4MergeError(ValueError):
    """L7 parser/type merge conflict (rule.go:57,67)."""


class TraceState:
    """repository.go:51."""

    def __init__(self):
        self.selected_rules = 0
        self.matched_rules = 0
        self.constrained_rules = 0
        self.rule_id = 0

    def select_rule(self, ctx: SearchContext, r: "PolicyRule") -> None:
        ctx.policy_trace("* Rule %s: selected\n", r)
        self.selected_rules += 1

    def unselect_rule(self, ctx: SearchContext, labels, r: "PolicyRule") -> None:
        ctx.policy_trace_verbose(
            "  Rule %s: did not select %+s\n", r, labels
        )


def _merge_l4_port_shared(
    ctx: SearchContext,
    endpoints: List[EndpointSelector],
    existing: L4Filter,
    to_merge: L4Filter,
) -> None:
    """mergeL4Port (rule.go:36): merge to_merge into existing."""
    # Case 1: either side allows all at L3 -> collapse to wildcard.
    if existing.allows_all_at_l3() or to_merge.allows_all_at_l3():
        existing.endpoints = [WILDCARD_SELECTOR]
    else:
        existing.endpoints = existing.endpoints + list(endpoints)

    if to_merge.l7_parser != PARSER_TYPE_NONE:
        if existing.l7_parser == PARSER_TYPE_NONE:
            existing.l7_parser = to_merge.l7_parser
        elif to_merge.l7_parser != existing.l7_parser:
            ctx.policy_trace(
                "   Merge conflict: mismatching parsers %s/%s\n",
                to_merge.l7_parser, existing.l7_parser,
            )
            raise L4MergeError(
                f"Cannot merge conflicting L7 parsers "
                f"({to_merge.l7_parser}/{existing.l7_parser})"
            )

    for sel, new_rules in to_merge.l7_rules_per_ep.items():
        ep = existing.l7_rules_per_ep.get(sel)
        if ep is None:
            existing.l7_rules_per_ep[sel] = new_rules.copy()
            continue
        if new_rules.http:
            if (ep.kafka and len(ep.kafka) > 0) or ep.l7proto != "":
                ctx.policy_trace(
                    "   Merge conflict: mismatching L7 rule types.\n"
                )
                raise L4MergeError("Cannot merge conflicting L7 rule types")
            if ep.http is None:
                ep.http = []
            for nr in new_rules.http:
                if not nr.exists(ep):
                    ep.http.append(nr)
        elif new_rules.kafka:
            if (ep.http and len(ep.http) > 0) or ep.l7proto != "":
                ctx.policy_trace(
                    "   Merge conflict: mismatching L7 rule types.\n"
                )
                raise L4MergeError("Cannot merge conflicting L7 rule types")
            if ep.kafka is None:
                ep.kafka = []
            for nr in new_rules.kafka:
                if not nr.exists(ep):
                    ep.kafka.append(nr)
        elif new_rules.l7proto != "":
            if (
                (ep.kafka and len(ep.kafka) > 0)
                or (ep.http and len(ep.http) > 0)
                or (ep.l7proto != "" and ep.l7proto != new_rules.l7proto)
            ):
                ctx.policy_trace(
                    "   Merge conflict: mismatching L7 rule types.\n"
                )
                raise L4MergeError("Cannot merge conflicting L7 rule types")
            if ep.l7proto == "":
                ep.l7proto = new_rules.l7proto
            if ep.l7 is None:
                ep.l7 = []
            for nr in new_rules.l7 or []:
                if not nr.exists(ep):
                    ep.l7.append(nr)
        else:
            ctx.policy_trace("   No L7 rules to merge.\n")
        existing.l7_rules_per_ep[sel] = ep


def merge_l4_ingress_port(
    ctx: SearchContext,
    endpoints: List[EndpointSelector],
    endpoints_with_l3_override: List[EndpointSelector],
    r: PortRule,
    p,  # PortProtocol
    proto: str,
    rule_labels: LabelArray,
    res_map: L4PolicyMap,
) -> int:
    """rule.go:121."""
    key = f"{p.port}/{proto}"
    existing = res_map.get(key)
    if existing is None:
        res_map[key] = create_l4_ingress_filter(
            endpoints, endpoints_with_l3_override, r, p, proto, rule_labels
        )
        return 1
    to_merge = create_l4_ingress_filter(
        endpoints, endpoints_with_l3_override, r, p, proto, rule_labels
    )
    _merge_l4_port_shared(ctx, endpoints, existing, to_merge)
    existing.derived_from_rules.append(rule_labels)
    res_map[key] = existing
    return 1


def merge_l4_egress_port(
    ctx: SearchContext,
    endpoints: List[EndpointSelector],
    r: PortRule,
    p,
    proto: str,
    rule_labels: LabelArray,
    res_map: L4PolicyMap,
) -> int:
    """rule.go:499."""
    key = f"{p.port}/{proto}"
    existing = res_map.get(key)
    if existing is None:
        res_map[key] = create_l4_egress_filter(
            endpoints, r, p, proto, rule_labels
        )
        return 1
    to_merge = create_l4_egress_filter(endpoints, r, p, proto, rule_labels)
    _merge_l4_port_shared(ctx, endpoints, existing, to_merge)
    existing.derived_from_rules.append(rule_labels)
    res_map[key] = existing
    return 1


def _l3_override_endpoints() -> List[EndpointSelector]:
    """rule.go:166-172: daemon options may force host/world L3 allows."""
    out: List[EndpointSelector] = []
    if option.Config.always_allow_localhost():
        out.append(RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_HOST])
        if option.Config.host_allows_world:
            out.append(RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_WORLD])
    return out


def merge_l4_ingress(
    ctx: SearchContext,
    rule: IngressRule,
    rule_labels: LabelArray,
    res_map: L4PolicyMap,
) -> int:
    """rule.go:143."""
    if len(rule.to_ports) == 0:
        ctx.policy_trace("    No L4 %s rules\n", "Ingress")
        return 0

    from_endpoints = rule.get_source_endpoint_selectors()
    found = 0

    if ctx.from_labels is not None and len(from_endpoints) > 0:
        if not slice_matches(from_endpoints, ctx.from_labels):
            ctx.policy_trace("    Labels %s not found", ctx.from_labels)
            return 0

    ctx.policy_trace("    Found all required labels")

    endpoints_with_l3_override = _l3_override_endpoints()

    for r in rule.to_ports:
        ctx.policy_trace(
            "    Allows %s port %s from endpoints %s\n",
            "Ingress", [ (p.port, p.protocol) for p in r.ports], from_endpoints,
        )
        for p in r.ports:
            if p.protocol != PROTO_ANY:
                found += merge_l4_ingress_port(
                    ctx, from_endpoints, endpoints_with_l3_override,
                    r, p, p.protocol, rule_labels, res_map,
                )
            else:
                found += merge_l4_ingress_port(
                    ctx, from_endpoints, endpoints_with_l3_override,
                    r, p, PROTO_TCP, rule_labels, res_map,
                )
                found += merge_l4_ingress_port(
                    ctx, from_endpoints, endpoints_with_l3_override,
                    r, p, PROTO_UDP, rule_labels, res_map,
                )
    return found


def merge_l4_egress(
    ctx: SearchContext,
    rule: EgressRule,
    rule_labels: LabelArray,
    res_map: L4PolicyMap,
) -> int:
    """rule.go:442."""
    if len(rule.to_ports) == 0:
        ctx.policy_trace("    No L4 %s rules\n", "Egress")
        return 0

    to_endpoints = rule.get_destination_endpoint_selectors()
    found = 0

    for r in rule.to_ports:
        ctx.policy_trace(
            "    Allows %s port %s to endpoints %s\n",
            "Egress", [(p.port, p.protocol) for p in r.ports], to_endpoints,
        )
        for p in r.ports:
            if p.protocol != PROTO_ANY:
                found += merge_l4_egress_port(
                    ctx, to_endpoints, r, p, p.protocol, rule_labels, res_map
                )
            else:
                found += merge_l4_egress_port(
                    ctx, to_endpoints, r, p, PROTO_TCP, rule_labels, res_map
                )
                found += merge_l4_egress_port(
                    ctx, to_endpoints, r, p, PROTO_UDP, rule_labels, res_map
                )
    return found


class PolicyRule:
    """pkg/policy rule (rule.go:28): an api.Rule inside the repository."""

    def __init__(self, rule: Rule):
        self.rule = rule

    @property
    def endpoint_selector(self) -> EndpointSelector:
        return self.rule.endpoint_selector

    @property
    def labels(self) -> LabelArray:
        return self.rule.labels

    def __str__(self) -> str:
        return repr(self.rule.endpoint_selector)

    # -- label-level verdicts (rule.go:352,399) -----------------------------

    def can_reach_ingress(self, ctx: SearchContext,
                          state: TraceState) -> Decision:
        if not self.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, self)
            return Decision.UNDECIDED

        state.select_rule(ctx, self)
        for r in self.rule.ingress:
            for sel in r.from_requires:
                ctx.policy_trace("    Requires from labels %+s", sel)
                if not sel.matches(ctx.from_labels):
                    ctx.policy_trace(
                        "-     Labels %s not found\n", ctx.from_labels
                    )
                    state.constrained_rules += 1
                    return Decision.DENIED
                ctx.policy_trace("+     Found all required labels\n")

        # Separate loop: FromRequires failure takes precedence.
        for r in self.rule.ingress:
            for sel in r.get_source_endpoint_selectors():
                ctx.policy_trace("    Allows from labels %+s", sel)
                if sel.matches(ctx.from_labels):
                    ctx.policy_trace("      Found all required labels")
                    if len(r.to_ports) == 0:
                        ctx.policy_trace("+       No L4 restrictions\n")
                        state.matched_rules += 1
                        return Decision.ALLOWED
                    ctx.policy_trace(
                        "        Rule restricts traffic to specific L4 "
                        "destinations; deferring policy decision to L4 "
                        "policy stage\n"
                    )
                else:
                    ctx.policy_trace(
                        "      Labels %s not found\n", ctx.from_labels
                    )
        return Decision.UNDECIDED

    def can_reach_egress(self, ctx: SearchContext,
                         state: TraceState) -> Decision:
        if not self.endpoint_selector.matches(ctx.from_labels):
            state.unselect_rule(ctx, ctx.from_labels, self)
            return Decision.UNDECIDED

        state.select_rule(ctx, self)
        for r in self.rule.egress:
            for sel in r.to_requires:
                ctx.policy_trace("    Requires from labels %+s", sel)
                if not sel.matches(ctx.to_labels):
                    ctx.policy_trace(
                        "-     Labels %s not found\n", ctx.to_labels
                    )
                    state.constrained_rules += 1
                    return Decision.DENIED
                ctx.policy_trace("+     Found all required labels\n")

        for r in self.rule.egress:
            for sel in r.get_destination_endpoint_selectors():
                ctx.policy_trace("    Allows to labels %+s", sel)
                if sel.matches(ctx.to_labels):
                    ctx.policy_trace("      Found all required labels")
                    if len(r.to_ports) == 0:
                        ctx.policy_trace("+       No L4 restrictions\n")
                        state.matched_rules += 1
                        return Decision.ALLOWED
                    ctx.policy_trace(
                        "        Rule restricts traffic from specific L4 "
                        "destinations; deferring policy decision to L4 "
                        "policy stage\n"
                    )
                else:
                    ctx.policy_trace(
                        "      Labels %s not found\n", ctx.to_labels
                    )
        return Decision.UNDECIDED

    # -- L4 resolution (rule.go:227,521) ------------------------------------

    def resolve_l4_ingress_policy(
        self,
        ctx: SearchContext,
        state: TraceState,
        result: L4Policy,
        requirements: List[Requirement],
    ) -> Optional[L4Policy]:
        if not self.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, self)
            return None

        state.select_rule(ctx, self)
        found = 0

        if len(self.rule.ingress) == 0:
            ctx.policy_trace("    No L4 ingress rules\n")
        for ingress_rule in self.rule.ingress:
            rule_copy = ingress_rule
            if requirements:
                rule_copy = ingress_rule.deep_copy()
                rule_copy.from_endpoints = [
                    s.add_requirements(requirements)
                    for s in rule_copy.from_endpoints
                ]
            cnt = merge_l4_ingress(
                ctx, rule_copy, LabelArray(self.rule.labels), result.ingress
            )
            if cnt > 0:
                found += cnt
        return result if found > 0 else None

    def resolve_l4_egress_policy(
        self,
        ctx: SearchContext,
        state: TraceState,
        result: L4Policy,
        requirements: List[Requirement],
    ) -> Optional[L4Policy]:
        if not self.endpoint_selector.matches(ctx.from_labels):
            state.unselect_rule(ctx, ctx.from_labels, self)
            return None

        state.select_rule(ctx, self)
        found = 0

        if len(self.rule.egress) == 0:
            ctx.policy_trace("    No L4 rules\n")
        for egress_rule in self.rule.egress:
            rule_copy = egress_rule
            if requirements:
                rule_copy = egress_rule.deep_copy()
                rule_copy.to_endpoints = [
                    s.add_requirements(requirements)
                    for s in rule_copy.to_endpoints
                ]
            cnt = merge_l4_egress(
                ctx, rule_copy, LabelArray(self.rule.labels), result.egress
            )
            if cnt > 0:
                found += cnt
        return result if found > 0 else None

    # -- CIDR resolution (rule.go:296) --------------------------------------

    def resolve_cidr_policy(
        self, ctx: SearchContext, state: TraceState, result: CIDRPolicy
    ) -> Optional[CIDRPolicy]:
        if not self.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, self)
            return None

        state.select_rule(ctx, self)
        found = 0

        for ingress_rule in self.rule.ingress:
            all_cidrs = list(ingress_rule.from_cidr)
            all_cidrs.extend(
                compute_resultant_cidr_set(ingress_rule.from_cidr_set)
            )
            # CIDR+L4 handled via merge_l4_ingress; skip here (rule.go:314).
            if all_cidrs and len(ingress_rule.to_ports) > 0:
                continue
            found += _merge_cidr(
                ctx, "Ingress", all_cidrs, self.rule.labels, result.ingress
            )

        # Egress counts CIDR+L4 too, for prefix-length accounting
        # (rule.go:327-339).
        for egress_rule in self.rule.egress:
            all_cidrs = list(egress_rule.to_cidr)
            all_cidrs.extend(
                compute_resultant_cidr_set(egress_rule.to_cidr_set)
            )
            found += _merge_cidr(
                ctx, "Egress", all_cidrs, self.rule.labels, result.egress
            )

        if found > 0:
            return result
        ctx.policy_trace("    No L3 rules\n")
        return None


def _merge_cidr(
    ctx: SearchContext,
    direction: str,
    ip_rules: List[str],
    rule_labels: LabelArray,
    res_map: CIDRPolicyMap,
) -> int:
    """rule.go:279."""
    found = 0
    for r in ip_rules:
        ctx.policy_trace("  Allows %s IP %s\n", direction, r)
        found += res_map.insert(r, rule_labels)
    return found
