"""The policy repository: ordered rules + revisioned verdict resolution.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/repository.go.  This is the
control-plane source of truth; every compiled table tensor carries the
repository revision it was generated from, and table swaps on device are
gated on revision (the ACK-flip pattern, SURVEY.md §5).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.logging import get_logger

from cilium_tpu_torch.policy.api.rule import (
    PROTO_TCP,
    PROTO_UDP,
    PortRuleHTTP,
    PortRuleKafka,
    L7Rules,
    Rule,
)
from cilium_tpu_torch.policy.api.selector import Requirement
from cilium_tpu_torch.policy.l3 import CIDRPolicy
from cilium_tpu_torch.policy.l4 import (
    L4Policy,
    L4PolicyMap,
    PARSER_TYPE_HTTP,
    PARSER_TYPE_KAFKA,
    PARSER_TYPE_NONE,
)
from cilium_tpu_torch.policy.rule_resolve import L4MergeError, PolicyRule, TraceState
from cilium_tpu_torch.policy.search import Decision, SearchContext

log = get_logger("policy")


class Repository:
    """repository.go:31: rules + revision."""

    def __init__(self):
        self.lock = threading.RLock()
        self.rules: List[PolicyRule] = []
        self.revision = 1

    # -- trace helper (repository.go:66) ------------------------------------

    def _trace(self, state: TraceState, ctx: SearchContext) -> None:
        ctx.policy_trace(
            "%d/%d rules selected\n", state.selected_rules, len(self.rules)
        )
        if state.constrained_rules > 0:
            ctx.policy_trace("Found unsatisfied FromRequires constraint\n")
        elif state.matched_rules > 0:
            ctx.policy_trace("Found allow rule\n")
        else:
            ctx.policy_trace("Found no allow rule\n")

    # -- label-level verdicts ------------------------------------------------

    def can_reach_ingress(self, ctx: SearchContext) -> Decision:
        """CanReachIngressRLocked (repository.go:80): first Denied breaks;
        Allowed is remembered but later rules may still deny."""
        decision = Decision.UNDECIDED
        state = TraceState()
        for i, r in enumerate(self.rules):
            state.rule_id = i
            v = r.can_reach_ingress(ctx, state)
            if v == Decision.DENIED:
                decision = Decision.DENIED
                break
            elif v == Decision.ALLOWED:
                decision = Decision.ALLOWED
        self._trace(state, ctx)
        return decision

    def can_reach_egress(self, ctx: SearchContext) -> Decision:
        """CanReachEgressRLocked (repository.go:466)."""
        decision = Decision.UNDECIDED
        state = TraceState()
        for i, r in enumerate(self.rules):
            state.rule_id = i
            v = r.can_reach_egress(ctx, state)
            if v == Decision.DENIED:
                decision = Decision.DENIED
                break
            elif v == Decision.ALLOWED:
                decision = Decision.ALLOWED
        self._trace(state, ctx)
        return decision

    def allows_ingress_label_access(self, ctx: SearchContext) -> Decision:
        """AllowsIngressLabelAccess (repository.go:111): label-only verdict
        with default deny."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = Decision.DENIED
        if len(self.rules) == 0:
            ctx.policy_trace("  No rules found\n")
        else:
            if self.can_reach_ingress(ctx) == Decision.ALLOWED:
                decision = Decision.ALLOWED
        ctx.policy_trace("Label verdict: %s", str(decision))
        return decision

    def allows_egress_label_access(self, ctx: SearchContext) -> Decision:
        """repository.go:448."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = Decision.DENIED
        if len(self.rules) == 0:
            ctx.policy_trace("  No rules found\n")
        else:
            decision = self.can_reach_egress(ctx)
        ctx.policy_trace("Egress label verdict: %s", str(decision))
        return decision

    # -- L4 resolution -------------------------------------------------------

    def _collect_ingress_requirements(
        self, ctx: SearchContext, rules=None
    ) -> List[Requirement]:
        """repository.go:252-266: flatten all FromRequires of rules
        selecting ctx.To into selector requirements."""
        reqs: List[Requirement] = []
        for r in self.rules if rules is None else rules:
            for ingress_rule in r.rule.ingress:
                if r.endpoint_selector.matches(ctx.to_labels):
                    for requirement in ingress_rule.from_requires:
                        reqs.extend(requirement.convert_to_requirements())
        return reqs

    def _collect_egress_requirements(
        self, ctx: SearchContext, rules=None
    ) -> List[Requirement]:
        """repository.go:297-311."""
        reqs: List[Requirement] = []
        for r in self.rules if rules is None else rules:
            for egress_rule in r.rule.egress:
                if r.endpoint_selector.matches(ctx.from_labels):
                    for requirement in egress_rule.to_requires:
                        reqs.extend(requirement.convert_to_requirements())
        return reqs

    def resolve_l4_ingress_policy(
        self, ctx: SearchContext, rules=None
    ) -> L4PolicyMap:
        """ResolveL4IngressPolicy (repository.go:245).

        `rules` restricts the walk to an ordered subset; callers must
        guarantee it contains every rule whose endpoint_selector
        matches ctx.to_labels (the RuleIndex invariant) — other rules
        are no-ops in this resolution."""
        result = L4Policy()
        ctx.policy_trace("\n")
        ctx.policy_trace(
            "Resolving ingress port policy for %+s\n", ctx.to_labels
        )
        state = TraceState()
        requirements = self._collect_ingress_requirements(ctx, rules)

        for r in self.rules if rules is None else rules:
            found = r.resolve_l4_ingress_policy(
                ctx, state, result, requirements
            )
            state.rule_id += 1
            if found is not None:
                state.matched_rules += 1

        self._wildcard_l3l4_rules(ctx, True, result.ingress, rules)
        self._trace(state, ctx)
        return result.ingress

    def resolve_l4_egress_policy(
        self, ctx: SearchContext, rules=None
    ) -> L4PolicyMap:
        """ResolveL4EgressPolicy (repository.go:291)."""
        result = L4Policy()
        ctx.policy_trace("\n")
        ctx.policy_trace(
            "Resolving egress port policy for %+s\n", ctx.to_labels
        )
        requirements = self._collect_egress_requirements(ctx, rules)
        state = TraceState()
        for i, r in enumerate(self.rules if rules is None else rules):
            state.rule_id = i
            found = r.resolve_l4_egress_policy(
                ctx, state, result, requirements
            )
            state.rule_id += 1
            if found is not None:
                state.matched_rules += 1

        result.revision = self.revision
        self._wildcard_l3l4_rules(ctx, False, result.egress, rules)
        self._trace(state, ctx)
        return result.egress

    # -- L3-allow -> L7-wildcard injection (repository.go:128-235) ----------

    @staticmethod
    def _l7_filter_index(l4_policy: L4PolicyMap):
        """(protocol → port → [keys]) over the L7-carrying filters —
        _wildcard_l3l4_rule's scan was O(rules × filters) per resolve;
        protocol/port/parser of a filter never change while the
        wildcard pass runs, so one index serves every rule."""
        index: Dict[str, Dict[int, List]] = {}
        for k, f in l4_policy.items():
            if f.l7_parser == PARSER_TYPE_NONE:
                continue
            index.setdefault(f.protocol, {}).setdefault(
                f.port, []
            ).append(k)
        return index

    def _wildcard_l3l4_rule(
        self,
        proto: str,
        port: int,
        endpoints: List,
        rule_labels: LabelArray,
        l4_policy: L4PolicyMap,
        index=None,
    ) -> None:
        """repository.go:128: endpoints allowed at L3/L4 get wildcarded
        into every L7 filter on a matching (proto, port)."""
        if index is not None:
            ports = index.get(proto, {})
            keys = (
                [k for lst in ports.values() for k in lst]
                if port == 0
                else list(ports.get(port, ()))
            )
            items = [(k, l4_policy[k]) for k in keys]
        else:
            items = list(l4_policy.items())
        for k, f in items:
            if proto != f.protocol or (port != 0 and port != f.port):
                continue
            if f.l7_parser == PARSER_TYPE_NONE:
                continue
            elif f.l7_parser == PARSER_TYPE_HTTP:
                for sel in endpoints:
                    f.l7_rules_per_ep[sel] = L7Rules(http=[PortRuleHTTP()])
            elif f.l7_parser == PARSER_TYPE_KAFKA:
                for sel in endpoints:
                    rule = PortRuleKafka()
                    rule.sanitize()
                    f.l7_rules_per_ep[sel] = L7Rules(kafka=[rule])
            else:
                for sel in endpoints:
                    f.l7_rules_per_ep[sel] = L7Rules(
                        l7proto=f.l7_parser, l7=[]
                    )
            f.endpoints = f.endpoints + list(endpoints)
            f.derived_from_rules.append(rule_labels)
            l4_policy[k] = f

    def _wildcard_l3l4_rules(
        self,
        ctx: SearchContext,
        ingress: bool,
        l4_policy: L4PolicyMap,
        rules=None,
    ) -> None:
        """repository.go:170."""
        index = self._l7_filter_index(l4_policy)
        for r in self.rules if rules is None else rules:
            if ingress:
                if not r.endpoint_selector.matches(ctx.to_labels):
                    continue
                for rule in r.rule.ingress:
                    if not rule.is_label_based():
                        continue
                    from_endpoints = rule.get_source_endpoint_selectors()
                    rule_labels = LabelArray(r.rule.labels)
                    if len(rule.to_ports) == 0:
                        self._wildcard_l3l4_rule(
                            PROTO_TCP, 0, from_endpoints, rule_labels,
                            l4_policy, index,
                        )
                        self._wildcard_l3l4_rule(
                            PROTO_UDP, 0, from_endpoints, rule_labels,
                            l4_policy, index,
                        )
                    else:
                        for to_port in rule.to_ports:
                            if (
                                to_port.rules is None
                                or to_port.rules.is_empty()
                            ):
                                for p in to_port.ports:
                                    self._wildcard_l3l4_rule(
                                        p.protocol,
                                        p.numeric_port(),
                                        from_endpoints,
                                        rule_labels,
                                        l4_policy,
                                        index,
                                    )
            else:
                if not r.endpoint_selector.matches(ctx.from_labels):
                    continue
                for rule in r.rule.egress:
                    if not rule.is_label_based():
                        continue
                    to_endpoints = rule.get_destination_endpoint_selectors()
                    rule_labels = LabelArray(r.rule.labels)
                    if len(rule.to_ports) == 0:
                        self._wildcard_l3l4_rule(
                            PROTO_TCP, 0, to_endpoints, rule_labels,
                            l4_policy, index,
                        )
                        self._wildcard_l3l4_rule(
                            PROTO_UDP, 0, to_endpoints, rule_labels,
                            l4_policy, index,
                        )
                    else:
                        for to_port in rule.to_ports:
                            if (
                                to_port.rules is None
                                or to_port.rules.is_empty()
                            ):
                                for p in to_port.ports:
                                    self._wildcard_l3l4_rule(
                                        p.protocol,
                                        p.numeric_port(),
                                        to_endpoints,
                                        rule_labels,
                                        l4_policy,
                                        index,
                                    )

    # -- CIDR ----------------------------------------------------------------

    def resolve_cidr_policy(
        self, ctx: SearchContext, rules=None
    ) -> CIDRPolicy:
        """ResolveCIDRPolicy (repository.go:340)."""
        result = CIDRPolicy()
        ctx.policy_trace("Resolving L3 (CIDR) policy for %+s\n", ctx.to_labels)
        state = TraceState()
        for r in self.rules if rules is None else rules:
            r.resolve_cidr_policy(ctx, state, result)
            state.rule_id += 1
        self._trace(state, ctx)
        return result

    # -- full-context verdicts (repository.go:355-442) -----------------------

    def _allows_l4_egress(self, ctx: SearchContext) -> Decision:
        """repository.go:355: a resolve error degrades to Undecided (the
        caller turns that into Denied) rather than propagating."""
        verdict = Decision.UNDECIDED
        try:
            egress_policy = self.resolve_l4_egress_policy(ctx)
        except L4MergeError as e:
            log.warning("Evaluation error while resolving L4 egress policy: %s", e)
            egress_policy = None
        if egress_policy is not None and len(egress_policy) > 0:
            verdict = egress_policy.egress_covers_context(ctx)
        if len(ctx.dports) == 0:
            ctx.policy_trace("L4 egress verdict: [no port context specified]")
        else:
            ctx.policy_trace("L4 egress verdict: %s", str(verdict))
        return verdict

    def _allows_l4_ingress(self, ctx: SearchContext) -> Decision:
        """repository.go:374: resolve errors degrade to Undecided."""
        verdict = Decision.UNDECIDED
        try:
            ingress_policy = self.resolve_l4_ingress_policy(ctx)
        except L4MergeError as e:
            log.warning("Evaluation error while resolving L4 ingress policy: %s", e)
            ingress_policy = None
        if ingress_policy is not None and len(ingress_policy) > 0:
            verdict = ingress_policy.ingress_covers_context(ctx)
        if len(ctx.dports) == 0:
            ctx.policy_trace("L4 ingress verdict: [no port context specified]")
        else:
            ctx.policy_trace("L4 ingress verdict: %s", str(verdict))
        return verdict

    def allows_ingress(self, ctx: SearchContext) -> Decision:
        """AllowsIngressRLocked (repository.go:397): label verdict, else L4
        if ports present; default deny."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self.can_reach_ingress(ctx)
        ctx.policy_trace("Label verdict: %s", str(decision))
        if decision == Decision.ALLOWED:
            ctx.policy_trace("L4 ingress policies skipped")
            return decision
        if len(ctx.dports) != 0:
            decision = self._allows_l4_ingress(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    def allows_egress(self, ctx: SearchContext) -> Decision:
        """AllowsEgressRLocked (repository.go:422)."""
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self.can_reach_egress(ctx)
        ctx.policy_trace("Egress label verdict: %s", str(decision))
        if decision == Decision.ALLOWED:
            ctx.policy_trace("L4 egress policies skipped")
            return decision
        if len(ctx.dports) != 0:
            decision = self._allows_l4_egress(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    # -- mutation (repository.go:525-685) ------------------------------------

    def add(self, rule: Rule) -> int:
        """repository.go:529: sanitize + insert."""
        with self.lock:
            rule.sanitize()
            return self.add_list([rule])

    def add_list(self, rules: List[Rule]) -> int:
        """repository.go:544 (rules must already be sanitized)."""
        with self.lock:
            self.rules.extend(PolicyRule(r) for r in rules)
            self.revision += 1
            return self.revision

    def delete_by_labels(self, labels: LabelArray) -> Tuple[int, int]:
        """repository.go:566."""
        with self.lock:
            deleted = 0
            kept: List[PolicyRule] = []
            for r in self.rules:
                if not r.labels.contains(labels):
                    kept.append(r)
                else:
                    deleted += 1
            if deleted > 0:
                self.revision += 1
                self.rules = kept
            return self.revision, deleted

    def search(self, labels: LabelArray) -> List[Rule]:
        """repository.go:495."""
        return [r.rule for r in self.rules if r.labels.contains(labels)]

    def contains_all(self, needed: List[LabelArray]) -> bool:
        """repository.go:510."""
        for needed_label in needed:
            if not any(
                len(r.labels) > 0 and needed_label.contains(r.labels)
                for r in self.rules
            ):
                return False
        return True

    def get_rules_matching(
        self, labels: LabelArray, rules=None
    ) -> Tuple[bool, bool]:
        """repository.go:624: (ingress_match, egress_match).  `rules`
        restricts the walk to a pre-matched sublist (the RuleIndex
        invariant: every rule in it selects `labels`), and the
        per-rule selector check is SKIPPED in that case — callers must
        not pass a superset."""
        ingress_match = False
        egress_match = False
        for r in self.rules if rules is None else rules:
            if rules is not None or r.endpoint_selector.matches(labels):
                if len(r.rule.ingress) > 0:
                    ingress_match = True
                if len(r.rule.egress) > 0:
                    egress_match = True
            if ingress_match and egress_match:
                break
        return ingress_match, egress_match

    def num_rules(self) -> int:
        return len(self.rules)

    def get_revision(self) -> int:
        return self.revision

    def empty(self) -> bool:
        return len(self.rules) == 0

    def bump_revision(self) -> None:
        with self.lock:
            self.revision += 1

    def translate_rules(self, translator) -> None:
        """repository.go:667: apply a rule translator (used by the k8s
        service-to-CIDR rewriter, pkg/k8s/rule_translate.go)."""
        with self.lock:
            for r in self.rules:
                translator.translate(r.rule)
