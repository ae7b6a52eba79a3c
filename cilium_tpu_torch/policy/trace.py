"""Policy trace / explain mode.

The port's own copy of the JAX package's policy/trace.py, without
`trace_tuple` (and its host LPM helpers): that stage-accurate explain
reads the daemon's prefilter, services and conntrack, which the port's
policy-plane daemon does not hold yet.

The reference exposes decision tracing at two levels:
  - rule-level: `cilium policy trace` / GET /policy/resolve
    (daemon/policy.go:66) runs the repository verdict with
    SearchContext.Trace enabled and returns the decision plus the
    human-readable trace buffer (pkg/policy/policy.go:39-61);
  - datapath-level: per-tuple attribution — which policy-map entry
    (exact / L3-only / wildcard probe) produced the verdict
    (the per-entry counters of bpf/lib/policy.h:66 made queryable).
"""

from __future__ import annotations

import io
import ipaddress
from typing import Tuple

from cilium_tpu_torch.engine.oracle import (
    MATCH_FRAG_DROP,
    MATCH_L3,
    MATCH_L4,
    MATCH_L4_WILD,
    policy_can_access,
)
from cilium_tpu_torch.maps.policymap import PolicyMapState
from cilium_tpu_torch.policy.search import SearchContext, Tracing


def trace_policy(repo, ctx: SearchContext, verbose: bool = False):
    """GET /policy/resolve (daemon/policy.go:66): ingress verdict with
    a populated trace buffer.  Returns (Decision, trace_text)."""
    ctx.trace = Tracing.VERBOSE if verbose else Tracing.ENABLED
    if ctx.logging is None:
        ctx.logging = io.StringIO()
    verdict = repo.allows_ingress(ctx)
    return verdict, ctx.trace_output()


def explain_tuple(
    state: PolicyMapState,
    identity: int,
    dport: int,
    proto: int,
    direction: int,
    is_fragment: bool = False,
) -> Tuple[bool, str]:
    """Datapath attribution for one tuple against one endpoint's map
    state: which probe of the 3-probe lattice decided, and on which
    entry."""
    verdict, why = _explain_verdict(
        state, identity, dport, proto, direction, is_fragment
    )
    action = "ALLOW" if verdict.allowed else "DENY"
    return verdict.allowed, f"{action}: {why}"


def _explain_verdict(
    state, identity, dport, proto, direction, is_fragment=False
):
    """One lattice evaluation + attribution text.  Deepcopies the
    state once (probe hits bump entry counters, policy.h:66, and an
    explain must not perturb what it reads); returns (Verdict, why)
    so trace_tuple gets match_kind/proxy_port without a second
    evaluation."""
    import copy

    verdict = policy_can_access(
        copy.deepcopy(state), identity, dport, proto, direction,
        is_fragment,
    )
    direction_name = "ingress" if direction == 0 else "egress"
    if verdict.match_kind == MATCH_L4:
        why = (
            f"L4 exact entry ({identity}, {dport}/{proto}, "
            f"{direction_name})"
            + (
                f" → proxy port {verdict.proxy_port}"
                if verdict.proxy_port
                else ""
            )
        )
    elif verdict.match_kind == MATCH_L3:
        why = f"L3-only entry ({identity}, {direction_name})"
    elif verdict.match_kind == MATCH_L4_WILD:
        why = (
            f"L4 wildcard entry (any identity, {dport}/{proto}, "
            f"{direction_name})"
            + (
                f" → proxy port {verdict.proxy_port}"
                if verdict.proxy_port
                else ""
            )
        )
    elif verdict.match_kind == MATCH_FRAG_DROP:
        why = "fragment without L3-only allow (DROP_FRAG_NOSUPPORT)"
    else:
        why = "no matching entry (DROP_POLICY)"
    return verdict, why


def _matching_rules(daemon, ep_labels, peer_labels, peer_addr_u32,
                    dport, proto, direction, match_kind):
    """Repository rules consistent with the matched map entry: the
    rule must select the endpoint, and its direction clause must
    admit the peer (from_endpoints/to_endpoints selector over the
    peer identity's labels, or a CIDR clause covering the address)
    on the matched port (exact/wildcard L4) or with no port clause
    (L3-only).  Returns [(rule index, rule labels string)]."""
    proto_name = {6: "TCP", 17: "UDP"}.get(proto, str(proto))
    out = []
    for i, repo_rule in enumerate(daemon.repo.rules):
        # repo entries are PolicyRule wrappers around the api.Rule
        rule = getattr(repo_rule, "rule", repo_rule)
        if not rule.endpoint_selector.matches(ep_labels):
            continue
        clauses = rule.ingress if direction == 0 else rule.egress
        for clause in clauses:
            sels = (
                clause.from_endpoints
                if direction == 0
                else getattr(clause, "to_endpoints", [])
            )
            peer_ok = any(
                s.matches(peer_labels) for s in sels
            ) if peer_labels is not None else False
            cidrs = [str(c) for c in getattr(
                clause, "from_cidr" if direction == 0 else "to_cidr", []
            )] + [str(c.cidr) for c in getattr(
                clause,
                "from_cidr_set" if direction == 0 else "to_cidr_set",
                [],
            )]
            for cidr in cidrs:
                net = ipaddress.ip_network(cidr, strict=False)
                if net.version == 4 and (
                    peer_addr_u32 & int(net.netmask)
                ) == int(net.network_address):
                    peer_ok = True
            ports = [
                (pp.port, (pp.protocol or "TCP").upper())
                for pr in clause.to_ports
                for pp in pr.ports
            ]
            if match_kind == MATCH_L3:
                port_ok = not ports
            elif match_kind in (MATCH_L4, MATCH_L4_WILD):
                port_ok = any(
                    p == str(dport) and pn in (proto_name, "ANY", "")
                    for p, pn in ports
                )
                # an L4 wildcard entry needs no peer selector at all
                if match_kind == MATCH_L4_WILD and port_ok and not sels:
                    peer_ok = True
            else:
                port_ok = False
            if peer_ok and port_ok:
                out.append((i, str(rule.labels)))
                break
    return out
