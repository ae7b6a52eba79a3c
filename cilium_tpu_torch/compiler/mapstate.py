"""Desired policy-map-state computation (the compiler frontend).

The port's copy of the JAX package's compiler/mapstate.py, so far only
`resolve_l4_policy` (pkg/endpoint/policy.go:222 resolveL4Policy), which
feeds the proxy's redirects.  The map-state computation itself
(`compute_desired_policy_map_state` and the per-filter key expansion)
comes with the selector cache and the endpoint.
"""

from __future__ import annotations

from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.policy.l4 import L4Policy, L4PolicyMap
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.search import SearchContext


def resolve_l4_policy(
    repo: Repository,
    ep_labels: LabelArray,
    ingress_enabled: bool = True,
    egress_enabled: bool = True,
    rules=None,
) -> L4Policy:
    """policy.go:222 resolveL4Policy.  `rules` restricts the walk to
    the endpoint's relevant sublist (RuleIndex invariant)."""
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
