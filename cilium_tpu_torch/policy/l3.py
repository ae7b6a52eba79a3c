"""CIDR (L3) policy maps.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/l3.go: per-direction CIDR allow
maps with per-prefix-length refcounts.  The prefix-length sets drive the
LPM table compiler (cilium_tpu_torch.compiler.lpm): like the reference's
unrolled LPM fallback (bpf/lib/eps.h:86-108), the LPM kernel probes
a fixed, longest-to-shortest list of prefix lengths, so the list is part
of the compiled artifact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.policy.api.rule import (
    MAX_CIDR_PREFIX_LENGTHS,
    PolicyValidationError,
)
from cilium_tpu_torch.utils import cidr as cidr_util

# Cluster ranges used for the default prefix lengths (l3.go:53; the
# reference reads them from node config — these are its defaults).
DEFAULT_IPV4_CLUSTER_PREFIX = 8
DEFAULT_IPV6_CLUSTER_PREFIX = 64


def get_default_prefix_lengths() -> Tuple[List[int], List[int]]:
    """l3.go:53: (v6, v4) lengths for host/cluster/world, longest first."""
    s6 = [128, DEFAULT_IPV6_CLUSTER_PREFIX, 0]
    s4 = [32, DEFAULT_IPV4_CLUSTER_PREFIX, 0]
    return s6, s4


@dataclass
class CIDRPolicyMapRule:
    """l3.go:30."""

    prefix: object  # ipaddress network
    derived_from_rules: List[LabelArray] = field(default_factory=list)


class CIDRPolicyMap:
    """l3.go:41: allowed prefixes + per-prefix-length counts."""

    def __init__(self):
        self.map: Dict[str, CIDRPolicyMapRule] = {}
        self.ipv6_prefix_count: Dict[int, int] = {}
        self.ipv4_prefix_count: Dict[int, int] = {}

    def insert(self, cidr: str, rule_labels: LabelArray) -> int:
        """l3.go:66: parse (with Go classful-default-mask quirks), key by
        masked address, count new prefix lengths."""
        try:
            ipnet = cidr_util.parse_cidr_or_ip_classful(cidr)
        except ValueError:
            return 0
        ones = ipnet.prefixlen
        key = f"{ipnet.network_address}/{ones}"
        if key not in self.map:
            self.map[key] = CIDRPolicyMapRule(
                prefix=ipnet, derived_from_rules=[rule_labels]
            )
            if ipnet.version == 6:
                self.ipv6_prefix_count[ones] = (
                    self.ipv6_prefix_count.get(ones, 0) + 1
                )
            else:
                self.ipv4_prefix_count[ones] = (
                    self.ipv4_prefix_count.get(ones, 0) + 1
                )
            return 1
        self.map[key].derived_from_rules.append(rule_labels)
        return 0


class CIDRPolicy:
    """l3.go:111: ingress+egress CIDR maps with default prefix lengths
    pre-seeded (l3.go:117-142)."""

    def __init__(self):
        self.ingress = CIDRPolicyMap()
        self.egress = CIDRPolicyMap()
        s6, s4 = get_default_prefix_lengths()
        for i in s6:
            self.ingress.ipv6_prefix_count.setdefault(i, 0)
            self.egress.ipv6_prefix_count.setdefault(i, 0)
        for i in s4:
            self.ingress.ipv4_prefix_count.setdefault(i, 0)
            self.egress.ipv4_prefix_count.setdefault(i, 0)

    def to_bpf_data(self) -> Tuple[List[int], List[int]]:
        """l3.go:152: distinct prefix lengths, longest-to-shortest.

        This is the probe schedule of the LPM kernel.
        """
        s6, s4 = set(), set()
        for m in (self.ingress, self.egress):
            s6.update(m.ipv6_prefix_count)
            s4.update(m.ipv4_prefix_count)
        return sorted(s6, reverse=True), sorted(s4, reverse=True)

    def validate(self) -> None:
        """l3.go:206."""
        if len(self.ingress.ipv6_prefix_count) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyValidationError(
                f"too many ingress CIDR prefix lengths "
                f"{len(self.ingress.ipv6_prefix_count)}/{MAX_CIDR_PREFIX_LENGTHS}"
            )
