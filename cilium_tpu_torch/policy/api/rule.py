"""Policy rule schema.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/api/{rule.go,ingress.go,egress.go,
l4.go,http.go,kafka.go,l7.go,cidr.go,entity.go,fqdn.go,service.go,
rule_validation.go}.  Pure host-side model: rules are sanitized here,
then lowered to tensors by cilium_tpu_torch.compiler.
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.labels import Label, LabelArray
from cilium_tpu_torch.policy.api.selector import (
    EndpointSelector,
    RESERVED_ENDPOINT_SELECTORS,
    WILDCARD_SELECTOR,
)
from cilium_tpu_torch.utils import cidr as cidr_util


class PolicyValidationError(ValueError):
    """Raised by sanitize() on an invalid rule (reference: error returns)."""


# ---------------------------------------------------------------------------
# L4 (api/l4.go)
# ---------------------------------------------------------------------------

PROTO_TCP = "TCP"
PROTO_UDP = "UDP"
PROTO_ANY = "ANY"

MAX_PORTS = 40  # rule_validation.go:27
MAX_CIDR_PREFIX_LENGTHS = 40  # rule_validation.go:29

# pkg/u8proto numeric protocol values
U8PROTO = {"ANY": 0, "ICMP": 1, "TCP": 6, "UDP": 17, "ICMPv6": 58}


def parse_go_uint16(s: str) -> int:
    """Go strconv.ParseUint(s, 0, 16): base inferred from prefix, with
    legacy leading-zero octal ("010" == 8) which Python's int(s, 0)
    rejects."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        raise PolicyValidationError(f"invalid port syntax: {s!r}")
    try:
        if s.lower().startswith(("0x", "0b", "0o")):
            v = int(s, 0)
        elif len(s) > 1 and s.startswith("0"):
            v = int(s, 8)
        else:
            v = int(s, 10)
    except ValueError as e:
        raise PolicyValidationError(f"Unable to parse port: {e}")
    if not 0 <= v <= 0xFFFF:
        raise PolicyValidationError(f"Port out of 16-bit range: {v}")
    return v


def parse_l4_proto(proto: str) -> str:
    """api/utils.go:103: empty -> ANY; validate tcp/udp/any."""
    if proto == "":
        return PROTO_ANY
    p = proto.upper()
    if p not in (PROTO_ANY, PROTO_TCP, PROTO_UDP):
        raise PolicyValidationError(
            f"invalid protocol {proto!r}, must be {{ tcp | udp | any }}"
        )
    return p


@dataclass
class PortProtocol:
    """api/l4.go:27."""

    port: str
    protocol: str = ""

    def sanitize(self) -> None:
        """api/rule_validation.go:309."""
        if self.port == "":
            raise PolicyValidationError("Port must be specified")
        p = parse_go_uint16(self.port)
        if p == 0:
            raise PolicyValidationError("Port cannot be 0")
        self.protocol = parse_l4_proto(self.protocol)

    def numeric_port(self) -> int:
        return parse_go_uint16(self.port)


@dataclass
class PortRuleHTTP:
    """api/http.go:28: extended-regex constraints on an HTTP request."""

    path: str = ""
    method: str = ""
    host: str = ""
    headers: List[str] = field(default_factory=list)

    def sanitize(self) -> None:
        """api/http.go:66: path/method must be valid regexes."""
        for pattern in (self.path, self.method):
            if pattern:
                try:
                    re.compile(pattern)
                except re.error as e:
                    raise PolicyValidationError(
                        f"invalid regex {pattern!r}: {e}"
                    )

    def equal(self, o: "PortRuleHTTP") -> bool:
        return (
            self.path == o.path
            and self.method == o.method
            and self.host == o.host
            and self.headers == o.headers
        )

    def exists(self, rules: "L7Rules") -> bool:
        return any(self.equal(r) for r in rules.http)


# -- Kafka (api/kafka.go) ----------------------------------------------------

KAFKA_API_KEY_MAP: Dict[str, int] = {
    "produce": 0, "fetch": 1, "offsets": 2, "metadata": 3,
    "leaderandisr": 4, "stopreplica": 5, "updatemetadata": 6,
    "controlledshutdown": 7, "offsetcommit": 8, "offsetfetch": 9,
    "findcoordinator": 10, "joingroup": 11, "heartbeat": 12,
    "leavegroup": 13, "syncgroup": 14, "describegroups": 15,
    "listgroups": 16, "saslhandshake": 17, "apiversions": 18,
    "createtopics": 19, "deletetopics": 20, "deleterecords": 21,
    "initproducerid": 22, "offsetforleaderepoch": 23,
    "addpartitionstotxn": 24, "addoffsetstotxn": 25, "endtxn": 26,
    "writetxnmarkers": 27, "txnoffsetcommit": 28, "describeacls": 29,
    "createacls": 30, "deleteacls": 31, "describeconfigs": 32,
    "alterconfigs": 33,
}
KAFKA_REVERSE_API_KEY_MAP = {v: k for k, v in KAFKA_API_KEY_MAP.items()}

KAFKA_PRODUCE_KEY = 0
KAFKA_FETCH_KEY = 1
KAFKA_OFFSETS_KEY = 2
KAFKA_METADATA_KEY = 3
KAFKA_OFFSET_COMMIT_KEY = 8
KAFKA_OFFSET_FETCH_KEY = 9
KAFKA_FIND_COORDINATOR_KEY = 10
KAFKA_JOIN_GROUP_KEY = 11
KAFKA_HEARTBEAT_KEY = 12
KAFKA_LEAVE_GROUP_KEY = 13
KAFKA_SYNC_GROUP_KEY = 14
KAFKA_API_VERSIONS_KEY = 18

KAFKA_PRODUCE_ROLE = "produce"
KAFKA_CONSUME_ROLE = "consume"

KAFKA_MAX_TOPIC_LEN = 255
# api/kafka.go:244 — reference regex `^[a-zA-Z0-9\\._\\-]+$` (RE2: the
# doubled backslashes make `\\`, `.`, `_`, `\\`, `-` literal inside the
# class; net effect is [a-zA-Z0-9\._\-\\]).
KAFKA_TOPIC_VALID_CHAR = re.compile(r"^[a-zA-Z0-9\\._\-]+$")


@dataclass
class PortRuleKafka:
    """api/kafka.go:26."""

    role: str = ""
    api_key: str = ""
    api_version: str = ""
    client_id: str = ""
    topic: str = ""
    # private, filled by sanitize (kafka.go:100-107)
    api_key_int: List[int] = field(default_factory=list)
    api_version_int: Optional[int] = None

    def sanitize(self) -> None:
        """api/rule_validation.go:203."""
        if self.api_key and self.role:
            raise PolicyValidationError(
                f"Cannot set both Role:{self.role!r} and APIKey :{self.api_key!r} together"
            )
        if self.api_key:
            n = KAFKA_API_KEY_MAP.get(self.api_key.lower())
            if n is None:
                raise PolicyValidationError(
                    f"invalid Kafka APIKey :{self.api_key!r}"
                )
            self.api_key_int.append(n)
        if self.role:
            self.map_role_to_api_key()
        if self.api_version:
            try:
                n = int(self.api_version, 10)
            except ValueError:
                raise PolicyValidationError(
                    f"invalid Kafka APIVersion :{self.api_version!r}"
                )
            if not -(2 ** 15) <= n < 2 ** 15:
                raise PolicyValidationError(
                    f"invalid Kafka APIVersion :{self.api_version!r}"
                )
            self.api_version_int = n
        if self.topic:
            if len(self.topic) > KAFKA_MAX_TOPIC_LEN:
                raise PolicyValidationError(
                    f"kafka topic exceeds maximum len of {KAFKA_MAX_TOPIC_LEN}"
                )
            if not KAFKA_TOPIC_VALID_CHAR.match(self.topic):
                raise PolicyValidationError(
                    f'invalid Kafka Topic name "{self.topic}"'
                )

    def map_role_to_api_key(self) -> None:
        """api/kafka.go:274: role -> mandatory APIKey set."""
        role = self.role.lower()
        if role == KAFKA_PRODUCE_ROLE:
            self.api_key_int = [
                KAFKA_PRODUCE_KEY, KAFKA_METADATA_KEY, KAFKA_API_VERSIONS_KEY,
            ]
        elif role == KAFKA_CONSUME_ROLE:
            self.api_key_int = [
                KAFKA_FETCH_KEY, KAFKA_OFFSETS_KEY, KAFKA_METADATA_KEY,
                KAFKA_OFFSET_COMMIT_KEY, KAFKA_OFFSET_FETCH_KEY,
                KAFKA_FIND_COORDINATOR_KEY, KAFKA_JOIN_GROUP_KEY,
                KAFKA_HEARTBEAT_KEY, KAFKA_LEAVE_GROUP_KEY,
                KAFKA_SYNC_GROUP_KEY, KAFKA_API_VERSIONS_KEY,
            ]
        else:
            raise PolicyValidationError(f"Invalid Kafka Role {self.role}")

    def check_api_key_role(self, kind: int) -> bool:
        """api/kafka.go:248: empty set is a wildcard."""
        if not self.api_key_int:
            return True
        return kind in self.api_key_int

    def get_api_version(self) -> tuple:
        """api/kafka.go:265: (version, is_wildcard)."""
        if self.api_version_int is None:
            return 0, True
        return self.api_version_int, False

    def equal(self, o: "PortRuleKafka") -> bool:
        return (
            self.api_version == o.api_version and self.api_key == o.api_key
            and self.topic == o.topic and self.client_id == o.client_id
            and self.role == o.role
        )

    def exists(self, rules: "L7Rules") -> bool:
        return any(self.equal(r) for r in rules.kafka)


class PortRuleL7(dict):
    """api/l7.go: key-value pair rule for generic parsers."""

    def sanitize(self) -> None:
        for k in self:
            if k == "":
                raise PolicyValidationError("Empty key not allowed")

    def equal(self, o: "PortRuleL7") -> bool:
        return dict(self) == dict(o)

    def exists(self, rules: "L7Rules") -> bool:
        return any(self.equal(r) for r in rules.l7)


@dataclass
class L7Rules:
    """api/l4.go:65: union of L7 rule types; exactly one kind may be set.

    Mirrors the Go nil-vs-empty distinction: ``http``/``kafka``/``l7``
    are None when absent, possibly-empty lists when present (IsEmpty,
    api/l4.go:97 is nil-based).
    """

    http: Optional[List[PortRuleHTTP]] = None
    kafka: Optional[List[PortRuleKafka]] = None
    l7proto: str = ""
    l7: Optional[List[PortRuleL7]] = None

    def __len__(self) -> int:
        """api/l4.go:89 Len()."""
        return (
            len(self.http or ()) + len(self.kafka or ()) + len(self.l7 or ())
        )

    def is_empty(self) -> bool:
        """api/l4.go:97: nil receiver or all-kinds-nil."""
        return self.http is None and self.kafka is None and self.l7 is None

    def copy(self) -> "L7Rules":
        """Struct-copy semantics: new list containers, shared (immutable)
        rule entries — the analog of Go's by-value map storage
        (l4.go:143), so merge appends never reach the originating
        api.Rule."""
        return L7Rules(
            http=list(self.http) if self.http is not None else None,
            kafka=list(self.kafka) if self.kafka is not None else None,
            l7proto=self.l7proto,
            l7=list(self.l7) if self.l7 is not None else None,
        )

    def sanitize(self) -> None:
        """api/rule_validation.go:248."""
        n_types = 0
        if self.http is not None:
            n_types += 1
            for h in self.http:
                h.sanitize()
        if self.kafka is not None:
            n_types += 1
            for k in self.kafka:
                k.sanitize()
        if self.l7 is not None and self.l7proto == "":
            raise PolicyValidationError(
                "'l7' may only be specified when a 'l7proto' is also specified"
            )
        if self.l7proto != "":
            n_types += 1
            for r in self.l7 or []:
                r.sanitize()
        if n_types > 1:
            raise PolicyValidationError(
                "multiple L7 protocol rule types specified in single rule"
            )


def l7rules_is_empty(rules: Optional[L7Rules]) -> bool:
    return rules is None or rules.is_empty()


def l7rules_len(rules: Optional[L7Rules]) -> int:
    return 0 if rules is None else len(rules)


@dataclass
class PortRule:
    """api/l4.go:44."""

    ports: List[PortProtocol] = field(default_factory=list)
    rules: Optional[L7Rules] = None

    def sanitize(self) -> None:
        """api/rule_validation.go:287."""
        if len(self.ports) > MAX_PORTS:
            raise PolicyValidationError(
                f"too many ports, the max is {MAX_PORTS}"
            )
        for pp in self.ports:
            pp.sanitize()
            if not l7rules_is_empty(self.rules) and pp.protocol != PROTO_TCP:
                raise PolicyValidationError(
                    f"L7 rules can only apply exclusively to TCP, not {pp.protocol}"
                )
        if not l7rules_is_empty(self.rules):
            self.rules.sanitize()


# ---------------------------------------------------------------------------
# CIDR (api/cidr.go)
# ---------------------------------------------------------------------------

CIDR_MATCH_ALL = ("0.0.0.0/0", "::/0")


def cidr_matches_all(cidr: str) -> bool:
    return cidr in CIDR_MATCH_ALL


@dataclass
class CIDRRule:
    """api/cidr.go:44: a prefix with carve-out exceptions."""

    cidr: str
    except_cidrs: List[str] = field(default_factory=list)
    generated: bool = False

    def sanitize(self) -> int:
        """api/rule_validation.go:361; returns the prefix length."""
        try:
            net = ipaddress.ip_network(self.cidr, strict=False)
        except ValueError as e:
            raise PolicyValidationError(
                f"Unable to parse CIDRRule {self.cidr!r}: {e}"
            )
        for p in self.except_cidrs:
            try:
                except_net = ipaddress.ip_network(p, strict=False)
            except ValueError as e:
                raise PolicyValidationError(str(e))
            if except_net.version != net.version or not (
                int(net.network_address)
                <= int(except_net.network_address)
                <= int(net.broadcast_address)
            ):
                raise PolicyValidationError(
                    f"allow CIDR prefix {self.cidr} does not contain "
                    f"exclude CIDR prefix {p}"
                )
        return net.prefixlen


def sanitize_cidr(cidr: str) -> int:
    """api/rule_validation.go:333: plain CIDR or bare IP; returns prefix
    length (0 for a bare IP, matching the reference's quirk)."""
    if cidr == "":
        raise PolicyValidationError("IP must be specified")
    if "/" in cidr:
        try:
            net = ipaddress.ip_network(cidr, strict=False)
        except ValueError as e:
            raise PolicyValidationError(f"Unable to parse CIDR: {e}")
        return net.prefixlen
    try:
        ipaddress.ip_address(cidr)
    except ValueError as e:
        raise PolicyValidationError(f"Unable to parse CIDR: {e}")
    return 0


def compute_resultant_cidr_set(cidr_rules: Sequence[CIDRRule]) -> List[str]:
    """api/cidr.go:115: expand each CIDRRule minus its exceptions."""
    out: List[str] = []
    for r in cidr_rules:
        allow = cidr_util.parse_cidr(r.cidr)
        remove = [cidr_util.parse_cidr(t) for t in r.except_cidrs]
        for net in cidr_util.remove_cidrs([allow], remove):
            out.append(str(net))
    return out


def cidr_slice_as_selectors(cidrs: Sequence[str]) -> List[EndpointSelector]:
    """api/cidr.go:70: CIDRs -> selectors over cidr: labels, with the
    match-all CIDR adding reserved:world once."""
    out: List[EndpointSelector] = []
    world_added = False
    for c in cidrs:
        if cidr_matches_all(c) and not world_added:
            world_added = True
            out.append(RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_WORLD])
        label = lbl.ip_string_to_label(c)
        if label is not None:
            out.append(EndpointSelector.from_labels(label))
    return out


def cidr_rule_slice_as_selectors(
    rules: Sequence[CIDRRule],
) -> List[EndpointSelector]:
    """api/cidr.go:104."""
    return cidr_slice_as_selectors(compute_resultant_cidr_set(rules))


# ---------------------------------------------------------------------------
# Entities (api/entity.go)
# ---------------------------------------------------------------------------

ENTITY_ALL = "all"
ENTITY_WORLD = "world"
ENTITY_CLUSTER = "cluster"
ENTITY_HOST = "host"
ENTITY_INIT = "init"

ENTITY_SELECTOR_MAPPING: Dict[str, EndpointSelector] = {
    ENTITY_ALL: WILDCARD_SELECTOR,
    ENTITY_WORLD: EndpointSelector.from_labels(
        Label(key=lbl.ID_NAME_WORLD, value="", source=lbl.SOURCE_RESERVED)
    ),
    ENTITY_CLUSTER: EndpointSelector.from_labels(
        Label(key=lbl.ID_NAME_CLUSTER, value="", source=lbl.SOURCE_RESERVED)
    ),
    ENTITY_HOST: EndpointSelector.from_labels(
        Label(key=lbl.ID_NAME_HOST, value="", source=lbl.SOURCE_RESERVED)
    ),
    ENTITY_INIT: EndpointSelector.from_labels(
        Label(key=lbl.ID_NAME_INIT, value="", source=lbl.SOURCE_RESERVED)
    ),
}


def entities_as_selectors(entities: Sequence[str]) -> List[EndpointSelector]:
    """api/entity.go:96."""
    return [
        ENTITY_SELECTOR_MAPPING[e]
        for e in entities
        if e in ENTITY_SELECTOR_MAPPING
    ]


# ---------------------------------------------------------------------------
# FQDN / Service (api/fqdn.go, api/service.go)
# ---------------------------------------------------------------------------


@dataclass
class FQDNSelector:
    """api/fqdn.go: DNS name whose resolved IPs become ToCIDRSet rules."""

    match_name: str = ""

    def sanitize(self) -> None:
        if self.match_name == "":
            raise PolicyValidationError("FQDN matchName cannot be empty")


@dataclass
class K8sServiceNamespace:
    service_name: str = ""
    namespace: str = ""


@dataclass
class Service:
    """api/service.go: k8s service reference for ToServices."""

    k8s_service: Optional[K8sServiceNamespace] = None
    k8s_service_selector: Optional[dict] = None


# ---------------------------------------------------------------------------
# Ingress / Egress / Rule
# ---------------------------------------------------------------------------


@dataclass
class IngressRule:
    """api/ingress.go:35."""

    from_endpoints: List[EndpointSelector] = field(default_factory=list)
    from_requires: List[EndpointSelector] = field(default_factory=list)
    to_ports: List[PortRule] = field(default_factory=list)
    from_cidr: List[str] = field(default_factory=list)
    from_cidr_set: List[CIDRRule] = field(default_factory=list)
    from_entities: List[str] = field(default_factory=list)

    def get_source_endpoint_selectors(self) -> List[EndpointSelector]:
        """api/ingress.go:111."""
        res = list(self.from_endpoints)
        res.extend(entities_as_selectors(self.from_entities))
        res.extend(cidr_slice_as_selectors(self.from_cidr))
        res.extend(cidr_rule_slice_as_selectors(self.from_cidr_set))
        return res

    def is_label_based(self) -> bool:
        """api/ingress.go:120."""
        return (
            len(self.from_requires)
            + len(self.from_cidr)
            + len(self.from_cidr_set)
        ) == 0

    def sanitize(self) -> None:
        """api/rule_validation.go:67."""
        l3_members = {
            "FromEndpoints": len(self.from_endpoints),
            "FromCIDR": len(self.from_cidr),
            "FromCIDRSet": len(self.from_cidr_set),
            "FromEntities": len(self.from_entities),
        }
        l3_l4_support = {
            "FromEndpoints": True,
            "FromCIDR": False,
            "FromCIDRSet": False,
            "FromEntities": True,
        }
        names = list(l3_members)
        for m1 in names:
            for m2 in names:
                if m2 != m1 and l3_members[m1] > 0 and l3_members[m2] > 0:
                    raise PolicyValidationError(
                        f"Combining {m1} and {m2} is not supported yet"
                    )
        for member in names:
            if (
                l3_members[member] > 0
                and len(self.to_ports) > 0
                and not l3_l4_support[member]
            ):
                raise PolicyValidationError(
                    f"Combining {member} and ToPorts is not supported yet"
                )
        for pr in self.to_ports:
            pr.sanitize()
        prefix_lengths = set()
        for c in self.from_cidr:
            prefix_lengths.add(sanitize_cidr(c))
        for cr in self.from_cidr_set:
            prefix_lengths.add(cr.sanitize())
        for e in self.from_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyValidationError(f"unsupported entity: {e}")
        if len(prefix_lengths) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyValidationError(
                f"too many ingress CIDR prefix lengths "
                f"{len(prefix_lengths)}/{MAX_CIDR_PREFIX_LENGTHS}"
            )

    def deep_copy(self) -> "IngressRule":
        return IngressRule(
            from_endpoints=[
                s.add_requirements([]) for s in self.from_endpoints
            ],
            from_requires=[s.add_requirements([]) for s in self.from_requires],
            to_ports=list(self.to_ports),
            from_cidr=list(self.from_cidr),
            from_cidr_set=list(self.from_cidr_set),
            from_entities=list(self.from_entities),
        )


@dataclass
class EgressRule:
    """api/egress.go:28."""

    to_endpoints: List[EndpointSelector] = field(default_factory=list)
    to_requires: List[EndpointSelector] = field(default_factory=list)
    to_ports: List[PortRule] = field(default_factory=list)
    to_cidr: List[str] = field(default_factory=list)
    to_cidr_set: List[CIDRRule] = field(default_factory=list)
    to_entities: List[str] = field(default_factory=list)
    to_services: List[Service] = field(default_factory=list)
    to_fqdns: List[FQDNSelector] = field(default_factory=list)

    def get_destination_endpoint_selectors(self) -> List[EndpointSelector]:
        """api/egress.go:139."""
        res = list(self.to_endpoints)
        res.extend(entities_as_selectors(self.to_entities))
        res.extend(cidr_slice_as_selectors(self.to_cidr))
        res.extend(cidr_rule_slice_as_selectors(self.to_cidr_set))
        return res

    def is_label_based(self) -> bool:
        """api/egress.go:148."""
        return (
            len(self.to_requires)
            + len(self.to_cidr)
            + len(self.to_cidr_set)
            + len(self.to_services)
        ) == 0

    def sanitize(self) -> None:
        """api/rule_validation.go:132."""
        l3_members = {
            "ToCIDR": len(self.to_cidr),
            "ToCIDRSet": len(self.to_cidr_set),
            "ToEndpoints": len(self.to_endpoints),
            "ToEntities": len(self.to_entities),
            "ToServices": len(self.to_services),
            "ToFQDNs": len(self.to_fqdns),
        }
        names = list(l3_members)
        for m1 in names:
            for m2 in names:
                if m2 != m1 and l3_members[m1] > 0 and l3_members[m2] > 0:
                    raise PolicyValidationError(
                        f"Combining {m1} and {m2} is not supported yet"
                    )
        # All egress L3 members support ToPorts (rule_validation.go:141).
        for pr in self.to_ports:
            pr.sanitize()
        prefix_lengths = set()
        for c in self.to_cidr:
            prefix_lengths.add(sanitize_cidr(c))
        for cr in self.to_cidr_set:
            prefix_lengths.add(cr.sanitize())
        for e in self.to_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyValidationError(f"unsupported entity: {e}")
        for f in self.to_fqdns:
            f.sanitize()
        if len(prefix_lengths) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyValidationError(
                f"too many egress CIDR prefix lengths "
                f"{len(prefix_lengths)}/{MAX_CIDR_PREFIX_LENGTHS}"
            )

    def deep_copy(self) -> "EgressRule":
        return EgressRule(
            to_endpoints=[s.add_requirements([]) for s in self.to_endpoints],
            to_requires=[s.add_requirements([]) for s in self.to_requires],
            to_ports=list(self.to_ports),
            to_cidr=list(self.to_cidr),
            to_cidr_set=list(self.to_cidr_set),
            to_entities=list(self.to_entities),
            to_services=list(self.to_services),
            to_fqdns=list(self.to_fqdns),
        )


@dataclass
class Rule:
    """api/rule.go:32: selector + ingress[] + egress[] + labels."""

    endpoint_selector: Optional[EndpointSelector] = None
    ingress: List[IngressRule] = field(default_factory=list)
    egress: List[EgressRule] = field(default_factory=list)
    labels: LabelArray = field(default_factory=LabelArray)
    description: str = ""

    def sanitize(self) -> None:
        """api/rule_validation.go:37."""
        for label in self.labels:
            if label.source == lbl.SOURCE_CILIUM_GENERATED:
                raise PolicyValidationError(
                    "rule labels cannot have cilium-generated source"
                )
        if self.endpoint_selector is None:
            raise PolicyValidationError("rule cannot have nil EndpointSelector")
        for i in self.ingress:
            i.sanitize()
        for e in self.egress:
            e.sanitize()
