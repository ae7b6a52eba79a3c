"""JSON (de)serialization of the rule tree.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Accepts the CiliumNetworkPolicy-style JSON used in the reference's
``examples/policies`` and ``cilium policy import`` (daemon/policy.go:329).
"""

from __future__ import annotations

import json
from typing import List, Union

from cilium_tpu_torch.labels import Label, LabelArray, parse_label


def _label_from_json(v) -> Label:
    """Reference Label.UnmarshalJSON (labels.go:356): accepts the full
    {source,key,value} object form or the "[SOURCE:]KEY[=VALUE]" string
    short form."""
    if isinstance(v, str):
        return parse_label(v)
    return Label(
        key=v.get("key", ""),
        value=v.get("value", ""),
        source=v.get("source", ""),
    )
from cilium_tpu_torch.policy.api.rule import (
    CIDRRule,
    EgressRule,
    FQDNSelector,
    IngressRule,
    K8sServiceNamespace,
    L7Rules,
    PortProtocol,
    PortRule,
    PortRuleHTTP,
    PortRuleKafka,
    PortRuleL7,
    Rule,
    Service,
)
from cilium_tpu_torch.policy.api.selector import EndpointSelector


def _port_rule_http_from_dict(d: dict) -> PortRuleHTTP:
    return PortRuleHTTP(
        path=d.get("path", ""),
        method=d.get("method", ""),
        host=d.get("host", ""),
        headers=list(d.get("headers") or []),
    )


def _port_rule_kafka_from_dict(d: dict) -> PortRuleKafka:
    return PortRuleKafka(
        role=d.get("role", ""),
        api_key=d.get("apiKey", ""),
        api_version=d.get("apiVersion", ""),
        client_id=d.get("clientID", ""),
        topic=d.get("topic", ""),
    )


def _l7rules_from_dict(d: dict) -> L7Rules:
    return L7Rules(
        http=(
            [_port_rule_http_from_dict(h) for h in d["http"]]
            if d.get("http") is not None
            else None
        ),
        kafka=(
            [_port_rule_kafka_from_dict(k) for k in d["kafka"]]
            if d.get("kafka") is not None
            else None
        ),
        l7proto=d.get("l7proto", ""),
        l7=(
            [PortRuleL7(e) for e in d["l7"]]
            if d.get("l7") is not None
            else None
        ),
    )


def _port_rule_from_dict(d: dict) -> PortRule:
    return PortRule(
        ports=[
            PortProtocol(port=p.get("port", ""), protocol=p.get("protocol", ""))
            for p in d.get("ports") or []
        ],
        rules=(
            _l7rules_from_dict(d["rules"]) if d.get("rules") is not None else None
        ),
    )


def _cidr_rule_from_dict(d: dict) -> CIDRRule:
    return CIDRRule(
        cidr=d.get("cidr", ""), except_cidrs=list(d.get("except") or [])
    )


def _ingress_from_dict(d: dict) -> IngressRule:
    return IngressRule(
        from_endpoints=[
            EndpointSelector.from_dict(s) for s in d.get("fromEndpoints") or []
        ],
        from_requires=[
            EndpointSelector.from_dict(s) for s in d.get("fromRequires") or []
        ],
        to_ports=[_port_rule_from_dict(p) for p in d.get("toPorts") or []],
        from_cidr=list(d.get("fromCIDR") or []),
        from_cidr_set=[
            _cidr_rule_from_dict(c) for c in d.get("fromCIDRSet") or []
        ],
        from_entities=list(d.get("fromEntities") or []),
    )


def _service_from_dict(d: dict) -> Service:
    svc = d.get("k8sService")
    return Service(
        k8s_service=(
            K8sServiceNamespace(
                service_name=svc.get("serviceName", ""),
                namespace=svc.get("namespace", ""),
            )
            if svc
            else None
        ),
        k8s_service_selector=d.get("k8sServiceSelector"),
    )


def _egress_from_dict(d: dict) -> EgressRule:
    return EgressRule(
        to_endpoints=[
            EndpointSelector.from_dict(s) for s in d.get("toEndpoints") or []
        ],
        to_requires=[
            EndpointSelector.from_dict(s) for s in d.get("toRequires") or []
        ],
        to_ports=[_port_rule_from_dict(p) for p in d.get("toPorts") or []],
        to_cidr=list(d.get("toCIDR") or []),
        to_cidr_set=[_cidr_rule_from_dict(c) for c in d.get("toCIDRSet") or []],
        to_entities=list(d.get("toEntities") or []),
        to_services=[_service_from_dict(s) for s in d.get("toServices") or []],
        to_fqdns=[
            FQDNSelector(match_name=f.get("matchName", ""))
            for f in d.get("toFQDNs") or []
        ],
    )


def rule_from_dict(d: dict) -> Rule:
    return Rule(
        endpoint_selector=(
            EndpointSelector.from_dict(d["endpointSelector"])
            if "endpointSelector" in d
            else None
        ),
        ingress=[_ingress_from_dict(i) for i in d.get("ingress") or []],
        egress=[_egress_from_dict(e) for e in d.get("egress") or []],
        labels=LabelArray(_label_from_json(s) for s in d.get("labels") or []),
        description=d.get("description", ""),
    )


def rules_from_json(text: str) -> List[Rule]:
    """Parse a JSON rule list (or single rule object)."""
    data = json.loads(text)
    if isinstance(data, dict):
        data = [data]
    return [rule_from_dict(d) for d in data]
