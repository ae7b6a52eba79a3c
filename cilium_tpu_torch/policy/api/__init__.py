"""Policy rule schema (the analog of pkg/policy/api)."""

from cilium_tpu_torch.policy.api.selector import (  # noqa: F401
    EndpointSelector,
    RESERVED_ENDPOINT_SELECTORS,
    Requirement,
    WILDCARD_SELECTOR,
    selects_all_endpoints,
)
from cilium_tpu_torch.policy.api.rule import (  # noqa: F401
    CIDRRule,
    EgressRule,
    FQDNSelector,
    IngressRule,
    L7Rules,
    PROTO_ANY,
    PROTO_TCP,
    PROTO_UDP,
    PolicyValidationError,
    PortProtocol,
    PortRule,
    PortRuleHTTP,
    PortRuleKafka,
    PortRuleL7,
    Rule,
    Service,
    compute_resultant_cidr_set,
)
from cilium_tpu_torch.policy.api.parse import rule_from_dict, rules_from_json  # noqa: F401
