"""The PyTorch port's policy layer against the JAX package's, on the CPU,
with tolerance 0 (every output is a bool, an int, a string or a
structure of them):

  * labels (parse, extended keys, LabelArray has/get/contains, sorted
    lists and digests, CIDR labels) and selectors (matchLabels,
    matchExpressions, reserved selectors, requirements);
  * `rules_from_json` + `sanitize`, raising the same
    PolicyValidationError messages at the same rules;
  * `Repository`: add_list, delete_by_labels, revisions, search,
    allows_ingress/allows_egress, resolve_l4_*_policy (L4MergeError
    included), resolve_cidr_policy, and `resolve_l4_policy` with ingress
    and egress on and off, with the daemon options that widen L3
    overrides set in both packages;
  * the identity allocator and its cache.

The corpora are the rule sets of the reference's tests/test_repository.py,
test_l4_merge.py, test_selector.py, test_labels.py and
test_validation.py rebuilt as JSON, and a seeded generator of 200 mixed
rules over 64 label sets.  L4 policies are compared in a canonical
form: per filter, in order, the port, protocol, direction, parser,
selectors, L7 rules per selector and derived_from_rules.
"""

import io
import ipaddress
import json
import types

import numpy as np
import pytest

from cilium_tpu_torch import identity as t_identity
from cilium_tpu_torch import labels as t_labels
from cilium_tpu_torch import option as t_option
from cilium_tpu_torch.compiler import mapstate as t_mapstate
from cilium_tpu_torch.policy import api as t_api
from cilium_tpu_torch.policy import l4 as t_l4
from cilium_tpu_torch.policy import repository as t_repository
from cilium_tpu_torch.policy import rule_resolve as t_rule_resolve
from cilium_tpu_torch.policy import search as t_search
from cilium_tpu_torch.policy.api import selector as t_selector

try:
    from cilium_tpu import identity as j_identity
    from cilium_tpu import labels as j_labels
    from cilium_tpu import option as j_option
    from cilium_tpu.compiler import mapstate as j_mapstate
    from cilium_tpu.policy import api as j_api
    from cilium_tpu.policy import l4 as j_l4
    from cilium_tpu.policy import repository as j_repository
    from cilium_tpu.policy import rule_resolve as j_rule_resolve
    from cilium_tpu.policy import search as j_search
    from cilium_tpu.policy.api import selector as j_selector
except ImportError:  # the card's machine has no JAX package stack
    j_labels = None



@pytest.fixture(autouse=True)
def _need_reference():
    if j_labels is None:
        pytest.skip("the JAX package is not importable")

T = types.SimpleNamespace(
    labels=t_labels, api=t_api, selector=t_selector, l4=t_l4,
    repository=t_repository, rule_resolve=t_rule_resolve, search=t_search,
    option=t_option, mapstate=t_mapstate, identity=t_identity,
)
J = (types.SimpleNamespace(
    labels=j_labels, api=j_api, selector=j_selector, l4=j_l4,
    repository=j_repository, rule_resolve=j_rule_resolve, search=j_search,
    option=j_option, mapstate=j_mapstate, identity=j_identity,
) if j_labels is not None else None)


# -- canonical forms ----------------------------------------------------------


def outcome(fn):
    """fn()'s value, or the raised exception as (class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e))


def canon_label(l):
    return (l.source, l.key, l.value)


def canon_labels(arr):
    return tuple(canon_label(l) for l in arr)


def canon_sel(pkg, s):
    return (
        tuple(sorted(s.match_labels.items())),
        tuple((e.key, e.operator, tuple(e.values))
              for e in s.match_expressions),
        s is pkg.selector.WILDCARD_SELECTOR,
    )


def canon_l7(r):
    def opt(xs, f):
        return None if xs is None else tuple(f(x) for x in xs)

    return (
        opt(r.http, lambda h: (h.path, h.method, h.host, tuple(h.headers))),
        opt(r.kafka, lambda k: (k.role, k.api_key, k.api_version,
                                k.client_id, k.topic, tuple(k.api_key_int),
                                k.api_version_int)),
        r.l7proto,
        opt(r.l7, lambda d: tuple(sorted(d.items()))),
    )


def canon_filter(pkg, f):
    return (
        f.port, f.protocol, f.u8proto, f.ingress, f.l7_parser,
        tuple(canon_sel(pkg, s) for s in f.endpoints),
        tuple((canon_sel(pkg, s), canon_l7(r))
              for s, r in f.l7_rules_per_ep.items()),
        tuple(canon_labels(d) for d in f.derived_from_rules),
    )


def canon_map(pkg, m):
    return tuple((k, canon_filter(pkg, f)) for k, f in m.items())


def canon_policy(pkg, p):
    return (canon_map(pkg, p.ingress), canon_map(pkg, p.egress))


def canon_cidr(p):
    def one(m):
        return (
            tuple((k, str(r.prefix), tuple(canon_labels(d)
                                            for d in r.derived_from_rules))
                  for k, r in m.map.items()),
            tuple(sorted(m.ipv4_prefix_count.items())),
            tuple(sorted(m.ipv6_prefix_count.items())),
        )

    return (one(p.ingress), one(p.egress), p.to_bpf_data())


def load(pkg, rules_json, sanitize=True):
    rules = pkg.api.rules_from_json(json.dumps(rules_json))
    if sanitize:
        for r in rules:
            r.sanitize()
    repo = pkg.repository.Repository()
    repo.add_list(rules)
    return repo


def ctx(pkg, frm, to, ports=()):
    return pkg.search.SearchContext(
        from_labels=None if frm is None else
        pkg.labels.LabelArray.parse_select(*frm),
        to_labels=None if to is None else
        pkg.labels.LabelArray.parse_select(*to),
        dports=[pkg.search.Port(p, proto) for p, proto in ports],
    )


def verdicts(pkg, repo, label_sets, port_sets, pairs=None):
    """Every repository verdict over the (from, to, ports) grid."""
    out = []
    grid = pairs if pairs is not None else [
        (a, b) for a in label_sets for b in label_sets
    ]
    for frm, to in grid:
        for ports in port_sets:
            out.append((
                int(repo.allows_ingress(ctx(pkg, frm, to, ports))),
                int(repo.allows_egress(ctx(pkg, frm, to, ports))),
                int(repo.can_reach_ingress(ctx(pkg, frm, to, ports))),
                int(repo.can_reach_egress(ctx(pkg, frm, to, ports))),
                int(repo.allows_ingress_label_access(ctx(pkg, frm, to))),
                int(repo.allows_egress_label_access(ctx(pkg, frm, to))),
            ))
    return out


def resolutions(pkg, repo, label_sets):
    """resolve_l4_policy (each direction on and off), the directional
    resolves and resolve_cidr_policy for every label set as the
    endpoint, with errors as outcomes."""
    out = []
    for ls in label_sets:
        ep = pkg.labels.LabelArray.parse(*ls)
        for ing, eg in ((True, True), (True, False), (False, True)):
            out.append(outcome(lambda: canon_policy(
                pkg, pkg.mapstate.resolve_l4_policy(repo, ep, ing, eg))))
        sel = pkg.labels.LabelArray.parse_select(*ls)
        out.append(outcome(lambda: canon_map(
            pkg, repo.resolve_l4_ingress_policy(
                pkg.search.SearchContext(to_labels=sel)))))
        out.append(outcome(lambda: canon_map(
            pkg, repo.resolve_l4_egress_policy(
                pkg.search.SearchContext(from_labels=sel)))))
        out.append(outcome(lambda: canon_cidr(repo.resolve_cidr_policy(
            pkg.search.SearchContext(to_labels=sel)))))
    return out


# -- the reference tests' rule sets as JSON -----------------------------------


def sel(*names):
    """{"matchLabels": ...} of parse_select_label names, as `es()` in the
    reference's tests builds them ("a" -> any.a, "k8s:a=b" -> k8s.a)."""
    ml = {}
    for n in names:
        key, _, value = n.partition("=")
        ml[key] = value
    return {"matchLabels": ml}


def ports(*pp):
    return [{"port": p, "protocol": proto} for p, proto in pp]


HTTP80 = {"ports": ports(("80", "TCP")),
          "rules": {"http": [{"method": "GET", "path": "/"}]}}

REPOSITORY_CASES = {
    "can_reach_ingress_basic": [
        {"endpointSelector": sel("bar"), "labels": ["tag1"],
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
        {"endpointSelector": sel("groupA"), "labels": ["tag1"],
         "ingress": [{"fromRequires": [sel("groupA")]}]},
        {"endpointSelector": sel("bar2"), "labels": ["tag1"],
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
    ],
    "can_reach_egress_basic": [
        {"endpointSelector": sel("foo"),
         "egress": [{"toEndpoints": [sel("bar")]}]},
        {"endpointSelector": sel("groupA"),
         "egress": [{"toRequires": [sel("groupA")]}]},
    ],
    "requires_denies_even_with_later_allow": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromRequires": [sel("groupA")]}]},
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
    ],
    "l3_only_match_allows_but_toports_defers": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")],
                      "toPorts": [{"ports": ports(("80", "TCP"))}]}]},
    ],
    "l4_any_proto_expansion": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"toPorts": [{"ports": ports(("53", "ANY"))}]}]},
    ],
    "from_requires_injected_into_l4": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")],
                      "toPorts": [{"ports": ports(("80", "TCP"))}]}]},
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromRequires": [sel("groupA")]}]},
    ],
    "entities": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEntities": ["world", "host"]}]},
        {"endpointSelector": sel("bar2"),
         "ingress": [{"fromEntities": ["all"]}]},
    ],
    # test_l4_merge.py
    "merge_l7_http_wildcard_and_selector": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"toPorts": [{"ports": ports(("80", "TCP"))}]},
            {"toPorts": [HTTP80]},
            {"fromEndpoints": [sel("foo")], "toPorts": [HTTP80]},
        ]},
    ],
    "merge_l7_kafka": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"toPorts": [{"ports": ports(("9092", "TCP")),
                          "rules": {"kafka": [{"topic": "foo"}]}}]},
            {"fromEndpoints": [sel("foo")],
             "toPorts": [{"ports": ports(("9092", "TCP")),
                          "rules": {"kafka": [{"topic": "foo"}]}}]},
        ]},
    ],
    "merge_parser_conflict": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"toPorts": [{"ports": ports(("80", "TCP")),
                          "rules": {"http": [{"path": "/"}]}}]},
            {"toPorts": [{"ports": ports(("80", "TCP")),
                          "rules": {"kafka": [{"topic": "t"}]}}]},
        ]},
    ],
    "merge_generic_conflict": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"toPorts": [{"ports": ports(("11211", "TCP")),
                          "rules": {"l7proto": "binarymemcache",
                                    "l7": [{"opCode": "get"}]}}]},
            {"toPorts": [{"ports": ports(("11211", "TCP")),
                          "rules": {"l7proto": "test.lineparser",
                                    "l7": []}}]},
        ]},
    ],
    "merge_l7_dedup": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"toPorts": [HTTP80]}, {"toPorts": [HTTP80]}]},
    ],
    "wildcard_l3_injects_l7_allow_all": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("baz")],
                      "toPorts": [{"ports": ports(("80", "TCP")),
                                   "rules": {"http": [{"path": "/admin"}]}},
                                  {"ports": ports(("9092", "TCP")),
                                   "rules": {"kafka": [{"role": "produce"}]}},
                                  {"ports": ports(("11211", "TCP")),
                                   "rules": {"l7proto": "binarymemcache",
                                             "l7": [{"opCode": "set"}]}}]}]},
    ],
    "wildcard_l3l4_injects_on_matching_port": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")],
                      "toPorts": [{"ports": ports(("80", "TCP"))}]}]},
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("baz")],
                      "toPorts": [{"ports": ports(("80", "TCP")),
                                   "rules": {"http": [{"path": "/admin"}]}}]}]},
    ],
    "l3_only_rule_no_l7_filters_untouched": [
        {"endpointSelector": sel("bar"),
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
        {"endpointSelector": sel("bar"),
         "ingress": [{"toPorts": [{"ports": ports(("80", "TCP"))}]}]},
    ],
    "egress_merge": [
        {"endpointSelector": sel("foo"), "egress": [
            {"toEndpoints": [sel("bar")],
             "toPorts": [{"ports": ports(("80", "TCP"))}]},
            {"toEndpoints": [sel("baz")],
             "toPorts": [{"ports": ports(("80", "TCP"))}]},
            {"toEndpoints": [sel("baz")],
             "toPorts": [{"ports": ports(("8080", "TCP")),
                          "rules": {"http": [{"method": "PUT"}]}}]},
            {"toCIDRSet": [{"cidr": "10.0.0.0/8",
                            "except": ["10.96.0.0/12"]}],
             "toPorts": [{"ports": ports(("443", "TCP"))}]},
        ]},
    ],
    "cidr": [
        {"endpointSelector": sel("bar"), "ingress": [
            {"fromCIDR": ["10.0.0.0/8", "192.168.1.5", "10.1.2.0"]},
            {"fromCIDRSet": [{"cidr": "172.16.0.0/12",
                              "except": ["172.16.5.0/24"]}]},
        ], "egress": [{"toCIDR": ["0.0.0.0/0", "fd00::/64"]}]},
    ],
    "match_expressions_and_sources": [
        {"endpointSelector": {"matchExpressions": [
            {"key": "env", "operator": "In", "values": ["prod", "stage"]}]},
         "ingress": [{"fromEndpoints": [
             {"matchLabels": {"k8s:role": "frontend"},
              "matchExpressions": [
                  {"key": "k8s:team", "operator": "NotIn",
                   "values": ["b"]}]}],
             "toPorts": [{"ports": ports(("80", "TCP"), ("8080", ""))}]}]},
        {"endpointSelector": {"matchExpressions": [
            {"key": "env", "operator": "Exists"}]},
         "egress": [{"toEndpoints": [{"matchExpressions": [
             {"key": "tier", "operator": "DoesNotExist"}]}]}]},
    ],
}

CASE_LABELS = [
    ["foo"], ["bar"], ["bar2"], ["bar3"], ["baz"], ["foo", "groupA"],
    ["foo", "groupB"], ["bar", "groupA"], ["bar", "groupB"],
    ["reserved:world"], ["reserved:host"], ["anything"],
    ["k8s:role=frontend", "k8s:team=a"], ["k8s:role=frontend", "k8s:team=b"],
    ["k8s:env=prod", "bar"], ["k8s:env=dev", "k8s:tier=db"],
    ["cidr:10.1.2.3/32", "reserved:world"],
]
CASE_PORTS = [(), ((80, "TCP"),), ((81, "TCP"),), ((53, "UDP"),),
              ((53, "ANY"),), ((9092, "TCP"), (80, "TCP")),
              ((8080, "UDP"),)]


@pytest.mark.parametrize("name", sorted(REPOSITORY_CASES))
def test_reference_rule_sets(name):
    """Each rule set of the reference's repository and merge tests:
    every verdict over the label grid, and every resolution."""
    rules = REPOSITORY_CASES[name]
    tr, jr = load(T, rules), load(J, rules)
    assert verdicts(T, tr, CASE_LABELS, CASE_PORTS) == verdicts(
        J, jr, CASE_LABELS, CASE_PORTS)
    assert resolutions(T, tr, CASE_LABELS) == resolutions(J, jr, CASE_LABELS)


def test_merge_conflict_raises_the_same_error():
    for pkg in (T, J):
        repo = load(pkg, REPOSITORY_CASES["merge_parser_conflict"])
        with pytest.raises(pkg.rule_resolve.L4MergeError,
                           match="conflicting L7 parsers"):
            repo.resolve_l4_ingress_policy(
                ctx(pkg, None, ["bar"]))
    got = [outcome(lambda: load(p, REPOSITORY_CASES[c])
                   .resolve_l4_ingress_policy(ctx(p, None, ["bar"])))[:2]
           for p in (T, J) for c in ("merge_parser_conflict",
                                     "merge_generic_conflict")]
    assert got[:2] == got[2:] == [("raised", "L4MergeError")] * 2


def test_resolution_keeps_the_wildcard_singleton():
    """The L7 map is keyed by selector identity: the port's wildcard
    entry is its own WILDCARD_SELECTOR, as the reference's is its own."""
    for pkg in (T, J):
        repo = load(pkg, REPOSITORY_CASES["merge_l7_http_wildcard_and_selector"])
        f = repo.resolve_l4_ingress_policy(ctx(pkg, None, ["bar"]))["80/TCP"]
        assert f.endpoints == [pkg.selector.WILDCARD_SELECTOR]
        keys = list(f.l7_rules_per_ep)
        assert keys[0] is pkg.selector.WILDCARD_SELECTOR
        assert len(f.derived_from_rules) == 4


@pytest.mark.parametrize("allow_localhost,host_allows_world", [
    ("always", False), ("always", True), ("policy", True)])
def test_l3_overrides_follow_the_daemon_options(allow_localhost,
                                                host_allows_world):
    """rule_resolve reads option.Config: set in both packages, restored."""
    saved = [(p.option.Config.allow_localhost,
              p.option.Config.host_allows_world) for p in (T, J)]
    try:
        for p in (T, J):
            p.option.Config.allow_localhost = allow_localhost
            p.option.Config.host_allows_world = host_allows_world
        for name in ("merge_l7_http_wildcard_and_selector",
                     "wildcard_l3_injects_l7_allow_all", "entities"):
            rules = REPOSITORY_CASES[name]
            assert resolutions(T, load(T, rules), CASE_LABELS) == \
                resolutions(J, load(J, rules), CASE_LABELS)
    finally:
        for p, (a, h) in zip((T, J), saved):
            p.option.Config.allow_localhost = a
            p.option.Config.host_allows_world = h


def test_repository_mutation_and_revisions():
    """repository_test.go:29 and the rest of the mutation surface."""
    rules = [
        {"endpointSelector": sel("bar"), "labels": ["tag1", "tag2"]},
        {"endpointSelector": sel("bar"), "labels": ["tag1", "tag2"],
         "ingress": [{"fromEndpoints": [sel("foo")]}]},
        {"endpointSelector": sel("bar"), "labels": ["tag3", "tag4"],
         "egress": [{"toEndpoints": [sel("foo")]}]},
    ]

    def run(pkg):
        LA = pkg.labels.LabelArray
        repo = pkg.repository.Repository()
        trace = [repo.get_revision(), repo.empty()]
        parsed = pkg.api.rules_from_json(json.dumps(rules))
        trace.append(repo.add(parsed[0]))
        trace.append(repo.add_list(parsed[1:]))
        trace.append([len(repo.search(LA.parse(*t)))
                      for t in (("tag1",), ("tag3",), ("tag1", "tag3"), ())])
        trace.append(repo.contains_all([LA.parse("tag1", "tag2")]))
        trace.append(repo.contains_all([LA.parse("tag9")]))
        trace.append(repo.get_rules_matching(LA.parse_select("bar")))
        trace.append(repo.get_rules_matching(LA.parse_select("other")))
        trace.append(repo.delete_by_labels(LA.parse("tag2")))
        trace.append(repo.delete_by_labels(LA.parse("tag2")))
        repo.bump_revision()
        trace += [repo.num_rules(), repo.get_revision()]
        return trace

    assert run(T) == run(J)


def test_trace_output_is_the_same():
    rules = REPOSITORY_CASES["from_requires_injected_into_l4"]
    outs = []
    for pkg in (T, J):
        repo = load(pkg, rules)
        for verbose in (pkg.search.Tracing.ENABLED, pkg.search.Tracing.VERBOSE):
            c = ctx(pkg, ["foo", "groupA"], ["bar"], [(80, "TCP")])
            c.trace = verbose
            c.logging = io.StringIO()
            outs.append((int(repo.allows_ingress(c)), c.trace_output()))
    assert outs[:2] == outs[2:]
    assert "Found all required labels" in outs[0][1]


# -- labels and selectors -----------------------------------------------------

LABEL_STRINGS = [
    "foo", "foo=bar", "k8s:foo=bar", "container:foo", "$host", "reserved:world",
    "reserved:init", "reserved:health", "reserved:", "reserved.host", "=x",
    "any:a=b=c", "cidr:10.0.0.0/8", ":x", "", "k8s:io.kubernetes.pod=ns",
]


def test_labels_parse_and_keys():
    def run(pkg):
        L = pkg.labels
        out = []
        for s in LABEL_STRINGS:
            out.append((canon_label(L.parse_label(s)),
                        canon_label(L.parse_select_label(s)),
                        L.parse_source(s), L.get_extended_key_from(s),
                        str(L.parse_label(s)), L.parse_label(s).is_valid()))
            out.append(L.get_cilium_key_from(s))
        out.append(canon_label(L.new_label("reserved:", "host")))
        out.append(canon_label(L.new_label("k8s:x", "1", "container")))
        return out

    assert run(T) == run(J)


def test_label_arrays_and_digests():
    def run(pkg):
        L = pkg.labels
        arr = L.LabelArray.parse("k8s:app=web", "container:tier=db",
                                 "reserved:world")
        out = [arr.has(k) for k in ("any.app", "k8s.app", "container.app",
                                    "any.tier", "reserved.world", "any.x")]
        out += [arr.get(k) for k in ("any.app", "container.tier", "any.x")]
        out.append(arr.contains(L.LabelArray.parse_select("app=web")))
        out.append(arr.contains(L.LabelArray.parse_select("app=db")))
        out.append(arr.contains(L.LabelArray.parse("reserved:all")))
        out.append(canon_labels(arr.lacks(
            L.LabelArray.parse_select("app=web", "x=y"))))
        out += [arr.get_model(), arr.sorted_list(), arr.sha256sum()]
        lbls = L.Labels.from_model(["k8s:b=2", "k8s:a=1", "reserved:host"])
        out += [lbls.sorted_list(), lbls.sha256sum(),
                canon_labels(lbls.to_label_array()),
                sorted(lbls.find_reserved() or {}),
                lbls.equals(L.Labels.from_sorted_list(
                    lbls.sorted_list().decode()))]
        out.append(sorted((k, canon_label(v)) for k, v in L.labels_from_json(
            [{"key": "a", "value": "1"}, {"key": "b", "source": "k8s"}]
        ).items()))
        for c in ("10.0.0.0/8", "192.168.1.5", "::1/128", "fd00::/64",
                  "bogus"):
            got = L.ip_string_to_label(c)
            out.append(None if got is None else canon_label(got))
        out.append(canon_labels(
            L.get_cidr_labels(ipaddress.ip_network("10.1.0.0/16"))))
        out.append(canon_labels(
            L.get_cidr_labels(ipaddress.ip_network("2001:db8::/40"))))
        return out

    assert run(T) == run(J)


SELECTORS = [
    {"matchLabels": {"role": "backend"}},
    {"matchLabels": {"k8s:role": "backend"}},
    {},
    {"matchLabels": {"reserved:all": ""}},
    {"matchLabels": {"reserved:world": ""}},
    {"matchExpressions": [{"key": "env", "operator": "In",
                           "values": ["prod", "stage"]}]},
    {"matchExpressions": [{"key": "env", "operator": "NotIn",
                           "values": ["dev"]}]},
    {"matchExpressions": [{"key": "k8s:env", "operator": "Exists"}]},
    {"matchExpressions": [{"key": "env", "operator": "DoesNotExist"}]},
    {"matchExpressions": [{"key": "env", "operator": "Bogus"}]},
    {"matchLabels": {"role": "backend"},
     "matchExpressions": [{"key": "team", "operator": "In", "values": ["A"]}]},
]
SELECTOR_LABELS = [
    [], ["k8s:role=backend"], ["any:role=backend"], ["k8s:role=frontend"],
    ["container:role=backend"], ["k8s:env=prod"], ["k8s:env=dev"],
    ["reserved:world"], ["reserved:host"], ["k8s:role=backend", "k8s:team=A"],
]


def test_selectors():
    def run(pkg):
        S, L = pkg.selector, pkg.labels
        out = []
        for d in SELECTORS:
            s = S.EndpointSelector.from_dict(d)
            out.append((s.to_dict(), s.is_wildcard(),
                        s.label_selector_string(), repr(s),
                        [repr(r) for r in s.requirements()],
                        [repr(r) for r in s.convert_to_requirements()],
                        s.get_match("any.env"), s.get_match("k8s.role"),
                        s.has_key("any.env"), s.has_key_prefix("k8s.")))
            for ls in SELECTOR_LABELS:
                out.append(s.matches(L.LabelArray.parse(*ls)))
            out.append(s.matches(None))
            extra = s.add_requirements(
                [S.Requirement("any.team", S.OP_IN, ["A"])])
            out.append([extra.matches(L.LabelArray.parse(*ls))
                        for ls in SELECTOR_LABELS])
        world = S.RESERVED_ENDPOINT_SELECTORS["world"]
        out.append([world.matches(L.LabelArray.parse(*ls))
                    for ls in SELECTOR_LABELS])
        out.append(S.selects_all_endpoints([]))
        out.append(S.selects_all_endpoints([S.WILDCARD_SELECTOR]))
        a, b = S.EndpointSelector.from_dict(SELECTORS[0]), \
            S.EndpointSelector.from_dict(SELECTORS[0])
        out.append((a.deep_equal(b), a == b, b in {a: 1}, a in {a: 1}))
        return out

    assert run(T) == run(J)


# -- validation ---------------------------------------------------------------

def _rule(**kw):
    base = {"endpointSelector": sel("bar")}
    base.update(kw)
    return base


VALIDATION_RULES = [
    {"ingress": [{"fromEndpoints": [sel("foo")]}]},  # no endpointSelector
    _rule(labels=[{"key": "x", "source": "cilium-generated"}]),
    _rule(ingress=[{"fromEndpoints": [sel("foo")], "fromCIDR": ["10.0.0.0/8"]}]),
    _rule(ingress=[{"fromCIDR": ["10.0.0.0/8"],
                    "toPorts": [{"ports": ports(("80", "TCP"))}]}]),
    _rule(egress=[{"toCIDR": ["10.0.0.0/8"],
                   "toPorts": [{"ports": ports(("80", "TCP"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("0", "TCP"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("", "TCP"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("99999", "TCP"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "SCTP"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "tcp"), ("010", ""),
                                                ("0x50", "udp"))}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(*[(str(1000 + i), "TCP")
                                                 for i in range(41)])}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "UDP")),
                                 "rules": {"http": [{"path": "/"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "TCP")),
                                 "rules": {"http": [{"path": "/"}],
                                           "kafka": [{"topic": "t"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "TCP")),
                                 "rules": {"l7": [{"key": "val"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "TCP")),
                                 "rules": {"l7proto": "x", "l7": [{"": "v"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"role": "produce",
                                                      "apiKey": "fetch"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"apiKey": "bogus"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"role": "consume",
                                                      "apiVersion": "70000"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"topic": "x" * 256}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"topic": "bad topic!"}]}}]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("9092", "TCP")),
                                 "rules": {"kafka": [{"role": "consume",
                                                      "topic": "good.t_1-x",
                                                      "apiVersion": "2"}]}}]}]),
    _rule(ingress=[{"fromCIDRSet": [{"cidr": "10.0.0.0/8",
                                     "except": ["192.168.0.0/16"]}]}]),
    _rule(ingress=[{"fromCIDRSet": [{"cidr": "10.0.0.0/8",
                                     "except": ["10.96.0.0/12"]}]}]),
    _rule(ingress=[{"fromEntities": ["bogus"]}]),
    _rule(ingress=[{"fromEntities": ["world", "host", "cluster"]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("80", "TCP")),
                                 "rules": {"http": [{"path": "[invalid"}]}}]}]),
    _rule(egress=[{"toFQDNs": [{"matchName": ""}]}]),
    _rule(egress=[{"toFQDNs": [{"matchName": "example.com"}],
                   "toEntities": ["world"]}]),
    _rule(ingress=[{"fromCIDR": ["not-an-ip"]}]),
    _rule(ingress=[{"fromCIDR": [f"10.{i}.0.0/{8 + i}" for i in range(17)]
                    + [f"fd{i:02x}::/{20 + i}" for i in range(25)]}]),
    _rule(ingress=[{"toPorts": [{"ports": ports(("11211", "TCP")),
                                 "rules": {"l7proto": "binarymemcache",
                                           "l7": [{"opCode": "readGroup",
                                                   "keyPrefix": "a"}]}}]}]),
]


def test_rules_from_json_validation():
    """The same rules parse, and the same rules fail sanitize() with the
    same message (rule_validation_test.go's cases as JSON)."""
    def run(pkg):
        out = []
        for d in VALIDATION_RULES:
            def one():
                rules = pkg.api.rules_from_json(json.dumps(d))
                for r in rules:
                    r.sanitize()
                return [(repr(r.endpoint_selector), canon_labels(r.labels),
                         [[(p.port, p.protocol) for pr in i.to_ports
                           for p in pr.ports] for i in r.ingress])
                        for r in rules]
            out.append(outcome(one))
        # a list, a single object, and the CIDR set expansion
        out.append(len(pkg.api.rules_from_json(json.dumps(VALIDATION_RULES))))
        out.append(pkg.api.compute_resultant_cidr_set([
            pkg.api.CIDRRule(cidr="10.0.0.0/24", except_cidrs=["10.0.0.64/26"]),
            pkg.api.CIDRRule(cidr="10.0.0.0/24", except_cidrs=["10.0.0.0/24"]),
        ]))
        return out

    got_t, got_j = run(T), run(J)
    assert got_t == got_j
    raised = sum(1 for o in got_t[:-2] if o[0] == "raised")
    assert 15 <= raised < len(VALIDATION_RULES)


# -- a seeded generator of mixed rules ----------------------------------------

TEAMS, TIERS, ENVS = 8, 4, 2


def label_sets(n=64):
    """n label sets: team, tier, env and app labels, some reserved."""
    out = []
    for i in range(n - 4):
        out.append([f"k8s:team=t{i % TEAMS}", f"k8s:tier=r{(i // 8) % TIERS}",
                    f"k8s:env=e{i % ENVS}", f"k8s:app=a{i}"])
    out += [["reserved:world"], ["reserved:host"], ["reserved:init"],
            ["k8s:app=lonely"]]
    return out


def gen_selector(rng):
    kind = rng.integers(0, 6)
    if kind == 0:
        return {}
    if kind == 1:
        return {"matchLabels": {"team": f"t{rng.integers(0, TEAMS)}"}}
    if kind == 2:
        return {"matchLabels": {"k8s:tier": f"r{rng.integers(0, TIERS)}",
                                "env": f"e{rng.integers(0, ENVS)}"}}
    if kind == 3:
        return {"matchExpressions": [{
            "key": "team", "operator": ["In", "NotIn"][rng.integers(0, 2)],
            "values": [f"t{v}" for v in rng.choice(TEAMS, 3, replace=False)]}]}
    if kind == 4:
        return {"matchExpressions": [{
            "key": "k8s:tier", "operator": ["Exists", "DoesNotExist"][
                rng.integers(0, 2)]}]}
    return {"matchLabels": {"app": f"a{rng.integers(0, 60)}"}}


def gen_port_rule(rng):
    """One port, and on TCP often the L7 rules of that port's parser
    (80, 8080 HTTP; 9092 Kafka; 11211 memcached), so that merges
    conflict only where an L4-only rule meets them, as in a cluster."""
    port = int(rng.choice([80, 443, 9092, 11211, 53, 8080]))
    proto = ["TCP", "TCP", "UDP", "ANY", ""][rng.integers(0, 5)]
    pr = {"ports": [{"port": str(port), "protocol": proto}]}
    if proto != "TCP" or rng.random() < 0.3 or port in (53, 443):
        return pr
    if port in (80, 8080):
        pr["rules"] = {"http": [] if rng.random() < 0.2 else [
            {"method": ["GET", "POST", "GET|HEAD"][rng.integers(0, 3)],
             "path": f"/p{rng.integers(0, 4)}/.*"}]}
    elif port == 9092:
        pr["rules"] = {"kafka": [{"topic": f"top{rng.integers(0, 4)}"}]
                       if rng.random() < 0.5 else [{"role": "consume"}]}
    else:
        pr["rules"] = {"l7proto": "binarymemcache", "l7": [
            {"opCode": ["get", "set", "readGroup"][rng.integers(0, 3)],
             "keyExact": f"k{rng.integers(0, 4)}"}]}
    return pr


def gen_rules(seed, n=200):
    rng = np.random.default_rng(seed)
    rules = []
    for i in range(n):
        r = {"endpointSelector": gen_selector(rng),
             "labels": [f"k8s:rule=r{i}", f"k8s:batch=b{i % 5}"]}
        if rng.random() < 0.8:
            blocks = []
            for _ in range(int(rng.integers(1, 3))):
                kind = rng.random()
                b = {}
                if kind < 0.65:
                    b["fromEndpoints"] = [gen_selector(rng)
                                          for _ in range(int(rng.integers(1, 3)))]
                elif kind < 0.75:
                    b["fromRequires"] = [gen_selector(rng)]
                elif kind < 0.85:
                    b["fromEntities"] = [["world", "host", "all", "cluster"][
                        rng.integers(0, 4)]]
                if kind < 0.85 and rng.random() < 0.7:
                    b["toPorts"] = [gen_port_rule(rng)]
                elif kind >= 0.85:
                    b["fromCIDR"] = [f"10.{rng.integers(0, 4)}.0.0/16"]
                blocks.append(b)
            r["ingress"] = blocks
        if rng.random() < 0.5:
            b = {"toEndpoints": [gen_selector(rng)]}
            if rng.random() < 0.6:
                b["toPorts"] = [gen_port_rule(rng)]
            r["egress"] = [b]
        rules.append(r)
    return rules


@pytest.mark.parametrize("seed", [3, 11])
def test_generated_rules(seed):
    """200 mixed rules over 64 label sets: the same rules pass
    sanitize; then every resolution of every label set, and the
    verdicts of 64 sampled (from, to) pairs over three port sets."""
    rules = gen_rules(seed)
    kept = []
    for d in rules:
        a = outcome(lambda: [r.sanitize() for r in
                             T.api.rules_from_json(json.dumps(d))])
        b = outcome(lambda: [r.sanitize() for r in
                             J.api.rules_from_json(json.dumps(d))])
        assert a == b
        if a[0] == "ok":
            kept.append(d)
    assert len(kept) > 150
    sets = label_sets()
    tr, jr = load(T, kept), load(J, kept)
    assert resolutions(T, tr, sets) == resolutions(J, jr, sets)
    rng = np.random.default_rng(seed + 100)
    pairs = [(sets[a], sets[b])
             for a, b in rng.integers(0, len(sets), (64, 2))]
    port_sets = [(), ((80, "TCP"),), ((11211, "TCP"), (53, "ANY"))]
    assert verdicts(T, tr, sets, port_sets, pairs) == verdicts(
        J, jr, sets, port_sets, pairs)
    # deleting one batch of rules by label moves the same revisions
    for pkg, repo in ((T, tr), (J, jr)):
        repo.delete_by_labels(pkg.labels.LabelArray.parse("k8s:batch=b2"))
    assert (tr.get_revision(), tr.num_rules()) == (jr.get_revision(),
                                                   jr.num_rules())
    assert resolutions(T, tr, sets[::8]) == resolutions(J, jr, sets[::8])


# -- identities ---------------------------------------------------------------


def test_identity_allocator():
    def run(pkg):
        L, I = pkg.labels, pkg.identity
        alloc = I.IdentityAllocator()
        out = []
        idents = []
        for s in label_sets(24) + [["reserved:host"], ["reserved:world"]]:
            ident, new = alloc.allocate(L.Labels.from_model(s))
            idents.append(ident)
            out.append((ident.id, new, ident.sha256))
        out.append(alloc.allocate(L.Labels.from_model(["k8s:x=1"]),
                                  local_only=True)[0].id)
        out.append(alloc.allocate(L.Labels.from_model(label_sets(24)[3]))[1])
        out.append(alloc.release(idents[3]))
        out.append(alloc.release(idents[3]))
        out.append(alloc.release(idents[4]))
        cache = alloc.identity_cache()
        out.append(sorted((k, canon_labels(v)) for k, v in cache.items()))
        out.append(alloc.version)
        out.append(alloc.lookup_by_id(1).id)
        out.append(alloc.lookup_by_labels(
            L.Labels.from_model(label_sets(24)[5])).id)
        out.append([I.is_reserved_identity(n) for n in (1, 5, 128, 255, 256)])
        out.append(I.RESERVED_IDENTITIES)
        return out

    assert run(T) == run(J)
