"""The PyTorch port's L7 proxy path against the JAX package's, on the
CPU, with tolerance 0 (every output is a bool, an int or a structure):

  * the memcached parser: the wire codec, `compile_rules`, the host
    matcher, `compile_device` leaf for leaf, and
    `MemcacheDeviceTables.evaluate` (plain) against JAX's at R in {0, 1,
    24, 33, 70} (one, two and three membership words), identity indices
    -1, 0, N - 1, N and 2^31 - 1, opcodes -1 (absent), 0 and 255, unseen
    keys, unknown identities, and hand-built key ids of 2^31 and more;
  * the proxylib registry and the test parsers;
  * the redirects of `Proxy` from the same JSON rules: proxy ports,
    parsers, reuse of unchanged tables, removal, the asynchronous
    compile behind a WaitGroup (the newest generation wins) and the
    xds cache's versions;
  * the whole slice: JSON rules -> Repository -> resolve_l4_policy ->
    update_endpoint_redirects -> verdict_http, verdict_kafka and
    verdict_generic equal the reference's (header rules, overflowed HTTP
    fields and Kafka topic lists, memcached host fallback included).

The `cuda`-marked tests hold MEMCACHE_MATCH against its plain version
and the proxy on the card against the proxy on the CPU; they need no
JAX and skip here.  On the card:

    python -m pytest --noconftest tests/test_torch_proxy.py -q -m cuda
"""

import os
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.l7 import http as th
from cilium_tpu_torch.l7 import kafka as tk
from cilium_tpu_torch.l7 import memcached as tm
from cilium_tpu_torch.l7 import proxylib as tp
from cilium_tpu_torch.proxy import Proxy
from cilium_tpu_torch.utils.completion import WaitGroup

try:
    import jax  # noqa: F401

    from cilium_tpu.compiler import tables as j_tables
    from cilium_tpu.compiler.mapstate import resolve_l4_policy as j_resolve
    from cilium_tpu.identity import IdentityAllocator as JAllocator
    from cilium_tpu.l7 import http as jh
    from cilium_tpu.l7 import kafka as jk
    from cilium_tpu.l7 import memcached as jm
    from cilium_tpu.l7 import proxylib as jp
    from cilium_tpu.labels import LabelArray as JLabelArray
    from cilium_tpu.labels import Labels as JLabels
    from cilium_tpu.policy.api import rules_from_json as j_rules_from_json
    from cilium_tpu.policy.repository import Repository as JRepository
    from cilium_tpu.proxy import Proxy as JProxy
    from cilium_tpu.utils.completion import WaitGroup as JWaitGroup
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernels")


# -- memcached ---------------------------------------------------------------


def _frames(mod):
    e = mod.encode_request
    return [
        e(0, "k1"), e(1, "key", b"\0" * 8, b"value"), e(255, ""),
        e(12, "été"), e(300, "wrap"),
    ]


def _decode_outcome(mod, buf):
    try:
        reqs, used = mod.decode_stream(buf)
        return ("ok", [r.fields for r in reqs], used)
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))


def test_memcache_codec():
    _need_jax()
    assert tm.OPCODE_MAP == jm.OPCODE_MAP
    assert tm.DENIED_MSG == jm.DENIED_MSG
    wire = b"".join(_frames(tm))
    assert wire == b"".join(_frames(jm))
    bad_magic = b"\x81" + wire[1:]
    other_magic = b"\x42" + wire[1:]
    lying = bytearray(tm.encode_request(0, "abcdef"))
    lying[11] = 2  # body length 2 < key length 6
    for buf in (wire, wire[:-3], wire[:10], b"", bad_magic, other_magic,
                bytes(lying), wire + bytes(lying)):
        assert _decode_outcome(tm, buf) == _decode_outcome(jm, buf)
    req = tm.decode_stream(wire)[0][0]
    assert tm.deny_response(req) == jm.deny_response(
        jm.decode_stream(wire)[0][0])


RULE_DICTS = [
    [{"opCode": "get"}],
    [{"opCode": "readGroup", "keyExact": "a"},
     {"opCode": "set", "keyPrefix": "p"}],
    [{"opCode": "writeGroup", "keyRegex": "^x[0-9]+$"}],
    [],
    [{"opCode": "bogus"}],
    [{"opCode": "get", "keyExact": "a", "keyPrefix": "b"}],
    [{"opCode": "get", "color": "red"}],
    [{"keyExact": "a"}],
]


def _spec_tuple(s):
    return (sorted(s.identity_indices), s.op_codes, s.key_exact,
            s.key_prefix, s.key_regex, s.device_expressible)


def test_memcache_compile_rules_and_host_match():
    _need_jax()
    for dicts in RULE_DICTS:
        def run(mod):
            try:
                return [_spec_tuple(s)
                        for s in mod.compile_rules(dicts, [3, 1, 3])]
            except ValueError as e:
                return ("raised", str(e))
        assert run(tm) == run(jm)
    wire = b"".join(tm.encode_request(op, key) for op, key in (
        (0, "a"), (9, "a"), (1, "pz"), (2, "pz"), (4, "x12"), (4, "x1y"),
        (200, ""), (13, "b")))
    treqs, jreqs = tm.decode_stream(wire)[0], jm.decode_stream(wire)[0]
    treqs.append(tp.L7Request(proto="binarymemcache", fields=(("key", "a"),)))
    jreqs.append(jp.L7Request(proto="binarymemcache", fields=(("key", "a"),)))
    for dicts in RULE_DICTS[:4]:
        ts, js = tm.compile_rules(dicts, [0]), jm.compile_rules(dicts, [0])
        assert [[tm.rule_matches(r, s) for s in ts] for r in treqs] == \
            [[jm.rule_matches(r, s) for s in js] for r in jreqs]


def _rule_dicts(r: int, seed: int):
    """r rule dicts: exact keys, prefixes, regexes, bare opcodes."""
    rng = np.random.default_rng(seed)
    names = sorted(tm.OPCODE_MAP)
    out = []
    for j in range(r):
        d = {"opCode": names[int(rng.integers(0, len(names)))]}
        kind = int(rng.integers(0, 6))
        if kind < 3:
            d["keyExact"] = f"k{int(rng.integers(0, 12))}"
        elif kind == 3:
            d["keyPrefix"] = f"p{int(rng.integers(0, 3))}"
        elif kind == 4:
            d["keyRegex"] = f"^r{int(rng.integers(0, 3))}[0-9]*$"
        out.append(d)
    return out


def _specs(mod, r: int, n: int, seed: int):
    """r specs over n identities, each rule's identities drawn (some
    out of range, which compile_device skips), one wildcard for
    identity 0 alone (so rows 0 and N - 1 answer differently: a wrapped
    index would show)."""
    rng = np.random.default_rng(seed + 1)
    specs = []
    for d in _rule_dicts(r, seed):
        idx = [int(v) for v in rng.integers(-2, n + 2, size=4)]
        specs.extend(mod.compile_rules([d], idx))
    if r:
        specs[-1] = mod.compile_rules([], [0])[0]
    return specs


def _leaves(t):
    return {k: np.asarray(getattr(t, k)) for k in
            ("opcode_mask", "key_id", "device_ok", "ident_rules")}


@pytest.mark.parametrize("r", [0, 1, 24, 33, 70])
def test_memcache_compile_device_leaves(r):
    _need_jax()
    n = 16
    t = tm.compile_device(_specs(tm, r, n, r), n)
    j = jm.compile_device(_specs(jm, r, n, r), n)
    for k, v in _leaves(j).items():
        got = _leaves(t)[k]
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    assert t.interner._ids == j.interner._ids
    assert [_spec_tuple(s) for s in t.specs] == [_spec_tuple(s)
                                                for s in j.specs]


def _edge_requests(mod, seed: int, b: int = 160):
    """Opcodes -1 (no opcode field), 0, 255 and drawn ones; seen,
    unseen, prefixed and regex keys."""
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(14)] + ["p0x", "p2", "r1", "r2123", "",
                                           "zz"]
    reqs = []
    for i in range(b):
        key = keys[int(rng.integers(0, len(keys)))]
        if i % 17 == 0:
            reqs.append(mod.L7Request(proto="binarymemcache",
                                      fields=(("key", key),)))
            continue
        op = [0, 255, int(rng.integers(0, 72))][i % 3]
        reqs.append(mod.L7Request(proto="binarymemcache",
                                  fields=(("opcode", str(op)), ("key", key))))
    return reqs


def _edge_idents(n: int, b: int, seed: int):
    rng = np.random.default_rng(seed)
    ident = rng.integers(0, n, size=b).astype(np.int64)
    ident[:5] = [-1, 0, n - 1, n, (1 << 31) - 1]
    known = rng.random(b) < 0.9
    known[:5] = True
    return ident, known


@pytest.mark.parametrize("r", [0, 1, 24, 33, 70])
def test_memcache_evaluate_matches_jax(r):
    """The plain K17c against JAX's evaluate: both columns, every edge."""
    _need_jax()
    n = 16
    t = convert.l7_tables_to(tm.compile_device(_specs(tm, r, n, r), n), "cpu")
    j = jm.compile_device(_specs(jm, r, n, r), n)
    ident, known = _edge_idents(n, 160, r)
    ta, tn = t.evaluate(_edge_requests(tm, r), ident, known)
    ja, jn = j.evaluate(_edge_requests(jm, r), ident, known)
    assert ta.dtype == bool and tn.dtype == bool
    assert np.array_equal(ta, np.asarray(ja))
    assert np.array_equal(tn, np.asarray(jn))
    if r >= 24:
        assert 0 < ta.sum() < len(ta) and tn.any()


def test_memcache_evaluate_u32_key_words():
    """Key ids of 2^31 and more compare as u32 words: built by hand in
    both packages' tables and interners (no test interns 2^31 keys)."""
    _need_jax()
    n, r = 8, 33
    host_t = tm.compile_device(_specs(tm, r, n, 5), n)
    host_j = jm.compile_device(_specs(jm, r, n, 5), n)
    big = [0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 0x80000001]
    for tab in (host_t, host_j):
        for j, word in enumerate(big):
            tab.key_id[3 * j] = np.uint32(word)
            tab.interner._ids[f"big{j}"] = word
        tab.interner._ids["big9"] = 0x80000002  # matches no rule
    reqs_t = [tm.L7Request("binarymemcache", (("opcode", str(op)),
                                              ("key", f"big{k}")))
              for op in range(0, 72, 3) for k in (0, 1, 2, 3, 9)]
    reqs_j = [jm.L7Request("binarymemcache", r.fields) for r in reqs_t]
    b = len(reqs_t)
    ident = np.arange(b) % n
    known = np.ones(b, bool)
    ta, tn = convert.l7_tables_to(host_t, "cpu").evaluate(reqs_t, ident, known)
    ja, jn = host_j.evaluate(reqs_j, ident, known)
    assert np.array_equal(ta, np.asarray(ja)) and ta.any()
    assert np.array_equal(tn, np.asarray(jn))


def test_memcache_evaluate_refuses_host_tables_and_empty_rules_skip():
    t = tm.compile_device(_specs(tm, 3, 4, 3), 4)
    reqs = _edge_requests(tm, 1, 8)
    with pytest.raises(ValueError, match="move them"):
        t.evaluate(reqs, np.zeros(8, np.int32), np.ones(8, bool))
    empty = tm.compile_device([], 4)  # numpy, never touched: no rules
    a, h = empty.evaluate(reqs, np.zeros(8, np.int32), np.ones(8, bool))
    assert not a.any() and not h.any()


# -- the proxylib registry and the test parsers -------------------------------

TEST_PARSER_DATA = {
    "test.lineparser": [b"PASS one\nDROP two\nPASS", b"", b"\n\n"],
    "test.headerparser": [b"GET /x HTTP\n  foo bar baz \nend\n"],
    "test.blockparser": [b"9:PASSabcd5:DROP8:PASS", b"x:abc", b"1:", b"3:P"],
}
TEST_PARSER_RULES = {
    "test.lineparser": [[]],
    "test.headerparser": [[{"HasPrefix": "GET"}],
                          [{"Contains": "bar", "HasSuffix": "baz"}],
                          [{"HasPrefix": "end"}, {"Contains": "x"}]],
    "test.blockparser": [[]],
}


def test_proxylib_registry_and_test_parsers():
    _need_jax()
    assert tp.known_parsers() == jp.known_parsers()
    with pytest.raises(KeyError) as te:
        tp.get_parser("nope")
    with pytest.raises(KeyError) as je:
        jp.get_parser("nope")
    assert str(te.value) == str(je.value)
    for name, bufs in TEST_PARSER_DATA.items():
        tparser, jparser = tp.get_parser(name), jp.get_parser(name)
        for buf in bufs:
            got = []
            for parser in (tparser, jparser):
                try:
                    reqs, used = parser.decode_stream(buf)
                    got.append(([r.fields for r in reqs], used))
                except ValueError as e:
                    got.append(("raised", str(e)))
            assert got[0] == got[1], (name, buf)
            if got[0][0] == "raised":
                continue
            treqs = tparser.decode_stream(buf)[0]
            jreqs = jparser.decode_stream(buf)[0]
            if not treqs:
                continue
            for rules in TEST_PARSER_RULES[name]:
                per = [([0, 2], rules), ([1], [])]
                tt = tp.compile_generic_rules(name, per, 4)
                jt = jp.compile_generic_rules(name, per, 4)
                assert tt.device is None and jt.device is None
                ident = np.arange(len(treqs)) % 4
                known = np.arange(len(treqs)) % 5 != 4
                assert np.array_equal(
                    tp.evaluate_requests(tt, treqs, ident, known),
                    jp.evaluate_requests(jt, jreqs, ident, known))
                if tparser.deny_response is not None:
                    assert tparser.deny_response(treqs[0]) == \
                        jparser.deny_response(jreqs[0])


# -- the proxy from rules -----------------------------------------------------

SMALL_IDENTITIES = 64
SMALL_REQUESTS = 3000


def _small_world():
    return world.proxy_world(SMALL_IDENTITIES, SMALL_REQUESTS)


def _jax_setup(pw, wait_group=None, proxy=None):
    """world.proxy_setup's steps with the JAX package's modules."""
    rules = j_rules_from_json(pw.rules_json)
    for r in rules:
        r.sanitize()
    repo = JRepository()
    repo.add_list(rules)
    alloc = JAllocator()
    for labels in pw.identity_labels:
        alloc.allocate(JLabels.from_model(labels))
    cache = alloc.identity_cache()
    id_table = j_tables.build_id_table(list(cache), world.PROXY_IDENTITY_PAD)
    id_index = {int(v): i for i, v in enumerate(id_table)
                if v != j_tables.PAD_ID}
    policy = j_resolve(repo, JLabelArray.parse(*pw.server_labels))
    endpoint = types.SimpleNamespace(id=world.PROXY_ENDPOINT_ID,
                                     desired_l4_policy=policy,
                                     realized_redirects={})
    proxy = proxy or JProxy()
    proxy.update_endpoint_redirects(endpoint, cache, id_index, len(id_table),
                                    wait_group=wait_group)
    if wait_group is not None:
        assert wait_group.wait(timeout=120)
    eid = world.PROXY_ENDPOINT_ID
    return types.SimpleNamespace(
        repo=repo, cache=cache, id_table=id_table, id_index=id_index,
        policy=policy, endpoint=endpoint, proxy=proxy, redirects={
            "http": proxy.redirect_for(eid, True, "TCP", 80),
            "kafka": proxy.redirect_for(eid, True, "TCP", 9092),
            "memcache": proxy.redirect_for(eid, True, "TCP", 11211),
            "http_egress": proxy.redirect_for(eid, False, "TCP", 8080),
        })


def _jax_requests(pw, parser):
    pick, ident, known = pw.draws[parser]
    if parser == "memcache":
        templates = jm.decode_stream(pw.memcache_wire)[0]
    elif parser == "kafka":
        templates = [jk.KafkaRequest(kind=k, version=v, client_id=c,
                                     topics=t, parsed=p)
                     for k, v, c, t, p in pw.kafka_templates]
    else:
        templates = pw.http_templates
    return [templates[i] for i in pick.tolist()], ident, known


class _Monitor:
    def __init__(self):
        self.events = []

    def publish(self, ev):
        self.events.append((ev.endpoint_id, ev.l7_proto, ev.verdict, ev.info,
                            ev.type))


def _verdicts(proxy, redirects, reqs, log=False):
    calls = (("http", proxy.verdict_http), ("kafka", proxy.verdict_kafka),
             ("memcache", proxy.verdict_generic))
    out = {}
    for parser, fn in calls:
        r, ident, known = reqs[parser]
        out[parser] = np.asarray(fn(redirects[parser], r, ident, known,
                                    log=log))
    r, ident, known = reqs["http"]
    out["http_egress"] = np.asarray(proxy.verdict_http(
        redirects["http_egress"], r, ident, known, log=False))
    return out


def test_whole_slice_matches_reference():
    """JSON rules -> verdicts of all three parsers (and the egress
    redirect) equal the reference's, with their access logs."""
    _need_jax()
    pw = _small_world()
    t = world.proxy_setup(pw, "cpu")
    j = _jax_setup(pw)
    assert np.array_equal(t.id_table, j.id_table)
    assert t.endpoint.realized_redirects == j.endpoint.realized_redirects
    assert len(t.endpoint.realized_redirects) == 4
    for name in t.redirects:
        a, b = t.redirects[name], j.redirects[name]
        assert (a.id, a.proxy_port, a.parser, a.ingress) == \
            (b.id, b.proxy_port, b.parser, b.ingress)
    # the compiled tables agree leaf for leaf
    assert np.array_equal(
        t.redirects["http"].http_policy.tables.ident_rules.numpy().view(
            np.uint32), j.redirects["http"].http_policy.tables.ident_rules)
    assert np.array_equal(
        t.redirects["kafka"].kafka_tables.ident_rules.numpy().view(np.uint32),
        j.redirects["kafka"].kafka_tables.ident_rules)
    tg = t.redirects["memcache"].generic_tables
    jg = j.redirects["memcache"].generic_tables
    assert [_spec_tuple(s) for s in tg.specs] == [_spec_tuple(s)
                                                 for s in jg.specs]
    for k, v in _leaves(jg.device).items():
        got = getattr(tg.device, k).numpy()
        got = got.view(np.uint32) if v.dtype == np.uint32 else got
        assert np.array_equal(got, v), k
    treqs = {p: world.proxy_requests(pw, p)
             for p in ("http", "kafka", "memcache")}
    jreqs = {p: _jax_requests(pw, p) for p in ("http", "kafka", "memcache")}
    t.proxy.monitor, j.proxy.monitor = _Monitor(), _Monitor()
    tv = _verdicts(t.proxy, t.redirects, treqs, log=True)
    jv = _verdicts(j.proxy, j.redirects, jreqs, log=True)
    for parser in tv:
        assert np.array_equal(tv[parser], jv[parser]), parser
        assert 0 < tv[parser].sum() < SMALL_REQUESTS, parser
    # the access logs: one record per request of the three ingress calls
    assert t.proxy.monitor.events == j.proxy.monitor.events
    assert len(t.proxy.monitor.events) == 3 * SMALL_REQUESTS
    # the memcached rows the host decides, and the prefix/regex allows
    _, needs = tg.device.evaluate(*treqs["memcache"])
    assert needs.any() and (tv["memcache"] & needs).any()
    # the host fallbacks ran: overflowed HTTP fields, Kafka topic lists
    assert any(len(p) > 128 for _, p, _ in pw.http_templates)
    assert any(len(k[3]) > tk.MAX_TOPICS for k in pw.kafka_templates)


def test_http_header_rules_host_fallback():
    """evaluate_with_host_fallback with header rules and overflowed
    fields, against the reference's."""
    _need_jax()
    def specs(mod):
        return [
            mod.HTTPRuleSpec(identity_indices=[0, 1], method="GET",
                             path="/a/.*"),
            mod.HTTPRuleSpec(identity_indices=[1, 2], path="/h/.*",
                             headers=("X-Token: s3cret",)),
            mod.HTTPRuleSpec(identity_indices=[2], headers=("X-Flag",)),
        ]
    tpol = convert.l7_tables_to(th.compile_http_rules(specs(th), 4), "cpu")
    jpol = jh.compile_http_rules(specs(jh), 4)
    reqs = [(b"GET", b"/a/" + b"q" * i, b"h") for i in (1, 20, 200)]
    reqs += [(b"POST", b"/h/x", b""), (b"GET", b"/h/y", b""),
             (b"PUT", b"/z", b""), (b"GET", b"/a/" + b"x" * 300, b"")]
    reqs = reqs * 4
    b = len(reqs)
    ident = np.arange(b) % 4
    known = np.arange(b) % 7 != 6
    headers = [None, {"x-token": "s3cret"}, {"x-flag": ""},
               {"x-token": "nope"}] * (b // 4)
    for hdrs in (None, headers):
        got = th.evaluate_with_host_fallback(tpol, reqs, ident, known, hdrs,
                                             lm=8, lp=32, lh=8)
        want = jh.evaluate_with_host_fallback(jpol, reqs, ident, known, hdrs,
                                              lm=8, lp=32, lh=8)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="move them"):
        th.evaluate_with_host_fallback(th.compile_http_rules(specs(th), 4),
                                       reqs, ident, known)


def _redirect_view(proxy, eid=world.PROXY_ENDPOINT_ID):
    return sorted((pid, r.proxy_port, r.parser, r.ingress)
                  for pid, r in proxy.redirects.items()
                  if r.endpoint_id == eid)


def test_redirect_lifecycle_matches_reference():
    """Ports, reuse, removal, recompiles and xds versions, step by step
    on both proxies."""
    _need_jax()
    pw = _small_world()
    t = world.proxy_setup(pw, "cpu")
    j = _jax_setup(pw)
    steps = [(_redirect_view(t.proxy), t.proxy.xds.version())]
    jsteps = [(_redirect_view(j.proxy), j.proxy.xds.version())]
    # 1: the same policy again reuses every compiled table
    before = {k: (r.http_policy, r.kafka_tables, r.generic_tables)
              for k, r in t.redirects.items()}
    for s in (t, j):
        s.proxy.update_endpoint_redirects(s.endpoint, s.cache, s.id_index,
                                          len(s.id_table))
    eid = world.PROXY_ENDPOINT_ID
    after = {"http": t.proxy.redirect_for(eid, True, "TCP", 80),
             "kafka": t.proxy.redirect_for(eid, True, "TCP", 9092),
             "memcache": t.proxy.redirect_for(eid, True, "TCP", 11211)}
    for k, r in after.items():
        assert (r.http_policy, r.kafka_tables, r.generic_tables) == before[k]
        assert r.generic_tables is before[k][2]
    steps.append((_redirect_view(t.proxy), t.proxy.xds.version()))
    jsteps.append((_redirect_view(j.proxy), j.proxy.xds.version()))
    # 2: drop the Kafka and egress filters: their redirects and ports go
    for s in (t, j):
        pol = s.endpoint.desired_l4_policy
        pol.ingress.pop("9092/TCP")
        pol.egress.clear()
        s.proxy.update_endpoint_redirects(s.endpoint, s.cache, s.id_index,
                                          len(s.id_table))
    steps.append((_redirect_view(t.proxy), t.proxy.xds.version(),
                  sorted(t.proxy._ports_in_use)))
    jsteps.append((_redirect_view(j.proxy), j.proxy.xds.version(),
                   sorted(j.proxy._ports_in_use)))
    # 3: a changed universe recompiles (fingerprints differ), same ports
    for s in (t, j):
        s.proxy.update_endpoint_redirects(s.endpoint, s.cache, s.id_index,
                                          len(s.id_table) + 32)
    steps.append((_redirect_view(t.proxy), t.proxy.xds.version()))
    jsteps.append((_redirect_view(j.proxy), j.proxy.xds.version()))
    assert t.proxy.redirect_for(eid, True, "TCP", 80).http_policy is not \
        before["http"][0]
    # 4: remove one redirect by hand, then an unknown one
    for s in (t, j):
        pid = f"{eid}:ingress:TCP:80"
        s.steps_removed = (s.proxy.remove_redirect(pid),
                           s.proxy.remove_redirect("nope"))
    steps.append((_redirect_view(t.proxy), t.proxy.xds.version(),
                  t.steps_removed))
    jsteps.append((_redirect_view(j.proxy), j.proxy.xds.version(),
                   j.steps_removed))
    assert steps == jsteps
    typeurl = "type.cilium.io/binarymemcacheNetworkPolicy"
    tver, tres = t.proxy.xds.get_resources(typeurl)
    jver, jres = j.proxy.xds.get_resources(typeurl)
    assert tver == jver and sorted(tres) == sorted(jres)


def _hold_worker(proxy):
    """Blocks the proxy's one compile worker until the returned event is
    set, so that the compiles submitted meanwhile stay pending."""
    gate = threading.Event()
    proxy._compiler.submit(gate.wait, 120)
    return gate


def test_async_compile_newest_generation_wins():
    """With a WaitGroup the compiles run on the proxy's worker; of two
    updates pending together only the second is installed (one xds
    transaction); the waiter sees every completion; a removal during a
    pending compile is not undone.  The worker is held while the calls
    are made, so that no compile finishes before the next call."""
    _need_jax()
    pw = _small_world()
    out = []
    for setup, wg_cls in (
        (lambda wg: world.proxy_setup(pw, "cpu", wait_group=wg), WaitGroup),
        (lambda wg: _jax_setup(pw, wait_group=wg), JWaitGroup),
    ):
        s = setup(wg_cls())
        f = s.policy.ingress["11211/TCP"]
        pid = f"{world.PROXY_ENDPOINT_ID}:ingress:TCP:11211"
        before = s.proxy.xds.version()
        wg2 = wg_cls()
        gate = _hold_worker(s.proxy)
        r1 = s.proxy.create_or_update_redirect(
            f, pid, world.PROXY_ENDPOINT_ID, s.cache, s.id_index, 512,
            wait_group=wg2)
        r2 = s.proxy.create_or_update_redirect(
            f, pid, world.PROXY_ENDPOINT_ID, s.cache, s.id_index, 256,
            wait_group=wg2)
        gate.set()
        assert wg2.wait(timeout=120) and wg2.pending == 2
        installed = s.proxy.redirects[pid]
        assert installed is r2 and installed is not r1
        n_ident = installed.generic_tables.n_identities
        version = s.proxy.xds.version()
        wg3 = wg_cls()
        gate = _hold_worker(s.proxy)
        s.proxy.create_or_update_redirect(
            f, pid, world.PROXY_ENDPOINT_ID, s.cache, s.id_index, 128,
            wait_group=wg3)
        removed = s.proxy.remove_redirect(pid)
        gate.set()
        wg3.wait(timeout=120)
        out.append((r1.proxy_port, r2.proxy_port, n_ident, removed,
                    pid in s.proxy.redirects, version - before,
                    s.proxy.xds.version() - version,
                    _redirect_view(s.proxy)))
    assert out[0] == out[1]
    assert out[0][2] == 256 and out[0][3] and not out[0][4]
    assert out[0][5] == 1 and out[0][6] == 1


def test_proxy_device_default_is_the_card():
    if torch.cuda.is_available():
        assert Proxy().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Proxy()
    assert Proxy(device="cpu").device.type == "cpu"


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 24, 33, 70, 2100])
def test_memcache_kernel_matches_plain(r):
    """MEMCACHE_MATCH against its plain version on the same card
    tensors (2,100 rules span three shared-memory tiles)."""
    _need_card()
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.device import array_tensor

    n = 16
    host = tm.compile_device(_specs(tm, r, n, r), n)
    if r == 33:  # key words of 2^31 and more
        for k, word in enumerate((0x80000000, 0xFFFFFFFF)):
            host.key_id[3 * k] = np.uint32(word)
            host.interner._ids[f"big{k}"] = word
    tables = convert.l7_tables_to(host, "cuda")
    reqs = _edge_requests(tm, r, 4096)
    reqs += [tm.L7Request("binarymemcache", (("opcode", "0"),
                                             ("key", f"big{k}")))
             for k in range(2)] * 64
    ident, known = _edge_idents(n, len(reqs), r)
    opcode, key_id = tables.pack(reqs)
    args = [array_tensor(a, "cuda") for a in
            (opcode, key_id, ident.astype(np.int32), known)]
    before = kernels.MEMCACHE_MATCH.launches
    ok, host_rows = tm.memcache_match(tables, *args)
    pok, phost = tm.memcache_match_plain(tables, *args)
    torch.cuda.synchronize()
    assert kernels.MEMCACHE_MATCH.launches == before + 1
    assert torch.equal(ok, pok) and torch.equal(host_rows, phost)
    assert 0 < int(ok.sum()) < len(reqs)
    a, h = tables.evaluate(reqs, ident, known)
    assert np.array_equal(a, pok.cpu().numpy())
    assert np.array_equal(h, phost.cpu().numpy())


@pytest.mark.cuda
def test_memcache_kernel_refuses_what_it_does_not_take():
    _need_card()
    from cilium_tpu_torch import kernels

    tables = convert.l7_tables_to(tm.compile_device(_specs(tm, 40, 8, 2), 8),
                                  "cuda")
    args = [torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool)]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.MEMCACHE_MATCH(tables, *args)
    cuda_args = [a.cuda() for a in args]
    bad = list(cuda_args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        kernels.MEMCACHE_MATCH(tables, *bad)
    narrow = types.SimpleNamespace(**{**vars(tables)})
    narrow.ident_rules = tables.ident_rules[:, :1].contiguous()
    with pytest.raises(ValueError, match="words"):
        kernels.MEMCACHE_MATCH(narrow, *cuda_args)
    empty = convert.l7_tables_to(tm.compile_device([], 8), "cuda")
    with pytest.raises(ValueError, match="at least one rule"):
        kernels.MEMCACHE_MATCH(empty, *cuda_args)
    before = kernels.MEMCACHE_MATCH.launches
    a, h = tm.memcache_match(empty, *cuda_args)  # no launch
    assert kernels.MEMCACHE_MATCH.launches == before
    assert not a.any() and not h.any()


@pytest.mark.cuda
def test_proxy_on_the_card_matches_the_cpu():
    """The slice on the card (HTTP_MATCH, KAFKA_MATCH, MEMCACHE_MATCH)
    equals the same slice on the CPU's plain versions."""
    _need_card()
    from cilium_tpu_torch import kernels

    pw = _small_world()
    card = world.proxy_setup(pw, None)
    cpu = world.proxy_setup(pw, "cpu")
    assert card.proxy.device.type == "cuda"
    reqs = {p: world.proxy_requests(pw, p)
            for p in ("http", "kafka", "memcache")}
    before = [k.launches for k in (kernels.HTTP_MATCH, kernels.KAFKA_MATCH,
                                   kernels.MEMCACHE_MATCH)]
    got = _verdicts(card.proxy, card.redirects, reqs)
    after = [k.launches for k in (kernels.HTTP_MATCH, kernels.KAFKA_MATCH,
                                  kernels.MEMCACHE_MATCH)]
    assert [a - b for a, b in zip(after, before)] == [2, 1, 1]
    want = _verdicts(cpu.proxy, cpu.redirects, reqs)
    for parser in want:
        assert np.array_equal(got[parser], want[parser]), parser
