"""The PyTorch port's L7 matchers against the JAX package's, on the CPU,
with tolerance 0 (every output is an integer or a bool):

  * the host compilers (compile_union, build_strided,
    compile_http_rules, compile_kafka_rules) and the request packers
    equal the reference leaf for leaf, on config 3's and 4's 24-rule
    sets (bench.py config3/config4), the DFA patterns of
    tests/test_l7_http.py and multi-word rule sets;
  * the plain evaluate_http_batch (strided and byte branches) and
    evaluate_kafka_batch equal the jitted JAX functions on the same
    numpy inputs, with and without scope bits, on tables compiled by
    the port and tables carried across from the reference
    (convert.*_from_numpy), including the edge cases: HTTP lengths of 0,
    of the full row width and above it, bytes >= 0x80, 40 rules (two
    mask words), unknown identities and out-of-range identity indices;
    Kafka kinds -1, 31, 32, 63 and 64, topic overflow, unseen strings
    and unparsed requests.

The `cuda`-marked tests hold the kernels HTTP_MATCH and KAFKA_MATCH
against their plain versions on the card; they need no JAX and skip
here.  On the card:

    python -m pytest --noconftest tests/test_torch_l7.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.device import array_tensor
from cilium_tpu_torch.l7 import http as th
from cilium_tpu_torch.l7 import kafka as tk
from cilium_tpu_torch.l7 import regex_dfa as tr

try:
    import jax

    from cilium_tpu.l7 import http as jh
    from cilium_tpu.l7 import kafka as jk
    from cilium_tpu.l7 import regex_dfa as jr
    from torch_parity import as_torch, assert_same_l7, as_spec, l7_leaves
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


# -- worlds -------------------------------------------------------------------

DFA_PATTERNS = [
    ["GET", "GET|POST", "/public/.*", "/api/v[0-9]+/users/[^/]+"],
    ["/a(b|cd)*e", "foo.*bar", "[a-z]{2,4}x", "(?:ab|a)bc", "a?b+c*"],
    ["\\d+\\.\\d+", "x{3}", "x{2,}y", "", "[[:alpha:]]+[[:digit:]]?"],
    ["/bin/[\\x80-\\xff]+", "[^\\x00-\\xff]", "\\x41\\x42*", ".*"],
    [f"/api/v{i % 4}/[a-z]+(/[0-9]+)?" for i in range(24)]
    + ["GET|POST", "svc[0-9]+\\.cluster\\.local"],
]


def _edge_http_specs(n_ident=16):
    """40 device rules (two mask words) over 16 identities: GET/POST
    paths, byte classes >= 0x80, host patterns, an allow-all rule."""
    rng = np.random.default_rng(7)
    specs = []
    for i in range(39):
        specs.append(th.HTTPRuleSpec(
            identity_indices=sorted(set(rng.integers(0, n_ident, 5).tolist())),
            method="GET" if i % 2 else "GET|POST",
            path=(f"/p{i % 5}/[a-z]{{{i % 8},}}" if i % 3
                  else f"/bin/{i}[\\x80-\\xff]+"),
            host="" if i % 4 else f"h{i % 3}[0-9]?",
        ))
    specs.append(th.HTTPRuleSpec(identity_indices=[5]))  # allow-all
    return specs


def _edge_http_requests():
    """Requests and their packed fields: a 32-byte path (the full row
    width), empty fields, bytes >= 0x80, and three rows whose path
    length claims more than the row holds."""
    rng = np.random.default_rng(8)
    reqs = [
        (b"GET", b"/p1/" + b"a" * 28, b""),  # exactly the 32-byte budget
        (b"", b"", b""),
        (b"GET", b"/bin/3\x80\xfe\xff", b"h0"),
        (b"POST", b"/bin/9\x7f", b"h1"),
        (b"GET", b"/p2/", b"h25"),
    ]
    for _ in range(123):
        m = rng.choice([b"GET", b"POST", b"PUT", b""])
        p = rng.choice([b"/p0/abc", b"/p3/", b"/p4/zz9", b"/bin/6\xc3\xa9",
                        b"/bin/12\x80", b"/x",
                        b"/p1/" + b"q" * int(rng.integers(0, 20))])
        h = rng.choice([b"", b"h0", b"h17", b"h2", b"\xff"])
        reqs.append((bytes(m), bytes(p), bytes(h)))
    m, ml, p, pl, h, hl, overflow = th.pad_requests(reqs, lm=8, lp=32, lh=8)
    assert not overflow.any()
    pl = pl.copy()
    pl[[3, 40, 77]] += 9  # lengths above the row width scan the whole row
    b = len(reqs)
    ident = rng.integers(0, 16, size=b).astype(np.int32)
    ident[[1, 9]] = [-3, 99]  # clipped to [0, N - 1]
    known = rng.random(b) < 0.85
    scope = rng.integers(0, 1 << 32, size=(b, 2), dtype=np.uint64).astype(
        np.uint32)
    return (m, ml, p, pl, h, hl), ident, known, scope


def _edge_kafka_specs(n_ident=16):
    """40 rules (two mask words): api keys 31, 32 and 63, wildcard keys,
    pinned versions, client ids and topics."""
    rng = np.random.default_rng(9)
    keys = [(31,), (32,), (63,), (), (0, 1), (3,), (0, 3, 32), (18,)]
    specs = []
    for i in range(40):
        specs.append(tk.KafkaRuleSpec(
            identity_indices=sorted(set(rng.integers(0, n_ident, 6).tolist())),
            api_keys=keys[i % len(keys)],
            api_version=(2 if i % 5 == 0 else None),
            client_id=("c1" if i % 7 == 0 else ("c2" if i % 7 == 1 else "")),
            topic=("" if i % 3 == 0 else f"t{i % 4}"),
        ))
    return specs


def _edge_kafka_requests(tables, pad):
    rng = np.random.default_rng(10)
    reqs = [
        tk.KafkaRequest(kind=k, version=2, client_id="c1",
                        topics=("t1", "t2"), parsed=True)
        for k in (-1, 31, 32, 63, 64)
    ]
    reqs.append(tk.KafkaRequest(  # nine topics: overflow, denied
        kind=0, version=0, topics=tuple(f"t{j}" for j in range(9))))
    reqs.append(tk.KafkaRequest(kind=3, version=0, client_id="nobody",
                                topics=("unseen",), parsed=False))
    for _ in range(150):
        reqs.append(tk.KafkaRequest(
            kind=int(rng.choice([-1, 0, 1, 3, 8, 18, 31, 32, 63, 64])),
            version=int(rng.choice([0, 2])),
            client_id=str(rng.choice(["c1", "c2", "zz", ""])),
            topics=tuple(str(t) for t in rng.choice(
                ["t1", "t2", "t3", "t0", "unseen"],
                size=int(rng.integers(0, 4)))),
            parsed=bool(rng.random() < 0.8),
        ))
    fields = pad(tables, reqs)
    b = len(reqs)
    ident = rng.integers(0, 16, size=b).astype(np.int32)
    ident[[2, 5]] = [-1, 40]
    known = rng.random(b) < 0.85
    scope = rng.integers(0, 1 << 32, size=(b, 2), dtype=np.uint64).astype(
        np.uint32)
    return reqs, tuple(np.asarray(a) for a in fields), ident, known, scope


# -- host compilers ------------------------------------------------------------


@pytest.mark.parametrize("group", range(len(DFA_PATTERNS)))
def test_compile_union_and_strided_match_reference(group):
    _need_jax()
    patterns = DFA_PATTERNS[group]
    port, ref = tr.compile_union(patterns), jr.compile_union(patterns)
    assert_same_l7(port, ref, "dfa")
    assert_same_l7(th.build_strided(port), jh.build_strided(ref), "sdfa")


def test_dfa_refusals_match_reference():
    _need_jax()
    for pattern in ["a(?=b)", "(a)\\1", "a|^b", "a$b", "a*?"]:
        with pytest.raises(tr.RegexUnsupported):
            tr.compile_union([pattern])
        with pytest.raises(jr.RegexUnsupported):
            jr.compile_union([pattern])
    with pytest.raises(tr.RegexTooComplex):
        tr.compile_union([".*a.{20}"], max_states=64)


@pytest.mark.parametrize("which", ["config3", "edge"])
def test_compile_http_rules_matches_reference(which):
    _need_jax()
    if which == "config3":
        specs, n = world.http_request_world(n=8).specs, 1024
    else:
        specs, n = _edge_http_specs(), 16
    port = th.compile_http_rules(specs, n)
    ref = jh.compile_http_rules([as_spec(s, jh) for s in specs], n)
    assert_same_l7(port.tables, ref.tables)
    assert [dataclasses.asdict(s) for s in port.device_rules] == [
        dataclasses.asdict(s) for s in ref.device_rules]
    if which == "edge":
        assert port.tables.n_words == 2


def test_compile_http_rules_splits_header_rules_as_reference():
    _need_jax()
    specs = _edge_http_specs()[:3] + [th.HTTPRuleSpec(
        identity_indices=[0], method="GET", headers=("X-Token: secret",))]
    port = th.compile_http_rules(specs, 16)
    ref = jh.compile_http_rules([as_spec(s, jh) for s in specs], 16)
    assert len(port.host_rules) == len(ref.host_rules) == 1
    assert_same_l7(port.tables, ref.tables)


@pytest.mark.parametrize("which", ["config4", "edge"])
def test_compile_kafka_rules_matches_reference(which):
    _need_jax()
    if which == "config4":
        specs, n = world.kafka_request_world(n=8).specs, 1024
    else:
        specs, n = _edge_kafka_specs(), 16
    port = tk.compile_kafka_rules(specs, n)
    ref = jk.compile_kafka_rules([as_spec(s, jk) for s in specs], n)
    assert_same_l7(port, ref)


def test_request_packers_match_reference():
    _need_jax()
    hw = world.http_request_world(n=8)
    reqs = hw.templates + [(b"GET" * 9, b"/x", b"")]  # an overflowed row
    for a, b in zip(th.pad_requests(reqs), jh.pad_requests(reqs)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    m, ml = th.pad_requests(reqs)[:2]
    np.testing.assert_array_equal(th.trim_packed(m, ml),
                                  jh.trim_packed(m, ml))
    specs = _edge_kafka_specs()
    tt = tk.compile_kafka_rules(specs, 16)
    jt = jk.compile_kafka_rules([as_spec(s, jk) for s in specs], 16)
    reqs, port_fields, *_ = _edge_kafka_requests(tt, tk.pad_kafka_requests)
    jreqs = [jk.KafkaRequest(**dataclasses.asdict(r)) for r in reqs]
    for a, b in zip(port_fields, jk.pad_kafka_requests(jt, jreqs)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    assert port_fields[-1].any()  # the nine-topic row overflowed


def test_host_oracles_match_reference():
    _need_jax()
    hw = world.http_request_world(n=8)
    jspecs = [as_spec(s, jh) for s in hw.specs]
    for m, p, h in hw.templates:
        for s, js in zip(hw.specs, jspecs):
            assert th.http_rule_matches_host(s, m, p, h) == \
                jh.http_rule_matches_host(js, m, p, h)
    kw = world.kafka_request_world(n=8)
    kspecs = [as_spec(s, jk) for s in kw.specs]
    for req in kw.templates:
        jreq = jk.KafkaRequest(**dataclasses.asdict(req))
        for idx in (None, 0, 17, 500):
            assert tk.matches_rules_host(req, kw.specs, idx) == \
                jk.matches_rules_host(jreq, kspecs, idx)


# -- device side: plain versions against the jitted reference ----------------


def _no_strided(tables):
    return dataclasses.replace(tables, method_sdfa=None, path_sdfa=None,
                               host_sdfa=None)


def _http_case(which):
    if which == "config3":
        hw = world.http_request_world(n=600)
        scope = np.random.default_rng(2).integers(
            0, 1 << 32, size=(600, 1), dtype=np.uint64).astype(np.uint32)
        return hw.specs, 1024, hw.fields, hw.ident, hw.known, scope
    fields, ident, known, scope = _edge_http_requests()
    return _edge_http_specs(), 16, fields, ident, known, scope


@pytest.mark.parametrize("branch", ["strided", "byte"])
@pytest.mark.parametrize("which", ["config3", "edge"])
def test_http_plain_matches_jax(branch, which):
    """Both branches, with and without scope bits, on port-compiled and
    carried-across tables."""
    _need_jax()
    specs, n, fields, ident, known, scope = _http_case(which)
    port = th.compile_http_rules(specs, n).tables
    ref = jh.compile_http_rules([as_spec(s, jh) for s in specs], n).tables
    if branch == "byte":
        port, ref = _no_strided(port), _no_strided(ref)
    assert (port.path_sdfa is None) == (branch == "byte")
    sources = {
        "port": convert.l7_tables_to(port, "cpu"),
        "convert": convert.http_tables_from_numpy(l7_leaves(ref), "cpu"),
    }
    for use_scope in (False, True):
        jfn = jax.jit(lambda *a, s=use_scope: jh.evaluate_http_batch(
            ref, *a[:8], scope_bits=a[8] if s else None))
        want_ok, want_m = jfn(*fields, ident, known, scope)
        args = as_torch((*fields, ident, known, scope))
        for name, tables in sources.items():
            ok, matched = th.evaluate_http_batch(
                tables, *args[:8], scope_bits=args[8] if use_scope else None)
            where = (branch, which, use_scope, name)
            np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok),
                                          err_msg=str(where))
            np.testing.assert_array_equal(
                matched.numpy().view(np.uint32), np.asarray(want_m),
                err_msg=str(where))
        assert 0 < int(ok.sum()) < len(ident)


@pytest.mark.parametrize("which", ["config4", "edge"])
def test_kafka_plain_matches_jax(which):
    """With and without scope bits, on port-compiled and carried-across
    tables."""
    _need_jax()
    if which == "config4":
        kw = world.kafka_request_world(n=600)
        specs, n, fields, ident, known = (kw.specs, 1024, kw.fields,
                                          kw.ident, kw.known)
        scope = np.random.default_rng(3).integers(
            0, 1 << 32, size=(600, 1), dtype=np.uint64).astype(np.uint32)
    else:
        specs, n = _edge_kafka_specs(), 16
        tt = tk.compile_kafka_rules(specs, n)
        _, fields, ident, known, scope = _edge_kafka_requests(
            tt, tk.pad_kafka_requests)
    port = tk.compile_kafka_rules(specs, n)
    ref = jk.compile_kafka_rules([as_spec(s, jk) for s in specs], n)
    sources = {
        "port": convert.l7_tables_to(port, "cpu"),
        "convert": convert.kafka_tables_from_numpy(l7_leaves(ref), "cpu"),
    }
    for use_scope in (False, True):
        jfn = jax.jit(lambda *a, s=use_scope: jk.evaluate_kafka_batch(
            ref, *a[:10], scope_bits=a[10] if s else None))
        want = np.asarray(jfn(*fields, ident, known, scope))
        args = as_torch((*fields, ident, known, scope))
        for name, tables in sources.items():
            got = tk.evaluate_kafka_batch(
                tables, *args[:10], scope_bits=args[10] if use_scope else None)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=str((which, use_scope, name)))
        assert 0 < int(want.sum()) < len(ident)


def test_entry_points_refuse_other_devices():
    tables = convert.l7_tables_to(
        th.compile_http_rules(_edge_http_specs(), 16).tables, "cpu")
    fields, ident, known, _ = _edge_http_requests()
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (*fields, ident, known)]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        th.evaluate_http_batch(tables, *meta)


# -- the kernels on the card ---------------------------------------------------


def _card_http_cases():
    hw = world.http_request_world(n=1 << 16)
    yield "config3", hw.specs, 1024, hw.fields, hw.ident, hw.known
    fields, ident, known, _ = _edge_http_requests()
    yield "edge", _edge_http_specs(), 16, fields, ident, known


@pytest.mark.cuda
def test_http_kernel_matches_plain():
    _need_card()
    from cilium_tpu_torch import kernels

    for which, specs, n, fields, ident, known in _card_http_cases():
        tables = convert.l7_tables_to(th.compile_http_rules(specs, n).tables,
                                        "cuda")
        b = len(ident)
        w = tables.n_words
        scope = torch.randint(-(1 << 31), 1 << 31, (b, w), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(4))
        args = [array_tensor(a, "cuda") for a in (*fields, ident, known)]
        for sb in (None, scope.cuda()):
            before = kernels.HTTP_MATCH.launches
            ok, matched = th.evaluate_http_batch(tables, *args, scope_bits=sb)
            pok, pm = th.evaluate_http_batch_plain(tables, *args,
                                                   scope_bits=sb)
            torch.cuda.synchronize()
            assert kernels.HTTP_MATCH.launches == before + 1
            assert torch.equal(ok, pok), which
            assert torch.equal(matched, pm), which
            assert 0 < int(ok.sum()) < b


@pytest.mark.cuda
def test_kafka_kernel_matches_plain():
    _need_card()
    from cilium_tpu_torch import kernels

    kw = world.kafka_request_world(n=1 << 16)
    cases = [("config4", kw.policy, kw.fields, kw.ident, kw.known)]
    et = tk.compile_kafka_rules(_edge_kafka_specs(), 16)
    _, fields, ident, known, _ = _edge_kafka_requests(
        et, tk.pad_kafka_requests)
    cases.append(("edge", et, fields, ident, known))
    for which, host, fields, ident, known in cases:
        tables = convert.l7_tables_to(host, "cuda")
        b = len(ident)
        w = int(tables.ident_rules.shape[1])
        scope = torch.randint(-(1 << 31), 1 << 31, (b, w), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(5))
        args = [array_tensor(a, "cuda") for a in (*fields, ident, known)]
        for sb in (None, scope.cuda()):
            before = kernels.KAFKA_MATCH.launches
            ok = tk.evaluate_kafka_batch(tables, *args, scope_bits=sb)
            pok = tk.evaluate_kafka_batch_plain(tables, *args, scope_bits=sb)
            torch.cuda.synchronize()
            assert kernels.KAFKA_MATCH.launches == before + 1
            assert torch.equal(ok, pok), which
            assert 0 < int(ok.sum()) < b


@pytest.mark.cuda
def test_l7_kernels_refuse_what_they_do_not_take():
    _need_card()
    from cilium_tpu_torch import kernels

    host = th.compile_http_rules(_edge_http_specs(), 16).tables
    tables = convert.l7_tables_to(host, "cuda")
    fields, ident, known, _ = _edge_http_requests()
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (*fields, ident, known)]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.HTTP_MATCH(tables, *args)
    cuda_args = [a.cuda() for a in args]
    bad = list(cuda_args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        kernels.HTTP_MATCH(tables, *bad)
    # a path DFA of 60,000 states does not fit one block's shared memory
    w = tables.n_words
    big = dataclasses.replace(
        tables, path_dfa=dataclasses.replace(
            tables.path_dfa,
            trans=torch.zeros((60_000, 2), dtype=torch.int32, device="cuda"),
            accept=torch.zeros((60_000, w), dtype=torch.int32, device="cuda"),
        ))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.HTTP_MATCH(big, *cuda_args)
