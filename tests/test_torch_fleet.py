"""The PyTorch port's fleet-scoped L7 matchers and its combined
datapath + proxy step against the JAX package, on the CPU, with
tolerance 0:

  * a small daemon world (as tests/test_l7_fleet.py builds): the port's
    compile_fleet_from_specs, fed the JAX fleet's deduped specs and
    parser kinds, gives leaves equal to JAX compile_fleet_l7's, and the
    port's evaluate_fleet_l7 equals the JAX one on port-compiled and
    carried-across tables;
  * the port's config-5 world (SMALL): its fleet equals the JAX
    compilers' on the same specs, and one combined step equals a
    reference composed here from the JAX _datapath_core (both
    direction-specialised halves), the stable argsort compaction and
    JAX evaluate_fleet_l7, on the same picks: the headers, the per-row
    L7 verdicts, the compacted order and the counters, with a cap above
    and a cap below the redirected count.

The `cuda`-marked tests hold FLEET_L7 and the combined step against
their plain versions on the card; they need no JAX and skip here.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.l7 import combined as tc
from cilium_tpu_torch.l7 import fleet as tf
from cilium_tpu_torch.l7 import http as th
from cilium_tpu_torch.l7 import kafka as tk

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.l7 import fleet as jf
    from cilium_tpu.l7 import http as jh
    from cilium_tpu.l7 import kafka as jk
    from torch_parity import (
        as_torch,
        assert_same_l7,
        jax_host_tables,
        as_spec,
        l7_leaves,
    )
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


# -- a small daemon world -------------------------------------------------------


def _daemon_fleet():
    """Three endpoints and three teams; HTTP filters on 8080 at web and
    api, Kafka filters on 9092 at web and db.  Returns (daemon, JAX
    fleet, {name: endpoint index}, {team: identity index}, slots)."""
    from cilium_tpu.daemon import Daemon
    from cilium_tpu.labels import Label, Labels
    from cilium_tpu.policy.api import (
        EndpointSelector,
        IngressRule,
        PortProtocol,
        PortRule,
        Rule,
    )
    from cilium_tpu.policy.api.rule import L7Rules, PortRuleHTTP, PortRuleKafka

    def rule(app, team, port, l7):
        return Rule(
            endpoint_selector=EndpointSelector(match_labels={"k8s.app": app}),
            ingress=[IngressRule(
                from_endpoints=[EndpointSelector(
                    match_labels={"k8s.team": team})],
                to_ports=[PortRule(
                    ports=[PortProtocol(port=str(port), protocol="TCP")],
                    rules=l7,
                )],
            )],
        )

    d = Daemon(num_workers=2)
    d.policy_trigger.close(wait=True)
    for i, app in enumerate(("web", "api", "db")):
        d.create_endpoint(100 + i, Labels({"app": Label("app", app, "k8s")}),
                          ipv4=f"10.7.0.{i + 1}", name=app)
    idents = {}
    for team in ("alpha", "beta", "gamma"):
        ident, _ = d.identity_allocator.allocate(
            Labels({"team": Label("team", team, "k8s")}))
        idents[team] = ident
    http = lambda path, method="GET": L7Rules(  # noqa: E731
        http=[PortRuleHTTP(method=method, path=path)])
    kafka = lambda **kw: L7Rules(kafka=[PortRuleKafka(**kw)])  # noqa: E731
    d.policy_add([
        rule("web", "alpha", 8080, http("/web/[a-z]+")),
        rule("web", "beta", 8080, http("/web/[0-9]+", "GET|POST")),
        rule("api", "alpha", 8080, http("/api/[0-9]+")),
        rule("api", "gamma", 8080, http("/api/v[12]/.*")),
        rule("web", "beta", 9092, kafka(topic="orders")),
        rule("db", "gamma", 9092, kafka(topic="logs", api_key="produce")),
        rule("db", "alpha", 9092, kafka(api_key="fetch")),
    ])
    d.regenerate_all("fleet l7 parity test")
    fleet = jf.compile_fleet_l7(d)
    _, tables, ep_index = d.endpoint_manager.published()
    id_index, n_ident = d.endpoint_manager.identity_index()
    eps = {app: ep_index[100 + i] for i, app in enumerate(("web", "api", "db"))}
    teams = {t: id_index[ident.id] for t, ident in idents.items()}
    slots = (int(tables.port_slot[6, 8080]), int(tables.port_slot[6, 9092]))
    return d, fleet, n_ident, eps, teams, slots


def _port_fleet_from_jax(fleet, n_ident):
    http_specs = [as_spec(s, th) for s in fleet.http.device_rules]
    kafka_specs = [as_spec(s, tk) for s in fleet.kafka.specs]
    return tf.compile_fleet_from_specs(http_specs, kafka_specs,
                                       fleet.parser_kind, n_ident)


def _fleet_batch(eps, teams, slots, kg, port_kafka, jax_kafka):
    """A batch over every (endpoint, slot) scope, the unknown-parser
    scopes, slots out of range and identities out of range, with HTTP
    and Kafka fields on every row (each row's parser picks)."""
    rng = np.random.default_rng(11)
    paths = [b"/web/abc", b"/web/123", b"/api/42", b"/api/v2/x", b"/api/v3/",
             b"/web/", b"/other"]
    topics = [("orders",), ("logs",), ("orders", "logs"), (), ("nope",)]
    b = 256
    reqs, kreqs = [], []
    for _ in range(b):
        reqs.append((bytes(rng.choice([b"GET", b"POST", b"PUT"])),
                     bytes(rng.choice(paths)), b""))
        kreqs.append(dict(kind=int(rng.choice([0, 1, 3])), version=0,
                          client_id="c", topics=topics[rng.integers(0, 5)],
                          parsed=bool(rng.random() < 0.9)))
    hf = th.pad_requests(reqs, lm=8, lp=16, lh=8)[:6]
    kf = tk.pad_kafka_requests(port_kafka, [tk.KafkaRequest(**r)
                                            for r in kreqs])
    jkf = jk.pad_kafka_requests(jax_kafka, [jk.KafkaRequest(**r)
                                            for r in kreqs])
    for a, c in zip(kf, jkf):
        np.testing.assert_array_equal(a, c)
    ep = rng.choice(list(eps.values()), size=b).astype(np.int32)
    direction = (rng.random(b) < 0.1).astype(np.int32)
    slot = rng.choice(list(slots) + [0, -1, kg + 5], size=b).astype(np.int32)
    ident = rng.choice(list(teams.values()) + [0, -2, 10_000],
                       size=b).astype(np.int32)
    known = rng.random(b) < 0.9
    return (ep, direction, slot, ident, known), hf, tuple(
        np.asarray(a) for a in kf)


def test_fleet_compile_matches_jax_daemon_world():
    _need_jax()
    _, fleet, n_ident, *_ = _daemon_fleet()
    port = _port_fleet_from_jax(fleet, n_ident)
    assert fleet.http is not None and fleet.kafka is not None
    assert_same_l7(port.http.tables, fleet.http.tables, "http")
    assert_same_l7(port.kafka, fleet.kafka, "kafka")
    for leaf in ("scope_http", "scope_kafka", "parser_kind"):
        assert_same_l7(getattr(port, leaf), getattr(fleet, leaf), leaf)


@pytest.mark.parametrize("fields", ["both", "http only", "kafka only"])
def test_fleet_plain_matches_jax(fields):
    """Port-compiled and carried-across fleets against JAX
    evaluate_fleet_l7; without a parser's fields its rows stay denied."""
    _need_jax()
    _, fleet, n_ident, eps, teams, slots = _daemon_fleet()
    port = _port_fleet_from_jax(fleet, n_ident)
    kg = fleet.parser_kind.shape[2]
    cols, hf, kf = _fleet_batch(eps, teams, slots, kg, port.kafka,
                                fleet.kafka)
    use_h = fields != "kafka only"
    use_k = fields != "http only"
    want = np.asarray(jax.jit(lambda *a: jf.evaluate_fleet_l7(
        fleet, *a[:5],
        http_fields=a[5:11] if use_h else None,
        kafka_fields=a[11:] if use_k else None,
    ))(*cols, *hf, *kf))
    assert 0 < want.sum() < len(want)
    sources = {
        "port": convert.l7_tables_to(port, "cpu"),
        "convert": convert.fleet_from_numpy(l7_leaves(fleet), "cpu"),
    }
    args = as_torch((*cols, *hf, *kf))
    for name, fl in sources.items():
        got = tf.evaluate_fleet_l7(
            fl, *args[:5],
            http_fields=args[5:11] if use_h else None,
            kafka_fields=args[11:] if use_k else None,
        )
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{fields} {name}")


# -- the config-5 world and the combined step ----------------------------------


def _small_world(seed):
    w = world.make_world(seed=seed, **SMALL)
    wide = w.host_tables()
    fleet = world.l7_fleet(w, wide.policy)
    return w, wide, fleet


def test_world_fleet_matches_jax_compilers():
    """The config-5 world's fleet: both parsers present, and the tables
    equal the JAX compilers' on the same deduped specs."""
    _need_jax()
    w, wide, fleet = _small_world(1)
    assert fleet.http is not None and fleet.kafka is not None
    n = int(wide.policy.id_table.shape[0])
    jhttp = jh.compile_http_rules(
        [as_spec(s, jh) for s in fleet.http.device_rules], n)
    jkafka = jk.compile_kafka_rules(
        [as_spec(s, jk) for s in fleet.kafka.specs], n)
    assert_same_l7(fleet.http.tables, jhttp.tables, "http")
    assert_same_l7(fleet.kafka, jkafka, "kafka")
    # every rule's scope bit sits at its own (endpoint, INGRESS, slot)
    for rules, table in ((fleet.http.device_rules, fleet.scope_http),
                         (fleet.kafka.specs, fleet.scope_kafka)):
        for r, spec in enumerate(rules):
            assert table[spec.scope_key][r // 32] >> (r % 32) & 1
        assert sum(bin(int(v)).count("1") for v in table.reshape(-1)) == \
            len(rules)


def _jax_combined(jt, jfleet, pool, hf, kf, picks, cap):
    """The reference combined step, composed from the JAX package as
    bench.py's _combined_step_fn composes it, on the given picks."""
    from cilium_tpu.engine.datapath import _datapath_core, flow_batch_from_packed
    from cilium_tpu.engine.verdict import make_counter_buffers
    from cilium_tpu.replay import pack_flow_pool

    pool_dev = jnp.asarray(pack_flow_pool(pool))
    hp = tuple(jnp.asarray(a) for a in hf)
    kp = tuple(jnp.asarray(a) for a in kf)

    def half(tables, picks, acc, static_direction):
        flows = flow_batch_from_packed(pool_dev[:, picks])
        out, acc = _datapath_core(
            tables, flows, with_counters=True, acc=acc, emit_sec_id=False,
            static_direction=static_direction,
        )
        b = picks.shape[0]
        redirected = (out.proxy_port > 0) & out.allowed.astype(bool)
        row_id = jnp.arange(b, dtype=jnp.int32)
        order = jnp.argsort(jnp.where(redirected, row_id, jnp.int32(b)))[:cap]
        valid = redirected[order]
        rows_pool = picks[order]
        l7_ok = jf.evaluate_fleet_l7(
            jfleet, flows.ep_index[order], flows.direction[order],
            out.l4_slot[order], out.sec_id[order].astype(jnp.int32),
            jnp.ones(order.shape, bool),
            http_fields=tuple(a[rows_pool] for a in hp),
            kafka_fields=tuple(a[rows_pool] for a in kp),
        ) & valid
        n_redirected = redirected.sum(dtype=jnp.uint32)
        overflow = n_redirected - valid.sum(dtype=jnp.uint32)
        l7_allowed = l7_ok.sum(dtype=jnp.uint32)
        combined = (out.allowed.astype(jnp.uint32).sum(dtype=jnp.uint32)
                    - n_redirected + l7_allowed)
        header = jnp.stack([combined, n_redirected, l7_allowed, overflow])
        return header, l7_ok, order, acc

    acc = jnp.asarray(make_counter_buffers(jt.policy))
    outs = []
    for d in (0, 1):
        step = jax.jit(lambda t, p, a, d=d: half(t, p, a, d))
        header, l7, order, acc = step(jt, jnp.asarray(picks[d]), acc)
        outs.append((np.asarray(header), np.asarray(l7), np.asarray(order)))
    return outs, np.asarray(acc)


@pytest.mark.parametrize("cap", [1024, 48])
def test_combined_step_matches_jax(cap):
    """One combined step on the port's config-5 world (SMALL) against
    the composed JAX reference on the same picks; cap 48 is below the
    redirected count, so which rows reach L7 depends on the order and
    the header's overflow counts the rest."""
    _need_jax()
    w, wide, fleet = _small_world(2)
    _, _, hf, kf = world.l7_payloads(w, fleet)
    jt = jax_host_tables(w, subword=True)
    n = int(wide.policy.id_table.shape[0])
    jfleet = jf.FleetL7(
        http=jh.compile_http_rules(
            [as_spec(s, jh) for s in fleet.http.device_rules], n),
        kafka=jk.compile_kafka_rules(
            [as_spec(s, jk) for s in fleet.kafka.specs], n),
        scope_http=fleet.scope_http, scope_kafka=fleet.scope_kafka,
        parser_kind=fleet.parser_kind,
    )
    rng = np.random.default_rng(21)
    b = 1024
    picks = np.stack([
        rng.choice(np.nonzero(w.pool["direction"] == d)[0], size=b)
        for d in (0, 1)
    ])
    want, want_acc = _jax_combined(jt, jfleet, w.pool, hf, kf, picks, cap)

    tables = convert.tables_to(world.headline_tables(w, wide), "cpu")
    acc = tv.make_counter_buffers(tables.policy)
    tel = tv.make_telemetry_buffers("cpu")
    out = tc.combined_step(
        tables, convert.l7_tables_to(fleet, "cpu"),
        tc.pool_to(w.pool, hf, kf, "cpu"), torch.from_numpy(picks), acc, tel,
        cap=cap,
    )
    header = out.header.numpy().view(np.uint32)
    for d, (wh, wl, wo) in enumerate(want):
        np.testing.assert_array_equal(header[d], wh, err_msg=f"half {d}")
        np.testing.assert_array_equal(out.l7_allowed[d].numpy(), wl)
        np.testing.assert_array_equal(out.order[d].numpy(), wo)
    np.testing.assert_array_equal(acc.numpy().view(np.uint32), want_acc)
    redirected, l7_allowed, overflow = header[0, 1:]
    assert 0 < l7_allowed < redirected
    assert (overflow > 0) == (cap < redirected)
    # redirected rows reached both parsers' scopes
    k = min(cap, int(redirected))
    ports = w.pool["dport"][picks[0][out.order[0].numpy()[:k]]]
    assert (ports < 9000).any() and (ports >= 9000).any()


# -- the kernels on the card ---------------------------------------------------


@pytest.mark.cuda
def test_fleet_and_combined_kernels_match_plain():
    _need_card()
    from cilium_tpu_torch import kernels

    w, wide, fleet = _small_world(2)
    _, _, hf, kf = world.l7_payloads(w, fleet)
    tables = convert.tables_to(world.headline_tables(w, wide), "cuda")
    fd = convert.l7_tables_to(fleet, "cuda")
    pool = tc.pool_to(w.pool, hf, kf, "cuda")
    rng = np.random.default_rng(22)
    picks = torch.from_numpy(np.stack([
        rng.choice(np.nonzero(w.pool["direction"] == d)[0], size=1 << 15)
        for d in (0, 1)
    ])).cuda()
    for cap in (1 << 14, 300):
        accs = [tv.make_counter_buffers(tables.policy) for _ in range(2)]
        tels = [tv.make_telemetry_buffers("cuda") for _ in range(2)]
        before = kernels.FLEET_L7.launches
        got = tc.combined_step(tables, fd, pool, picks, accs[0], tels[0],
                               cap=cap)
        want = tc.combined_step_plain(tables, fd, pool, picks, accs[1],
                                      tels[1], cap=cap)
        torch.cuda.synchronize()
        assert kernels.FLEET_L7.launches == before + 1
        assert torch.equal(got.header, want.header)
        assert torch.equal(got.l7_allowed, want.l7_allowed)
        assert torch.equal(got.order, want.order)
        assert torch.equal(accs[0], accs[1]) and torch.equal(tels[0], tels[1])
        h = got.header.cpu().numpy().view(np.uint32)
        assert 0 < h[0, 2] < h[0, 1]
        assert (h[0, 3] > 0) == (cap < h[0, 1])
