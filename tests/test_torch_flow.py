"""The PyTorch port's flow-observability plane on the CPU against the JAX
package's, with the recipes of tests/test_flow_store.py,
tests/test_flow_tail.py and tests/test_telemetry.py:

  * `FlowStore`: the ring's sequence numbers and eviction, filters from
    query params, `query(last=, after_seq=)`, `wait_for_flows` and
    `summary`, driven by the same records in both packages;
  * `capture_batch`: classification, allow sampling, the drop-storm
    truncation, per-tuple chips, tenants, cache hits and shadow
    transition names, record by record (`asdict`);
  * `MonitorBus` and `verdicts_to_events`: the published events, the
    sampling cap, the queue bound's lost events and the metrics deltas;
    `dissect`'s renderings of a record buffer and of every event kind;
  * `fold_telemetry_per_chip` and `telemetry_consistent`;
  * `replay(flow_store=...)` on the SMALL world: both stores record by
    record at two MonitorAggregationLevels, with and without counters
    (tests/test_torch_replay.py checks the refusal in churn mode).

Records are compared field by field with the capture time left out
(`ts`, the wall clock of the call); everything else is exact."""

import dataclasses

import numpy as np
import pytest

from cilium_tpu_torch import convert, option as topt, world
from cilium_tpu_torch import replay as trp
from cilium_tpu_torch import telemetry as ttel
from cilium_tpu_torch.engine.verdict import TELEM_COLS
from cilium_tpu_torch.flow import capture as tcap
from cilium_tpu_torch.flow import store as tstore
from cilium_tpu_torch.metrics import Registry as TRegistry
from cilium_tpu_torch.monitor import bus as tbus
from cilium_tpu_torch.monitor import dissect as tdis
from cilium_tpu_torch.native.loader import encode_flow_records

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax  # noqa: F401

    from cilium_tpu import option as jopt
    from cilium_tpu import replay as jrp
    from cilium_tpu import telemetry as jtel
    from cilium_tpu.flow import capture as jcap
    from cilium_tpu.flow import store as jstore
    from cilium_tpu.metrics import Registry as JRegistry
    from cilium_tpu.monitor import bus as jbus
    from cilium_tpu.monitor import dissect as jdis
    from torch_parity import jax_host_tables
except ImportError:  # the card's machine has no JAX
    jax = None


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _records(store):
    out = []
    for r in store.snapshot():
        d = dataclasses.asdict(r)
        d.pop("ts")
        out.append(d)
    return out


def _make(mod, i, verdict=None):
    return mod.FlowRecord(
        ts=1000.0 + i, chip=i % 3, ep_id=10 + i % 4, src_identity=256 + i,
        dst_identity=300 + i % 5, dport=(80, 443, 53)[i % 3],
        proto=(6, 17)[i % 2], direction=i % 2,
        verdict=verdict or (mod.VERDICT_DROPPED if i % 3 == 0
                            else mod.VERDICT_FORWARDED),
        match_kind=i % 5,
        drop_reason="Policy denied (L3)" if i % 3 == 0 else "",
        trace_id="ab" * 16 if i % 7 == 0 else "", cache_hit=i % 4 == 0,
        tenant=("team-a", "team-b", "")[i % 3],
        diff_status=("", "allow_to_deny")[i % 2],
    )


PARAMS = (
    {}, {"verdict": "dropped"}, {"drop-reason": "Policy denied (L3)"},
    {"identity": "260"}, {"ep": "11", "port": "443"}, {"proto": "udp"},
    {"direction": "egress"}, {"since": "1010"}, {"chip": "2"},
    {"trace-id": "AB" * 16}, {"cache-hit": "yes"}, {"tenant": "team-b"},
    {"diff-status": "any"}, {"diff-status": "allow-to-deny"},
)


def _store_run(mod):
    s = mod.FlowStore(capacity=16)
    s.extend(_make(mod, i) for i in range(10))
    s.append(_make(mod, 10))
    s.extend(_make(mod, i) for i in range(11, 25))
    views = [(s.last_seq, len(s), s.evicted, s.captured_total)]
    for params in PARAMS:
        flt = mod.FlowFilter.from_params(params)
        views.append([r.seq for r in s.query(flt)])
    views.append([r.seq for r in s.query(last=3)])
    views.append([r.seq for r in s.query(after_seq=20)])
    views.append([r.seq for r in s.query(after_seq=2, last=0)])
    views.append([r.seq for r in s.wait_for_flows(22, 0.01)])
    views.append(s.wait_for_flows(s.last_seq, 0.01))
    views.append(s.summary(top=3))
    views.append(_make(mod, 3).to_dict())
    s.charge_evicted(5)
    s.clear()
    views.append((len(s), s.evicted))
    for bad in ({"verdict": "maybe"}, {"direction": "up"}, {"nope": "1"},
                {"proto": "xyz"}):
        with pytest.raises(ValueError):
            mod.FlowFilter.from_params(bad)
    return views


def test_flow_store_matches_jax():
    _need_jax()
    assert _store_run(tstore) == _store_run(jstore)


def _capture_columns(rng, b):
    allowed = rng.integers(0, 2, b).astype(np.uint8)
    kind = np.where(allowed, rng.choice([1, 2, 3], b),
                    rng.choice([0, 4], b)).astype(np.uint8)
    return dict(
        ep_ids=rng.integers(0, 8, b), src_identities=rng.integers(0, 999, b),
        dst_identities=rng.integers(0, 999, b),
        dports=rng.choice([53, 80, 443], b), protos=rng.choice([6, 17], b),
        directions=rng.integers(0, 2, b), allowed=allowed, match_kind=kind,
        proxy_port=np.where(rng.random(b) < 0.2, 10001, 0).astype(np.int32),
        pre_dropped=(~allowed.astype(bool)) & (rng.random(b) < 0.3),
        ct_result=rng.integers(0, 3, b).astype(np.uint8),
        ct_delete=rng.random(b) < 0.1, lb_slave=rng.integers(0, 3, b),
        ipcache_miss=rng.random(b) < 0.2,
    )


def _capture_run(cap, store_mod, registry):
    rng = np.random.default_rng(7)
    s = store_mod.FlowStore(capacity=200)
    n = []
    cols = _capture_columns(rng, 256)
    n.append(cap.capture_batch(s, **cols, allow_sample=0, now=1.0,
                               metrics_registry=registry))
    cols = _capture_columns(rng, 128)
    n.append(cap.capture_batch(
        s, **cols, allow_sample=5, chip=rng.integers(0, 4, 128), now=2.0,
        trace_id="cd" * 16, cache_hit=rng.random(128) < 0.5,
        tenant=np.array(["a", "b"] * 64, dtype=object),
        diff_status=rng.integers(0, 4, 128).astype(np.uint8),
        metrics_registry=registry))
    early = _records(s)
    cols = _capture_columns(rng, 900)  # more drops than the ring holds
    cols["allowed"][:] = 0
    cols["match_kind"][:] = 0
    n.append(cap.capture_batch(s, **cols, allow_sample=None, now=3.0,
                               tenant="c", metrics_registry=registry))
    only = {k: cols[k] for k in ("ep_ids", "src_identities",
                                 "dst_identities", "dports", "protos",
                                 "directions", "allowed", "match_kind")}
    n.append(cap.capture_batch(s, **only, now=4.0))
    levels = [cap.allow_sample_for_level(v) for v in range(6)]
    return (n, early, _records(s), s.evicted, levels,
            cap.chip_of_rows(10, 3).tolist(), cap.chip_of_rows(5, 1).tolist(),
            registry.flow_records_captured_total.get("DROPPED"),
            registry.flow_records_captured_total.get("FORWARDED"),
            registry.flow_store_evicted.get())


def test_capture_batch_matches_jax():
    _need_jax()
    got = _capture_run(tcap, tstore, TRegistry())
    want = _capture_run(jcap, jstore, JRegistry())
    assert got == want
    reasons = {r["drop_reason"] for r in got[1]}
    assert {"Policy denied (CIDR)", "Policy denied (L3)",
            "Fragmentation needed"} <= reasons
    assert {r["diff_status"] for r in got[1]} > {""}
    assert got[3] > 0 and len(got[2]) == 200


def _bus_run(bus_mod, registry):
    from types import SimpleNamespace

    rng = np.random.default_rng(5)
    n = 300
    v = SimpleNamespace(
        allowed=rng.integers(0, 2, n).astype(np.uint8),
        match_kind=rng.integers(0, 5, n).astype(np.uint8),
        proxy_port=np.where(rng.random(n) < 0.3, 10001, 0).astype(np.int32),
    )
    cols = dict(ep_ids=rng.integers(0, 6, n),
                identities=rng.integers(256, 999, n).astype(np.uint32),
                dports=rng.choice([53, 80], n), protos=rng.choice([6, 17], n),
                directions=rng.integers(0, 2, n))
    bus = bus_mod.MonitorBus(queue_size=128)
    q = bus.subscribe_queue()
    seen = []
    bus.subscribe(lambda ev: seen.append(dataclasses.asdict(ev)))
    counts = [
        bus_mod.verdicts_to_events(bus, v, **cols, metrics_registry=registry),
        bus_mod.verdicts_to_events(bus, v, **cols, emit_allowed=True,
                                   sample=50, metrics_registry=registry),
        bus_mod.verdicts_to_events(bus, v, **cols, verdict_eps={2, 3},
                                   emit_drops=False, emit_trace=True,
                                   metrics_registry=registry),
    ]
    out = [counts, seen, [dataclasses.asdict(e) for e in q], bus.lost_events,
           bus.queue_drops(q), bus.queue_drops(q, reset=True),
           bus.queue_drops(q), bus.wait_for_events(q, 0.01)]
    q.clear()
    out.append(bus.wait_for_events(q, 0.01))
    out.append((bus.unsubscribe_queue(q), bus.unsubscribe_queue(q)))
    out.append({name: dict(getattr(registry, name)._values)
                for name in ("forward_count", "drop_count",
                             "policy_verdict_total")})
    return out


def test_monitor_bus_matches_jax():
    _need_jax()
    got = _bus_run(tbus, TRegistry())
    want = _bus_run(jbus, JRegistry())
    assert got == want
    assert got[3] > 0 and {e["type"] for e in got[1]} >= {1, 4, 7}


def test_dissect_matches_jax():
    _need_jax()
    rng = np.random.default_rng(2)
    n = 40
    buf = encode_flow_records(
        ep_id=rng.integers(0, 9, n), identity=rng.integers(0, 999, n),
        saddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        daddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        sport=rng.integers(0, 65536, n), dport=rng.integers(0, 65536, n),
        proto=rng.choice([1, 6, 17, 58, 132], n),
        direction=rng.integers(0, 2, n), is_fragment=np.zeros(n, np.uint8))
    assert list(tdis.dissect_flow_buffer(buf)) == list(
        jdis.dissect_flow_buffer(buf))
    events = [
        {"event": "DropNotify", "reason": 133, "source": 7, "src_label": 9},
        {"event": "DropNotify", "reason": -157},
        {"event": "TraceNotify", "dst_id": 3, "source": 0, "src_label": 5},
        {"event": "PolicyVerdictNotify", "allowed": True, "ingress": False,
         "source": 4, "src_label": 2, "dport": 80, "proto": 6,
         "proxy_port": 10001},
        {"event": "PolicyVerdictNotify", "proto": 17},
        {"event": "LogRecordNotify", "l7_proto": "http", "verdict": "Denied",
         "info": "GET /"},
        {"event": "AgentNotify", "text": "policy updated"},
        {"event": "Other", "x": 1}, {},
    ]
    assert tdis.dissect_events(events) == jdis.dissect_events(events)
    with pytest.raises(ValueError):
        list(tdis.dissect_flow_buffer(buf[:-3]))


def test_telemetry_per_chip_fold_matches_jax():
    _need_jax()
    rng = np.random.default_rng(4)
    per_chip = rng.integers(0, 50, (1, 2, TELEM_COLS)).astype(np.uint64)
    regs = (TRegistry(), JRegistry())
    got = ttel.fold_telemetry_per_chip(per_chip, registry=regs[0])
    want = jtel.fold_telemetry_per_chip(per_chip, registry=regs[1])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.uint64
    for name in ("telemetry_per_chip", "forward_count", "drop_count",
                 "policy_verdict_total", "datapath_stage_total"):
        assert dict(getattr(regs[0], name)._values) == dict(
            getattr(regs[1], name)._values), name
    for t in (per_chip[0], _consistent(rng)):
        assert ttel.telemetry_consistent(t) == jtel.telemetry_consistent(t)
    assert ttel.telemetry_consistent(_consistent(rng))
    assert not ttel.telemetry_consistent(per_chip[0])


def _consistent(rng):
    """A histogram whose outcomes, drops and CT results partition it."""
    from cilium_tpu_torch.engine import verdict as tv

    t = np.zeros((2, TELEM_COLS), np.uint64)
    for d in (0, 1):
        fwd, pre, pol, frag = (int(x) for x in rng.integers(0, 20, 4))
        total = fwd + pre + pol + frag
        t[d, tv.TELEM_TOTAL] = total
        t[d, tv.TELEM_FORWARDED] = fwd
        t[d, tv.TELEM_DENIED] = pre + pol + frag
        t[d, tv.TELEM_DROP_PREFILTER] = pre
        t[d, tv.TELEM_DROP_POLICY] = pol
        t[d, tv.TELEM_DROP_FRAG] = frag
        t[d, tv.TELEM_CT_NEW] = total
    return t


@pytest.fixture(scope="module")
def replay_world():
    _need_jax()
    from test_torch_replay import _records

    w = world.make_world(seed=1, **SMALL)
    jt = jax_host_tables(w, subword=False)
    tt = convert.tables_to(w.host_tables(), "cpu")
    return w, jt, tt, _records


@pytest.mark.parametrize("level,counters", [
    (topt.MONITOR_AGG_NONE, True), (topt.MONITOR_AGG_MEDIUM, True),
    (topt.MONITOR_AGG_MEDIUM, False)])
def test_replay_flow_store_matches_jax(replay_world, level, counters):
    """700 records in batches of 128 (a partial tail, unknown endpoint
    ids, directions 2 and 255) through both replays with a store: the
    same records in the same order, every drop among them."""
    w, jt, tt, records = replay_world
    buf, ep_map = records(w)
    saved = (topt.Config.opts.get(topt.MONITOR_AGGREGATION),
             jopt.Config.opts.get(jopt.MONITOR_AGGREGATION))
    topt.Config.opts[topt.MONITOR_AGGREGATION] = level
    jopt.Config.opts[jopt.MONITOR_AGGREGATION] = level
    try:
        js = jstore.FlowStore()
        jstats, _, _ = jrp.replay(jt, buf, batch_size=128, ep_map=ep_map,
                                  accumulate_counters=counters,
                                  flow_store=js, chip=1)
        ts = tstore.FlowStore()
        tstats, _, _ = trp.replay(tt, buf, batch_size=128, ep_map=ep_map,
                                  accumulate_counters=counters,
                                  flow_store=ts, chip=1, device="cpu")
    finally:
        topt.Config.opts[topt.MONITOR_AGGREGATION] = saved[0]
        jopt.Config.opts[jopt.MONITOR_AGGREGATION] = saved[1]
    got, want = _records(ts), _records(js)
    assert got == want
    assert (ts.captured_total, ts.evicted) == (js.captured_total, js.evicted)
    drops = [r for r in got if r["verdict"] == "DROPPED"]
    assert len(drops) == tstats.denied == jstats.denied > 0
    if level == topt.MONITOR_AGG_NONE:
        assert len(got) == tstats.total
    assert {r["ep_id"] for r in got} >= {100, 101}
    assert any(r["src_identity"] for r in got) and all(
        r["chip"] == 1 for r in got)
