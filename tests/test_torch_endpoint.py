"""The PyTorch port's map states from rules on the CPU against the JAX
package's: config 5's recipe (bench.py `build_config5`) at a small size
through the port's Daemon (world.rules_world, device "cpu") and through
the reference's own `build_config5`, from the same seed: the rules, the
map states endpoint by endpoint, the published tables leaf for leaf,
the LPMBuilder's tables, a one-rule update (its affected endpoints,
tables and `delta_for` rows, and the device epochs), the selector
cache and rule index, `diff_map_state` and `sync_map_arrays`, the
endpoint state matrix, a checkpoint the reference writes restored by
the port, `replay_lattice(manager=...)` and `replay(manager=...)` with
their stale-snapshot refusal, `sync_counters_to_endpoints`, the option
library, `policy_enforcement = "always"` (set in both packages and
restored), the structured logger, and the policy trace.  Every
comparison is exact.

Generation stamps carry a per-process compiler nonce in their high 32
bits, so stamps are compared by their low 32 bits.
"""

import argparse
import dataclasses
import itertools
import json

import numpy as np
import pytest

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler import selectorcache as tsc
from cilium_tpu_torch.endpoint import checkpoint as tckpt
from cilium_tpu_torch.endpoint import endpoint as tep
from cilium_tpu_torch.labels import Label, Labels
from cilium_tpu_torch.maps import policymap as tpm
from cilium_tpu_torch.policy import api as tapi
from cilium_tpu_torch.replay import (
    replay,
    replay_lattice,
    sync_counters_to_endpoints,
)

try:
    import bench
    from cilium_tpu.compiler import selectorcache as jsc
    from cilium_tpu.endpoint import checkpoint as jckpt
    from cilium_tpu.endpoint import endpoint as jep
    from cilium_tpu.maps import policymap as jpm
    from cilium_tpu.policy import api as japi
    from cilium_tpu import replay as jreplay
    from torch_parity import M32
    from torch_parity import assert_same_states as assert_states_equal
    from torch_parity import assert_same_tables_low32 as assert_tables_equal
except ImportError:  # the card's machine has no JAX
    bench = None

SMALL = dict(n_rules=600, n_endpoints=4, n_identities=256)


def _need_jax():
    if bench is None:
        pytest.skip("JAX is not installed")


def _worlds(seed: int = 5):
    """(reference daemon, port rules_world) of the same recipe."""
    _need_jax()
    args = argparse.Namespace(rules=SMALL["n_rules"],
                              endpoints=SMALL["n_endpoints"],
                              identities=SMALL["n_identities"], pool=1000)
    ref = bench.build_config5(args, np.random.default_rng(seed))[0]
    ref.policy_trigger.close(wait=True)
    rw = world.rules_world(seed=seed, device="cpu", **SMALL)
    return ref, rw


@pytest.fixture(scope="module")
def pair():
    return _worlds()


def test_build_rules_match_bench():
    _need_jax()
    a = bench.build_rules(np.random.default_rng(3), 300, 4, 16)
    b = world.build_rules(np.random.default_rng(3), 300, 4, 16)
    assert a[1] == b[1] and a[2] == b[2]
    assert [repr(r) for r in a[0]] == [repr(r) for r in b[0]]


def test_map_states_and_published_tables_match_reference(pair):
    ref, rw = pair
    v, tables, index, states = ref.endpoint_manager.published_with_states()
    assert v == rw.version and index == rw.index
    assert [e.id for e in ref.endpoint_manager.endpoints()] == [
        e.id for e in rw.daemon.endpoint_manager.endpoints()]
    for e_ref in ref.endpoint_manager.endpoints():
        e = rw.daemon.endpoint_manager.lookup(e_ref.id)
        assert_states_equal(e_ref.realized_map_state, e.realized_map_state)
        assert e_ref.realized_redirects == e.realized_redirects
        assert e_ref.state == e.state
        assert e_ref.policy_revision == e.policy_revision
    for a, b in zip(states, rw.states):
        assert_states_equal(a, b)
    assert_tables_equal(tables, rw.tables)
    # some L7 keys carry their allocated proxy ports
    assert any(int(s.proxy.max(initial=0)) > 0 for s in rw.states)
    assert sorted(ref.proxy.redirects) == sorted(rw.daemon.proxy.redirects)
    assert ref.prefix_lengths == rw.daemon.prefix_lengths
    assert {k: [str(lab) for lab in v] for k, v in ref.identity_cache().items()} \
        == {k: [str(lab) for lab in v]
            for k, v in rw.daemon.identity_cache().items()}


def test_lpm_builder_tables_match_reference(pair):
    ref, rw = pair
    assert ref.lpm_builder.mappings == rw.daemon.lpm_builder.mappings
    assert_tables_equal(ref.lpm_builder.tables(), rw.daemon.lpm_builder.tables())
    # the ipcache's own view: identities, prefix lengths, shadowing
    a, b = ref.ipcache, rw.daemon.ipcache
    assert a.ip_to_identity.keys() == b.ip_to_identity.keys()
    assert all(a.ip_to_identity[k].id == b.ip_to_identity[k].id
               and a.ip_to_identity[k].source == b.ip_to_identity[k].source
               for k in a.ip_to_identity)
    assert a.v4_prefix_lengths == b.v4_prefix_lengths


def _delta_rows(delta):
    return (
        delta.base_stamp & M32 if delta.base_stamp is not None else None,
        delta.new_stamp & M32,
        {k: (np.asarray(u.idx).tolist() if not isinstance(u.idx, tuple)
             else [np.asarray(i).tolist() for i in u.idx],
             np.asarray(u.values).astype(np.int64).tolist())
         for k, u in sorted(delta.updates.items())},
        sorted(delta.replace),
    )


def test_one_rule_update_matches_reference():
    """bench's incremental update: add_one_rule, a delta-scoped sweep,
    the new tables, delta_for's rows against the previous publish, and
    the device epochs (full, then a delta) against the host tables."""
    ref, rw = _worlds(7)
    d = rw.daemon
    ref_dev0 = ref.endpoint_manager.published_device()[1]
    dev0 = d.endpoint_manager.published_device()[1]
    assert_tables_equal(ref_dev0, dev0)
    assert d.endpoint_manager.last_publish_stats.mode == "full"
    for port in (4242, 4243):
        before_ref = {e.id: e.map_state_revision
                      for e in ref.endpoint_manager.endpoints()}
        before = {e.id: e.map_state_revision
                  for e in d.endpoint_manager.endpoints()}
        base_ref = int(np.asarray(ref.endpoint_manager.published()[1]
                                  .generation))
        base = int(np.asarray(d.endpoint_manager.published()[1].generation))
        bench.add_one_rule(ref, port, label_prefix="bench-incremental")
        world.add_one_rule(d, port, label_prefix="bench-incremental")
        assert ref.regenerate_all("incr") == d.regenerate_all("incr")
        changed_ref = {e.id for e in ref.endpoint_manager.endpoints()
                       if e.map_state_revision != before_ref[e.id]}
        changed = {e.id for e in d.endpoint_manager.endpoints()
                   if e.map_state_revision != before[e.id]}
        assert changed == changed_ref == {100}
        v_ref, t_ref, i_ref, s_ref = (
            ref.endpoint_manager.published_with_states())
        v, t, i, s = d.endpoint_manager.published_with_states()
        assert (v, i) == (v_ref, i_ref)
        assert_tables_equal(t_ref, t)
        for a, b in zip(s_ref, s):
            assert_states_equal(a, b)
        assert _delta_rows(ref.endpoint_manager.delta_for(base_ref, t_ref)) \
            == _delta_rows(d.endpoint_manager.delta_for(base, t))
        dev_ref = ref.endpoint_manager.published_device()[1]
        dev = d.endpoint_manager.published_device()[1]
        assert_tables_equal(dev_ref, dev)
        assert_tables_equal(t_ref, dev)
        assert d.endpoint_manager.last_publish_stats.mode == (
            ref.endpoint_manager.last_publish_stats.mode)
    assert d.endpoint_manager.last_publish_stats.mode == "delta"


def test_policy_delete_and_cidr_release_match_reference():
    ref, rw = _worlds(9)
    d = rw.daemon
    cidr_rule = next(r for r in rw.rules if r.ingress[0].from_cidr_set)
    for daemon in (ref, d):
        rev, n = daemon.policy_delete(
            type(daemon.repo.rules[0].rule.labels).parse(
                str(cidr_rule.labels[0])))
        assert n == 1
    assert ref.prefix_lengths == d.prefix_lengths
    ref.regenerate_all("delete")
    d.regenerate_all("delete")
    assert_tables_equal(ref.endpoint_manager.published()[1],
                        d.endpoint_manager.published()[1])
    assert ref.lpm_builder.mappings == d.lpm_builder.mappings


def _selectors(japi_mod, tapi):
    out = []
    for mod in (japi_mod, tapi):
        Sel = mod.EndpointSelector
        Req = mod.Requirement
        out.append([
            Sel(match_labels={"k8s.team": "t1"}),
            Sel(match_labels={"k8s.team": "t2", "k8s.svc": "s34"}),
            Sel(match_labels={"app": "app1"}),
            Sel(match_labels={"reserved.all": ""}),
            Sel(match_expressions=[Req("k8s.team", "In", ["t1", "t3"])]),
            Sel(match_expressions=[Req("k8s.team", "NotIn", ["t1"])]),
            Sel(match_expressions=[Req("svc", "Exists", [])]),
            Sel(match_expressions=[Req("k8s.app", "DoesNotExist", [])]),
            Sel(match_labels={"k8s.team": "t0"}, match_expressions=[
                Req("k8s.svc", "NotIn", ["s0", "s16"])]),
        ])
    return out


def test_selector_cache_and_rule_index_match_reference(pair):
    ref, rw = pair
    jsel, tsel = _selectors(japi, tapi)
    cache_ref = ref.identity_cache()
    cache = rw.daemon.identity_cache()
    a, b = jsc.SelectorCache(), tsc.SelectorCache()
    assert a.sync(cache_ref, cache_version=1) == b.sync(cache, cache_version=1)
    for js, ts in zip(jsel, tsel):
        assert a.matches(js) == b.matches(ts)
        # the cached sets equal the per-identity predicate
        assert b.matches(ts) == frozenset(
            i for i, lab in cache.items() if ts.matches(lab))
    # incremental removal and upsert
    victim = sorted(cache)[-1]
    a.remove_identity(victim)
    b.remove_identity(victim)
    assert a.version == b.version
    for js, ts in zip(jsel, tsel):
        assert a.matches(js) == b.matches(ts)
    ia, ib = jsc.RuleIndex(), tsc.RuleIndex()
    ia.build(ref.repo, ref.selector_cache)
    ib.build(rw.daemon.repo, rw.daemon.selector_cache)
    for num_id in cache:
        assert [str(r.rule.labels) for r in ia.relevant(num_id)] == [
            str(r.rule.labels) for r in ib.relevant(num_id)]


def _random_state(rng, mod, n):
    keys = {}
    for _ in range(n):
        k = mod.PolicyKey(int(rng.integers(0, 40)),
                          int(rng.choice([0, 80, 443])),
                          int(rng.choice([0, 6, 17])), int(rng.integers(0, 2)))
        keys[k] = mod.PolicyMapStateEntry(
            proxy_port=int(rng.choice([0, 0, 10001])),
            packets=int(rng.integers(0, 5)), bytes=int(rng.integers(0, 50)))
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diff_map_state_and_sync_map_arrays_match_reference(seed):
    _need_jax()
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    ra, da = _random_state(rng_a, jpm, 60), _random_state(rng_a, jpm, 60)
    rb, db = _random_state(rng_b, tpm, 60), _random_state(rng_b, tpm, 60)
    add_a, del_a = jpm.diff_map_state(ra, da)
    add_b, del_b = tpm.diff_map_state(rb, db)
    assert [tuple(dataclasses.astuple(k)) for k in add_a] == [
        tuple(dataclasses.astuple(k)) for k in add_b]
    assert [tuple(dataclasses.astuple(k)) for k in del_a] == [
        tuple(dataclasses.astuple(k)) for k in del_b]
    assert [dataclasses.astuple(k) for k in jpm.sort_keys(ra)] == [
        dataclasses.astuple(k) for k in tpm.sort_keys(rb)]
    na, add_na, del_na = jpm.sync_map_arrays(
        jpm.MapStateArrays.from_dict(ra), jpm.MapStateArrays.from_dict(da))
    nb, add_nb, del_nb = tpm.sync_map_arrays(
        tpm.MapStateArrays.from_dict(rb), tpm.MapStateArrays.from_dict(db))
    assert (add_na, del_na) == (add_nb, del_nb)
    assert_states_equal(na, nb)
    # the converters carry a reference state across and back
    carried = convert.map_states_from_numpy(na.keys_packed, na.proxy)
    assert_states_equal(jpm.MapStateArrays(na.keys_packed, na.proxy),
                        carried)
    keys, proxy = convert.map_states_to_numpy(carried)
    assert np.array_equal(keys, na.keys_packed)
    assert np.array_equal(proxy, na.proxy)
    with pytest.raises(ValueError, match="strictly increasing"):
        convert.map_states_from_numpy(na.keys_packed[::-1], na.proxy[::-1])


def test_endpoint_state_machine_matches_reference():
    _need_jax()
    states = sorted(set(jep._TRANSITIONS) | {
        s for v in jep._TRANSITIONS.values() for s in v})
    assert tep._TRANSITIONS == jep._TRANSITIONS
    assert tep._BUILDER_TRANSITIONS == jep._BUILDER_TRANSITIONS
    for frm, to in itertools.product(states, states):
        for method in ("set_state", "builder_set_state"):
            got = []
            for mod in (jep, tep):
                e = mod.Endpoint(1)
                e.state = frm
                got.append((getattr(e, method)(to), e.state))
            assert got[0] == got[1], (frm, to, method)


def test_checkpoint_written_by_reference_restores_in_port(pair, tmp_path):
    """A state directory the reference's save_endpoint writes (one
    current, one version-0 document) restores through the port's
    restore_endpoints with equal map states, redirects and identities;
    the migrations agree."""
    ref, rw = pair
    for e in ref.endpoint_manager.endpoints():
        jckpt.save_endpoint(e, str(tmp_path))
    old = {"id": 7, "name": "old", "ipv4": "10.250.9.9",
           "labels": [{"key": "app", "value": "app1", "source": "k8s"}],
           "realized_map_state": [{"identity": 300, "dest_port": 80,
                                   "nexthdr": 6, "dir": 0,
                                   "proxy_port": 0}]}
    (tmp_path / "7").mkdir()
    (tmp_path / "7" / "ep_state.json").write_text(json.dumps(old))
    assert jckpt.migrate_doc(dict(old)) == tckpt.migrate_doc(dict(old))
    got = tckpt.restore_endpoints(str(tmp_path),
                                  rw.daemon.identity_allocator)
    want = jckpt.restore_endpoints(str(tmp_path), ref.identity_allocator)
    assert [e.id for e in got] == [e.id for e in want]
    for a, b in zip(want, got):
        assert_states_equal(a.realized_map_state, b.realized_map_state)
        assert a.realized_redirects == b.realized_redirects
        assert a.security_identity.id == b.security_identity.id
        assert (a.state, a.name, a.ipv4) == (b.state, b.name, b.ipv4)
    # and the reference's live states round-trip through the port
    for e_ref in ref.endpoint_manager.endpoints():
        e = next(x for x in got if x.id == e_ref.id)
        assert_states_equal(e_ref.realized_map_state, e.realized_map_state)
    (tmp_path / "9").mkdir()
    (tmp_path / "9" / "ep_state.json").write_text(
        json.dumps({**old, "id": 9, "version": 99}))
    assert 9 not in [e.id for e in tckpt.restore_endpoints(str(tmp_path))]


def _republish(daemon, port, mod):
    mod.add_one_rule(daemon, port, label_prefix="stale")
    daemon.regenerate_all("stale")
    return daemon.endpoint_manager.published_device()[1]


def test_replay_lattice_with_manager_and_counter_sync_match_reference():
    """replay_lattice(manager=) on the live device epoch (the port's on
    CPU tensors), the counters folded into the endpoints by
    sync_counters_to_endpoints, then the refusal of a snapshot two
    publishes old, in both packages."""
    ref, rw = _worlds(11)
    d = rw.daemon
    buf = world.rules_records(rw, 3000, seed=4)
    dev = d.endpoint_manager.published_device()[1]
    _, t_ref, i_ref = ref.endpoint_manager.published()
    st_ref, l4_ref, l3_ref = jreplay.replay_lattice(
        t_ref, buf, 1024, manager=ref.endpoint_manager)
    st, l4, l3 = replay_lattice(dev, buf, 1024,
                                manager=d.endpoint_manager, device="cpu")
    for f in ("total", "allowed", "denied", "redirected", "batches"):
        assert getattr(st, f) == getattr(st_ref, f), f
    assert np.array_equal(l4, l4_ref) and np.array_equal(l3, l3_ref)
    before = sum(int(e.realized_map_state.packets.sum())
                 for e in d.endpoint_manager.endpoints())
    n_ref = jreplay.sync_counters_to_endpoints(
        l4_ref, l3_ref, ref.endpoint_manager, t_ref, i_ref)
    n = sync_counters_to_endpoints(l4, l3, d.endpoint_manager, dev,
                                   d.endpoint_manager.published()[2])
    assert n == n_ref > 0
    for e_ref in ref.endpoint_manager.endpoints():
        assert_states_equal(
            e_ref.realized_map_state,
            d.endpoint_manager.lookup(e_ref.id).realized_map_state)
    after = sum(int(e.realized_map_state.packets.sum())
                for e in d.endpoint_manager.endpoints())
    assert after - before == int(l4.sum() + l3.sum())
    # the epoch two publishes back is refused, as the reference's is
    _republish(ref, 5001, bench)
    _republish(d, 5001, world)
    ref_stale = t_ref
    _republish(ref, 5002, bench)
    _republish(d, 5002, world)
    with pytest.raises(ValueError):
        jreplay.replay_lattice(ref_stale, buf, 1024,
                               manager=ref.endpoint_manager)
    with pytest.raises(ValueError, match="stale"):
        replay_lattice(dev, buf, 1024, manager=d.endpoint_manager,
                       device="cpu")
    live = d.endpoint_manager.published_device()[1]
    assert replay_lattice(live, buf, 1024, manager=d.endpoint_manager,
                          device="cpu")[0].total == 3000


def test_replay_with_manager_runs_and_refuses_stale_tables():
    """replay(manager=) checks tables.policy first: the live epoch
    runs, one two publishes old raises before any batch."""
    from cilium_tpu_torch.ct.device import compile_ct
    from cilium_tpu_torch.ct.table import CTMap
    from cilium_tpu_torch.engine.datapath import DatapathTables
    from cilium_tpu_torch.ipcache.lpm import specialize_ipcache_to_idx
    from cilium_tpu_torch.lb.device import compile_lb
    from cilium_tpu_torch.lb.service import ServiceManager
    from cilium_tpu_torch.prefilter import build_prefilter

    rw = world.rules_world(seed=13, device="cpu", **SMALL)
    d = rw.daemon
    em = d.endpoint_manager

    def datapath_tables(policy_host):
        return convert.tables_to(DatapathTables(
            prefilter=build_prefilter({"203.0.113.0/24": 1}),
            ipcache=specialize_ipcache_to_idx(d.lpm_builder.tables(),
                                              policy_host),
            ct=compile_ct(CTMap()), lb=compile_lb(ServiceManager()),
            policy=policy_host), "cpu")

    host = em.published()[1]
    tables = datapath_tables(host)
    buf = world.rules_records(rw, 500, seed=2)
    st, l4, l3 = replay(tables, buf, 256, manager=em, device="cpu")
    assert st.total == 500 and l4 is not None
    _republish(d, 6001, world)
    _republish(d, 6002, world)
    with pytest.raises(ValueError, match="stale"):
        replay(tables, buf, 256, manager=em, device="cpu")


def test_create_endpoint_conflict_and_idempotence(pair):
    _, rw = pair
    d = rw.daemon
    e = d.endpoint_manager.lookup(100)
    assert d.create_endpoint(100, Labels({"app": Label("app", "app0", "k8s")}),
                             ipv4="10.250.0.0", name=e.name) is e
    from cilium_tpu_torch.daemon import EndpointConflict

    with pytest.raises(EndpointConflict):
        d.create_endpoint(100, Labels({"app": Label("app", "x", "k8s")}),
                          name="other")


def test_option_map_and_monitor_aggregation_match_reference():
    _need_jax()
    from cilium_tpu import option as jopt
    from cilium_tpu_torch import option as topt

    for v in (0, 3, "low", "Medium", "max", "", "2", True, False, 9, "x"):
        got = []
        for mod in (jopt, topt):
            try:
                got.append(mod.parse_monitor_aggregation(v))
            except ValueError:
                got.append("ValueError")
        assert got[0] == got[1], v
    for level in range(4):
        assert jopt.format_monitor_aggregation(level) == (
            topt.format_monitor_aggregation(level))
    for changes in ({"ConntrackAccounting": True}, {"Conntrack": "off"},
                    {"MonitorAggregationLevel": "low", "Debug": "on"}):
        a, b = jopt.default_opts(), topt.default_opts()
        seen_a, seen_b = [], []
        assert a.apply(changes, lambda k, v: seen_a.append((k, v))) == (
            b.apply(changes, lambda k, v: seen_b.append((k, v))))
        assert dict(a) == dict(b) and seen_a == seen_b
        assert a.describe() == b.describe()
    for bad in ({"NAT46": True}, {"Nope": 1}, {"Debug": "maybe"}):
        for mod in (jopt, topt):
            with pytest.raises(ValueError):
                mod.default_opts().apply(bad)


def test_policy_enforcement_always_matches_reference():
    """option.Config.policy_enforcement = "always" in both packages (set
    and restored): egress is enforced too, so the map states keep no
    egress key, equally."""
    _need_jax()
    from cilium_tpu import option as jopt
    from cilium_tpu_torch import option as topt

    saved = [m.Config.policy_enforcement for m in (jopt, topt)]
    try:
        for m in (jopt, topt):
            m.Config.policy_enforcement = m.ALWAYS_ENFORCE
        ref, rw = _worlds(17)
        _, t_ref, _, s_ref = ref.endpoint_manager.published_with_states()
        for a, b in zip(s_ref, rw.states):
            assert_states_equal(a, b)
        assert_tables_equal(t_ref, rw.tables)
        # no rule has an egress clause: nothing is allowed on egress
        assert not any(((s.keys_packed & np.uint64(0xFF)) == tpm.EGRESS).any()
                       for s in rw.states)
    finally:
        for m, v in zip((jopt, topt), saved):
            m.Config.policy_enforcement = v


def test_logging_matches_reference():
    _need_jax()
    import io

    from cilium_tpu import logging as jlog
    from cilium_tpu_torch import logging as tlog

    out = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        root = mod.setup(fmt="json", stream=buf)
        try:
            log = mod.with_fields(mod.get_logger("endpoint"), node="n0")
            log.info("regenerated", extra={"fields": {
                mod.ENDPOINT_ID: 7, mod.POLICY_REVISION: 3}})
        finally:
            root.handlers.clear()
        line = json.loads(buf.getvalue())
        line.pop("ts")
        out.append(line)
    assert out[0] == out[1]


def test_policy_trace_matches_reference(pair):
    """trace_policy's verdict and text, explain_tuple and
    _matching_rules over a few tuples of the small world."""
    ref, rw = pair
    from cilium_tpu.policy import search as jsearch
    from cilium_tpu.policy import trace as jtrace
    from cilium_tpu_torch.policy import search as tsearch
    from cilium_tpu_torch.policy import trace as ttrace

    from cilium_tpu import labels as jlab
    from cilium_tpu_torch import labels as tlab

    ctx = [m.SearchContext(
        from_labels=lab.LabelArray.parse("k8s:team=t1", "k8s:svc=s1"),
        to_labels=lab.LabelArray.parse("k8s:app=app1"),
        dports=[m.Port(int(rw.all_ports[0][0]), "TCP")])
        for m, lab in ((jsearch, jlab), (tsearch, tlab))]
    va, ta = jtrace.trace_policy(ref.repo, ctx[0], verbose=True)
    vb, tb = ttrace.trace_policy(rw.daemon.repo, ctx[1], verbose=True)
    assert int(va) == int(vb) and ta == tb
    cols = world.rules_tuples(rw, 64, seed=9)
    cache = rw.daemon.identity_cache()
    for i in range(64):
        ep = int(cols["ep_index"][i])
        args = (int(cols["identity"][i]), int(cols["dport"][i]),
                int(cols["proto"][i]), int(cols["direction"][i]),
                bool(cols["is_fragment"][i]))
        assert jtrace.explain_tuple(rw.states[ep], *args) == (
            ttrace.explain_tuple(rw.states[ep], *args))
        v, _ = ttrace._explain_verdict(rw.states[ep], *args)
        ep_id = next(k for k, x in rw.index.items() if x == ep)
        ep_labels = rw.daemon.endpoint_manager.lookup(
            ep_id).security_identity.label_array
        ep_labels_ref = ref.endpoint_manager.lookup(
            ep_id).security_identity.label_array
        peer = cache.get(args[0])
        peer_ref = ref.identity_cache().get(args[0])
        assert jtrace._matching_rules(
            ref, ep_labels_ref, peer_ref, 0, args[1], args[2], args[3],
            v.match_kind) == ttrace._matching_rules(
            rw.daemon, ep_labels, peer, 0, args[1], args[2], args[3],
            v.match_kind)
