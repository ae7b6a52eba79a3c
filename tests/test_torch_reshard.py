"""The PyTorch port's live resharding (engine/reshard.py, the relayout
windows of engine/publish.py's DeviceTableStore and engine/
datapath_mesh.py's DatapathStore, the router's adopt_reshard, the chip-id
grid of engine/mesh.py, the reshard row maps of compiler/partition.py)
on the CPU against the JAX package's, which runs on the 8 virtual host
devices tests/conftest.py gives it.  Both routers get the same map
states, tuples, fault schedules and breaker clock (a manual one), and
each scenario drives JAX's ReshardPlan and the port's through the same
sequence, mirroring tests/test_reshard.py:

  * grow tp 2 -> 4 checked at every step, then shrink back;
  * a chip kill mid-migration that completes from the replicas, and one
    that rolls back to the source layout;
  * a full publish that restarts the plan (churn dual-applied during a
    window and a shrink under churn are in
    tests/test_torch_reshard_stream.py);
  * a readmission that races the window (refused, then repaired after
    cutover);

comparing at every step the verdicts (each router's against the other's
and the host oracle's), and the ordinals, the outcome, the step count,
`bytes_h2d` and the restarts.  A last test grows and shrinks a router with
the fused datapath attached (the DatapathStore's relayout half), its
dispatch_flows compared at every step.  The row maps are held
`np.array_equal` against JAX's on the reshard world and on config 5's
tables.  Every value is an integer: every comparison is exact.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert
from cilium_tpu_torch import faultinject as tfi
from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import failover as tfo
from cilium_tpu_torch.engine import mesh as tmesh
from cilium_tpu_torch.engine import reshard as trs
from cilium_tpu_torch.engine.hostpath import lattice_fold_host
from cilium_tpu_torch.maps import policymap as tpm
from cilium_tpu_torch.metrics import registry as tmet
from cilium_tpu_torch.resilience import ChipBreakerBank

try:
    import jax

    from cilium_tpu import faultinject as jfi
    from cilium_tpu.compiler import partition as jpart
    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import failover as jfo
    from cilium_tpu.engine import reshard as jrs
    from cilium_tpu.engine.hostpath import lattice_fold_host as jfold
    from cilium_tpu.engine.oracle import evaluate_batch_oracle
    from cilium_tpu.maps import policymap as jpm
    from cilium_tpu.resilience import ChipBreakerBank as JBank

    from tests.test_verdict_engine import random_map_state, random_tuples
    from torch_parity import chaos_storm, convert_states, jax_leaves
except ImportError:  # the card's machine has no JAX
    jax = None

WIDE_IDS = [1, 2, 3, 4, 5] + [256 + i for i in range(120)] + [65536, 70000]


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


@pytest.fixture(autouse=True)
def _disarm():
    tfi.disarm_all()
    if jax is not None:
        jfi.disarm_all()
    yield
    tfi.disarm_all()
    if jax is not None:
        jfi.disarm_all()


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _jmesh(dp, tp):
    devs = jax.devices()
    assert len(devs) == 8, "conftest must force 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs[:dp * tp]).reshape(dp, tp),
                             ("batch", "table"))


class World:
    """tests/test_reshard.py's `_world` behind both routers: 3 endpoints,
    256 tuples, a policy that can churn, breakers on one manual clock."""

    def __init__(self, dp=2, tp=2, seed=11, batch=256):
        rng = np.random.default_rng(seed)
        self.states = [random_map_state(rng, WIDE_IDS, n_l4=16, n_l3=24)
                       for _ in range(3)]
        self.tstates = convert_states(self.states, jpm, tpm)
        self.jfc = jtab.FleetCompiler(identity_pad=256, filter_pad=16)
        self.tfc = ttab.FleetCompiler(identity_pad=256, filter_pad=16)
        self.tok = 0
        self.t = random_tuples(rng, batch, 3, WIDE_IDS)
        self.clock = Clock()
        kw = dict(recovery_timeout=0.05, failure_threshold=1,
                  clock=self.clock)
        self.jbank, self.tbank = JBank(**kw), ChipBreakerBank(**kw)
        jt, tt = self.compile()
        self.jr = jfo.ChipFailoverRouter(
            _jmesh(dp, tp), jt, bank=self.jbank, collect_telemetry=True,
            host_fold=lambda *a: jfold(self.states, *a[:5],
                                       is_fragment=a[5]))
        self.tr = tfo.ChipFailoverRouter(
            tmesh.make_mesh(dp, tp, device="cpu"), tt, bank=self.tbank,
            collect_telemetry=True,
            host_fold=lambda *a: lattice_fold_host(self.tstates, *a[:5],
                                                   is_fragment=a[5]))
        self.publish(*self.compile())
        self.publish(*self.compile())
        self.want = self.oracle()

    def compile(self):
        self.tok += 1
        j = self.jfc.compile([(i, s, (self.tok, i))
                              for i, s in enumerate(self.states)],
                             WIDE_IDS)[0]
        t = self.tfc.compile([(i, s, (self.tok, i))
                              for i, s in enumerate(self.tstates)],
                             WIDE_IDS)[0]
        return j, t

    def publish(self, jt, tt, delta=None):
        """Both routers publish; `delta` "current" records the delta against
        the live epoch (what a relayout window patches), "spare" against
        the spare (the ping-pong's base)."""
        jd = td = None
        if delta:
            jd = self.jfc.delta_for(getattr(self.jr.store,
                                            f"{delta}_stamp")(), jt)
            td = self.tfc.delta_for(getattr(self.tr.store,
                                            f"{delta}_stamp")(), tt)
        _, js = self.jr.publish(jt, jd)
        _, ts = self.tr.publish(tt, td)
        assert (ts.mode, ts.bytes_h2d) == (js.mode, js.bytes_h2d)
        return ts

    def add_rule(self, ep, ident, port):
        self.states[ep][jpm.PolicyKey(ident, port, 6, jpm.INGRESS)] = (
            jpm.PolicyMapStateEntry())
        self.tstates[ep][tpm.PolicyKey(ident, port, 6, tpm.INGRESS)] = (
            tpm.PolicyMapStateEntry())

    def oracle(self):
        return evaluate_batch_oracle(copy.deepcopy(self.states), **self.t)

    def check(self, tag):
        """Both routers on the tuples: equal to each other and to the
        oracle, and the routers' ordinals and breakers equal."""
        jres = self.jr.dispatch(**self.t)
        tres = self.tr.dispatch(**self.t)
        for k, col in enumerate(("allowed", "proxy_port", "match_kind")):
            got = getattr(tres.verdicts, col)
            np.testing.assert_array_equal(
                got, np.asarray(getattr(jres.verdicts, col)),
                err_msg=f"{tag} {col}")
            np.testing.assert_array_equal(got, self.want[k],
                                          err_msg=f"{tag} {col} oracle")
        for f in ("l4_counts", "l3_counts", "telemetry", "alive"):
            np.testing.assert_array_equal(getattr(tres, f),
                                          np.asarray(getattr(jres, f)),
                                          err_msg=f"{tag} {f}")
        for f in ("replica_hits", "rerouted", "degraded", "rebalanced_chips",
                  "rebalance_bytes"):
            assert getattr(tres, f) == getattr(jres, f), (tag, f)
        self.same_router(tag)
        return tres

    def same_router(self, tag):
        assert (self.tr.dp, self.tr.tp) == (self.jr.dp, self.jr.tp), tag
        np.testing.assert_array_equal(self.tr.ordinals, self.jr.ordinals,
                                      err_msg=f"{tag} ordinals")
        assert self.tr.chip_states() == self.jr.chip_states(), tag
        for f in dataclasses.fields(self.tr.stats):
            if f.name != "last_rebalance_ms":
                assert getattr(self.tr.stats, f.name) == getattr(
                    self.jr.stats, f.name), (tag, f.name)

    def plans(self, tp, **kw):
        jp = jrs.ReshardPlan(self.jr, jrs.reshard_target_mesh(self.jr, tp),
                             **kw)
        tp_ = trs.ReshardPlan(self.tr, trs.reshard_target_mesh(self.tr, tp),
                              **kw)
        return jp, tp_


def _same_step(ts, js, tag):
    """Two step results equal (a terminal's stats too, but for ms)."""
    assert ts.keys() == js.keys(), tag
    for k in ts:
        if k != "ms":
            assert ts[k] == js[k], (tag, k, ts[k], js[k])


def _same_stats(tstats, jstats, tag):
    for k in ("steps", "bytes_h2d", "restarts", "dead_cols", "outcome",
              "queued_items"):
        assert tstats[k] == jstats[k], (tag, k, tstats[k], jstats[k])
    assert tstats.get("deferred") == jstats.get("deferred"), tag


def _stream(w, jp, tp_, tag, every=1):
    """Step both plans to the end of their queues, comparing every step's
    result and checking the verdicts after every `every`-th step and the
    last; returns the step count."""
    steps = 0
    while jp.pending():
        assert tp_.pending() == jp.pending(), tag
        _same_step(tp_.step(), jp.step(), f"{tag} step {steps}")
        steps += 1
        if steps % every == 0 or not jp.pending():
            w.check(f"{tag} mid-step {steps}")
    assert not tp_.pending(), tag
    return steps


def _arm(spec, site):
    tfi.arm(site, spec)
    jfi.arm(site, spec)


# -- the row maps and the target mesh --------------------------------------------


@pytest.mark.parametrize("src,dst", [(2, 4), (4, 2), (1, 8), (8, 2), (2, 2)])
def test_reshard_row_map_matches_jax(src, dst):
    _need_jax()
    for n in (8, 64, 1024):
        got = tpart.reshard_row_map(n, src, dst)
        want = jpart.reshard_row_map(n, src, dst)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), (n, src, dst)
    for fn in (tpart.reshard_row_map, jpart.reshard_row_map):
        with pytest.raises(ValueError, match="must divide"):
            fn(12, 2, 8)


def _config5():
    from cilium_tpu_torch import world

    from torch_parity import SMALL, jax_host_tables

    w = world.make_world(seed=5, **SMALL)
    return jax_host_tables(w, subword=True)


def test_moved_rows_match_jax():
    """reshard_moved_rows on the reshard world's policy tables and
    datapath_reshard_moved_rows on config 5's fused tables (the small
    world) and the storm world, every shard-count pair."""
    _need_jax()
    w = World()
    jt, tt = w.compile()
    jdt = _config5()
    tdt = convert.host_tables_from_numpy(jax_leaves(jdt))
    sjt, _ = chaos_storm()._fused_world(31, n_ids=32)
    stt = convert.host_tables_from_numpy(jax_leaves(sjt))
    for src, dst in ((2, 4), (4, 2), (1, 4), (4, 8)):
        got = tpart.reshard_moved_rows(tt, src, dst)
        want = jpart.reshard_moved_rows(jt, src, dst)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k][0] == want[k][0]
            assert np.array_equal(got[k][1], want[k][1]), (src, dst, k)
        for tdt_, jdt_ in ((tdt, jdt), (stt, sjt)):
            try:
                want = jpart.datapath_reshard_moved_rows(jdt_, src, dst)
            except ValueError:
                with pytest.raises(ValueError, match="not a permutation"):
                    tpart.datapath_reshard_moved_rows(tdt_, src, dst)
                continue
            got = tpart.datapath_reshard_moved_rows(tdt_, src, dst)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k][0] == want[k][0]
                assert np.array_equal(got[k][1], want[k][1]), (src, dst, k)


def test_target_mesh_ordinals_match_jax():
    """tp 2 -> 4 over [[0, 1], [2, 3]] keeps the surviving columns' chips
    and gives the new columns the next free ids, [[0, 1, 4, 5], [2, 3,
    6, 7]], as JAX's device ids, every new coordinate a virtual chip of
    the mesh's one device."""
    _need_jax()
    w = World()
    jm = jrs.reshard_target_mesh(w.jr, 4)
    tm = trs.reshard_target_mesh(w.tr, 4)
    want = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(tm.ids, want)
    assert tm.ids.tolist() == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert all(str(d) == "cpu" for d in tm.devices.flat)
    with pytest.raises(ValueError, match="one distinct id"):
        tmesh.make_mesh(2, 2, device="cpu", ids=[[0, 1], [1, 2]])


class _Router:
    """What reshard_target_mesh reads of a router: dp, tp, ordinals, mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp, self.tp = mesh.devices.shape
        self.ordinals = mesh.ids


@pytest.mark.parametrize("cards,grow,want", [
    (8, 4, ["cuda:0", "cuda:1", "cuda:4", "cuda:5",
            "cuda:2", "cuda:3", "cuda:6", "cuda:7"]),
    (6, 3, ["cuda:0", "cuda:1", "cuda:4",
            "cuda:2", "cuda:3", "cuda:5"]),
    (7, 4, None),
    (4, 3, None),
])
def test_target_mesh_takes_free_cards(monkeypatch, cards, grow, want):
    """On a mesh of distinct cards (no card needed: a Mesh only names
    its devices) a grow gives each new coordinate the next card the mesh
    does not use, row by row, as the reference gives the next free jax
    device; too few free cards is refused; the chip ids are those of the
    virtual mesh; the shrink keeps the surviving columns' cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    src = tmesh.make_mesh(2, 2, devices=[f"cuda:{i}" for i in range(4)])
    if want is None:
        with pytest.raises(ValueError, match="free devices"):
            trs.reshard_target_mesh(_Router(src), grow)
        return
    tm = trs.reshard_target_mesh(_Router(src), grow)
    assert [str(d) for d in tm.devices.flat] == want
    virt = trs.reshard_target_mesh(_Router(tmesh.make_mesh(
        2, 2, device="cpu")), grow)
    np.testing.assert_array_equal(tm.ids, virt.ids)
    back = trs.reshard_target_mesh(_Router(tm), 2)
    assert [str(d) for d in back.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert back.ids.tolist() == [[0, 1], [2, 3]]


# -- the scenarios of tests/test_reshard.py ------------------------------------------


def test_grow_every_step_then_shrink_back():
    _need_jax()
    w = World()
    w.check("pre-reshard")
    jp, tp_ = w.plans(4, step_bytes=1 << 13)
    jp.begin()
    tp_.begin()
    assert tp_.pending() == jp.pending()
    steps = _stream(w, jp, tp_, "grow")
    out, jout = tp_.cutover(), jp.cutover()
    _same_stats(out, jout, "grow")
    assert out["outcome"] == "cutover" and out["steps"] == steps >= 2
    assert out["bytes_h2d"] > 0 and out["restarts"] == 0
    assert w.tr.ordinals.tolist() == [[0, 1, 4, 5], [2, 3, 6, 7]]
    w.check("grow post-cutover")
    jp, tp_ = w.plans(2, step_bytes=1 << 13)
    _same_stats(tp_.run(), jp.run(), "shrink")
    assert tp_.stats["outcome"] == "cutover"
    assert w.tr.ordinals.tolist() == [[0, 1], [2, 3]]
    w.check("shrink post-cutover")
    # the old live slot is a source-layout spare: one full upload, then
    # deltas resume
    w.add_rule(0, 65536, 5101)
    w.want = w.oracle()
    assert w.publish(*w.compile(), delta="spare").mode == "full"
    assert w.publish(*w.compile(), delta="spare").mode == "delta"
    w.check("shrink post-cutover publishes")


def test_chip_kill_mid_migration_completes_via_replicas():
    _need_jax()
    w = World()
    jp, tp_ = w.plans(4, step_bytes=1 << 12, on_fault="complete")
    jp.begin()
    tp_.begin()
    victims = tp_._target_ordinals_of_col(2)
    assert victims == jp._target_ordinals_of_col(2)
    _arm(f"raise:chip={victims[0]}", "reshard.migrate")
    _stream(w, jp, tp_, "complete-leg")
    out, jout = tp_.cutover(), jp.cutover()
    _same_stats(out, jout, "complete-leg")
    assert out["outcome"] == "cutover" and out["dead_cols"] == [2]
    res = w.check("complete-leg post-cutover")
    assert res.replica_hits > 0


def test_chip_kill_mid_migration_rolls_back_to_source():
    _need_jax()
    w = World(seed=13)
    jp, tp_ = w.plans(4, step_bytes=1 << 12, on_fault="rollback")
    jp.begin()
    tp_.begin()
    victims = tp_._target_ordinals_of_col(3)
    _arm(f"raise:chip={victims[0]};next=1", "reshard.migrate")
    steps = 0
    while jp.state == "migrating" and jp.pending():
        _same_step(tp_.step(), jp.step(), f"rollback step {steps}")
        steps += 1
    assert tp_.state == jp.state == "rolled_back"
    _same_stats(tp_.stats, jp.stats, "rollback")
    assert (w.tr.dp, w.tr.tp) == (2, 2)
    tfi.disarm_all()
    jfi.disarm_all()
    w.check("rollback post")
    w.publish(*w.compile())
    w.check("rollback post churn")


def test_full_publish_during_migration_restarts_into_target():
    _need_jax()
    w = World(seed=19)
    jp, tp_ = w.plans(4, step_bytes=1 << 12)
    jp.begin()
    tp_.begin()
    _same_step(tp_.step(), jp.step(), "restart step 0")
    w.add_rule(1, 70000, 6001)
    jt, tt = w.compile()
    assert w.publish(jt, tt).mode == "full"  # breaks the window
    jp.on_publish(jt)
    tp_.on_publish(tt)
    assert tp_.stats["restarts"] == jp.stats["restarts"] >= 1
    w.want = w.oracle()
    w.check("restart mid")
    _same_stats(tp_.run(), jp.run(), "restart")
    assert tp_.stats["outcome"] == "cutover" and w.tr.tp == 4
    w.check("restart post-cutover")


def test_readmit_races_migration_refused_then_repairs_post_cutover():
    _need_jax()
    w = World(seed=29)
    victim = int(w.tr.ordinals[0, 1])
    _arm(f"raise:chip={victim};next=1", "engine.dispatch")
    w.check("kill dispatch")
    tfi.disarm_all()
    jfi.disarm_all()
    assert w.tr.store.chip_outage(victim) is not None
    jp, tp_ = w.plans(4, step_bytes=1 << 13)
    jp.begin()
    tp_.begin()
    for r in (w.jr, w.tr):
        with pytest.raises(RuntimeError, match="repair refused"):
            r._rebalance(victim)
        assert r.store.chip_outage(victim) is not None
        assert r.stats.rebalances == 0
    w.clock.now += 0.06
    w.check("mid-window readmit attempt")
    assert w.tr.stats.rebalances == 0
    assert w.tr.store.chip_outage(victim) is not None
    _same_stats(tp_.run(), jp.run(), "readmit race")
    assert w.tr.tp == 4
    w.check("post-cutover, chip still out")
    w.publish(*w.compile())
    w.clock.now += 0.06
    w.check("post-cutover readmission")
    assert w.tr.stats.rebalances >= 1
    assert w.tr.store.chip_outage(victim) is None


def test_reshard_metrics_count_the_plan():
    """The reshard_* series move with the plan (the port's registry)."""
    _need_jax()
    w = World(seed=37)
    before = (tmet.reshard_total.get("cutover"),
              tmet.reshard_steps_total.get(),
              tmet.reshard_bytes_h2d_total.get())
    out = trs.ReshardPlan(w.tr, trs.reshard_target_mesh(w.tr, 4),
                          step_bytes=1 << 13).run()
    assert tmet.reshard_total.get("cutover") == before[0] + 1
    assert tmet.reshard_steps_total.get() == before[1] + out["steps"]
    assert tmet.reshard_bytes_h2d_total.get() == before[2] + out["bytes_h2d"]
    with pytest.raises(RuntimeError, match="not migrating"):
        trs.ReshardPlan(w.tr, trs.reshard_target_mesh(w.tr, 2)).step()
    with pytest.raises(ValueError, match="on_fault"):
        trs.ReshardPlan(w.tr, w.tr.mesh, on_fault="retry")


# -- the fused datapath's half ---------------------------------------------------


def test_datapath_store_grow_and_shrink_matches_jax():
    """A router with the fused datapath attached (publish_datapath through
    attach_datapath), grown 2 -> 4 and shrunk back through ReshardPlan
    (dtables=): dispatch_flows equal to JAX's router at every step, and
    the plans' stats equal."""
    _need_jax()
    jt, parts = chaos_storm()._fused_world(31, n_ids=32)
    tt = convert.host_tables_from_numpy(jax_leaves(jt))
    clock = Clock()
    kw = dict(recovery_timeout=1.0, failure_threshold=1, clock=clock)
    jr = jfo.ChipFailoverRouter(_jmesh(2, 2), jt.policy, bank=JBank(**kw),
                                collect_telemetry=True)
    tr = tfo.ChipFailoverRouter(tmesh.make_mesh(2, 2, device="cpu"),
                                tt.policy, bank=ChipBreakerBank(**kw),
                                collect_telemetry=True)
    jr.attach_datapath(jt)
    tr.attach_datapath(tt)
    jr.publish(jt.policy)
    tr.publish(tt.policy)
    flows = chaos_storm()._fused_flows(np.random.default_rng(3), 256, parts)

    def check(tag):
        jres = jr.dispatch_flows(**flows)
        tres = tr.dispatch_flows(**flows)
        for c in tdp.VERDICT_COLUMNS:
            np.testing.assert_array_equal(
                getattr(tres.verdicts, c),
                np.asarray(getattr(jres.verdicts, c)), err_msg=f"{tag} {c}")
        for f in ("l4_counts", "l3_counts", "telemetry"):
            np.testing.assert_array_equal(getattr(tres, f),
                                          np.asarray(getattr(jres, f)),
                                          err_msg=f"{tag} {f}")
        assert tres.replica_hits == jres.replica_hits, tag
        np.testing.assert_array_equal(tr.ordinals, jr.ordinals)

    check("pre-reshard")
    for tp, want_ids in ((4, [[0, 1, 4, 5], [2, 3, 6, 7]]),
                         (2, [[0, 1], [2, 3]])):
        jp = jrs.ReshardPlan(jr, jrs.reshard_target_mesh(jr, tp),
                             step_bytes=1 << 14, dtables=jt)
        tp_ = trs.ReshardPlan(tr, trs.reshard_target_mesh(tr, tp),
                              step_bytes=1 << 14, dtables=tt)
        jp.begin()
        tp_.begin()
        assert tp_.pending() == jp.pending()
        steps = 0
        while jp.pending():
            _same_step(tp_.step(), jp.step(), f"tp {tp} step {steps}")
            steps += 1
            check(f"tp {tp} step {steps}")
        _same_stats(tp_.cutover(), jp.cutover(), f"tp {tp}")
        assert steps >= 2 and tr.tp == tp and tr.dp_store.ntp == tp
        assert tr.ordinals.tolist() == want_ids
        check(f"tp {tp} post-cutover")
