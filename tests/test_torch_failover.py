"""The PyTorch port's per-chip failure domain (engine/failover.py, the
outage half of engine/publish.py, engine/hostpath.py lattice_fold_host)
on the CPU against the JAX package's ChipFailoverRouter, which runs on
the 8 virtual host devices tests/conftest.py gives it.  The port's
router runs on a CPU Mesh of the same (dp, tp), its coordinates ordered
row-major as the reference's mesh of `jax.devices()`.  Both routers get
the same map states, tuples, fault schedules and breaker clock (a
manual one: no test waits on a real timer), and every FailoverResult
field, the RouterStats and the repaired epochs are compared exactly,
mirroring tests/test_chip_failover.py:

  * a chip-scoped kill serves from the replicas; a dead primary and its
    backup in one row re-split the row; a mesh-wide outage folds on the
    host; the empty batch;
  * readmission replays the rows missed while out through the repair
    scatter (bytes below a full upload, live epoch equal to a fresh
    upload), a full upload while out downgrades to the whole slice, a
    failed rebalance restores the ledger, repair_rows rewrites poisoned
    rows only, a plain store retains no host tables;
  * a launch error that is no chip fault (a kernel that fails to build
    or launch, also the memo's and the repair's) propagates with no
    breaker opened and no host fold (the port alone: the reference
    folds on any launch error);
  * a caller's bank listener is chained, the terminal fold gives back
    half-open probe slots, the identity pack fast path;
  * the memo on the router (attach_memo): cold and warm dispatches equal
    to the uncached router's, healthy and with a chip dead, an overflow
    re-dispatched uncached, a chip transition flushing the cache;
  * REPAIR_SCATTER's plain version against the reference's jitted
    `_repair_fn` with negative and out-of-range indices.

The cuda-marked test at the end holds REPAIR_SCATTER against its plain
version on the card.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from cilium_tpu_torch import faultinject as tfi
from cilium_tpu_torch import kernels as tkern
from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.compiler.delta import tables_nbytes
from cilium_tpu_torch.engine import failover as tfo
from cilium_tpu_torch.engine import mesh as tmesh
from cilium_tpu_torch.engine import publish as tpub
from cilium_tpu_torch.engine.hostpath import lattice_fold_host
from cilium_tpu_torch.maps import policymap as tpm
from cilium_tpu_torch.metrics import registry as tmet
from cilium_tpu_torch.resilience import ChipBreakerBank

try:
    import jax

    from cilium_tpu import faultinject as jfi
    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import failover as jfo
    from cilium_tpu.engine import hostpath as jhp
    from cilium_tpu.engine.oracle import evaluate_batch_oracle
    from cilium_tpu.maps import policymap as jpm
    from cilium_tpu.resilience import ChipBreakerBank as JBank

    from tests.test_verdict_engine import random_map_state, random_tuples
    from torch_parity import convert_states
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
    """The breakers' clock, moved by hand."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _jmesh(dp, tp):
    devs = jax.devices()
    assert len(devs) == 8, "conftest must force 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs).reshape(dp, tp),
                             ("batch", "table"))


class Pair:
    """The same world behind both routers."""

    def __init__(self, seed=0, dp=2, tp=4, batch=768, telemetry=True,
                 listener=None):
        rng = np.random.default_rng(seed)
        self.states = [random_map_state(rng, WIDE_IDS, n_l4=16, n_l3=24)
                       for _ in range(3)]
        self.tstates = convert_states(self.states, jpm, tpm)
        self.jt = jtab.compile_map_states(self.states, WIDE_IDS,
                                          identity_pad=256, filter_pad=16)
        self.tt = ttab.compile_map_states(self.tstates, WIDE_IDS,
                                          identity_pad=256, filter_pad=16)
        self.t = random_tuples(rng, batch, 3, WIDE_IDS)
        self.clock = Clock()
        kw = dict(recovery_timeout=1.0, failure_threshold=1,
                  clock=self.clock)
        self.jbank = JBank(**kw, on_transition=listener)
        self.tbank = ChipBreakerBank(**kw, on_transition=listener)
        self.jr = jfo.ChipFailoverRouter(
            _jmesh(dp, tp), self.jt, bank=self.jbank,
            collect_telemetry=telemetry,
            host_fold=lambda *a: jhp.lattice_fold_host(
                self.states, *a[:5], is_fragment=a[5]))
        self.tr = tfo.ChipFailoverRouter(
            tmesh.make_mesh(dp, tp, device="cpu"), self.tt, bank=self.tbank,
            collect_telemetry=telemetry,
            host_fold=lambda *a: lattice_fold_host(
                self.tstates, *a[:5], is_fragment=a[5]))
        for _ in range(2):
            self.publish(self.jt, self.tt)

    def publish(self, jt, tt, jdelta=None, tdelta=None):
        _, js = self.jr.publish(jt, jdelta)
        _, ts = self.tr.publish(tt, tdelta)
        assert ts.mode == js.mode and ts.bytes_h2d == js.bytes_h2d
        return ts

    def want(self):
        return evaluate_batch_oracle(copy.deepcopy(self.states), **self.t)

    def dispatch(self, tag, degraded=False):
        """Both routers on the same tuples: every result field equal,
        the verdicts equal to the oracle's."""
        jres = self.jr.dispatch(**self.t)
        tres = self.tr.dispatch(**self.t)
        same_result(tres, jres, tag)
        want = self.want()
        for k, col in enumerate(("allowed", "proxy_port", "match_kind")):
            np.testing.assert_array_equal(getattr(tres.verdicts, col),
                                          want[k], err_msg=f"{tag} {col}")
        assert tres.degraded == degraded, tag
        same_stats(self.tr.stats, self.jr.stats, tag)
        assert self.tr.chip_states() == self.jr.chip_states(), tag
        return tres

    def both(self, fn):
        fn(self.jr, self.jbank)
        fn(self.tr, self.tbank)


def same_result(tres, jres, tag):
    for col in ("allowed", "proxy_port", "match_kind"):
        np.testing.assert_array_equal(getattr(tres.verdicts, col),
                                      np.asarray(getattr(jres.verdicts, col)),
                                      err_msg=f"{tag} {col}")
    for f in ("l4_counts", "l3_counts", "telemetry", "alive", "cache_hit"):
        a, b = getattr(tres, f), getattr(jres, f)
        assert (a is None) == (b is None), (tag, f)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{tag} {f}")
    for f in ("replica_hits", "rerouted", "degraded", "rebalanced_chips",
              "rebalance_bytes"):
        assert getattr(tres, f) == getattr(jres, f), (tag, f)


def same_stats(ts, js, tag):
    for f in dataclasses.fields(ts):
        if f.name != "last_rebalance_ms":
            assert getattr(ts, f.name) == getattr(js, f.name), (tag, f.name)


def _arm(spec, site="engine.dispatch"):
    tfi.arm(site, spec)
    jfi.arm(site, spec)


# -- the router ------------------------------------------------------------------


def test_router_single_chip_kill_serves_from_replicas():
    _need_jax()
    p = Pair()
    healthy = p.dispatch("healthy")
    assert healthy.replica_hits == 0 and not healthy.rerouted
    victim = int(p.tr.ordinals[0, 1])
    assert victim == int(p.jr.ordinals[0, 1]) == 1
    before = tmet.replica_gather_total.get()
    _arm(f"raise:chip={victim}")
    killed = p.dispatch("one chip dead")
    assert p.tbank.state(victim) != "closed"
    assert killed.replica_hits > 0 and not killed.rerouted
    assert tmet.replica_gather_total.get() - before == killed.replica_hits
    np.testing.assert_array_equal(killed.l4_counts, healthy.l4_counts)
    np.testing.assert_array_equal(killed.l3_counts, healthy.l3_counts)
    np.testing.assert_array_equal(
        killed.telemetry.astype(np.uint64).sum(axis=0),
        healthy.telemetry.astype(np.uint64).sum(axis=0))


@pytest.mark.parametrize("dp,tp,cols", [(2, 4, (1, 2)), (4, 2, (0, 1))])
def test_router_dead_row_resplits_across_survivors(dp, tp, cols):
    """A primary and its backup dead in one row: the row's shard
    re-splits over the survivors, counted, and stays bit-identical."""
    _need_jax()
    p = Pair(dp=dp, tp=tp)
    healthy = p.dispatch("healthy")
    for col in cols:
        p.both(lambda r, bank: bank.record_failure(int(r.ordinals[0, col]),
                                                   "test kill"))
    before = tmet.rerouted_batches_total.get()
    killed = p.dispatch("dead row")
    assert killed.rerouted
    assert tmet.rerouted_batches_total.get() - before == 1
    np.testing.assert_array_equal(killed.l4_counts, healthy.l4_counts)
    np.testing.assert_array_equal(killed.l3_counts, healthy.l3_counts)


def test_router_mesh_wide_outage_host_folds():
    _need_jax()
    p = Pair(telemetry=False)
    _arm("raise")
    p.dispatch("terminal fold", degraded=True)
    assert p.tr.stats.degraded_batches == 1


def test_router_readmission_rebalances_missed_rows():
    """Kill a chip, publish two deltas while it is out, readmit: the
    half-open probe replays exactly the missed rows, bytes below a full
    upload, and the live epoch equals a fresh upload on every
    coordinate."""
    _need_jax()
    p = Pair(seed=5)
    rng = np.random.default_rng(5)
    jfc = jtab.FleetCompiler(identity_pad=256, filter_pad=16)
    tfc = ttab.FleetCompiler(identity_pad=256, filter_pad=16)
    tok = [0]

    def compile_both():
        tok[0] += 1
        tst = convert_states(p.states, jpm, tpm)
        jt = jfc.compile([(i, s, (tok[0], i))
                          for i, s in enumerate(p.states)], WIDE_IDS)[0]
        tt = tfc.compile([(i, s, (tok[0], i)) for i, s in enumerate(tst)],
                         WIDE_IDS)[0]
        return jt, tt

    for _ in range(2):
        p.publish(*compile_both())
    victim = int(p.tr.ordinals[1, 0])
    _arm(f"raise:chip={victim};next=1")
    p.dispatch("kill")
    assert p.tr.store.chip_outage(victim) is not None
    for step in range(2):
        jbase, tbase = p.jr.store.spare_stamp(), p.tr.store.spare_stamp()
        p.states[0][jpm.PolicyKey(int(rng.choice(WIDE_IDS)), 7000 + step, 6,
                                  jpm.INGRESS)] = jpm.PolicyMapStateEntry()
        p.tstates = convert_states(p.states, jpm, tpm)
        jt, tt = compile_both()
        st = p.publish(jt, tt, jfc.delta_for(jbase, jt),
                       tfc.delta_for(tbase, tt))
        assert st.mode == "delta"
    out = p.tr.store.chip_outage(victim)
    assert len(out["missed"]) == 2 and not out["needs_full"]
    p.clock.now += 2.0
    before = tmet.rebalance_bytes_h2d_total.get()
    res = p.dispatch("after readmission")
    assert res.rebalanced_chips == (victim,)
    assert p.tbank.state(victim) == "closed"
    assert p.tr.store.chip_outage(victim) is None
    assert 0 < res.rebalance_bytes < tables_nbytes(tt)
    assert tmet.rebalance_bytes_h2d_total.get() - before == res.rebalance_bytes
    fresh = tmesh.place_tables(
        tpart.replicate_table_leaves(tt, p.tr.tp),
        tpart.table_shardings(p.tr.mesh, tpart.replicate_table_leaves(
            tt, p.tr.tp)))
    live = p.tr.store.current()[1]
    for coord in p.tr.mesh.coords():
        for f in dataclasses.fields(live.shard(*coord)):
            a, b = getattr(live.shard(*coord), f.name), getattr(
                fresh.shard(*coord), f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (coord, f.name)
    again = p.dispatch("steady after readmission")
    assert again.replica_hits == 0


def test_repair_rows_rewrites_poisoned_device_rows():
    """Poison coordinate (0, 0)'s own slice of the live epoch's hash
    rows, repair the first rows: only those come back, on that
    coordinate's slice alone."""
    _need_jax()
    p = Pair(seed=6)
    store = p.tr.store
    slot = store._slots[store._cur]
    mt = slot["tables"]
    own = mt.shard(0, 0).l4_hash_rows.clone().fill_(0x0BADC0DE)
    mt.shards[0, 0] = dataclasses.replace(mt.shard(0, 0), l4_hash_rows=own)
    aug = tpart.replicate_table_leaves(p.tt, 4)
    got = store.repair_rows({"l4_hash_rows": (0, np.arange(8))})
    want_bytes = 8 * 8 + np.asarray(aug.l4_hash_rows)[:8].nbytes
    assert got == want_bytes
    rows = mt.shard(0, 0).l4_hash_rows.numpy().view(np.uint32)
    np.testing.assert_array_equal(rows[:8],
                                  np.asarray(aug.l4_hash_rows)[:8])
    assert (rows[8:] == 0x0BADC0DE).all()
    # the other coordinates' (shared) slices were untouched and whole
    np.testing.assert_array_equal(
        mt.shard(1, 0).l4_hash_rows.numpy().view(np.uint32),
        np.asarray(aug.l4_hash_rows)[:rows.shape[0]])


def test_full_upload_while_out_downgrades_to_whole_slice():
    _need_jax()
    p = Pair(seed=7)
    p.both(lambda r, bank: r.store.mark_chip_out(3))
    p.publish(p.jt, p.tt)  # no delta: full
    assert p.tr.store.chip_outage(3)["needs_full"]
    assert p.jr.store.chip_outage(3)["needs_full"]
    p.publish(p.jt, p.tt)  # the spare too was published while out
    rec = p.tr.store.readmit_chip(3)
    jrec = p.jr.store.readmit_chip(3)
    assert rec["spare_stale"] and jrec["spare_stale"]
    assert rec["spare_epoch"] == jrec["spare_epoch"]
    sets = p.tr._whole_owned_row_sets(3)
    jsets = p.jr._whole_owned_row_sets(3)
    assert sets.keys() == jsets.keys()
    for name in sets:
        assert sets[name][0] == jsets[name][0]
        np.testing.assert_array_equal(sets[name][1], jsets[name][1])


def test_dispatch_empty_batch_returns_empty_result():
    _need_jax()
    p = Pair(telemetry=False)
    empty = dict(ep_index=[], identity=[], dport=[], proto=[], direction=[])
    res = p.tr.dispatch(**empty)
    assert len(res.verdicts.allowed) == 0
    assert not res.degraded and not res.rerouted
    assert p.tr.stats.batches == p.jr.stats.batches == 0


def test_terminal_fold_releases_half_open_probe_slots():
    _need_jax()
    p = Pair(telemetry=False)
    victim = 0
    p.both(lambda r, bank: bank.record_failure(victim, "test kill"))
    p.clock.now += 2.0
    others = [o for o in range(8) if o != victim]
    for o in others:
        p.both(lambda r, bank, o=o: bank.record_failure(o, "test kill"))
    p.dispatch("terminal fold", degraded=True)
    assert p.tbank.snapshot()[victim]["half_open_inflight"] == 0
    for o in others:
        p.both(lambda r, bank, o=o: bank.breaker(o).reset())
    p.dispatch("after recovery")
    assert p.tbank.state(victim) == "closed"


def test_failed_rebalance_restores_outage_ledger():
    _need_jax()
    p = Pair()
    victim = int(p.tr.ordinals[1, 2])
    p.both(lambda r, bank: bank.record_failure(victim, "test kill"))
    p.publish(p.jt, p.tt)  # full while out: needs_full
    real = (p.jr.store.repair_rows, p.tr.store.repair_rows)

    def broken(row_sets, **kw):
        raise RuntimeError("transient device error")

    p.jr.store.repair_rows = broken
    p.tr.store.repair_rows = broken
    p.clock.now += 2.0
    res = p.dispatch("failed rebalance")
    assert victim not in res.rebalanced_chips
    assert p.tbank.state(victim) != "closed"
    assert p.tr.store.chip_outage(victim)["needs_full"]
    p.jr.store.repair_rows, p.tr.store.repair_rows = real
    p.clock.now += 2.0
    before = tmet.rebalance_bytes_h2d_total.get()
    res = p.dispatch("second readmission")
    assert victim in res.rebalanced_chips and res.rebalance_bytes > 0
    assert tmet.rebalance_bytes_h2d_total.get() - before == res.rebalance_bytes
    assert p.tbank.state(victim) == "closed"
    assert p.tr.store.chip_outage(victim) is None


def _kernel_failure(*args, **kwargs):
    raise tkern.KernelError("ROUTED_PROBE launch failed: CUDA error 700")


def _other_failure(*args, **kwargs):
    raise RuntimeError("device-side assert triggered")


@pytest.mark.parametrize("memo", [False, True])
@pytest.mark.parametrize("broken", [_kernel_failure, _other_failure])
def test_launch_error_propagates_without_blame(memo, broken):
    """An evaluator that fails with no chip fault (a kernel that does not
    build or launch) is no dead chip: the error propagates, no breaker
    opens, nothing is folded on the host, and a half-open chip's probe
    slot comes back.  The memo's failure also flushes its cache."""
    _need_jax()
    p = Pair(seed=4, telemetry=False)
    if memo:
        p.tr.attach_memo(n_rows_local=16, entries=4)
        p.tr.dispatch(**p.t)
        p.tr._memo_evaluator = lambda rep_cap: broken
    else:
        p.tr._ev = broken
    victim = int(p.tr.ordinals[1, 1])
    p.tbank.record_failure(victim, "test kill")
    p.clock.now += 2.0
    flushes = p.tr._memo["cache"].flushes if memo else 0
    with pytest.raises(RuntimeError, match="700|assert"):
        p.tr.dispatch(**p.t)
    assert p.tr.stats.degraded_batches == 0
    assert p.tbank.open_chips() == (victim,)
    assert p.tbank.state(victim) == "half-open"
    assert p.tbank.snapshot()[victim]["half_open_inflight"] == 0
    if memo:
        # the victim's half-open transition flushes, then the failure;
        # a stamp of None is the failure's flush (ensure set it before)
        assert p.tr._memo["cache"].flushes == flushes + 2
        assert p.tr._memo["cache"].stamp is None


def test_repair_kernel_error_propagates_and_keeps_ledger():
    """REPAIR_SCATTER failing to build or launch at readmission
    propagates: the chip is not blamed, its probe slot comes back and
    its outage ledger stays for the next attempt."""
    _need_jax()
    p = Pair(seed=6, telemetry=False)
    victim = int(p.tr.ordinals[0, 3])
    p.tbank.record_failure(victim, "test kill")
    p.tr.publish(p.tt)
    real = p.tr.store.repair_rows
    p.tr.store.repair_rows = _kernel_failure
    p.clock.now += 2.0
    with pytest.raises(tkern.KernelError):
        p.tr.dispatch(**p.t)
    assert p.tbank.state(victim) == "half-open"
    assert p.tbank.snapshot()[victim]["half_open_inflight"] == 0
    assert p.tr.store.chip_outage(victim) is not None
    assert p.tr.stats.degraded_batches == 0
    p.tr.store.repair_rows = real
    res = p.tr.dispatch(**p.t)
    assert victim in res.rebalanced_chips and not res.degraded
    assert p.tbank.state(victim) == "closed"
    want = p.want()
    for k, col in enumerate(("allowed", "proxy_port", "match_kind")):
        np.testing.assert_array_equal(getattr(res.verdicts, col), want[k])


def test_router_chains_caller_bank_listener():
    _need_jax()
    seen = []
    p = Pair(seed=1, listener=lambda o, old, new, why: seen.append(
        (int(o), old, new)))
    p.both(lambda r, bank: bank.record_failure(0, "test kill"))
    assert seen == [(0, "closed", "open")] * 2
    assert p.tr.store.chip_outage(0) is not None
    assert tmet.chip_breaker_state.get("0") == 1
    assert "cilium_chip_breaker_state" in tmet.expose()


def test_plain_store_does_not_retain_host_tables():
    _need_jax()
    p = Pair(seed=9, telemetry=False)
    plain = tpub.DeviceTableStore(device="cpu")
    plain.publish(p.tt)
    assert plain._slots[plain._cur]["host"] is None
    with pytest.raises(RuntimeError, match="host source"):
        plain.repair_rows({"l4_hash_rows": (0, np.arange(4))})
    assert p.tr.store._slots[p.tr.store._cur]["host"] is not None


def test_pack_identity_fast_path():
    _need_jax()
    p = Pair(seed=2, batch=1024)
    cols = {k: np.asarray(v) for k, v in p.t.items()}
    cols["is_fragment"] = np.zeros(1024, bool)
    padded, valid, positions = p.tr._pack(cols, np.ones(p.tr.dp, bool))
    assert positions is None and valid.all()
    assert padded["ep_index"] is cols["ep_index"]
    usable = np.ones(p.tr.dp, bool)
    usable[0] = False
    assert p.tr._pack(cols, usable)[2] is not None
    p.dispatch("fast path healthy")


# -- the memo on the router ------------------------------------------------------


@pytest.mark.parametrize("dead", [None, 1])
def test_router_memo_matches_reference_and_uncached(dead):
    """attach_memo on both routers: a cold and a warm dispatch of a
    stream with repeated keys equal the reference's (hit flags
    included) and the uncached router's outputs; a chip kill flushes."""
    _need_jax()
    p = Pair(seed=4)
    plain = Pair(seed=4)
    rng = np.random.default_rng(4)
    pick = rng.integers(0, 120, 768)  # below rep_cap distinct keys a row
    for q in (p, plain):
        q.t = {k: np.asarray(v)[pick] for k, v in q.t.items()}
    p.both(lambda r, bank: r.attach_memo(n_rows_local=16, entries=4))
    flushes = tmet.verdict_cache_flushes_total.get()
    if dead is not None:
        for q in (p, plain):
            q.both(lambda r, bank: bank.record_failure(dead, "test kill"))
    for tag in ("cold", "warm"):
        res = p.dispatch(tag)
        ref = plain.dispatch(tag + " uncached")
        for col in ("allowed", "proxy_port", "match_kind"):
            np.testing.assert_array_equal(getattr(res.verdicts, col),
                                          getattr(ref.verdicts, col))
        np.testing.assert_array_equal(res.l4_counts, ref.l4_counts)
        np.testing.assert_array_equal(res.l3_counts, ref.l3_counts)
        np.testing.assert_array_equal(
            res.telemetry.astype(np.uint64).sum(axis=0),
            ref.telemetry.astype(np.uint64).sum(axis=0))
        assert res.cache_hit is not None
    assert res.cache_hit.any(), "the warm dispatch must hit"
    assert p.tr._memo["hits"] == p.jr._memo["hits"] > 0
    if dead is not None:
        assert tmet.verdict_cache_flushes_total.get() > flushes


def test_router_memo_overflow_redispatches_uncached():
    _need_jax()
    p = Pair(seed=8)
    p.both(lambda r, bank: r.attach_memo(n_rows_local=16, entries=4,
                                         rep_shift=8))
    # rep_cap = max(384 >> 8, min(384, 256)) = 256 < the distinct keys
    res = p.dispatch("overflow")
    assert res.cache_hit is None
    assert p.tr._memo["overflow_redispatches"] == 1
    assert p.jr._memo["overflow_redispatches"] == 1


def test_router_chip_transition_flushes_memo_cache():
    _need_jax()
    p = Pair(seed=3, telemetry=False)
    p.tr.attach_memo(n_rows_local=16, entries=4)
    p.tr.dispatch(**p.t)
    cache = p.tr._memo["cache"]
    assert cache.stamp is not None
    n = cache.flushes
    p.tbank.record_failure(5, "test kill")
    assert cache.flushes == n + 1 and cache.stamp is None


# -- the host fold and the repair scatter's plain version ---------------------------


def test_lattice_fold_host_matches_reference():
    _need_jax()
    p = Pair(seed=12, telemetry=False)
    t = dict(p.t)
    frag = np.arange(768) % 9 == 0
    want = jhp.lattice_fold_host(p.states, t["ep_index"], t["identity"],
                                 t["dport"], t["proto"], t["direction"],
                                 is_fragment=frag, pad_to=800)
    got = lattice_fold_host(p.tstates, t["ep_index"], t["identity"],
                            t["dport"], t["proto"], t["direction"],
                            is_fragment=frag, pad_to=800)
    for col in ("allowed", "proxy_port", "match_kind"):
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype and a.shape == (800,)
        np.testing.assert_array_equal(a, b)


# REPAIR_SCATTER's cases beyond the three axes of a (6, 8, 10) leaf: leaf
# shape, axis, index kind, the destination's and the payload's offsets
# in words into larger buffers.  Index kinds: "owned" the first half of
# the axis (a chip's primary words), "whole" every index (on a narrow
# axis one run over several outer rows), "tail" the last 8 by negative
# indices, "mixed" a consecutive run, a scattered unsorted part, -1 and
# -n, n and -n - 1 (dropped) and pow2 padding repeating the last,
# "wide" 3 rows of a leaf wider than a tile.
_REPAIR_CASES = {
    "last_owned": ((4, 2, 6, 520), 3, "owned", 0, 0),
    "last_whole": ((4, 2, 6, 520), 3, "whole", 0, 0),
    "last_whole_narrow": ((40, 2, 6, 8), 3, "whole", 0, 0),
    "last_scattered": ((3, 2, 3000), 2, "mixed", 0, 0),
    "last_tail": ((5, 70), 1, "tail", 0, 0),
    "width1": ((200, 1), 0, "mixed", 0, 0),
    "width3": ((200, 3), 0, "mixed", 0, 0),
    "width4": ((200, 4), 0, "mixed", 0, 0),
    "width5": ((200, 5), 0, "mixed", 0, 0),
    "width64": ((3, 200, 64), 1, "mixed", 0, 0),
    "unaligned_dst": ((120, 8), 0, "mixed", 1, 0),
    "unaligned_both": ((120, 8), 0, "owned", 3, 3),
    "wide_row": ((4, 4500), 0, "wide", 0, 0),
}
SIXTEEN_SEGMENTS = 16  # csrc/publish.cu MAX_SEGMENTS: one launch


def _repair_idx(rng, n, kind):
    if kind == "owned":
        return np.arange(n // 2, dtype=np.int64)
    if kind == "whole":
        return np.arange(n, dtype=np.int64)
    if kind == "tail":
        return np.arange(-8, 0, dtype=np.int64)
    if kind == "wide":
        return np.array([2, -1, 4], np.int64)
    run = np.arange(n // 4, n // 4 + n // 3)
    rest = rng.permutation(n)[:n // 4]
    idx = np.concatenate([run, rest, [-1, -n, n, -n - 1]]).astype(np.int64)
    pad = tpub.next_pow2(len(idx)) - len(idx)
    return np.concatenate([idx, np.repeat(idx[-1:], pad)])


def _repair_segment(rng, shape, axis, kind, dst_off, val_off):
    """(leaf, axis, idx, values, dst_off, val_off), numpy u32; duplicate
    cells carry their first row, as the store's padding does."""
    leaf = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    n = shape[axis]
    idx = _repair_idx(rng, n, kind)
    vshape = list(shape)
    vshape[axis] = len(idx)
    values = rng.integers(0, 2 ** 32, vshape, dtype=np.uint64).astype(
        np.uint32)
    _, first, inverse = np.unique(np.where(idx < 0, idx + n, idx),
                                  return_index=True, return_inverse=True)
    values = np.take(values, first[inverse.reshape(-1)], axis=axis)
    return leaf, axis, idx, values, dst_off, val_off


def _repair_case(case):
    """The segments of a repair case: one, or SIXTEEN_SEGMENTS of the
    width and last-axis cases for "sixteen"."""
    rng = np.random.default_rng(len(case))
    if case == "sixteen":
        names = sorted(c for c in _REPAIR_CASES if c.startswith(("width",
                                                                 "last")))
        return [_repair_segment(rng, *_REPAIR_CASES[names[k % len(names)]])
                for k in range(SIXTEEN_SEGMENTS)]
    return [_repair_segment(rng, *_REPAIR_CASES[case])]


def _words(a, offset=0, device="cpu"):
    """A u32 array as int32 words (same bits), a view `offset` words
    into a larger buffer on `device`."""
    flat = torch.from_numpy(a.view(np.int32).reshape(-1).copy())
    buf = torch.zeros(offset + flat.numel(), dtype=torch.int32,
                      device=device)
    buf[offset:] = flat.to(device)
    return buf[offset:].view(a.shape)


@pytest.mark.parametrize("case", [0, 1, 2] + sorted(_REPAIR_CASES)
                         + ["sixteen"])
def test_repair_scatter_plain_matches_reference_repair_fn(case):
    """repair_segments_plain against the reference store's jitted
    `_repair_fn` (leaf.at[(slice(None),) * axis + (idx,)].set(values)):
    negative indices count from the end once, an index still out of
    range is dropped.  Cases 0, 1, 2 are the axes of a (6, 8, 10) leaf;
    the named ones the shapes REPAIR_SCATTER's paths take (inner 1
    along the last axis, owned and scattered; row widths 1 to 64; an
    unaligned destination; a row wider than a tile; sixteen
    segments)."""
    _need_jax()
    from cilium_tpu.engine.publish import DeviceTableStore as JStore

    if isinstance(case, int):
        axis = case
        rng = np.random.default_rng(axis)
        leaf = rng.integers(0, 2 ** 32, (6, 8, 10), dtype=np.uint64).astype(
            np.uint32)
        n = leaf.shape[axis]
        idx = np.array([0, -1, n - 2, n + 3, -n - 1, 2], np.int64)
        shape = list(leaf.shape)
        shape[axis] = len(idx)
        values = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(
            np.uint32)
        segments = [(leaf, axis, idx, values, 0, 0)]
    else:
        segments = _repair_case(case)
    fields = tuple(f.name for f in dataclasses.fields(jtab.PolicyTables))
    jt0 = jtab.PolicyTables(**{f: None for f in fields})
    dsts, wants = [], []
    for leaf, axis, idx, values, dst_off, val_off in segments:
        jt = dataclasses.replace(jt0, l3_allow_bits=jax.numpy.asarray(leaf))
        fn = JStore()._repair_fn(("l3_allow_bits",), (axis,))
        wants.append(np.asarray(fn(jt, ((jax.numpy.asarray(idx),
                                         jax.numpy.asarray(values)),))
                                .l3_allow_bits))
        dsts.append((_words(leaf, dst_off), axis, torch.from_numpy(idx),
                     _words(values, val_off)))
    tpub.repair_segments_plain(dsts)
    for (dst, *_), want in zip(dsts, wants):
        np.testing.assert_array_equal(dst.numpy().view(np.uint32), want)


def test_route_repair_splits_rows_by_block():
    """route_repair sends each row of a sharded axis to the block that
    owns it, in the block's coordinates."""
    mesh = tmesh.make_mesh(2, 4, device="cpu")
    sh = tmesh.NamedSharding(mesh, tmesh.P("table"))
    vals = np.arange(5 * 3).reshape(5, 3)
    idx = np.array([0, 5, 9, 15, -1])
    got = {c: tpub.route_repair(idx, vals, 0, (16, 3), sh, c)
           for c in mesh.coords()}
    np.testing.assert_array_equal(got[(0, 0)][0], [0])
    np.testing.assert_array_equal(got[(1, 1)][0], [1])
    np.testing.assert_array_equal(got[(0, 2)][0], [1])
    np.testing.assert_array_equal(got[(0, 3)][0], [3, 3])
    np.testing.assert_array_equal(got[(0, 3)][1], vals[[3, 4]])
    # along the unsharded axis jax's rules still hold: -1 counts from the
    # end once, -4 (below -n) and 3 are dropped, the rows are sliced
    vals = np.arange(16 * 5).reshape(16, 5)
    idx = np.array([0, -1, -4, 3, 1])
    for c in mesh.coords():
        got_idx, got_vals = tpub.route_repair(idx, vals, 1, (16, 3), sh, c)
        lo = 4 * c[1]
        np.testing.assert_array_equal(got_idx, [0, 2, 1])
        np.testing.assert_array_equal(got_vals, vals[lo:lo + 4][:, [0, 1, 4]])


# -- REPAIR_SCATTER on the card ----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random"] + sorted(_REPAIR_CASES)
                         + ["sixteen"])
def test_repair_scatter_kernel_matches_plain(case):
    """REPAIR_SCATTER against repair_segments_plain on the card, one
    launch a case: three random leaves along axes 0, 1 and 2 with
    negative and out-of-range indices, and each named case of the plain
    version's test (inner 1 along the last axis, owned and scattered;
    row widths 1 to 64; unaligned views; a row wider than a tile;
    sixteen segments)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cilium_tpu_torch import kernels

    rng = np.random.default_rng(1)
    segs = {"cpu": [], "cuda": []}
    if case == "random":
        for axis, shape in ((0, (4096, 64)), (1, (3, 2000, 7)),
                            (2, (32, 2, 96))):
            leaf = rng.integers(-2 ** 31, 2 ** 31, shape,
                                dtype=np.int64).astype(np.int32)
            n = shape[axis]
            idx = np.concatenate([rng.integers(-n - 3, n + 3, 300), [0, -1]])
            vshape = list(shape)
            vshape[axis] = idx.size
            values = rng.integers(-2 ** 31, 2 ** 31, vshape,
                                  dtype=np.int64).astype(np.int32)
            # duplicates carry identical rows, as the store's padding does
            _, first = np.unique(np.where(idx < 0, idx + n, idx),
                                 return_index=True)
            idx = idx[np.sort(first)]
            values = np.take(values, np.sort(first), axis=axis)
            for dev in ("cpu", "cuda"):
                segs[dev].append((torch.from_numpy(leaf.copy()).to(dev),
                                  axis, torch.from_numpy(idx).to(dev),
                                  torch.from_numpy(values).to(dev)))
    else:
        for leaf, axis, idx, values, dst_off, val_off in _repair_case(case):
            for dev in ("cpu", "cuda"):
                segs[dev].append((_words(leaf, dst_off, dev), axis,
                                  torch.from_numpy(idx).to(dev),
                                  _words(values, val_off, dev)))
    before = kernels.REPAIR_SCATTER.launches
    kernels.REPAIR_SCATTER(segs["cuda"])
    tpub.repair_segments_plain(segs["cpu"])
    torch.cuda.synchronize()
    assert kernels.REPAIR_SCATTER.launches == before + 1
    for (a, *_), (b, *_) in zip(segs["cpu"], segs["cuda"]):
        assert torch.equal(a, b.cpu())
