"""The port's record replay through the fused datapath against the JAX
package, on the CPU, with tolerance 0 (every value is an integer):

  * every single-batch form (`datapath_step_with_counters`,
    `datapath_step_accum`, its ingress and egress forms,
    `datapath_step_telem`, `datapath_step_accum_telem`) against its
    jitted JAX function on the SMALL config-5 world's wide tables, port-
    built and carried across, over every pool flow plus rows with
    direction 2 and 255 and endpoint words past the axis (7, and
    0xFFFFFFFF): the 15 columns, the counters and the telemetry;
  * the unpacked pair forms and the packed4 one;
  * `read_flow_batches` against JAX's;
  * `replay()` against JAX's `replay()`: counters on and off, telemetry
    on and off, a partial tail, an `ep_map` with an unknown id, records
    with direction 2 and 255; the stats, the u64 counters, the
    telemetry and the metrics registry's deltas of the four telemetry
    counters; and churn mode with `ct_map` (stats, counters, every CT
    entry, the snapshot);
  * the host telemetry fold and `composed_oracle` (64 rows, with its
    stages) against JAX's, and the port's step against the oracle.

The `cuda`-marked tests hold DATAPATH_STEP's forms against their plain
versions on the card and replay() on the card against the plain loop;
they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_replay.py -q -m cuda
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, metrics, telemetry, world
from cilium_tpu_torch import replay as trp
from cilium_tpu_torch.ct import table as tct
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import hostpath as thp
from cilium_tpu_torch.engine import verdict as tvd
from cilium_tpu_torch.native.loader import encode_flow_records

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)
TELEM_METRICS = ("forward_count", "drop_count", "policy_verdict_total",
                 "datapath_stage_total")

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu import metrics as jmetrics
    from cilium_tpu import replay as jrp
    from cilium_tpu import telemetry as jtelemetry
    from cilium_tpu.ct import table as jct
    from cilium_tpu.engine import datapath as jdp
    from cilium_tpu.engine import hostpath as jhp
    from cilium_tpu.engine import verdict as jvd
    from torch_parity import (
        assert_same_buffers,
        assert_same_verdicts,
        convert_ct,
        jax_host_tables,
        jax_inputs,
        jax_leaves,
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


_CACHE = {}


def _world(seed=1):
    key = ("world", seed)
    if key not in _CACHE:
        _CACHE[key] = world.make_world(seed=seed, **SMALL)
    return _CACHE[key]


@pytest.fixture(scope="module")
def tables():
    """(world, JAX tables, {source: port tables on the CPU}), built
    once for the module."""
    _need_jax()
    w = _world()
    jt = jax_host_tables(w, subword=False)
    return w, jt, {
        "port": convert.tables_to(w.host_tables(), "cpu"),
        "convert": convert.tables_from_numpy(jax_leaves(jt), device="cpu"),
    }


def _edge_flows(w) -> np.ndarray:
    """Every pool flow, then 96 of them again: 32 with direction 2, 32
    with 255, 16 with endpoint 7 (past the 4-endpoint axis) and 16 with
    endpoint 0xFFFFFFFF (-1 as int32); [8, B] u32."""
    packed = trp.pack_flow_pool(w.pool)
    more = packed[:, :96].copy()
    d = tdp.FLOW_COLUMNS.index("direction")
    e = tdp.FLOW_COLUMNS.index("ep_index")
    more[d, :32] = 2
    more[d, 32:64] = 255
    more[e, 64:80] = 7
    more[e, 80:96] = 0xFFFFFFFF
    return np.concatenate([packed, more], axis=1)


def _both_flows(packed):
    return (jdp.flow_batch_from_packed(jnp.asarray(packed)),
            tdp.flow_batch_from_packed(
                torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))))


def _assert_acc(acc, jacc):
    np.testing.assert_array_equal(acc.numpy().view(np.uint32), np.asarray(jacc))


@pytest.mark.parametrize("source", ["port", "convert"])
def test_single_batch_forms_match_jax(tables, source):
    w, jt, tts = tables
    tt = tts[source]
    jf, tf = _both_flows(_edge_flows(w))

    jo, jl4, jl3 = jdp.datapath_step_with_counters(jt, jf)
    to, tl4, tl3 = tdp.datapath_step_with_counters(tt, tf)
    assert_same_verdicts(to, jo, "with_counters")
    _assert_acc(tl4, jl4)
    _assert_acc(tl3, jl3)
    assert int(jl4.sum()) > 0 and int(jl3.sum()) > 0

    for name in ("datapath_step_accum", "datapath_step_accum_ingress",
                 "datapath_step_accum_egress"):
        # carried buffers: what was there stays, the hits add to it
        jacc = jvd.make_counter_buffers(jt.policy) + 3
        tacc = tvd.make_counter_buffers(tt.policy) + 3
        jo, jacc = getattr(jdp, name)(jt, jf, jacc)
        to, tacc2 = getattr(tdp, name)(tt, tf, tacc)
        assert tacc2 is tacc  # in place
        assert_same_verdicts(to, jo, name)
        _assert_acc(tacc, jacc)

    jo, jrow = jdp.datapath_step_telem(jt, jf)
    to, trow = tdp.datapath_step_telem(tt, tf)
    assert_same_verdicts(to, jo, "telem")
    _assert_acc(trow, jrow)
    # the egress row is the column total minus the ingress row, so the
    # direction-2 and -255 rows count there
    assert int(np.asarray(jrow)[:, 0].sum()) == len(jf.saddr)

    jacc = jvd.make_counter_buffers(jt.policy)
    tacc = tvd.make_counter_buffers(tt.policy)
    jtel = jvd.make_telemetry_buffers() + 5
    ttel = tvd.make_telemetry_buffers("cpu") + 5
    jo, jacc, jtel = jdp.datapath_step_accum_telem(jt, jf, jacc, jtel)
    to, tacc, ttel = tdp.datapath_step_accum_telem(tt, tf, tacc, ttel)
    assert_same_verdicts(to, jo, "accum_telem")
    assert_same_buffers(tacc, ttel, jacc, jtel)


def test_pair_forms_match_jax(tables):
    w, jt, tts = tables
    tt = tts["port"]
    packed = trp.pack_flow_pool(w.pool)
    b = 1000
    jfi, tfi = _both_flows(packed[:, :b])
    jfe, tfe = _both_flows(packed[:, b:2 * b])

    jacc = jvd.make_counter_buffers(jt.policy)
    tacc = tvd.make_counter_buffers(tt.policy)
    joi, joe, jacc = jdp.datapath_step_accum_pair(jt, jfi, jfe, jacc)
    toi, toe, tacc = tdp.datapath_step_accum_pair(tt, tfi, tfe, tacc)
    assert_same_verdicts(toi, joi, "pair in")
    assert_same_verdicts(toe, joe, "pair eg")
    _assert_acc(tacc, jacc)

    jacc = jvd.make_counter_buffers(jt.policy)
    tacc = tvd.make_counter_buffers(tt.policy)
    jtel = jvd.make_telemetry_buffers()
    ttel = tvd.make_telemetry_buffers("cpu")
    joi, joe, jacc, jtel = jdp.datapath_step_accum_pair_telem(
        jt, jfi, jfe, jacc, jtel)
    toi, toe, tacc, ttel = tdp.datapath_step_accum_pair_telem(
        tt, tfi, tfe, tacc, ttel)
    assert_same_verdicts(toi, joi, "pair_telem in")
    assert_same_verdicts(toe, joe, "pair_telem eg")
    assert_same_buffers(tacc, ttel, jacc, jtel)

    # the packed4 form over the same flows
    p4 = [tdp.pack_flow_records4(**{c: w.pool[c][rows] for c in
                                    tdp.FLOW_COLUMNS})
          for rows in (np.arange(b), np.arange(b, 2 * b))]
    jacc = jvd.make_counter_buffers(jt.policy)
    tacc = tvd.make_counter_buffers(tt.policy)
    jtel = jvd.make_telemetry_buffers()
    ttel = tvd.make_telemetry_buffers("cpu")
    joi, joe, jacc, jtel = jdp.datapath_step_accum_pair_telem_packed4(
        jt, jnp.asarray(p4[0]), jnp.asarray(p4[1]), jacc, jtel)
    toi, toe, tacc, ttel = tdp.datapath_step_accum_pair_telem_packed4(
        tt, *(torch.from_numpy(p.view(np.int32)) for p in p4), tacc, ttel)
    assert_same_verdicts(toi, joi, "packed4 in")
    assert_same_verdicts(toe, joe, "packed4 eg")
    assert_same_buffers(tacc, ttel, jacc, jtel)

    # packed4 words hold what a pair half can carry, and no more
    assert torch.equal(tdp.pack_flow_batch4(tfi),
                       torch.from_numpy(p4[0].view(np.int32)))
    _, bad = _both_flows(_edge_flows(w)[:, -64:])
    with pytest.raises(ValueError, match="packed4"):
        tdp.pack_flow_batch4(bad)


def _records(w, n=700, seed=9, odd_directions=True):
    """`n` flow records from the pool with ids 100 + endpoint, 20 of
    them with an id no ep_map knows, and with `odd_directions` 8 with
    direction 2 and 8 with 255; and the ep_map."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(w.pool["saddr"]), n)
    pool = {c: w.pool[c][rows].copy() for c in tdp.FLOW_COLUMNS}
    ep_id = pool["ep_index"].astype(np.int64) + 100
    ep_id[:20] = 999
    if odd_directions:
        pool["direction"][20:28] = 2
        pool["direction"][28:36] = 255
    buf = encode_flow_records(
        ep_id=ep_id, identity=np.zeros(n, np.uint32),
        **{c: pool[c] for c in tdp.FLOW_COLUMNS if c != "ep_index"})
    ep_map = {100 + e: e for e in range(SMALL["n_endpoints"])}
    return buf, ep_map


def test_read_flow_batches_matches_jax(tables):
    w, _, _ = tables
    buf, ep_map = _records(w, n=300)
    got = list(trp.read_flow_batches(buf, 128, ep_map, device="cpu"))
    want = list(jrp.read_flow_batches(buf, 128, ep_map))
    assert [v for _, v in got] == [v for _, v in want] == [128, 128, 44]
    for (tf, _), (jf, _) in zip(got, want):
        for c in tdp.FLOW_COLUMNS:
            np.testing.assert_array_equal(
                getattr(tf, c).numpy(), np.asarray(getattr(jf, c)).astype(
                    np.int64 if c != "is_fragment" else bool), err_msg=c)
        assert tf.packed.shape == (8, 128)


def _metric_values(reg):
    return {name: dict(getattr(reg, name)._values) for name in TELEM_METRICS}


def _deltas(before, after):
    return {name: {k: v - before[name].get(k, 0.0)
                   for k, v in after[name].items()
                   if v != before[name].get(k, 0.0)}
            for name in TELEM_METRICS}


@pytest.mark.parametrize("counters", [True, False])
@pytest.mark.parametrize("telem", [True, False])
def test_replay_matches_jax(tables, counters, telem):
    w, jt, tts = tables
    tt = tts["port"]
    buf, ep_map = _records(w)
    jb, tb = _metric_values(jmetrics.registry), _metric_values(
        metrics.registry)
    js, jl4, jl3 = jrp.replay(jt, buf, batch_size=128,
                              accumulate_counters=counters, ep_map=ep_map,
                              collect_telemetry=telem)
    ts, tl4, tl3 = trp.replay(tt, buf, batch_size=128,
                              accumulate_counters=counters, ep_map=ep_map,
                              collect_telemetry=telem, device="cpu")
    jd = _deltas(jb, _metric_values(jmetrics.registry))
    td = _deltas(tb, _metric_values(metrics.registry))
    for f in ("total", "allowed", "denied", "redirected", "batches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.batches == 6 and ts.total == 700
    assert 0 < ts.allowed < 700 and ts.redirected > 0
    if counters:
        assert tl4.dtype == np.uint64 and tl3.dtype == np.uint64
        np.testing.assert_array_equal(tl4, jl4)
        np.testing.assert_array_equal(tl3, jl3)
    else:
        assert tl4 is None and tl3 is None and jl4 is None
    if telem:
        assert ts.telemetry.dtype == np.uint64
        np.testing.assert_array_equal(ts.telemetry, js.telemetry)
        assert td == jd and td["forward_count"]
    else:
        assert ts.telemetry is None and js.telemetry is None
        assert td == jd
    assert set(ts.spans) == {"host_pack", "dispatch", "drain"}
    assert ts.spans["dispatch"].num_success == 6


def test_replay_churn_mode_matches_jax(tables, monkeypatch):
    """`ct_map`: the counter-carrying step on first passes, reruns at a
    small claim table, CT write-back between batches.  Directions 0 and
    1 only: the reference's write-back cannot take a created flow of
    direction 2 or 255 (ROADMAP queue 3)."""
    w, jt, tts = tables
    tt = tts["port"]
    buf, ep_map = _records(w, n=900, seed=10, odd_directions=False)
    jmap, tmap = convert_ct(w.ct, jct), convert_ct(w.ct, tct)
    jmap.now = lambda: 0
    tmap.now = lambda: 0
    monkeypatch.setattr(jrp, "_CT_CLAIM_SLOTS", 1 << 8)
    monkeypatch.setattr(trp, "_CT_CLAIM_SLOTS", 1 << 8)
    monkeypatch.setattr(jrp, "_CHURN_FNS", None)  # retrace with the patch
    js, jl4, jl3 = jrp.replay(jt, buf, batch_size=256, ep_map=ep_map,
                              ct_map=jmap)
    ts, tl4, tl3 = trp.replay(tt, buf, batch_size=256, ep_map=ep_map,
                              ct_map=tmap, device="cpu")
    for f in ("total", "allowed", "denied", "redirected", "batches",
              "ct_created", "ct_deleted"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.batches == 4 and ts.ct_created > 0 and ts.reruns > 0
    np.testing.assert_array_equal(tl4, jl4)
    np.testing.assert_array_equal(tl3, jl3)
    from test_torch_churn import _assert_same_ct, _assert_same_snapshot

    _assert_same_ct(tmap, jmap)
    _assert_same_snapshot(tmap._device_churn_cache[1],
                          jmap._device_churn_cache[1])


def test_replay_refuses_what_waits_for_later_planes(tables):
    """manager= (since the control plane's port) runs the manager's
    stale-table check on tables.policy first, and its refusal stops the
    replay; flow_store= (since the flow plane's port) is refused in churn
    mode, as the reference refuses it."""
    w, _, tts = tables
    buf, _ = _records(w, n=10)

    class Stale:
        checked = []

        def check_tables_current(self, t):
            self.checked.append(t)
            raise ValueError("stale PolicyTables")

    with pytest.raises(ValueError, match="stale"):
        trp.replay(tts["port"], buf, 8, manager=Stale(), device="cpu")
    assert Stale.checked == [tts["port"].policy]
    from cilium_tpu_torch.flow import FlowStore

    with pytest.raises(ValueError, match="churn mode"):
        trp.replay(tts["port"], buf, 8, flow_store=FlowStore(),
                   ct_map=convert_ct(w.ct, tct), device="cpu")


def test_telemetry_fold_matches_jax(tables):
    """telemetry_from_outputs over a padded prefix (rows of direction 2
    and 255 count in neither row) and fold_telemetry into fresh
    registries."""
    w, jt, tts = tables
    jf, tf = _both_flows(_edge_flows(w))
    jo = jdp.datapath_step(jt, jf)
    to = tdp.datapath_step(tts["port"], tf)
    n = len(jf.saddr)
    for valid in (None, n - 40):
        want = jtelemetry.telemetry_from_outputs(jo, jf.direction, valid)
        got = telemetry.telemetry_from_outputs(to, tf.direction, valid)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
        # numpy columns fold the same
        np.testing.assert_array_equal(telemetry.telemetry_from_outputs(
            jo, np.asarray(jf.direction), valid), want)
    assert int(want[:, 0].sum()) < n - 40  # direction 2 / 255 left out
    jreg, treg = jmetrics.Registry(), metrics.Registry()
    jtelemetry.fold_telemetry(want, registry=jreg)
    telemetry.fold_telemetry(want, registry=treg)
    assert _metric_values(treg) == _metric_values(jreg)
    assert telemetry.telemetry_summary(want) == jtelemetry.telemetry_summary(
        want)
    with pytest.raises(ValueError, match="direction"):
        telemetry.telemetry_from_outputs(to, None)


def test_composed_oracle_matches_jax(tables):
    """64 pool rows (VIP flows among them) through both oracles, with
    their stages; the port's step on the same rows read through
    read_flow_batches agrees with the oracle, as bench.py's gate checks."""
    w, jt, tts = tables
    rng = np.random.default_rng(12)
    vip = np.nonzero((w.pool["daddr"] >> 24) == 172)[0]
    rows = np.concatenate([vip[:16], rng.integers(0, len(w.pool["saddr"]),
                                                  48)])
    inp = jax_inputs(w)
    jctx = {
        "prefilter": jhp.HostLPM({c: 1 for c in w.prefilter_cidrs}),
        "ipcache": jhp.HostLPM(w.ipc_map),
        "ct": inp["ct"],
        "mgr": inp["mgr"],
    }
    ctx = world.oracle_context(w)
    ctx["ct"] = copy.deepcopy(w.ct)
    states = copy.deepcopy(w.states)
    want = jhp.composed_oracle(jctx, inp["states"], w.pool, list(rows),
                               return_stages=True)
    got = thp.composed_oracle(ctx, states, w.pool, list(rows),
                              return_stages=True)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)
    assert got[3]["lb_hit"].any() and got[3]["ipcache_miss"].any()
    assert (got[3]["ct_res"] != 0).any()

    flows, valid = next(trp.read_flow_batches(
        world.pool_records(w, rows), len(rows), device="cpu"))
    out = tdp.datapath_step(tts["port"], flows)
    np.testing.assert_array_equal(out.allowed.numpy(), got[0])
    np.testing.assert_array_equal(out.proxy_port.numpy(), got[1])
    np.testing.assert_array_equal(out.sec_id.numpy().view(np.uint32), got[2])
    for col, key in (("pre_dropped", "pre_drop"), ("ct_result", "ct_res"),
                     ("match_kind", "match_kind"),
                     ("ipcache_miss", "ipcache_miss")):
        np.testing.assert_array_equal(
            getattr(out, col).numpy().astype(np.int64),
            got[3][key].astype(np.int64), err_msg=col)
    np.testing.assert_array_equal(out.lb_slave.numpy() > 0, got[3]["lb_hit"])


def test_replay_and_draw_default_to_the_card(tables):
    """device=None is the card: without one replay() and randint_u32
    raise instead of running the plain versions."""
    from cilium_tpu_torch import prng

    w, _, tts = tables
    buf, _ = _records(w, n=16)
    calls = [
        lambda d: trp.replay(tts["port"], buf, 8, device=d),
        lambda d: prng.randint_u32((0, 1), 8, 5, device=d),
        lambda d: trp.read_flow_batches(buf, 8, device=d).__next__(),
    ]
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(None)
        assert call("cpu") is not None


# -- on the card -----------------------------------------------------------------


def _card_tables():
    w = world.make_world(seed=3, **SMALL)
    return w, convert.tables_to(w.host_tables(), "cuda")


@pytest.mark.cuda
def test_step_forms_kernel_matches_plain():
    """Every single-batch form on the card against its plain version on
    the same device inputs: columns, counters, telemetry."""
    _need_card()
    from cilium_tpu_torch import kernels

    w, tt = _card_tables()
    packed = _edge_flows(w)
    flows = tdp.flow_batch_from_packed(
        torch.from_numpy(packed.view(np.int32)).cuda())
    before = kernels.DATAPATH_STEP.launches
    forms = [dict(), dict(emit_sec_id=False), dict(static_dir=0),
             dict(static_dir=1)]
    for form in forms:
        acc_k = tvd.make_counter_buffers(tt.policy) + 1
        tel_k = tvd.make_telemetry_buffers("cuda") + 2
        acc_p, tel_p = acc_k.clone(), tel_k.clone()
        got = kernels.DATAPATH_STEP(tt, tdp.pack_flow_batch(flows), None,
                                    acc=acc_k, telem=tel_k, **form)
        want = tdp.datapath_step_plain(tt, flows, acc=acc_p, telem=tel_p,
                                       **form)
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(got, col), getattr(want, col)), (
                form, col)
        assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p), form
    # the entry points route to the kernel
    out, l4, l3 = tdp.datapath_step_with_counters(tt, flows)
    plain = tdp.datapath_step_plain(tt, flows)
    assert torch.equal(out.sec_id, plain.sec_id)
    torch.cuda.synchronize()
    assert kernels.DATAPATH_STEP.launches == before + len(forms) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("churn", [False, True])
def test_replay_on_card_matches_plain(churn):
    """replay() on the card against replay() on the CPU: stats,
    counters, telemetry, and in churn mode every CT entry."""
    _need_card()
    w, tt = _card_tables()
    cpu_tt = convert.tables_to(w.host_tables(), "cpu")
    buf, ep_map = _records(w, n=5000, seed=4, odd_directions=not churn)
    res = []
    for tabs, dev in ((tt, "cuda"), (cpu_tt, "cpu")):
        ct = copy.deepcopy(w.ct) if churn else None
        if ct is not None:
            ct.now = lambda: 0
        st, l4, l3 = trp.replay(tabs, buf, 1024, ep_map=ep_map, ct_map=ct,
                                collect_telemetry=True, device=dev)
        res.append((st, l4, l3, ct))
    (a, a4, a3, act), (b, b4, b3, bct) = res
    for f in ("total", "allowed", "denied", "redirected", "batches",
              "ct_created", "ct_deleted", "rounds", "intents"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a4, b4)
    np.testing.assert_array_equal(a3, b3)
    if churn:
        assert a.telemetry is None and a.ct_created > 0
        assert act.entries == bct.entries
    else:
        np.testing.assert_array_equal(a.telemetry, b.telemetry)
