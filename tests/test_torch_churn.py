"""The PyTorch port's conntrack churn loop against the JAX package, on
the CPU, with tolerance 0 (every value is an integer):

  * the plain single-batch step (`datapath_step`, over the pool gather
    too) against the jitted `cilium_tpu.engine.datapath.datapath_step`
    on the SMALL config-5 world's wide tables: all 15 columns, over
    every pool flow (both directions, VIP flows, fragments, sources in
    the CIDR and unknown ranges) and rows whose direction is 2;
  * the plain intent compaction against `cilium_tpu.replay._churn_compact`
    with valid < B, at the default sizes and at a small claim table and
    cap (collisions, true losers and the cap cut);
  * the host CT fold (`apply_ct_writeback_host`, `apply_ct_writeback`)
    and `CTBucketIndex.apply` (the stash included) against JAX;
  * `apply_bucket_delta`, with the pow2 padding and a new stash;
  * `replay_pool` with explicit picks over three batches, the last
    partial, at a claim size that forces reruns: the stats, every CT
    entry (clocks pinned on both maps) and the final snapshot bytes;
    with int picks: the accounting JAX's own test checks;
  * the snapshot cache: reused while valid, rebuilt after a mutation
    or a change of the key set;
  * the 5-word CT probe and the 3-word L4 probe on hand-made rows: hits
    in the row and in the stash, duplicate hits summed, empty lanes.

The `cuda`-marked tests hold DATAPATH_STEP, CHURN_COMPACT and CT_DELTA
against their plain versions on the card, and the churn loop on the
card against the plain loop; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_churn.py -q -m cuda
"""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch import replay as trp
from cilium_tpu_torch.ct import device as tcd
from cilium_tpu_torch.ct import table as tct
from cilium_tpu_torch.engine import datapath as tdp

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu import replay as jrp
    from cilium_tpu.ct import device as jcd
    from cilium_tpu.ct import table as jct
    from cilium_tpu.engine import datapath as jdp
    from torch_parity import (
        assert_same_verdicts,
        convert_ct,
        jax_host_tables,
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


_WORLDS = {}


def _world(seed):
    if seed not in _WORLDS:
        _WORLDS[seed] = world.make_world(seed=seed, **SMALL)
    return _WORLDS[seed]


def _key(k):
    return (k.daddr, k.saddr, k.dport, k.sport, k.nexthdr, k.flags)


def _assert_same_ct(port_ct, jax_ct):
    """Same keys in the same order, and every CTEntry field equal (the
    JAX entry's extra fields at their defaults)."""
    assert [_key(k) for k in port_ct.entries] == [
        _key(k) for k in jax_ct.entries
    ]
    jdefault = jct.CTEntry()
    mine = {f.name for f in dataclasses.fields(tct.CTEntry)}
    for (k, v), jv in zip(port_ct.entries.items(), jax_ct.entries.values()):
        for f in dataclasses.fields(jv):
            want = getattr(jv, f.name)
            if f.name in mine:
                assert getattr(v, f.name) == want, (_key(k), f.name)
            else:
                assert want == getattr(jdefault, f.name), (_key(k), f.name)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _assert_same_snapshot(port_snap, jax_snap):
    assert port_snap.n_buckets == jax_snap.n_buckets
    np.testing.assert_array_equal(_u32(port_snap.buckets),
                                  np.asarray(jax_snap.buckets))
    np.testing.assert_array_equal(_u32(port_snap.stash),
                                  np.asarray(jax_snap.stash))


def _packed_flows(w, extra_dir2: int = 64):
    """Every pool flow, then `extra_dir2` pool flows again with
    direction 2, as [8, B] u32."""
    packed = trp.pack_flow_pool(w.pool)
    more = packed[:, :extra_dir2].copy()
    more[tdp.FLOW_COLUMNS.index("direction")] = 2
    return np.concatenate([packed, more], axis=1)


def _both_outputs(w, jt, tt, packed):
    """(JAX flows, JAX step output, port flows, port step output)."""
    jf = jdp.flow_batch_from_packed(jnp.asarray(packed))
    jo = jdp.datapath_step(jt, jf)
    tf = tdp.flow_batch_from_packed(torch.from_numpy(packed.view(np.int32)))
    return jf, jo, tf, tdp.datapath_step(tt, tf)


def _port_tables(w, jt, source):
    if source == "convert":
        return convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    return convert.tables_to(w.host_tables(), "cpu")


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("source", ["port", "convert"])
def test_datapath_step_matches_jax(seed, source):
    _need_jax()
    w = _world(seed)
    jt = jax_host_tables(w, subword=False)
    tt = _port_tables(w, jt, source)
    assert tt.ct.entry_words == 5 and tt.policy.l4_hash_stash.shape[1] == 3
    packed = _packed_flows(w)
    jf, jo, tf, to = _both_outputs(w, jt, tt, packed)
    assert_same_verdicts(to, jo, "datapath_step")
    # the pool route (gather inside the step) gives the same columns
    picks = np.arange(packed.shape[1] - 64, dtype=np.uint32)
    pool = convert.flow_pool_to(w.pool, "cpu")
    via_pool = tdp.datapath_step_pool(
        tt, pool, torch.from_numpy(picks.view(np.int32))
    )
    for col in tdp.VERDICT_COLUMNS:
        assert torch.equal(getattr(via_pool, col),
                           getattr(to, col)[: picks.size]), col
    # explicit picks at the pool's last row, past it and with bit 31
    # set: the reference's gather (replay.py _flows_from_pool) clamps
    # them as int32 indices, and so does the pool route
    n = pool.shape[1]
    edge = np.random.default_rng(seed).integers(0, n, packed.shape[1])
    edge[:7] = [n - 1, n, n + 9, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0]
    edge = edge.astype(np.uint32)
    jo_edge = jdp.datapath_step(jt, jrp._flows_from_pool(
        jnp.asarray(trp.pack_flow_pool(w.pool)), jnp.asarray(edge)))
    assert_same_verdicts(
        tdp.datapath_step_pool(tt, pool, torch.from_numpy(edge.view(np.int32))),
        jo_edge, "datapath_step over edge picks")
    # the mix reaches what the slice is about
    ct_res = np.asarray(jo.ct_result)
    assert all((ct_res == r).any() for r in (0, 1, 2)), np.bincount(ct_res)
    assert (np.asarray(jo.lb_slave) > 0).any()
    assert np.asarray(jo.ct_create).any() and np.asarray(jo.ct_delete).any()
    assert (np.asarray(jo.lb_slave)[-64:] > 0).any()  # direction 2 goes via LB
    assert np.asarray(tf.is_fragment).any()
    assert np.asarray(jo.ipcache_miss).any()


@pytest.mark.parametrize("sizes", ["default", "small"])
def test_churn_compact_matches_jax(sizes, monkeypatch):
    """valid < B; at the small sizes the claim table collides (true
    losers), later packets of a winner's flow lose silently, and the cap
    cuts the winners."""
    _need_jax()
    w = _world(1)
    jt = jax_host_tables(w, subword=False)
    tt = convert.tables_to(w.host_tables(), "cpu")
    rng = np.random.default_rng(4)
    packed = trp.pack_flow_pool(w.pool)[:, rng.integers(0, 3000, 6000)]
    jf, jo, tf, to = _both_outputs(w, jt, tt, packed)
    valid = 5500
    if sizes == "small":
        cap, slots = 64, 1 << 6
        for mod in (jrp, trp):
            monkeypatch.setattr(mod, "_CT_INTENT_CAP", cap)
            monkeypatch.setattr(mod, "_CT_CLAIM_SLOTS", slots)
    else:
        cap, slots = trp._CT_INTENT_CAP, trp._CT_CLAIM_SLOTS
    jh, ji = jrp._churn_compact(jo, jf, valid)  # eager: reads the patch
    th, ti = trp._churn_compact(to, tf, valid, cap, slots)
    np.testing.assert_array_equal(_u32(th), np.asarray(jh))
    np.testing.assert_array_equal(_u32(ti), np.asarray(ji))
    n_tx, _, _, remaining = (int(v) for v in np.asarray(jh))
    assert n_tx > 0
    if sizes == "small":
        assert n_tx == cap and remaining > 0
    # the pool route, at the patched module sizes, gives the same result
    pool = convert.flow_pool_to({c: packed[j] for j, c in
                                 enumerate(tdp.FLOW_COLUMNS)}, "cpu")
    picks = torch.arange(packed.shape[1], dtype=torch.int32)
    ph, pi = trp.churn_step(tt, pool, picks, valid)
    assert torch.equal(ph, th) and torch.equal(pi, ti)


def _writeback_arrays(rng, n, dnat_share=0.3):
    """Random intent columns as the churn drain hands them over (u32),
    with repeated rows, both directions and some DNATed creates."""
    daddr = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    saddr = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    dport = rng.integers(1, 1 << 16, n).astype(np.uint32)
    sport = rng.integers(1, 1 << 16, n).astype(np.uint32)
    proto = rng.choice([6, 17], n).astype(np.uint32)
    direction = rng.integers(0, 2, n).astype(np.uint32)
    dnat = rng.random(n) < dnat_share
    rev_nat = np.where(dnat, rng.integers(1, 9, n), 0).astype(np.uint32)
    slave = np.where(dnat, rng.integers(1, 4, n), 0).astype(np.uint32)
    orig_daddr = np.where(dnat, rng.integers(1, 1 << 31, n), daddr).astype(
        np.uint32)
    orig_dport = np.where(dnat, 80, dport).astype(np.uint32)
    create = rng.random(n) < 0.8  # a flow either creates or deletes
    rep = rng.integers(0, n, n // 5)
    cols = [daddr, dport, saddr, sport, proto, direction, rev_nat, slave,
            orig_daddr, orig_dport, create]
    return [np.concatenate([c, c[rep]]) for c in cols]


def test_ct_writeback_and_bucket_index_match_jax():
    """Creates (DNATed ones with their service entries) then deletes, on
    a map whose bucket index has 16 buckets, so rows overflow into the
    stash and stashed keys are deleted again."""
    _need_jax()
    rng = np.random.default_rng(8)
    maps, indexes = {}, {}
    for name, mod, dmod in (("port", tct, tcd), ("jax", jct, jcd)):
        m = mod.CTMap(max_entries=16)
        indexes[name] = dmod.CTBucketIndex(m)  # 16 buckets of 25 entries
        m.max_entries = 4096
        maps[name] = m
    for step in range(3):
        *cols, create = _writeback_arrays(rng, 140)
        delete = ~create
        if step == 2:  # delete keys created before, stashed ones among them
            keys = list(maps["port"].entries)[:: 3]
            cols = [np.array([getattr(k, f) for k in keys], np.uint32)
                    for f in ("daddr", "dport", "saddr", "sport", "nexthdr")]
            cols += [np.array([0 if k.flags == 0 else 1 for k in keys],
                              np.uint32)]
            cols += [np.zeros(len(keys), np.uint32)] * 2
            cols += [cols[0], cols[1]]
            create = np.zeros(len(keys), bool)
            delete = np.array([k.flags in (0, 1) for k in keys])
        out = {}
        for name, fn in (("port", tdp.apply_ct_writeback_host),
                         ("jax", jdp.apply_ct_writeback_host)):
            created, deleted = fn(
                maps[name], create, delete, *cols[:8], now=7,
                orig_daddr=cols[8], orig_dport=cols[9],
            )
            out[name] = ([_key(k) for k in created],
                         [_key(k) for k in deleted],
                         indexes[name].apply(created, deleted))
        assert out["port"][:2] == out["jax"][:2]
        assert out["port"][0] or out["port"][1]
        (pi, pr, ps), (ji, jr, js) = out["port"][2], out["jax"][2]
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pr, jr)
        assert (ps is None) == (js is None)
        if ps is not None:
            np.testing.assert_array_equal(ps, js)
        _assert_same_ct(maps["port"], maps["jax"])
    assert indexes["port"].stash_keys  # the stash was reached
    assert len(indexes["port"].stash_keys) == len(indexes["jax"].stash_keys)


def test_apply_ct_writeback_on_step_outputs_matches_jax():
    """The device-output wrapper on one step's outputs."""
    _need_jax()
    w = _world(2)
    jt = jax_host_tables(w, subword=False)
    tt = convert.tables_to(w.host_tables(), "cpu")
    jf, jo, tf, to = _both_outputs(w, jt, tt, _packed_flows(w))
    tmap, jmap = convert_ct(w.ct, tct), convert_ct(w.ct, jct)
    got = tdp.apply_ct_writeback(tmap, to, tf, now=3)
    want = jdp.apply_ct_writeback(jmap, jo, jf, now=3)
    assert got == want and got[0] > 0 and got[1] > 0
    _assert_same_ct(tmap, jmap)


def test_apply_bucket_delta_matches_jax():
    """Rows written in place (padded indices repeat the first changed
    bucket), a new stash replacing the old one; the snapshot carried
    across from JAX's leaves."""
    _need_jax()
    w = _world(1)
    jmap = convert_ct(w.ct, jct)
    jidx = jcd.CTBucketIndex(jmap)
    jsnap = jidx.full_snapshot()
    port = convert.ct_snapshot_from_numpy(
        {"buckets": jsnap.buckets, "stash": jsnap.stash,
         "n_buckets": jsnap.n_buckets}, device="cpu")
    buckets_before = port.buckets
    rng = np.random.default_rng(2)
    idx = np.sort(rng.choice(jsnap.n_buckets, 5, replace=False)).astype(
        np.int32)
    idx = np.concatenate([idx, np.full(3, idx[0], np.int32)])
    rows = rng.integers(0, 1 << 32, (5, 128), dtype=np.uint64).astype(
        np.uint32)
    rows = np.concatenate([rows, np.repeat(rows[:1], 3, axis=0)])
    stash = np.full((2, 5), 0xFFFFFFFF, np.uint32)
    stash[0] = [1, 2, 3, 4, 5]
    want = jcd.apply_bucket_delta(
        jax.device_put(jsnap), jnp.asarray(idx), jnp.asarray(rows), stash)
    got = tcd.apply_bucket_delta(port, idx, rows, stash)
    assert got is port and got.buckets is buckets_before  # in place
    _assert_same_snapshot(got, want)
    # without a stash only the rows change
    before = port.stash
    tcd.apply_bucket_delta(port, idx[:2], rows[1:3][::-1].copy())
    assert port.stash is before
    np.testing.assert_array_equal(_u32(port.buckets[idx[0]]), rows[2])


def _edge_delta(n, lanes, seed):
    """A delta over an n-bucket table holding every index case of jax's
    scatter rules: -1 and -n (counted from the end), n, n + 3 and -n - 1
    (dropped), a duplicate carrying an identical row, in-range rows."""
    idx = np.array([2, -1, n, 5, -n, n + 3, 2, -n - 1, 7], np.int32)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (idx.size, lanes), dtype=np.uint64
                        ).astype(np.uint32)
    rows[6] = rows[0]
    return idx, rows


def test_apply_bucket_delta_follows_jax_index_rules():
    """Out-of-range and negative indices as the jitted reference takes
    them: -1 and -n write rows n - 1 and 0, n, n + 3 and -n - 1 drop
    their rows.  A torch index write (the plain version before the
    repair) raises on n instead."""
    _need_jax()
    w = _world(1)
    jsnap = jcd.CTBucketIndex(convert_ct(w.ct, jct)).full_snapshot()
    n = 16
    small = {"buckets": np.asarray(jsnap.buckets)[:n].copy(),
             "stash": np.asarray(jsnap.stash), "n_buckets": n}
    idx, rows = _edge_delta(n, small["buckets"].shape[1], 3)
    port = convert.ct_snapshot_from_numpy(small, device="cpu")
    with pytest.raises(IndexError):
        port.buckets.clone()[torch.from_numpy(idx).long()] = torch.from_numpy(
            rows.view(np.int32))
    jfn = jax.jit(jcd.apply_bucket_delta)
    want = jfn(jax.device_put(jcd.CTSnapshot(
        buckets=jnp.asarray(small["buckets"]),
        stash=jnp.asarray(small["stash"]), n_buckets=n,
        entry_words=jsnap.entry_words)), jnp.asarray(idx), jnp.asarray(rows))
    got = tcd.apply_bucket_delta(port, idx, rows)
    _assert_same_snapshot(got, want)
    np.testing.assert_array_equal(_u32(got.buckets[n - 1]), rows[1])
    np.testing.assert_array_equal(_u32(got.buckets[0]), rows[4])


def _replay_both(w, picks, batch, slots, monkeypatch):
    jt = jax_host_tables(w, subword=False)
    tt = convert.tables_to(w.host_tables(), "cpu")
    jmap, tmap = convert_ct(w.ct, jct), convert_ct(w.ct, tct)
    jmap.now = lambda: 0
    tmap.now = lambda: 0
    monkeypatch.setattr(jrp, "_CT_CLAIM_SLOTS", slots)
    monkeypatch.setattr(trp, "_CT_CLAIM_SLOTS", slots)
    monkeypatch.setattr(jrp, "_CHURN_FNS", None)  # retrace with the patch
    js = jrp.replay_pool(jt, dict(w.pool), picks, batch_size=batch,
                         ct_map=jmap)
    ts = trp.replay_pool(tt, dict(w.pool), picks, batch_size=batch,
                         ct_map=tmap, device="cpu")
    return js, ts, jmap, tmap


@pytest.mark.parametrize("seed", [1, 2])
def test_replay_pool_explicit_picks_matches_jax(seed, monkeypatch):
    _need_jax()
    w = _world(seed)
    rng = np.random.default_rng(30 + seed)
    picks = rng.integers(0, 3000, 2 * 2048 + 700).astype(np.uint32)
    js, ts, jmap, tmap = _replay_both(w, picks, 2048, 1 << 10, monkeypatch)
    for f in ("total", "allowed", "denied", "redirected", "batches",
              "ct_created", "ct_deleted"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.batches == 3 and ts.total == picks.size
    assert ts.reruns > 0 and ts.ct_created > 0 and ts.ct_deleted > 0
    assert len(ts.intents) == ts.rounds
    _assert_same_ct(tmap, jmap)
    _assert_same_snapshot(tmap._device_churn_cache[1],
                          jmap._device_churn_cache[1])
    # the mirror and the snapshot agree
    full = tmap._device_churn_cache[0].full_snapshot()
    np.testing.assert_array_equal(_u32(tmap._device_churn_cache[1].buckets),
                                  full.buckets)


def test_replay_pool_int_picks_accounting():
    """Picks drawn on the device: totals add up over a partial final
    batch, created entries are pool flows' tuples, a second pass over
    the seeded CT creates little, and the draws are reproducible."""
    w = _world(1)
    tt = convert.tables_to(w.host_tables(), "cpu")
    ct = convert_ct_port(w.ct)
    ct2 = copy.deepcopy(ct)
    stats = trp.replay_pool(tt, dict(w.pool), 3000, batch_size=1024,
                            ct_map=ct, device="cpu")
    assert stats.total == 3000 and stats.batches == 3
    assert stats.allowed + stats.denied == 3000
    assert stats.ct_created > 0
    addrs = set(int(a) for a in w.pool["saddr"]) | set(
        int(a) for a in w.pool["daddr"])
    for key in ct.entries:
        if key not in w.ct.entries:
            assert key.saddr in addrs or key.daddr in addrs
    again = trp.replay_pool(tt, dict(w.pool), 3000, batch_size=1024,
                            ct_map=ct2, device="cpu")
    assert (again.allowed, again.ct_created, again.intents) == (
        stats.allowed, stats.ct_created, stats.intents)
    before = len(ct.entries)
    second = trp.replay_pool(tt, dict(w.pool), 2048, batch_size=1024,
                             ct_map=ct, device="cpu")
    assert second.total == 2048
    assert len(ct.entries) - before < stats.ct_created


def convert_ct_port(ct):
    out = copy.deepcopy(ct)
    out.now = lambda: 0
    return out


def test_snapshot_cache_is_gated_on_mutations_and_keys():
    w = _world(2)
    tt = convert.tables_to(w.host_tables(), "cpu")
    ct = convert_ct_port(w.ct)
    pool = dict(w.pool)
    picks = np.arange(512, dtype=np.uint32)

    def run():
        trp.replay_pool(tt, pool, picks, batch_size=512, ct_map=ct,
                        device="cpu")
        return ct._device_churn_cache

    first = run()
    assert first[2] == ct.mutations
    assert run()[0] is first[0]  # reused: nothing changed in between
    # a mutation through the map
    key = next(iter(ct.entries))
    ct.create(tct.CTTuple(key.daddr, key.saddr, key.dport, key.sport,
                          key.nexthdr), 1 - (key.flags & 1), now=0)
    second = run()
    assert second[0] is not first[0]
    # a key removed behind the map's back: mutations unchanged
    del ct.entries[next(iter(ct.entries))]
    third = run()
    assert third[0] is not second[0]
    # gc that drops entries bumps mutations
    for v in ct.entries.values():
        v.lifetime = 0
    assert ct.gc(now=1) > 0
    assert run()[0] is not third[0]
    # the rebuilt snapshot equals a fresh compile of the map
    snap = ct._device_churn_cache[1]
    np.testing.assert_array_equal(_u32(snap.buckets),
                                  tcd.compile_ct(ct).buckets)


def test_wide_ct_probe_matches_jax():
    """5-word rows and stash: forward hits (ESTABLISHED), reverse hits
    (REPLY), a stash-only hit, a key in the row twice and in the stash
    (summed), a zero key against empty lanes (NEW), service scope."""
    _need_jax()
    flows = [  # daddr, saddr, dport, sport, proto, direction
        (0x0A000001, 0x0A000002, 80, 40000, 6, 1),
        (0x0A000003, 0x0A000004, 53, 40001, 17, 0),
        (0x0A000005, 0x0A000006, 443, 40002, 6, 1),
        (0x0A000007, 0x0A000008, 8080, 40003, 6, 0),
        (0, 0, 0, 0, 0, 1),
        (0x0A000009, 0x0A00000A, 80, 40004, 6, 2),
    ]
    flag = {0: tct.TUPLE_F_OUT, 1: tct.TUPLE_F_IN, 2: tct.TUPLE_F_SERVICE}
    e = tcd.ENTRIES_PER_BUCKET
    rows = np.zeros((len(flows), 128), np.uint32)
    rows[:, 3 * e: 4 * e] = 0xFFFFFFFF
    stash = np.zeros((4, 5), np.uint32)
    stash[:, 3] = 0xFFFFFFFF

    def fwd(f):
        return tct.CTTuple(f[0], f[1], f[2], f[3], f[4], flag[f[5]])

    def rev(f):
        return tct.CTTuple(f[1], f[0], f[3], f[2], f[4],
                           flag[f[5]] ^ tct.TUPLE_F_IN)

    def put(b, lane, key, rev_nat, slave):
        words = tcd._pack_entry(key, tct.CTEntry(rev_nat_index=rev_nat,
                                                 slave=slave))
        for k, word in enumerate(words):
            rows[b, k * e + lane] = word

    put(0, 3, fwd(flows[0]), 2, 1)
    put(1, 24, rev(flows[1]), 0, 0)
    put(1, 0, fwd(flows[1]), 5, 5)  # REPLY takes precedence
    stash[0] = tcd._pack_entry(fwd(flows[2]), tct.CTEntry(rev_nat_index=3,
                                                          slave=2))
    put(3, 1, fwd(flows[3]), 1, 1)
    put(3, 7, fwd(flows[3]), 1, 2)
    stash[1] = tcd._pack_entry(fwd(flows[3]), tct.CTEntry(rev_nat_index=4,
                                                          slave=3))
    put(5, 10, fwd(flows[5]), 7, 2)
    cols = np.array(flows, np.int64).T
    jsnap = jcd.CTSnapshot(buckets=rows, stash=stash, n_buckets=8)
    tsnap = tcd.CTSnapshot(buckets=rows, stash=torch.from_numpy(
        stash.view(np.int32)), n_buckets=8)
    want = jcd.ct_probe_rows(
        jsnap, jnp.asarray(rows), *(jnp.asarray(c.astype(np.uint32))
                                    for c in cols[:2]),
        *(jnp.asarray(c.astype(np.int32)) for c in cols[2:]))
    got = tcd.ct_probe_rows(
        tsnap, torch.from_numpy(rows.view(np.int32)),
        *(torch.from_numpy(c) for c in cols))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(wv).astype(np.int64))
    assert got[0].tolist() == [1, 2, 1, 1, 0, 1]
    assert got[1][3] == 6 and got[2][3] == 6  # 1 + 1 + 4, 1 + 2 + 3


def test_wide_l4_probe_matches_jax():
    """3-word hashed entries: an exact hit, a key twice in its row and
    once in the stash (values summed), a stash-only hit, a miss, and
    empty lanes."""
    _need_jax()
    from cilium_tpu.compiler.tables import l4h_key0, l4h_key1
    from cilium_tpu.engine.hashtable import _fnv1a_host
    from cilium_tpu.engine.verdict import _l4hash_probe as j_probe
    from cilium_tpu_torch.engine.verdict import _l4hash_probe as t_probe

    nrows, e = 8, 4
    rows = np.full((nrows, 3 * e), 0xFFFFFFFF, np.uint32)
    rows[:, 2 * e:] = 0
    stash = np.full((2, 3), 0xFFFFFFFF, np.uint32)
    stash[:, 2] = 0
    q = dict(  # ep, dirn, idx, dport, proto per probe
        ep=np.array([0, 1, 2, 3, 300], np.int64),
        dirn=np.array([0, 1, 0, 1, 1], np.int64),
        idx=np.array([5, 6, 7, 8, (1 << 22) - 1], np.int64),
        dport=np.array([80, 443, 53, 8080, 9090], np.int64),
        proto=np.array([6, 6, 17, 6, 6], np.int64),
    )
    w0 = l4h_key0(q["idx"], q["dirn"], q["ep"]).astype(np.uint32)
    w1 = l4h_key1(q["dport"], q["proto"], q["ep"]).astype(np.uint32)
    home = _fnv1a_host(np.stack([w0, w1], axis=1)) & (nrows - 1)
    fill = np.zeros(nrows, int)

    def put(i, val):
        r = home[i]
        rows[r, fill[r]], rows[r, e + fill[r]] = w0[i], w1[i]
        rows[r, 2 * e + fill[r]] = val
        fill[r] += 1

    put(0, (3 << 16) | 15001)
    put(1, 1 << 16)
    put(1, 2)
    stash[0] = (w0[1], w1[1], 4)
    stash[1] = (w0[2], w1[2], (9 << 16) | 7)
    put(4, (2 << 16) | 3)  # the wildcard-index probe of a wide endpoint
    got = t_probe(torch.from_numpy(rows.view(np.int32)),
                  torch.from_numpy(stash.view(np.int32)),
                  *(torch.from_numpy(q[k]) for k in
                    ("ep", "dirn", "idx", "dport", "proto")))
    want = j_probe(rows, stash, *(jnp.asarray(q[k].astype(np.int32)) for k in
                                  ("ep", "dirn", "idx", "dport", "proto")))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    assert got[0].tolist() == [True, True, True, False, True]
    assert got[1][1] == (1 << 16) + 2 + 4


# -- on the card -----------------------------------------------------------------


def _card_world():
    w = world.make_world(seed=3, **SMALL)
    host = w.host_tables()
    return w, convert.tables_to(host, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [trp._CT_CLAIM_SLOTS, 1 << 8])
def test_churn_kernels_match_plain(slots):
    """DATAPATH_STEP, CHURN_COMPACT and CT_DELTA against their plain
    versions on the same device inputs, the wide tables."""
    _need_card()
    from cilium_tpu_torch import kernels

    w, tables = _card_world()
    pool = convert.flow_pool_to(w.pool, "cuda")
    picks = torch.randint(0, pool.shape[1], (50_000,), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1),
                          dtype=torch.int32)
    before = [k.launches for k in (kernels.DATAPATH_STEP,
                                   kernels.CHURN_COMPACT, kernels.CT_DELTA)]
    out = kernels.DATAPATH_STEP(tables, pool, picks)
    flows = tdp.flow_batch_from_packed(pool[:, picks.long()])
    plain = tdp.datapath_step_plain(tables, flows)
    # the FlowBatch entry point repacks CUDA columns and launches it too
    via_flows = tdp.datapath_step(tables, flows)
    for col in tdp.VERDICT_COLUMNS:
        assert torch.equal(getattr(out, col), getattr(plain, col)), col
        assert torch.equal(getattr(via_flows, col), getattr(plain, col)), col
    for cap in (trp._CT_INTENT_CAP, 100):
        h, i = kernels.CHURN_COMPACT(out, pool, picks, 49_000, cap, slots)
        ph, pi = trp._churn_compact(out, flows, 49_000, cap, slots)
        assert torch.equal(h, ph) and torch.equal(i, pi)
    snap = convert.ct_snapshot_to(tcd.compile_ct(w.ct), "cuda")
    ref = copy.deepcopy(snap)
    idx = torch.tensor([3, 9, 1, 3], dtype=torch.int32, device="cuda")
    rows = torch.randint(-2**31, 2**31 - 1, (4, 128), dtype=torch.int32,
                         device="cuda")
    rows[3] = rows[0]
    kernels.CT_DELTA(snap, idx, rows)
    tcd.apply_bucket_delta_plain(ref, idx, rows)
    torch.cuda.synchronize()
    assert torch.equal(snap.buckets, ref.buckets)
    after = [k.launches for k in (kernels.DATAPATH_STEP,
                                  kernels.CHURN_COMPACT, kernels.CT_DELTA)]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True])
def test_step_kernel_clamps_picks_as_plain(rows):
    """DATAPATH_STEP (the pool's row-major copy made by the wrapper, or
    passed in) and CHURN_COMPACT against their plain versions on picks at the
    pool's last row, past it and with bit 31 set, the wide tables."""
    _need_card()
    from cilium_tpu_torch import kernels

    w, tables = _card_world()
    pool = convert.flow_pool_to(w.pool, "cuda")
    n = pool.shape[1]
    edge = np.random.default_rng(2).integers(0, n, 20_000)
    edge[:7] = [n - 1, n, n + 9, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0]
    picks = torch.from_numpy(edge.astype(np.uint32).view(np.int32)).cuda()
    out = kernels.DATAPATH_STEP(
        tables, pool, picks,
        pool_rows=tdp.pool_rows_of(pool) if rows else None)
    flows = tdp.pool_flows(pool, picks)
    plain = tdp.datapath_step_plain(tables, flows)
    for col in tdp.VERDICT_COLUMNS:
        assert torch.equal(getattr(out, col), getattr(plain, col)), col
    h, i = kernels.CHURN_COMPACT(out, pool, picks, 19_000,
                                 trp._CT_INTENT_CAP, trp._CT_CLAIM_SLOTS)
    ph, pi = trp._churn_compact(out, flows, 19_000, trp._CT_INTENT_CAP,
                                trp._CT_CLAIM_SLOTS)
    torch.cuda.synchronize()
    assert torch.equal(h, ph) and torch.equal(i, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [128, 64, 12])
def test_ct_delta_kernel_follows_jax_index_rules(lanes):
    """CT_DELTA against its plain version on the edge indices (-1, -n,
    n, n + 3, -n - 1, a duplicate, in-range rows), at the wide, compact
    and a narrow row width (no 16-byte vectors)."""
    _need_card()
    from cilium_tpu_torch import kernels

    n = 16
    idx, rows = _edge_delta(n, lanes, 4)
    base = torch.randint(-2**31, 2**31 - 1, (n, lanes), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(lanes))
    snap = tcd.CTSnapshot(buckets=base.cuda(), stash=torch.zeros(
        (1, 5), dtype=torch.int32, device="cuda"), n_buckets=n)
    ref = copy.deepcopy(snap)
    idx_t = torch.from_numpy(idx).cuda()
    rows_t = torch.from_numpy(rows.view(np.int32)).cuda()
    before = kernels.CT_DELTA.launches
    kernels.CT_DELTA(snap, idx_t, rows_t)
    tcd.apply_bucket_delta_plain(ref, idx_t, rows_t)
    torch.cuda.synchronize()
    assert kernels.CT_DELTA.launches - before == 1
    assert torch.equal(snap.buckets, ref.buckets)
    assert torch.equal(snap.buckets[n - 1], rows_t[1])


@pytest.mark.cuda
def test_churn_loop_on_card_matches_plain(monkeypatch):
    """replay_pool with explicit picks on the card (the three kernels)
    and on the CPU (the plain versions): equal stats, CT entries and
    snapshot bytes."""
    _need_card()
    w, tables = _card_world()
    cpu_tables = convert.tables_to(w.host_tables(), "cpu")
    rng = np.random.default_rng(5)
    picks = rng.integers(0, len(w.pool["saddr"]), 3 * 4096 + 100).astype(
        np.uint32)
    maps = [convert_ct_port(w.ct), convert_ct_port(w.ct)]
    monkeypatch.setattr(trp, "_CT_CLAIM_SLOTS", 1 << 10)
    stats = [
        trp.replay_pool(t, dict(w.pool), picks, batch_size=4096, ct_map=m,
                        device=d)
        for t, m, d in ((tables, maps[0], "cuda"),
                        (cpu_tables, maps[1], "cpu"))
    ]
    a, b = (dataclasses.replace(s, seconds=0.0, fold_seconds=0.0)
            for s in stats)
    assert a == b and a.reruns > 0
    assert list(maps[0].entries) == list(maps[1].entries)
    assert maps[0].entries == maps[1].entries
    for leaf in ("buckets", "stash"):
        assert torch.equal(getattr(maps[0]._device_churn_cache[1], leaf).cpu(),
                           getattr(maps[1]._device_churn_cache[1], leaf))


@pytest.mark.cuda
def test_churn_loop_raises_on_a_layout_the_kernels_refuse():
    """No fallback: CUDA tables the kernels do not implement make the
    loop raise instead of running the plain version."""
    _need_card()
    w, tables = _card_world()
    # without the hashed rows the kernels take the dense lattice; without
    # its planes too they refuse the tables
    bad = dataclasses.replace(tables, policy=dataclasses.replace(
        tables.policy, l4_hash_rows=None, l4_allow_bits=None))
    with pytest.raises(ValueError, match="dense port_slot"):
        trp.replay_pool(bad, dict(w.pool), 1000, batch_size=1000,
                        ct_map=convert_ct_port(w.ct), device="cuda")
