"""The PyTorch port's policy publication on the CPU against the JAX
package's: MapStateArrays, FleetCompiler's incremental compile (leaf
for leaf, its index, its hashed tables against a from-scratch
placement), `delta_for`'s TableDelta, DeviceTableStore's two epochs
(the PublishStats sequence, every epoch leaf, the refusal of a delta
across a layout change, resident bytes, stale epochs) and the delta
scatter's plain version against jax's `.at[idx].set`.  Every comparison is exact integer
equality; the inputs are made from numpy seeds and handed to both
packages.

Generation stamps carry a per-process compiler nonce in their high 32
bits, so stamps are compared by their low 32 bits (the publish
counter), as the reference's device store compares them.

The cuda-marked tests at the end hold PUBLISH_SCATTER against its
plain version on the card; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_publish.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import world
from cilium_tpu_torch.compiler import delta as tdelta
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import publish as tpub
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.maps import policymap as tpm

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.compiler import delta as jdelta
    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import publish as jpub
    from cilium_tpu.engine import verdict as jv
    from cilium_tpu.maps import policymap as jpm
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

M32 = 0xFFFFFFFF
LEAVES = tuple(f.name for f in dataclasses.fields(ttab.PolicyTables))


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


# -- churn (tests/test_delta_publish.py's random_entry and churn_step) --------


def random_entry(rng, ids, ports):
    ident = int(rng.choice(ids)) if rng.random() > 0.15 else 0
    kind = rng.random()
    if kind < 0.15 and ident != 0:
        key = tpm.PolicyKey(ident, 0, 0, int(rng.integers(0, 2)))
    else:
        key = tpm.PolicyKey(
            ident,
            int(rng.choice(ports)),
            6 if rng.random() < 0.8 else 17,
            int(rng.integers(0, 2)),
        )
    return key, tpm.PolicyMapStateEntry(proxy_port=0)


def churn_step(rng, states, ids, ports):
    """Mutate a random endpoint's map state: add/remove/update."""
    ep = int(rng.choice(list(states)))
    st = states[ep]
    op = rng.random()
    if op < 0.55 or not st:
        k, v = random_entry(rng, ids, ports)
        st[k] = v
    elif op < 0.85:
        k = list(st)[int(rng.integers(0, len(st)))]
        del st[k]
    else:  # proxy-port style update: replace an entry wholesale
        k = list(st)[int(rng.integers(0, len(st)))]
        del st[k]
        k2, v2 = random_entry(rng, ids, ports)
        st[k2] = v2
    return ep


def _jax_state(st):
    return {
        jpm.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                      k.traffic_direction):
        jpm.PolicyMapStateEntry(proxy_port=v.proxy_port)
        for k, v in st.items()
    }


def _entries(states, tokens, arrays: bool):
    """(port entries, JAX entries) of the fleet: dict states, or
    MapStateArrays of each package."""
    port, ref = [], []
    for ep, st in sorted(states.items()):
        js = _jax_state(st)
        if arrays:
            port.append((ep, tpm.MapStateArrays.from_dict(dict(st)),
                         tokens[ep]))
            ref.append((ep, jpm.MapStateArrays.from_dict(js), tokens[ep]))
        else:
            port.append((ep, dict(st), tokens[ep]))
            ref.append((ep, js, tokens[ep]))
    return port, ref


def churn_run(seed: int, steps: int = 44):
    """The churn schedule both packages compile: yields (step, port
    entries, JAX entries, identity ids).  It grows the identity
    universe, removes an identity (a compiler reset), grows the slot
    space past filter_pad, removes and adds endpoints, and alternates
    dict and MapStateArrays states."""
    rng = np.random.default_rng(seed)
    ids = [256 + i for i in range(40)]
    spare = [1000, 1001, 1002]  # never in a state: removing one resets
    ports = [80, 443, 1000, 1001]
    states = {100 + e: {} for e in range(5)}
    tokens = {ep: 0 for ep in states}
    for ep in states:
        for _ in range(8):
            k, v = random_entry(rng, ids, ports)
            states[ep][k] = v
    for step in range(steps):
        ep = churn_step(rng, states, ids, ports)
        tokens[ep] += 1
        if step % 9 == 4:
            ids.append(256 + len(ids))
        if step == 12:
            ports.extend(7000 + i for i in range(8))
        if step == 22:
            spare.pop()
        if step == 30:
            gone = sorted(states)[1]
            del states[gone], tokens[gone]
        if step == 36:
            states[200] = dict(states[sorted(states)[0]])
            tokens[200] = 0
        port, ref = _entries(states, tokens, arrays=(step // 3) % 2 == 0)
        yield step, port, ref, ids + spare


def _np(leaf):
    """A leaf of either package (numpy, jax array or port tensor) ->
    numpy, u32 bits as u32, port_slot's int32 as u16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def assert_host_equal(port, ref, where=""):
    for name in LEAVES:
        a, b = getattr(port, name), getattr(ref, name)
        if name == "generation":
            assert int(a) & M32 == int(b) & M32, where
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, name)


def _same_words(dev_leaf, want) -> bool:
    got = _np(dev_leaf)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    elif want.dtype == np.uint16:
        got = got.astype(np.uint16)
    return got.shape == want.shape and np.array_equal(got, want)


def assert_epoch_equal(dev, host, where=""):
    """Every leaf of a port device epoch equals the host arrays (a JAX
    epoch or host tables): word for word, the stamp by its low bits."""
    for name in LEAVES:
        a, b = getattr(dev, name), getattr(host, name)
        if a is None or b is None:
            assert a is None and b is None, (where, name)
        elif name in ("generation", "id_lo_len"):
            assert int(a) & M32 == int(np.asarray(b)) & M32, (where, name)
        else:
            assert _same_words(a, b), (where, name)


def ground_truth_hash(compiler, order):
    """From-scratch placement over the compiler's cached entry columns."""
    ents = [compiler._rows[ep]["ent"] for ep in order]
    if not ents:
        return ttab.build_l4_hash_pair(*([np.zeros(0, np.uint32)] * 6))
    ep = np.concatenate(
        [np.full(len(e["d"]), i, np.uint32) for i, e in enumerate(ents)])
    cat = {k: np.concatenate([e[k] for e in ents])
           for k in ("d", "idx", "dport", "proto", "val")}
    return ttab.build_l4_hash_pair(ep, cat["d"], cat["idx"], cat["dport"],
                                   cat["proto"], cat["val"])


def assert_delta_equal(port, ref, where=""):
    assert (port is None) == (ref is None), where
    if port is None:
        return
    assert port.base_stamp & M32 == ref.base_stamp & M32, where
    assert port.new_stamp & M32 == ref.new_stamp & M32, where
    assert port.layout == ref.layout, where
    assert sorted(port.updates) == sorted(ref.updates), where
    assert sorted(port.replace) == sorted(ref.replace), where
    for name, u in port.updates.items():
        r = ref.updates[name]
        assert len(u.idx) == len(r.idx), (where, name)
        for a, b in zip(u.idx, r.idx):
            assert a.dtype == b.dtype and np.array_equal(a, b), (where, name)
        assert u.values.dtype == r.values.dtype, (where, name)
        assert np.array_equal(u.values, r.values), (where, name)
    for name, a in port.replace.items():
        b = ref.replace[name]
        if name == "generation":
            assert int(a) & M32 == int(b) & M32, where
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), (where, name)
    assert port.bytes_h2d == ref.bytes_h2d, where


# -- map states ----------------------------------------------------------------


def test_map_state_arrays_match_reference():
    _need_jax()
    rng = np.random.default_rng(3)
    ids = [0, 2, 256, 257, 1 << 24, (1 << 24) + 5]
    st = {}
    for _ in range(60):
        k, _ = random_entry(rng, ids, [0, 53, 80, 65535])
        st[k] = tpm.PolicyMapStateEntry(
            proxy_port=int(rng.integers(0, 3)) * 10000,
            packets=int(rng.integers(0, 9)), bytes=int(rng.integers(0, 99)))
    ref = {jpm.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                         k.traffic_direction):
           jpm.PolicyMapStateEntry(v.proxy_port, v.packets, v.bytes)
           for k, v in st.items()}
    a, b = tpm.MapStateArrays.from_dict(st), jpm.MapStateArrays.from_dict(ref)
    for name in ("keys_packed", "proxy", "packets", "bytes"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a == st and a.to_dict() == st and len(a) == len(st)
    for key, entry in st.items():
        assert key in a and a[key] == entry and a.get(key) == entry
    assert a.get(tpm.PolicyKey(9, 9, 9, 1)) is None
    cols = tpm.unpack_keys(a.keys_packed)
    for x, y in zip(cols, jpm.unpack_keys(b.keys_packed)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(tpm.pack_keys(*cols), a.keys_packed)
    # build keeps the last of duplicate keys, as dict insertion does
    keys = np.asarray([5, 3, 5, 1, 3], np.uint64)
    proxy = np.asarray([1, 2, 3, 4, 5], np.uint32)
    x, y = tpm.MapStateArrays.build(keys, proxy), jpm.MapStateArrays.build(
        keys, proxy)
    assert np.array_equal(x.keys_packed, y.keys_packed)
    assert np.array_equal(x.proxy, y.proxy)
    assert x.proxy.tolist() == [4, 5, 3]
    assert (tpm.MAX_ENTRIES, tpm.ALL_PORTS) == (jpm.MAX_ENTRIES,
                                                jpm.ALL_PORTS)


def test_one_rule_states_in_both_forms():
    """world.one_rule_states adds and removes bench's one-rule entries
    alike on dict and MapStateArrays states, and remove restores them;
    FleetCompiler lowers the arrays to JAX's tables from the same
    states."""
    _need_jax()
    w = world.make_world(seed=2, **_SMALL)
    arrays = world.map_state_arrays(w.states)
    for st, arr in zip(w.states, arrays):
        assert arr == tpm.MapStateArrays.from_dict(st)
    added = world.one_rule_states(w, 4311, team=1, endpoint=2)
    added_arr = world.one_rule_states(w, 4311, team=1, endpoint=2,
                                      states=arrays)
    assert all(a is b for i, (a, b) in enumerate(zip(added, w.states))
               if i != 2)
    for m in w.team_members[1]:
        key = tpm.PolicyKey(int(m), 4311, 6, tpm.INGRESS)
        assert key in added[2] and key in added_arr[2]
    assert added_arr[2] == tpm.MapStateArrays.from_dict(added[2])
    back = world.one_rule_states(w, 4311, team=1, endpoint=2,
                                 states=added_arr, remove=True)
    assert back[2] == arrays[2]
    port_c = ttab.FleetCompiler(w.identity_pad, w.filter_pad)
    ref_c = jtab.FleetCompiler(w.identity_pad, w.filter_pad)
    for tok, states in enumerate((arrays, added_arr, back)):
        pt, _ = port_c.compile(
            [(e, s, tok if e == 2 else 0) for e, s in enumerate(states)],
            w.identity_ids)
        rt, _ = ref_c.compile(
            [(e, jpm.MapStateArrays.from_dict(_jax_state(s.to_dict())),
              tok if e == 2 else 0) for e, s in enumerate(states)],
            w.identity_ids)
        assert_host_equal(pt, rt, f"publish {tok}")


_SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)


# -- the incremental compile ---------------------------------------------------


@pytest.mark.parametrize("seed", [7, 11])
def test_fleet_compiler_churn_matches_reference(seed):
    """At every churn step the port's FleetCompiler gives JAX's tables
    leaf for leaf and its endpoint index, and its incrementally kept
    hashed tables equal a from-scratch placement."""
    _need_jax()
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    resets = 0
    for step, port, ref, ids in churn_run(seed):
        before = port_c._reset_count
        pt, pidx = port_c.compile(port, ids)
        rt, ridx = ref_c.compile(ref, ids)
        resets += port_c._reset_count != before
        assert pidx == ridx, step
        assert_host_equal(pt, rt, f"step {step}")
        assert int(pt.generation) >> 32 == port_c._instance_nonce
        want = ground_truth_hash(port_c, sorted(pidx))
        got = (pt.l4_hash_rows, pt.l4_hash_stash, pt.l4_wild_rows,
               pt.l4_wild_stash)
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_), f"step {step}: hashed table"
        assert port_c.identity_index() == ref_c.identity_index()
    assert resets == 1


def test_fleet_compiler_universe_token_and_staleness():
    """A repeated universe token skips the identity diff in both
    packages; check_tables_current refuses tables two compiles old and
    accepts unstamped tables and another compiler's."""
    _need_jax()
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    ids = [256, 257]
    outs = []
    for tok, extra in ((1, []), (1, [258]), (2, [258])):
        st = {key: tpm.PolicyMapStateEntry()}
        pt, _ = port_c.compile([(1, st, tok)], ids + extra,
                               universe_token=tok)
        rt, _ = ref_c.compile([(1, _jax_state(st), tok)], ids + extra,
                              universe_token=tok)
        assert_host_equal(pt, rt, f"token {tok}")
        outs.append(pt)
    assert outs[1].id_table[2] == ttab.PAD_ID  # the token held it back
    assert outs[2].id_table[2] == 258
    port_c.check_tables_current(outs[2])
    port_c.check_tables_current(outs[1])
    with pytest.raises(ValueError, match="stale PolicyTables"):
        port_c.check_tables_current(outs[0])
    port_c.check_tables_current(ttab.compile_map_states([{}], ids))
    other = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    other.check_tables_current(outs[0])


# -- delta_for and the device store --------------------------------------------


def _store_pair():
    return tpub.DeviceTableStore(device="cpu"), jpub.DeviceTableStore()


def _stats(s):
    return (s.epoch, s.mode, s.bytes_h2d, s.scatter_leaves,
            s.replaced_leaves)


@pytest.mark.parametrize("seed", [7, 11])
def test_delta_and_store_match_reference(seed):
    """delta_for's TableDelta (updates, replace, layout, or None) and
    the store's PublishStats equal JAX's at every churn step; every leaf
    of the port's epoch equals JAX's epoch, and the host compile wherever
    JAX's does; the store's accessors agree."""
    _need_jax()
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    ps, rs = _store_pair()
    modes = []
    for step, port, ref, ids in churn_run(seed):
        pt, _ = port_c.compile(port, ids)
        rt, _ = ref_c.compile(ref, ids)
        pd = port_c.delta_for(ps.spare_stamp(), pt)
        rd = ref_c.delta_for(rs.spare_stamp(), rt)
        assert_delta_equal(pd, rd, f"step {step}")
        pdev, pst = ps.publish(pt, pd)
        rdev, rst = rs.publish(rt, rd)
        assert _stats(pst) == _stats(rst), step
        modes.append(pst.mode)
        where = f"step {step}"
        assert_epoch_equal(pdev, rdev, where)
        ref_matches_host = all(
            np.array_equal(np.asarray(getattr(rdev, n)), np.asarray(
                getattr(rt, n))) for n in LEAVES if n != "generation")
        if ref_matches_host:
            assert_epoch_equal(pdev, pt, where)
        assert ps.current()[1] is pdev and ps.holds(pdev)
        assert ps.current()[0] == rs.current()[0]
        assert ps.current_stamp() & M32 == rs.current_stamp() & M32
        assert ([s & M32 for s in ps.live_stamps()]
                == [s & M32 for s in rs.live_stamps()])
        assert ps.get(ps.current_stamp()) is pdev
        assert ps.get(12345) is None
    assert modes.count("delta") > len(modes) // 2


def test_delta_for_none_cases_match_reference():
    """No delta for an unknown base (None, 0), another compiler's stamp,
    a record gap (more than 8 compiles back) or stale tables; an empty
    delta for the current base."""
    _need_jax()
    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    other = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    st = {key: tpm.PolicyMapStateEntry()}
    ot, _ = other.compile([(1, st, 0)], [256])
    stamps = []
    for tok in range(11):
        st = {key: tpm.PolicyMapStateEntry(),
              tpm.PolicyKey(256, 1000 + tok, 6, 0): tpm.PolicyMapStateEntry()}
        pt, _ = port_c.compile([(1, st, tok)], [256])
        rt, _ = ref_c.compile([(1, _jax_state(st), tok)], [256])
        stamps.append((int(pt.generation), int(rt.generation)))
    for k in (None, 0):
        assert port_c.delta_for(k, pt) is None
        assert ref_c.delta_for(k, rt) is None
    assert port_c.delta_for(int(ot.generation), pt) is None
    # nine compiles back: the eight-record window has a gap
    assert port_c.delta_for(stamps[1][0], pt) is None
    assert ref_c.delta_for(stamps[1][1], rt) is None
    assert_delta_equal(port_c.delta_for(stamps[2][0], pt),
                       ref_c.delta_for(stamps[2][1], rt), "8 back")
    empty = port_c.delta_for(stamps[-1][0], pt)
    assert_delta_equal(empty, ref_c.delta_for(stamps[-1][1], rt), "current")
    assert not empty.updates and not empty.replace
    # tables that are not the compiler's latest compile
    prev = dataclasses.replace(pt, generation=np.uint64(stamps[-2][0]))
    assert port_c.delta_for(stamps[-3][0], prev) is None


def test_store_refuses_a_delta_across_a_layout_change():
    """An epoch in the compact sub-word layout (repack_l4_subword)
    carries another layout stamp: a delta published with repacked
    tables (onto a spare of the compiler's layout at step 4, onto a
    repacked spare at step 6) and a delta onto a repacked spare (step 8)
    upload in full in both packages, and deltas resume once the spare
    holds the compiler's layout again."""
    _need_jax()
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    ps, rs = _store_pair()
    got = []
    for step, port, ref, ids in churn_run(13, steps=10):
        pt, _ = port_c.compile(port, ids)
        rt, _ = ref_c.compile(ref, ids)
        pd = port_c.delta_for(ps.spare_stamp(), pt)
        rd = ref_c.delta_for(rs.spare_stamp(), rt)
        assert_delta_equal(pd, rd, f"step {step}")
        if step in (4, 6):
            pt = ttab.repack_l4_subword(pt)
            rt = jtab.repack_l4_subword(rt)
        pdev, pst = ps.publish(pt, pd)
        rdev, rst = rs.publish(rt, rd)
        assert _stats(pst) == _stats(rst), step
        assert_epoch_equal(pdev, pt, f"step {step}")
        assert_epoch_equal(pdev, rdev, f"step {step}")
        got.append((pst.mode, ttab.tables_layout_version(pdev)))
    assert [m for m, _ in got[2:]] == ["delta", "delta", "full", "delta",
                                      "full", "delta", "full", "delta"]
    assert got[4][1] == got[6][1] != got[3][1] == got[5][1] == got[8][1]


def test_store_counts_resident_bytes():
    """chip_bytes() is the two resident epochs' tensor bytes under the
    device's ordinal, and the per-chip gauge follows every publish."""
    from cilium_tpu_torch.metrics import registry

    def resident(epoch):
        return sum(t.numel() * t.element_size()
                   for t in (getattr(epoch, n) for n in LEAVES)
                   if isinstance(t, torch.Tensor))

    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    store = tpub.DeviceTableStore(device="cpu")
    assert store.chip_bytes() == {0: 0}
    epochs = []
    for tok in range(5):
        # the fourth compile adds 8 ports past filter_pad: Kg grows
        state = {key: tpm.PolicyMapStateEntry()}
        state.update({tpm.PolicyKey(257, 1000 + p, 6, tpm.INGRESS):
                      tpm.PolicyMapStateEntry()
                      for p in range(8 if tok >= 3 else tok)})
        pt, _ = port_c.compile([(1, state, tok)], [256, 257])
        dev, _ = store.publish(pt, port_c.delta_for(store.spare_stamp(), pt))
        epochs.append(dev)
        want = sum(resident(e) for e in epochs[-2:])
        assert store.chip_bytes() == {0: want}, tok
        assert registry.device_table_bytes_per_chip.get("0") == want, tok
    assert resident(epochs[3]) > resident(epochs[2])


def test_stale_epoch_and_in_flight_verdicts_match_reference():
    """The reference's epoch-swap scenario on both packages: verdicts of
    the live epoch equal JAX's after every publish, the previous epoch
    still gives its old verdicts, and the epoch two publishes back is
    refused with StaleEpochError."""
    _need_jax()
    ids = [256, 257, 258, 259]
    key_a = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    key_b = tpm.PolicyKey(257, 443, 6, tpm.INGRESS)
    key_c = tpm.PolicyKey(0, 53, 17, tpm.INGRESS)
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    ps, rs = _store_pair()
    cols = dict(
        ep_index=np.zeros(6, np.int64),
        identity=np.asarray([256, 257, 258, 256, 999, 259], np.uint32),
        dport=np.asarray([80, 443, 80, 81, 53, 53]),
        proto=np.asarray([6, 6, 6, 6, 17, 17]),
        direction=np.zeros(6, np.int64),
    )
    pb = tv.TupleBatch.from_numpy(**cols, device="cpu")
    rb = jv.TupleBatch.from_numpy(**cols)
    state = {key_a: tpm.PolicyMapStateEntry()}
    epochs, ref_epochs, verdicts = [], [], []
    for tok, change in enumerate((None, ("add", key_b), ("add", key_c),
                                  ("del", key_a))):
        if change is not None:
            op, key = change
            if op == "add":
                state[key] = tpm.PolicyMapStateEntry()
            else:
                del state[key]
        pt, _ = port_c.compile([(1, dict(state), tok)], ids)
        rt, _ = ref_c.compile([(1, _jax_state(state), tok)], ids)
        pdev, pst = ps.publish(pt, port_c.delta_for(ps.spare_stamp(), pt))
        rdev, rst = rs.publish(rt, ref_c.delta_for(rs.spare_stamp(), rt))
        assert _stats(pst) == _stats(rst)
        got = tv.evaluate_batch(pdev, pb, device="cpu")
        want = jv.evaluate_batch(rdev, rb)
        for col in ("allowed", "proxy_port", "match_kind"):
            assert np.array_equal(getattr(got, col).numpy(),
                                  np.asarray(getattr(want, col))), col
        if epochs:
            # the previous epoch is still live: its old verdicts
            ps.check_current(epochs[-1])
            old = tv.evaluate_batch(epochs[-1], pb, device="cpu")
            assert np.array_equal(old.allowed.numpy(), verdicts[-1])
        if len(epochs) >= 2:
            with pytest.raises(tpub.StaleEpochError):
                ps.check_current(epochs[-2])
            with pytest.raises(jpub.StaleEpochError):
                rs.check_current(ref_epochs[-2])
            assert not ps.holds(epochs[-2])
        epochs.append(pdev)
        ref_epochs.append(rdev)
        verdicts.append(got.allowed.numpy().copy())
    assert [v.tolist() for v in verdicts] == [
        [1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0], [1, 1, 0, 0, 1, 1],
        [0, 1, 0, 0, 1, 1]]
    assert ps.spare_stamp() & M32 == rs.spare_stamp() & M32


def test_delta_across_a_reset_mirrors_reference():
    """A reference fault the port mirrors (ROADMAP queue 3): after an
    identity removal resets the compiler, a delta from the spare stamped
    before the reset is still accepted, and its `port_slot` keeps the
    old numbering's cells.  Both packages give the same epoch, and both
    differ from the host compile in exactly that cell."""
    _need_jax()
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    ps, rs = _store_pair()
    k80 = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    k443 = tpm.PolicyKey(256, 443, 6, tpm.INGRESS)
    plan = (({k80, k443}, [256, 1000]), ({k80, k443}, [256, 1000]),
            ({k443}, [256]), ({k443}, [256]))
    modes = []
    for tok, (keys, ids) in enumerate(plan):
        st = {k: tpm.PolicyMapStateEntry() for k in sorted(
            keys, key=lambda k: k.dest_port)}
        pt, _ = port_c.compile([(1, st, tok)], ids)
        rt, _ = ref_c.compile([(1, _jax_state(st), tok)], ids)
        pdev, pst = ps.publish(pt, port_c.delta_for(ps.spare_stamp(), pt))
        rdev, rst = rs.publish(rt, ref_c.delta_for(rs.spare_stamp(), rt))
        assert _stats(pst) == _stats(rst), tok
        assert_epoch_equal(pdev, rdev, f"publish {tok}")
        modes.append(pst.mode)
    assert modes == ["full", "full", "full", "delta"]
    assert int(pdev.port_slot[6, 80]) == 0 == int(np.asarray(
        rdev.port_slot)[6, 80])
    assert pt.port_slot[6, 80] == ttab.NO_SLOT
    for name in LEAVES:
        if name not in ("port_slot", "generation"):
            assert _same_words(getattr(pdev, name), getattr(pt, name)), name


def test_failed_scatter_deregisters_the_spare_and_raises(monkeypatch):
    """A scatter that fails leaves no half-written epoch registered: the
    error propagates, the spare slot is dropped, and the next publish
    uploads in full."""
    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    comp = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    store = tpub.DeviceTableStore(device="cpu")
    for tok in range(2):
        t, _ = comp.compile([(1, {key: tpm.PolicyMapStateEntry()}, tok)],
                            [256, 257])
        store.publish(t, comp.delta_for(store.spare_stamp(), t))
    t, _ = comp.compile(
        [(1, {tpm.PolicyKey(257, 80, 6, 0): tpm.PolicyMapStateEntry()}, 2)],
        [256, 257])
    delta = comp.delta_for(store.spare_stamp(), t)
    assert delta is not None and delta.updates

    def boom(segments):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(tpub, "publish_scatter", boom)
    with pytest.raises(RuntimeError, match="scatter failed"):
        store.publish(t, delta)
    assert store.spare_stamp() is None and len(store.live_stamps()) == 1
    monkeypatch.undo()
    dev, st = store.publish(t, comp.delta_for(store.spare_stamp(), t))
    assert st.mode == "full"
    assert_epoch_equal(dev, t)


@pytest.mark.parametrize("spec,falls_back", [
    ("raise:next=1", True), ("raise:chip=0", True), ("raise:chip=5", False),
])
def test_injected_scatter_fault_falls_back_to_full_upload(spec, falls_back):
    """The publish.scatter fault seam, probed once per chip holding a
    slice of the spare (chip 0 on one device): a fired fault drops the
    spare and serves the publish by a full upload (publish_fallback_total,
    the publish.epoch span's `fallback`); a schedule scoped to a chip
    that holds no slice never fires and the delta lands."""
    from cilium_tpu_torch import faultinject, tracing
    from cilium_tpu_torch.metrics import registry as metrics

    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    comp = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    store = tpub.DeviceTableStore(device="cpu")
    for tok in range(2):
        t, _ = comp.compile([(1, {key: tpm.PolicyMapStateEntry()}, tok)],
                            [256, 257])
        store.publish(t, comp.delta_for(store.spare_stamp(), t))
    t, _ = comp.compile(
        [(1, {tpm.PolicyKey(257, 80, 6, 0): tpm.PolicyMapStateEntry()}, 2)],
        [256, 257])
    delta = comp.delta_for(store.spare_stamp(), t)
    before = metrics.publish_fallback_total.get()
    tracer = tracing.Tracer(sample_rate=1.0, seed=3)
    old = tracing.tracer
    tracing.tracer = tracer
    try:
        with faultinject.injected("publish.scatter", spec):
            dev, st = store.publish(t, delta)
    finally:
        tracing.tracer = old
    assert st.mode == ("full" if falls_back else "delta")
    assert (metrics.publish_fallback_total.get() - before
            == int(falls_back))
    span = [s for s in tracer.snapshot() if s.name == "publish.epoch"][-1]
    assert ("fallback" in span.attrs) == falls_back
    assert_epoch_equal(dev, t)


def test_epochs_never_share_storage():
    """A delta publish writes only the spare's tensors: the live epoch
    and the host arrays keep their words, and no tensor of one epoch is
    a tensor of the other."""
    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    comp = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    store = tpub.DeviceTableStore(device="cpu")
    epochs, hosts = [], []
    state = {key: tpm.PolicyMapStateEntry()}
    for tok in range(4):
        state[tpm.PolicyKey(257, 2000 + tok, 6, 0)] = (
            tpm.PolicyMapStateEntry())
        t, _ = comp.compile([(1, dict(state), tok)], [256, 257, 258])
        hosts.append(copy_tables(t))
        dev, st = store.publish(t, comp.delta_for(store.spare_stamp(), t))
        assert st.mode == ("full" if tok < 2 else "delta")
        epochs.append(dev)
        assert_epoch_equal(dev, hosts[-1])
        if tok:
            assert_epoch_equal(epochs[-2], hosts[-2])
            ptrs = {getattr(epochs[-2], n).data_ptr() for n in LEAVES
                    if isinstance(getattr(epochs[-2], n), torch.Tensor)}
            for n in LEAVES:
                leaf = getattr(dev, n)
                if isinstance(leaf, torch.Tensor):
                    assert leaf.data_ptr() not in ptrs, n


def copy_tables(t):
    """A host PolicyTables copied out of FleetCompiler's ping-pong
    buffers."""
    return dataclasses.replace(t, **{
        n: np.array(getattr(t, n), copy=True) for n in LEAVES
        if isinstance(getattr(t, n), np.ndarray)})


def test_generation_is_carried_to_the_device():
    """convert carries the stamp: policy_tables_to and tables_from_numpy
    (a JAX compile's leaves) keep it as a Python int."""
    _need_jax()
    from cilium_tpu_torch import convert

    comp = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    jt, _ = comp.compile(
        [(1, {jpm.PolicyKey(256, 80, 6, 0): jpm.PolicyMapStateEntry()}, 0)],
        [256])
    leaves = {f.name: (None if getattr(jt, f.name) is None
                       else np.asarray(getattr(jt, f.name)))
              for f in dataclasses.fields(jt)}
    pol = convert._plane_to(ttab.PolicyTables(**leaves), torch.device("cpu"))
    assert pol.generation == int(jt.generation) and pol.generation >> 32
    dev = convert.policy_tables_to(ttab.PolicyTables(**leaves), "cpu")
    assert_epoch_equal(dev, jt)
    assert ttab.tables_layout_version(dev) == jtab.tables_layout_version(jt)
    assert tdelta.tables_nbytes(ttab.PolicyTables(**leaves)) == (
        jdelta.tables_nbytes(jt))


# -- the scatter's plain version -----------------------------------------------

_SCATTER_CASES = {
    # leaf shape, dtype, indexed axes, index values per axis (None: a
    # consecutive run, a scattered unsorted part, negative and
    # out-of-range indices, pow2 padding repeating the last; _mixed_idx),
    # the destination's offset in words into a larger buffer
    "rows_u32": ((8, 2, 3), np.uint32, 1, ([0, -1, 3, 9, -9, 3, -8],), 0),
    "elements_u32": ((16,), np.uint32, 1, ([15, -16, 16, -17, 2, 2, 7],),
                     0),
    "port_slot_u16": ((6, 10), np.uint16, 2,
                      ([0, 5, -1, 6, 2, 2, -7, 3], [9, 0, -10, 1, 10, 4, 4,
                                                    -1]), 0),
    # the kernel's 16-byte and ragged paths: row widths of 1, 3, 4, 5, 64
    "width1_u32": ((300, 1), np.uint32, 1, None, 0),
    "width3_u32": ((300, 3), np.uint32, 1, None, 0),
    "width4_u32": ((300, 4), np.uint32, 1, None, 0),
    "width5_u32": ((300, 5), np.uint32, 1, None, 0),
    "width64_u32": ((300, 4, 16), np.uint32, 1, None, 0),
    # a destination whose start is not 16-byte aligned
    "unaligned_width8_u32": ((120, 8), np.uint32, 1, None, 1),
    # consecutive dports of one proto: one run of cells on two axes
    "port_slot_run_u16": ((17, 300), np.uint16, 2,
                          ([3] * 64 + [-1, 16, 17, -18, 2, 2, 2, 2],
                           list(range(100, 164)) + [-1, 299, 300, 5, 7, 7,
                                                    7, 7]), 0),
    # one row wider than a tile (1,024 to 8,192 words)
    "wide_row_u32": ((4, 2, 4500), np.uint32, 1, ([2, 0, -1, 4],), 0),
}
SIXTEEN_LEAVES = 16  # csrc/publish.cu MAX_SEGMENTS: one launch


def _mixed_idx(rng, n, k):
    """k-ish indices into an axis of n: a consecutive run, a scattered
    unsorted part, -1 and -n (counting from the end), n and -n - 1
    (dropped), padded to a power of two by repeating the last."""
    run = np.arange(n // 4, n // 4 + k // 2)
    rest = rng.permutation(n)[:k - len(run)]
    idx = np.concatenate([run, rest, [-1, -n, n, -n - 1]]).astype(np.int64)
    pad = tpub.next_pow2(len(idx)) - len(idx)
    return np.concatenate([idx, np.repeat(idx[-1:], pad)])


def _scatter_leaf(rng, shape, dtype, axes, idx, offset):
    """(base, idx, values, offset) of one leaf, numpy; duplicate cells
    carry their first row, as the store's padding does."""
    info = np.iinfo(dtype)
    base = rng.integers(0, int(info.max) + 1, size=shape,
                        dtype=np.int64).astype(dtype)
    if idx is None:
        idx = (_mixed_idx(rng, shape[0], 96),)
    idx = tuple(np.asarray(i, np.int64) for i in idx)
    r = len(idx[0])
    values = rng.integers(0, int(info.max) + 1, size=(r,) + shape[axes:],
                          dtype=np.int64).astype(dtype)
    cells = np.stack([np.where(i < 0, i + s, i)
                      for i, s in zip(idx, shape)], axis=1)
    _, first, inverse = np.unique(cells, axis=0, return_index=True,
                                  return_inverse=True)
    values = values[first[inverse.reshape(-1)]]
    return base, idx, values, offset


def _scatter_case(case):
    """The leaves of a scatter case: one, or SIXTEEN_LEAVES of the width
    cases for "sixteen_leaves"."""
    rng = np.random.default_rng(len(case))
    if case == "sixteen_leaves":
        names = sorted(c for c in _SCATTER_CASES if c.startswith("width"))
        return [_scatter_leaf(rng, *_SCATTER_CASES[names[k % len(names)]])
                for k in range(SIXTEEN_LEAVES)]
    return [_scatter_leaf(rng, *_SCATTER_CASES[case])]


def _u32_tensor(a, offset=0, device="cpu"):
    """A u32 or u16 array as the port's int32 words (same bits), as a
    view `offset` words into a larger buffer on `device`."""
    words = a.astype(np.int64).astype(np.uint32).view(np.int32).reshape(-1)
    buf = torch.zeros(offset + words.size, dtype=torch.int32, device=device)
    buf[offset:] = torch.from_numpy(words.copy()).to(device)
    return buf[offset:].view(a.shape)


@pytest.mark.parametrize("case", sorted(_SCATTER_CASES) + ["sixteen_leaves"])
def test_plain_scatter_matches_jax(case):
    """scatter_segments_plain against jitted jax `.at[idx].set` (the
    reference's scatter) with negative, out-of-range and duplicate
    indices (duplicates carry identical rows, as the store's pow2
    padding does), at the row widths and alignments the kernel's paths
    take."""
    _need_jax()
    leaves = _scatter_case(case)
    segs, wants = [], []
    for base, idx, values, offset in leaves:
        wants.append(np.asarray(jax.jit(lambda a, v, *i: a.at[i].set(v))(
            jnp.asarray(base), jnp.asarray(values),
            *[jnp.asarray(i) for i in idx])))
        segs.append((_u32_tensor(base, offset),
                     tuple(torch.from_numpy(i) for i in idx),
                     _u32_tensor(values)))
    tpub.publish_scatter(segs)
    for (dst, _, _), want in zip(segs, wants):
        got = dst.numpy().view(np.uint32)
        assert np.array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("outer,k,inner", [
    (1, 1, 2_129_920), (32_768, 520, 1), (64, 1040, 1), (1, 297_136, 64),
    (1, 3302, 64), (3, 3000, 1), (40, 8, 1), (4, 3, 4500), (7, 5, 3)])
def test_scatter_tiling_covers_every_word_once(outer, k, inner):
    """kernels.scatter_tiling (csrc/publish.cu decodes a block's tile
    the same way): along each axis of values [outer, k, inner] the
    tiles' chunks cover every index once, a tile stages at most
    MAX_TILE_ROWS index rows and moves at most its words, at the least
    and the most tile words.  Shapes: the sites' (a publish row, the
    readmission, the relayout, the churn delta), a narrow whole axis, a
    row wider than a tile, a ragged one."""
    from cilium_tpu_torch import kernels

    for words in kernels.SCATTER_TILE_WORDS:
        cols, log_rows, outers, ct, rt, ot = kernels.scatter_tiling(
            outer, k, inner, words)
        rows = 1 << log_rows
        assert rows <= kernels.MAX_TILE_ROWS and ct * rt * ot < 2 ** 31
        assert outers * min(rows, k) * cols <= words
        for n, step, tiles in ((inner, cols, ct), (k, rows, rt),
                               (outer, outers, ot)):
            cover = np.zeros(n, np.int64)
            for t in range(tiles):
                cover[t * step:(t + 1) * step] += 1
            assert (cover == 1).all()


def test_scatter_args_lay_out_segments_and_tiles():
    """kernels.scatter_args: each segment's fields in SEGMENT_FIELDS
    order with its tiling, tile_start the running count of tiles, then
    the segment count and the launch's tiles; the tile words follow the
    launch's payload words."""
    from cilium_tpu_torch import kernels

    geo = [(11, 12, 0, 13, 100, 1, 1, 64, 3302),
           (21, 22, 23, 24, 256, 65536, 1, 1, 2),
           (31, 32, 0, 33, 1040, 1, 64, 1, 1040)]
    args = list(kernels.scatter_args(geo, "test"))
    nf = len(kernels.SEGMENT_FIELDS)
    words = kernels.scatter_tile_words(sum(g[6] * g[7] * g[8] for g in geo))
    start = 0
    for n, g in enumerate(geo):
        seg = dict(zip(kernels.SEGMENT_FIELDS, args[n * nf:(n + 1) * nf]))
        tiling = kernels.scatter_tiling(g[6], g[8], g[7], words)
        assert args[n * nf:n * nf + len(g)] == list(g)
        assert [seg[f] for f in ("cols", "log_rows", "outers", "col_tiles",
                                 "row_tiles")] == list(tiling[:5])
        assert seg["tile_start"] == start
        start += tiling[3] * tiling[4] * tiling[5]
    assert args[len(geo) * nf:-2] == [0] * (nf * (
        kernels.MAX_SCATTER_SEGMENTS - len(geo)))
    assert args[-2:] == [len(geo), start]


def test_pad_pow2_matches_reference():
    _need_jax()
    for k in (1, 3, 4, 5):
        upd = tdelta.LeafUpdate(
            (np.arange(k, dtype=np.int64), np.arange(k, dtype=np.int64) * 2),
            np.arange(k * 3, dtype=np.uint32).reshape(k, 3))
        pi, pv = tpub._pad_pow2(upd)
        ri, rv = jpub._pad_pow2(upd)
        assert all(np.array_equal(a, b) for a, b in zip(pi, ri))
        assert np.array_equal(pv, rv) and len(pv) == tpub.next_pow2(k)


# -- the card --------------------------------------------------------------------


def _random_segments(dev, seed):
    """Leaves and payloads like a publish's: a row leaf, an element leaf
    and a 2-axis leaf, with negative, out-of-range and duplicate
    indices (duplicates carry identical rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, axes in (((64, 2, 16, 5), 1), ((1000,), 1), ((256, 300), 2)):
        base = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32))
        r = 37
        idx = [rng.integers(-s - 3, s + 3, size=r) for s in shape[:axes]]
        idx[0][-5:] = idx[0][:5]
        if axes == 2:
            idx[1][-5:] = idx[1][:5]
        vals = rng.integers(-2**31, 2**31, size=(r,) + shape[axes:],
                            dtype=np.int64).astype(np.int32)
        # every row of a cell carries the cell's first row
        cells = np.stack([np.where(i < 0, i + s, i)
                          for i, s in zip(idx, shape)], axis=1)
        for k in range(r):
            first = np.nonzero((cells[:k] == cells[k]).all(axis=1))[0]
            if len(first):
                vals[k] = vals[first[0]]
        out.append((base.to(dev),
                    tuple(torch.from_numpy(i.astype(np.int64)).to(dev)
                          for i in idx),
                    torch.from_numpy(vals).to(dev)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random"] + sorted(_SCATTER_CASES)
                         + ["sixteen_leaves"])
def test_publish_scatter_kernel_matches_plain(case):
    """PUBLISH_SCATTER against scatter_segments_plain on the card, one
    launch a case: the random leaves of a publish, and each case of the
    plain version's test (row widths 1 to 64 words, an unaligned
    destination, a run of port_slot cells, a row wider than a tile,
    sixteen leaves)."""
    _need_card()
    from cilium_tpu_torch import kernels

    if case == "random":
        segs = _random_segments("cuda", 1)
    else:
        segs = [(_u32_tensor(base, offset, "cuda"),
                 tuple(torch.from_numpy(i).cuda() for i in idx),
                 _u32_tensor(values, 0, "cuda"))
                for base, idx, values, offset in _scatter_case(case)]
    plain = [(d.clone(), i, v) for d, i, v in segs]
    before = kernels.PUBLISH_SCATTER.launches
    kernels.PUBLISH_SCATTER(segs)
    tpub.scatter_segments_plain(plain)
    torch.cuda.synchronize()
    assert kernels.PUBLISH_SCATTER.launches == before + 1
    for (a, _, _), (b, _, _) in zip(segs, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_store_on_the_card_matches_the_cpu_store():
    """The same churn through a store on the card (PUBLISH_SCATTER) and
    one on the CPU (the plain version): equal stats and epochs."""
    _need_card()
    from cilium_tpu_torch import kernels

    rng = np.random.default_rng(4)
    ids = [256 + i for i in range(40)]
    ports = [80, 443, 1000, 1001]
    states = {100 + e: {} for e in range(4)}
    tokens = {ep: 0 for ep in states}
    comp = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    card = tpub.DeviceTableStore()
    cpu = tpub.DeviceTableStore(device="cpu")
    before = kernels.PUBLISH_SCATTER.launches
    deltas = 0
    for step in range(24):
        ep = churn_step(rng, states, ids, ports)
        tokens[ep] += 1
        if step == 10:
            ports.extend(7000 + i for i in range(8))
        t, _ = comp.compile(
            [(e, dict(s), tokens[e]) for e, s in sorted(states.items())], ids)
        assert card.spare_stamp() == cpu.spare_stamp()
        d = comp.delta_for(card.spare_stamp(), t)
        kdev, kst = card.publish(t, d)
        cdev, cst = cpu.publish(t, d)
        assert _stats(kst) == _stats(cst)
        deltas += kst.mode == "delta" and kst.scatter_leaves > 0
        for name in LEAVES:
            a, b = getattr(kdev, name), getattr(cdev, name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.cpu(), b), (step, name)
            else:
                assert a == b, (step, name)
    assert kernels.PUBLISH_SCATTER.launches == before + deltas > before
