"""The PyTorch port's tuple-level lattice on the CPU against the JAX
package: the DIR-24-8 build and lookup, `evaluate_batch` (hashed 3-word,
compact 2-word and dense tables) with its counter form,
`evaluate_batch_from_ips`, the flow-record codec, `replay_lattice` and
the host oracle.  Every value is an integer: the tolerance is 0,
columns compared with np.array_equal.  The inputs are made from seeds
with numpy and handed to both packages.  The cuda-marked tests at the
end hold the LATTICE and LPM_LOOKUP kernels against their plain
versions on the card; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_lattice.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import oracle as tor
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.engine.hostpath import HostLPM
from cilium_tpu_torch.ipcache import lpm as tlpm
from cilium_tpu_torch.maps import policymap as tpm
from cilium_tpu_torch.native import loader as tld

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import oracle as jor
    from cilium_tpu.engine import verdict as jv
    from cilium_tpu.ipcache import lpm as jlpm
    from cilium_tpu.maps import policymap as jpm
    from cilium_tpu.native import loader as jld
    from torch_parity import convert_states
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


LAYOUTS = ("wide", "compact", "dense")
HASH_LEAVES = ("l4_hash_rows", "l4_hash_stash", "l4_wild_rows",
               "l4_wild_stash")


# -- worlds on both sides ------------------------------------------------------------


def _layout(tables, layout, repack):
    if layout == "compact":
        return repack(tables)
    if layout == "dense":
        return dataclasses.replace(tables, **{k: None for k in HASH_LEAVES})
    return tables


def _port_policy(w, layout):
    """The port's host PolicyTables of a world's map states, in one
    layout."""
    tt = ttab.compile_map_states(
        w.states, w.identity_ids, identity_pad=w.identity_pad,
        filter_pad=w.filter_pad,
    )
    return _layout(tt, layout, ttab.repack_l4_subword)


def _both_policies(w, layout):
    """(port PolicyTables on the CPU, JAX PolicyTables) of a world's map
    states, in one layout."""
    _need_jax()
    jt = jtab.compile_map_states(
        convert_states(w.states, tpm, jpm), w.identity_ids,
        identity_pad=w.identity_pad, filter_pad=w.filter_pad,
    )
    return (convert.policy_tables_to(_port_policy(w, layout), "cpu"),
            _layout(jt, layout, jtab.repack_l4_subword))


_SMALL5 = {}


def _small5():
    if not _SMALL5:
        w = world.make_world(seed=1, **SMALL)
        _SMALL5["w"] = w
        _SMALL5["rec"] = tld.decode_flow_records(
            world.lattice_records(w, 4000, seed=2))
    return _SMALL5["w"]


def _edge_columns(jt, e_count, n, rng):
    """`n` tuples mixing valid values with the edges: identities at the
    id_direct region edges and beyond the u32 sign bit, endpoints and
    directions out of range and negative, dports and protos outside
    their ranges, fragment words other than 0 and 1."""
    lo_len = int(jt.id_lo_len)
    direct_sz = int(jt.id_direct.shape[0])
    base = int(ttab.LOCAL_ID_BASE)
    live = np.asarray(jt.id_table)
    live = live[live != 0xFFFFFFFF]
    idents = np.array(
        [0, lo_len - 1, lo_len, base - 1, base, base + 1,
         base + direct_sz - lo_len - 1, base + direct_sz - lo_len,
         base + direct_sz, 1 << 31, 0xFFFFFFFF, 0xFFFFFFFE], np.uint64)
    eps = np.array([-1, -2, -e_count, -e_count - 1, e_count, e_count + 7,
                    1 << 20, 0, e_count - 1], np.int64)
    dirs = np.array([-1, -2, -3, 2, 7, 0, 1], np.int64)
    dports = np.array([-5, 0, 80, 443, 65535, 65536, 1 << 20], np.int64)
    protos = np.array([-1, 0, 6, 17, 255, 256, 1000], np.int64)
    frags = np.array([0, 1, 2, 0x80000000, 0xFFFFFFFF], np.uint64)

    def pick(edges, normal):
        edge = rng.random(n) < 0.3
        return np.where(edge, edges[rng.integers(0, len(edges), n)], normal)

    return dict(
        ep_index=pick(eps, rng.integers(0, e_count, n)),
        identity=pick(idents, live[rng.integers(0, len(live), n)]
                      .astype(np.uint64)).astype(np.uint32),
        dport=pick(dports, rng.integers(1, 10_000, n)),
        proto=pick(protos, rng.choice([6, 17], n)),
        direction=pick(dirs, rng.integers(0, 2, n)),
        is_fragment=pick(frags, (rng.random(n) < 0.05).astype(np.uint64)),
    )


def _config5_columns(w, jt, n, seed):
    """The small config-5 world's own tuples (lattice_records of its
    pool: each row's peer identity, so every probe kind and the L7
    redirects occur), then the edges."""
    rng = np.random.default_rng(seed)
    rec = _SMALL5["rec"]
    rows = rng.integers(0, len(rec["ep_id"]), n)
    own = dict(
        ep_index=rec["ep_id"][rows],
        identity=rec["identity"][rows],
        dport=rec["dport"][rows],
        proto=rec["proto"][rows],
        direction=rec["direction"][rows],
        is_fragment=rec["is_fragment"][rows],
    )
    edges = _edge_columns(jt, len(w.states), n // 2, rng)
    return {k: np.concatenate([np.asarray(own[k]).astype(np.int64),
                               np.asarray(edges[k]).astype(np.int64)])
            for k in own}


def _batches(cols):
    _need_jax()
    return (tv.TupleBatch.from_numpy(**cols, device="cpu"),
            jv.TupleBatch.from_numpy(**cols))


def assert_same_columns(port, ref, names, where=""):
    for name in names:
        got = getattr(port, name) if not isinstance(port, dict) else port[name]
        want = np.asarray(getattr(ref, name) if not isinstance(ref, dict)
                          else ref[name])
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        if want.dtype == np.uint32 and got.dtype == np.int32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, (where, name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {name}")


VERDICT_COLS = ("allowed", "proxy_port", "match_kind")


# -- DIR-24-8 -------------------------------------------------------------------------


LPM_MAPS = {
    # nested covers, a /25 block seeded from its /24, a /32 on top
    "overlaps": {"0.0.0.0/0": 1, "10.0.0.0/8": 5, "10.1.0.0/16": 6,
                 "10.1.2.0/24": 7, "10.1.2.128/25": 8, "10.1.2.130/32": 9,
                 "10.1.3.7/32": 10, "10.1.3.0/31": 11},
    # two strings normalising to one network: both painted, larger id
    # last; the address ends of the space; an IPv6 prefix skipped
    "duplicates": {"10.2.3.4/24": 12, "10.2.3.0/24": 3, "10.2.3.9/30": 13,
                   "10.2.3.8/30": 4, "255.255.255.255/32": 14,
                   "0.0.0.0/32": 15, "0.0.0.0/24": 16, "fd00::/64": 99,
                   "192.168.255.0/28": 17, "192.168.255.240/28": 18},
    # blocks of cells that shorter prefixes painted first, and /32s in
    # cells no prefix covers
    "blocks": {"172.16.0.0/12": 20, "172.16.5.0/24": 21,
               "172.16.5.17/32": 22, "172.31.255.255/32": 23,
               "8.8.8.8/32": 24, "8.8.4.4/32": 25, "100.64.0.0/10": 26,
               "100.127.255.0/26": 27},
    "empty": {},
}


def _edge_addresses(mapping, rng, n_random=2000):
    import ipaddress

    addrs = [0, 0xFFFFFFFF, 1, 0xFFFFFFFE]
    for cidr in mapping:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        lo, hi = int(net.network_address), int(net.broadcast_address)
        for a in (lo - 1, lo, lo + 1, hi - 1, hi, hi + 1,
                  lo & ~0xFF, lo | 0xFF, (lo & ~0xFF) - 1, (lo | 0xFF) + 1):
            addrs.append(a & 0xFFFFFFFF)
    addrs += rng.integers(0, 1 << 32, n_random, dtype=np.uint64).tolist()
    return np.asarray(addrs, np.uint64).astype(np.uint32)


@pytest.mark.parametrize("case", sorted(LPM_MAPS))
def test_build_lpm_and_lookup_match_jax(case):
    _need_jax()
    mapping = LPM_MAPS[case]
    tt, jt = tlpm.build_lpm(mapping), jlpm.build_lpm(mapping)
    for leaf in ("l1", "l2"):
        got, want = getattr(tt, leaf), np.asarray(getattr(jt, leaf))
        assert got.dtype == want.dtype and got.shape == want.shape, leaf
        assert np.array_equal(got, want), f"{case} {leaf}"
    if not mapping:
        assert tt.l2.shape == (1, 256) and not tt.l2.any()
    ips = _edge_addresses(mapping, np.random.default_rng(3))
    got = tlpm.lpm_lookup(convert.lpm_to(tt, "cpu"), ips, device="cpu")
    want = np.asarray(jlpm.lpm_lookup(jt, jnp.asarray(ips)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the host references agree on the edges (random rows skipped: the
    # lookup_host scan is slow)
    host = HostLPM(mapping)
    edge = ips[:-2000]
    for ip in edge:
        s = str(jax_ip(ip))
        assert tlpm.lookup_host(mapping, s) == jlpm.lookup_host(mapping, s)
    # HostLPM keeps one id per normalised network (the last string), so
    # it is held only where no two strings share a network
    if case != "duplicates":
        for ip, ident in zip(edge, got.numpy().view(np.uint32)[:len(edge)]):
            assert host.lookup(int(ip)) == int(ident)


def jax_ip(v):
    import ipaddress

    return ipaddress.ip_address(int(v))


def test_build_lpm_refusals_match_jax():
    _need_jax()
    big = {"10.0.0.0/8": 1 << 31}
    for build in (tlpm.build_lpm, jlpm.build_lpm):
        with pytest.raises(ValueError, match="31-bit"):
            build(big)
    # a bucketized IPCacheDevice is looked up once it lies on the device
    host = tlpm.build_ipcache({"10.0.0.0/8": 1})
    with pytest.raises(ValueError, match="ipcache tables"):
        tlpm.lpm_lookup(host, np.zeros(1, np.uint32), device="cpu")
    got = tlpm.lpm_lookup(convert.plane_to(host, "cpu"),
                          np.array([0x0A000001, 0x0B000001], np.uint32),
                          device="cpu")
    assert got.tolist() == [1, 0]


def test_lpm_from_numpy_carries_jax_tables():
    _need_jax()
    mapping = LPM_MAPS["overlaps"]
    jt = jlpm.build_lpm(mapping)
    tt = convert.lpm_from_numpy({"l1": jt.l1, "l2": jt.l2}, "cpu")
    ips = _edge_addresses(mapping, np.random.default_rng(4), 100)
    np.testing.assert_array_equal(
        tlpm.lpm_lookup(tt, ips, device="cpu").numpy().view(np.uint32),
        np.asarray(jlpm.lpm_lookup(jt, jnp.asarray(ips))))


# -- the tuple lattice --------------------------------------------------------------


def test_example_world_is_config1():
    """The port's config-1 map state, identity universe and batch are
    those __graft_entry__._build_example computes through the policy
    repository."""
    _need_jax()
    import __graft_entry__

    jt, jb, jstate = __graft_entry__._build_example(batch=1024,
                                                    return_state=True)
    w = world.example_world()
    assert convert_states(w.states, tpm, jpm) == [jstate]
    assert {k: (v.proxy_port, v.packets, v.bytes) for k, v in
            convert_states(w.states, tpm, jpm)[0].items()} == {
        k: (v.proxy_port, v.packets, v.bytes) for k, v in jstate.items()}
    tt, _ = _both_policies(w, "wide")
    np.testing.assert_array_equal(tt.id_table.numpy().view(np.uint32),
                                  np.asarray(jt.id_table))
    tb, _ = _batches(w.tuples)
    assert_same_columns(tb, jb, ("ep_index", "identity", "dport", "proto",
                                 "direction", "is_fragment"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("which", ["config1", "config5"])
def test_evaluate_batch_matches_jax(which, layout):
    """Config 1's own batch and the small config-5 world's tuples, both
    with edge inputs, through evaluate_batch on the CPU and the JAX
    reference's evaluate_batch."""
    _need_jax()
    rng = np.random.default_rng(5)
    if which == "config1":
        w = world.example_world()
        tt, jt = _both_policies(w, layout)
        edges = _edge_columns(jt, 1, 512, rng)
        cols = {k: np.concatenate([np.asarray(w.tuples[k]).astype(np.int64),
                                   np.asarray(edges[k]).astype(np.int64)])
                for k in edges if k in w.tuples}
        cols["is_fragment"] = np.concatenate(
            [np.zeros(len(w.tuples["ep_index"]), np.int64),
             edges["is_fragment"].astype(np.int64)])
    else:
        w = _small5()
        tt, jt = _both_policies(w, layout)
        cols = _config5_columns(w, jt, 3000, 6)
    assert tt.l4_hash_rows is None if layout == "dense" else (
        ttab.l4_entry_words(tt) == (2 if layout == "compact" else 3))
    tb, jb = _batches(cols)
    got = tv.evaluate_batch(tt, tb, device="cpu")
    want = jv.evaluate_batch(jt, jb)
    assert_same_columns(got, want, VERDICT_COLS, f"{which}/{layout}")
    kinds = np.bincount(got.match_kind.numpy(), minlength=5)
    assert kinds[tor.MATCH_L4] and kinds[tor.MATCH_NONE] and kinds[
        tor.MATCH_FRAG_DROP], kinds
    if which == "config5":
        assert kinds[tor.MATCH_L3] and kinds[tor.MATCH_L4_WILD], kinds
        assert int((got.proxy_port > 0).sum()) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_counter_form_matches_jax(layout):
    """Both counter planes of the counter form, on the small config-5
    world with the edge inputs (out-of-range and negative endpoints and
    directions reach the scatter)."""
    _need_jax()
    w = _small5()
    tt, jt = _both_policies(w, layout)
    cols = _config5_columns(w, jt, 3000, 7)
    tb, jb = _batches(cols)
    v, l4, l3 = tv.evaluate_batch_with_counters(tt, tb, device="cpu")
    jv_, jl4, jl3 = jax.jit(jv._verdict_kernel_with_counters)(jt, jb)
    assert_same_columns(v, jv_, VERDICT_COLS, layout)
    for got, want in ((l4, jl4), (l3, jl3)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    assert int(l4.sum()) > 0 and int(l3.sum()) > 0


STASH_ENDPOINTS = 16  # world.stash_world's
_STASH = []


def _stash_hosts():
    """world.stash_world, built once: (world, {layout: host
    PolicyTables}) for "wide" and "compact", whose entries overflow into
    both stashes."""
    if not _STASH:
        _STASH.append(world.stash_world())
    return _STASH[0]


def _stash_columns(w, hosts):
    """The stash-heavy world's tuples: 1,500 of bench's lattice tuples,
    1,500 with the edges (out-of-range endpoints, directions, dports,
    identities, fragment words), then one a used stash entry of each
    layout of `hosts` (world.stash_tuples)."""
    own = world.lattice_tuples(w, 1500, seed=23)
    own["is_fragment"] = np.zeros(1500, np.int64)
    parts = [own, _edge_columns(hosts["wide"], STASH_ENDPOINTS, 1500,
                                np.random.default_rng(24))] + [
        world.stash_tuples(h, 25) for h in hosts.values()]
    parts = [{k: np.asarray(p[k]).astype(np.int64) for k in own}
             for p in parts]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _stash_used(host):
    """Used rows of a host PolicyTables' exact and wildcard stashes."""
    recs = ttab.l4_entry_records(dataclasses.replace(
        host, l4_hash_rows=host.l4_hash_rows[:0],
        l4_wild_rows=host.l4_wild_rows[:0]))
    return [len(recs[k]["ep"]) for k in ("exact", "wild")]


@pytest.fixture(scope="module")
def stash_world():
    """world.stash_world on both sides: {layout: (port tables on the
    CPU, JAX tables, used rows of the exact and the wildcard stash)},
    its tuples (_stash_columns) and how many of them are stash tuples."""
    _need_jax()
    w, hosts = _stash_hosts()
    jt = jtab.compile_map_states(
        convert_states(w.states, tpm, jpm), w.identity_ids,
        identity_pad=w.identity_pad, filter_pad=w.filter_pad,
        hash_lanes=world.STASH_LANES["wide"])
    refs = {"wide": jt, "compact": jtab.repack_l4_subword(
        jt, lanes=world.STASH_LANES["compact"])}
    pols = {k: (convert.policy_tables_to(h, "cpu"), refs[k], _stash_used(h))
            for k, h in hosts.items()}
    cols = _stash_columns(w, hosts)
    return dict(pols=pols, cols=cols, n_stash=len(cols["dport"]) - 3000)


@pytest.mark.parametrize("layout", ["wide", "compact"])
def test_stash_heavy_evaluate_matches_jax(stash_world, layout):
    """evaluate_batch on the stash-heavy world (both stashes used, the
    tuples hitting their entries, the edge words among them) against the
    JAX reference's."""
    tt, jt, used = stash_world["pols"][layout]
    assert min(used) >= 8, used
    tb, jb = _batches(stash_world["cols"])
    got = tv.evaluate_batch(tt, tb, device="cpu")
    want = jv.evaluate_batch(jt, jb)
    assert_same_columns(got, want, VERDICT_COLS, layout)
    kinds = got.match_kind.numpy()[-stash_world["n_stash"]:]
    assert np.isin(kinds, (tor.MATCH_L4, tor.MATCH_L4_WILD)).mean() > 0.5


@pytest.mark.parametrize("layout", ["wide", "compact"])
def test_stash_heavy_counters_match_jax(stash_world, layout):
    """The counter form on the stash-heavy world against the JAX
    reference's: both counter planes, the out-of-range endpoints and
    directions dropped as the reference's scatter drops them."""
    tt, jt, _ = stash_world["pols"][layout]
    tb, jb = _batches(stash_world["cols"])
    v, l4, l3 = tv.evaluate_batch_with_counters(tt, tb, device="cpu")
    jv_, jl4, jl3 = jax.jit(jv._verdict_kernel_with_counters)(jt, jb)
    assert_same_columns(v, jv_, VERDICT_COLS, layout)
    for got, want in ((l4, jl4), (l3, jl3)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    assert int(l4.sum()) > 0 and int(l3.sum()) > 0


def test_identity_index_sweep_matches_jax():
    """_index_identity over the region edges and the u32 range, on
    tables with both id_direct regions populated."""
    _need_jax()
    w = _small5()
    tt, jt = _both_policies(w, "wide")
    lo_len, direct_sz = int(jt.id_lo_len), int(jt.id_direct.shape[0])
    base = int(ttab.LOCAL_ID_BASE)
    rng = np.random.default_rng(8)
    ids = np.concatenate([
        np.array([0, lo_len - 1, lo_len, (1 << 24) - 1, 1 << 24,
                  base + direct_sz, base + direct_sz - lo_len - 1,
                  base + direct_sz - lo_len, 1 << 31, 0xFFFFFFFF], np.uint64),
        np.asarray(w.identity_ids, np.uint64),
        rng.integers(0, 1 << 32, 500, dtype=np.uint64),
    ]).astype(np.uint32)
    n = len(ids)
    cols = dict(ep_index=np.zeros(n, np.int32), identity=ids,
                dport=np.full(n, 80), proto=np.full(n, 6),
                direction=np.zeros(n, np.int32))
    tb, jb = _batches(cols)
    idx, known = tv._index_identity(tt, tv.widen(tb.identity))
    jidx, jknown = jv._index_identity(jt, jb)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(known.numpy(), np.asarray(jknown))
    assert known.any() and not known.all()


def test_evaluate_batch_from_ips_matches_jax():
    """A small config-2 world: source addresses over 10.0.0.0/8 and the
    edges of its prefixes, through the fused DIR-24-8 + lattice path."""
    _need_jax()
    w = world.cidr_world(n16=6, n24=300, n32=700)
    jtab_j = jtab.compile_map_states(convert_states(w.states, tpm, jpm),
                                     w.identity_ids, identity_pad=1024)
    tt = convert.policy_tables_to(w.policy_tables(), "cpu")
    lt, lj = tlpm.build_lpm(w.ipc_map), jlpm.build_lpm(w.ipc_map)
    addrs, cols = w.make_cidr_batch(3000)
    edge = _edge_addresses(dict(list(w.ipc_map.items())[::50]),
                           np.random.default_rng(9), 0)
    n_edge = len(edge)
    addrs = np.concatenate([addrs, edge])
    cols = {k: np.concatenate([np.asarray(v), np.asarray(v)[:n_edge]])
            for k, v in cols.items()}
    tb, jb = _batches(cols)
    got = tv.evaluate_batch_from_ips(
        convert.lpm_to(lt, "cpu"), tt, torch.from_numpy(addrs.view(np.int32)),
        tb, device="cpu")
    want = jv.evaluate_batch_from_ips(lj, jtab_j, jnp.asarray(addrs), jb)
    assert_same_columns(got, want, VERDICT_COLS, "cidr")
    assert 0 < int(got.allowed.sum()) < len(addrs)
    # bench.py config2's oracle on sampled rows
    host = HostLPM(w.ipc_map)
    allowed = got.allowed.numpy()
    for i in np.random.default_rng(10).integers(0, len(addrs), 256):
        v = tor.policy_can_access(w.states[0], host.lookup(int(addrs[i])),
                                  int(cols["dport"][i]), 6, tpm.INGRESS,
                                  count_hits=False)
        assert bool(allowed[i]) == v.allowed, i


def test_entry_points_refuse_inputs_elsewhere():
    w = world.example_world(batch=8)
    tt = convert.policy_tables_to(w.policy_tables(), "cpu")
    tb = tv.TupleBatch.from_numpy(**w.tuples, device="cpu")
    host = w.policy_tables()
    with pytest.raises(ValueError, match="policy tables"):
        tv.evaluate_batch(host, tb, device="cpu")
    with pytest.raises(ValueError, match="a tuple pack"):
        convert.tuple_batch_to(np.zeros((5, 3), np.uint32), "cpu")
    lt = tlpm.build_lpm({"10.0.0.0/8": 1})
    with pytest.raises(ValueError, match="LPM tables"):
        tlpm.lpm_lookup(lt, np.zeros(2, np.uint32), device="cpu")
    assert tv.evaluate_batch(tt, tb, device="cpu").allowed.shape == (8,)


# -- flow records and replay -------------------------------------------------------


def _record_columns(n, rng):
    return dict(
        ep_id=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        identity=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        saddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        daddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        sport=rng.integers(0, 1 << 16, n).astype(np.uint16),
        dport=rng.integers(0, 1 << 16, n).astype(np.uint16),
        proto=rng.integers(0, 256, n).astype(np.uint8),
        direction=rng.integers(0, 256, n).astype(np.uint8),
        is_fragment=rng.integers(0, 4, n).astype(np.uint8),
    )


def test_flow_record_codec_matches_jax():
    _need_jax()
    cols = _record_columns(1000, np.random.default_rng(12))
    buf = tld.encode_flow_records(**cols)
    assert buf == jld.encode_flow_records(**cols)
    assert tld.FLOW_RECORD_DTYPE == jld.FLOW_RECORD_DTYPE
    got, want = tld.decode_flow_records(buf), jld.decode_flow_records(buf)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["is_fragment"], cols["is_fragment"] & 1)
    for decode in (tld.decode_flow_records, jld.decode_flow_records):
        with pytest.raises(ValueError, match="truncated"):
            decode(buf[:-5])
    assert tld.decode_flow_records(b"")["ep_id"].shape == (0,)


def _replay_world():
    w = _small5()
    tt, jt = _both_policies(w, "compact")
    buf = world.lattice_records(w, 2500, seed=13)
    rec = tld.decode_flow_records(buf)
    rng = np.random.default_rng(14)
    # endpoint ids past the sign bit, and ids no ep_map knows
    odd = rng.random(len(rec["ep_id"])) < 0.05
    rec["ep_id"] = np.where(odd, rng.choice(
        np.array([1 << 31, 0xFFFFFFFF, 0x80000003, 5000], np.uint32),
        len(odd)), rec["ep_id"] + 1000).astype(np.uint32)
    return w, tt, jt, rec


@pytest.mark.parametrize("batch,ep_map,counters", [
    (1000, False, True), (1000, True, True), (4096, True, True),
    (1000, True, False),
])
def test_replay_lattice_matches_jax(batch, ep_map, counters):
    """Stats and u64 counters of replay_lattice over records drawn from
    the small config-5 pool (a padded last batch at 1,000 rows, one
    short batch at 4,096), with and without an ep_map, and without
    counter accumulation."""
    _need_jax()
    from cilium_tpu import replay as jrp
    from cilium_tpu_torch import replay as trp

    w, tt, jt, rec = _replay_world()
    n_eps = len(w.states)
    emap = {1000 + e: e for e in range(n_eps)} if ep_map else None
    if not ep_map:
        rec = dict(rec, ep_id=np.where(rec["ep_id"] >= 1000,
                                       rec["ep_id"] - 1000, rec["ep_id"]))
    buf = tld.encode_flow_records(**rec)
    st, l4, l3 = trp.replay_lattice(tt, buf, batch, counters, emap,
                                    device="cpu")
    jst, jl4, jl3 = jrp.replay_lattice(jt, buf, batch, counters, emap)
    for f in ("total", "allowed", "denied", "redirected", "batches"):
        assert getattr(st, f) == getattr(jst, f), f
    assert st.total == 2500 and st.batches == -(-2500 // batch)
    assert 0 < st.allowed < st.total and st.redirected > 0
    if not counters:
        assert l4 is None and l3 is None and jl4 is None
        return
    for got, want in ((l4, jl4), (l3, jl3)):
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    assert l4.sum() > 0 and l3.sum() > 0


def test_read_batches_and_slot_keys_match_jax():
    _need_jax()
    from cilium_tpu import replay as jrp
    from cilium_tpu_torch import replay as trp

    w, tt, jt, rec = _replay_world()
    emap = {1000 + e: e for e in range(len(w.states))}
    for m in (None, emap):
        np.testing.assert_array_equal(trp._ep_index_of(rec, m),
                                      jrp._ep_index_of(rec, m))
    buf = tld.encode_flow_records(**rec)
    got = list(trp.read_batches(buf, 1024, emap, device="cpu"))
    want = list(jrp.read_batches(buf, 1024, emap))
    assert [v for _, v in got] == [v for _, v in want] == [1024, 1024, 452]
    for (tb, _), (jb, _) in zip(got, want):
        assert_same_columns(tb, jb, ("ep_index", "identity", "dport",
                                     "proto", "direction", "is_fragment"))
    assert trp.slot_keys_from_tables(tt) == jrp.slot_keys_from_tables(jt)


def test_oracle_matches_jax():
    """policy_can_access (hits counted and not) and
    evaluate_batch_oracle on tuples the small config-5 world's rules
    name, against the reference oracle."""
    _need_jax()
    w = _small5()
    _, jt = _both_policies(w, "wide")
    cols = _config5_columns(w, jt, 600, 15)
    ok = (cols["ep_index"] >= 0) & (cols["ep_index"] < len(w.states))
    cols = {k: v[ok] for k, v in cols.items()}
    cols["is_fragment"] = cols["is_fragment"] != 0
    t_states = [dict(s) for s in w.states]
    j_states = convert_states(w.states, tpm, jpm)
    got = tor.evaluate_batch_oracle(t_states, **cols)
    want = jor.evaluate_batch_oracle(j_states, **cols)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the lattice agrees with the oracle on the world's own tuples (the
    # edge rows leave the key space the oracle's dict lookups see)
    tt, _ = _both_policies(w, "wide")
    own = {k: v[:600] for k, v in _config5_columns(w, jt, 600, 15).items()}
    tb = tv.TupleBatch.from_numpy(**own, device="cpu")
    dev = tv.evaluate_batch(tt, tb, device="cpu")
    want = tor.evaluate_batch_oracle(
        [dict(s) for s in convert_states(w.states, tpm, tpm)],
        **dict(own, is_fragment=own["is_fragment"] != 0))
    np.testing.assert_array_equal(dev.allowed.numpy(), want[0])
    np.testing.assert_array_equal(dev.proxy_port.numpy(), want[1])
    np.testing.assert_array_equal(dev.match_kind.numpy(), want[2])
    # hit counting: the same entries move on both sides
    t_states = convert_states(w.states, tpm, tpm)
    j_states = convert_states(w.states, tpm, jpm)
    for i in range(100):
        args = (int(cols["identity"][i]), int(cols["dport"][i]),
                int(cols["proto"][i]), int(cols["direction"][i]),
                bool(cols["is_fragment"][i]), 60, i % 2 == 0)
        e = int(cols["ep_index"][i])
        a = tor.policy_can_access(t_states[e], *args)
        b = jor.policy_can_access(j_states[e], *args)
        assert (a.allowed, a.proxy_port, a.match_kind) == (
            b.allowed, b.proxy_port, b.match_kind)
    for ts, js in zip(t_states, j_states):
        assert sorted((k.identity, k.dest_port, k.nexthdr,
                       k.traffic_direction, v.packets, v.bytes)
                      for k, v in ts.items()) == sorted(
            (k.identity, k.dest_port, k.nexthdr, k.traffic_direction,
             v.packets, v.bytes) for k, v in js.items())


# -- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


def _card_inputs(layout):
    w = _small5()
    host = _port_policy(w, layout)
    cols = _config5_columns(w, host, 20_000, 16)
    return (convert.policy_tables_to(host, "cuda"),
            tv.TupleBatch.from_numpy(**cols, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("counters", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_lattice_kernel_matches_plain(layout, counters):
    _need_card()
    from cilium_tpu_torch import kernels

    tt, tb = _card_inputs(layout)
    before = kernels.LATTICE.launches
    v, acc = kernels.LATTICE(tt, tb, counters=counters)
    pv, pacc = tv._lattice_plain(tt, tb, counters=counters)
    torch.cuda.synchronize()
    for c in VERDICT_COLS:
        assert torch.equal(getattr(v, c), getattr(pv, c)), c
    assert (acc is None) == (not counters)
    if counters:
        assert torch.equal(acc, pacc)
    assert kernels.LATTICE.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("counters", [False, True])
def test_lattice_ip_mode_matches_plain(counters):
    _need_card()
    from cilium_tpu_torch import kernels

    w = world.cidr_world(n16=6, n24=300, n32=700)
    tt = convert.policy_tables_to(w.policy_tables(), "cuda")
    lt = convert.lpm_to(tlpm.build_lpm(w.ipc_map), "cuda")
    addrs, cols = w.make_cidr_batch(50_000)
    tb = tv.TupleBatch.from_numpy(**cols, device="cuda")
    ips = torch.from_numpy(addrs.view(np.int32)).cuda()
    v, acc = kernels.LATTICE(tt, tb, counters=counters, lpm=lt, src_ips=ips)
    ids = tlpm.lpm_lookup_plain(lt, ips)
    pv, pacc = tv._lattice_plain(tt, tb, identity=ids, counters=counters)
    torch.cuda.synchronize()
    for c in VERDICT_COLS:
        assert torch.equal(getattr(v, c), getattr(pv, c)), c
    if counters:
        assert torch.equal(acc, pacc)


# the stash-heavy cases on the card: (layout, counters, IP mode, both
# stashes padded past the shared memory the kernel stages)
_STASH_CARD_CASES = {
    f"{lay}{'-counters' if c else ''}{'-ip' if ip else ''}"
    f"{'-padded' if pad else ''}": (lay, c, ip, pad)
    for lay in ("wide", "compact", "dense") for c in (False, True)
    for ip in ((False, True) if lay != "dense" else (False,))
    for pad in ((False, True) if lay != "dense" else (False,))
}
PAD_ROWS = 2048  # 16 KB of stash words is what csrc/lattice.cu stages


def _card_stash_case(layout, pad):
    """The stash-heavy world's tables on the card in `layout` ("dense":
    the wide tables without the hash), both stashes padded by PAD_ROWS
    empty rows with `pad`; its tuples on the card; and the DIR-24-8
    tables and source addresses of IP mode (the world's identities at
    /32s of 11.0.0.0/8, the others at an address it misses)."""
    w, hosts = _stash_hosts()
    host = hosts["wide" if layout == "dense" else layout]
    if layout == "dense":
        host = dataclasses.replace(host, **{k: None for k in HASH_LEAVES})
    if pad:
        empty = (0, 0xFFFFFFFF, 0) if layout == "wide" else (0, 1 << 31)
        rows = np.tile(np.asarray(empty, np.uint32), (PAD_ROWS, 1))
        host = dataclasses.replace(host, **{
            k: np.concatenate([np.asarray(getattr(host, k)), rows])
            for k in ("l4_hash_stash", "l4_wild_stash")})
    cols = _stash_columns(w, hosts)
    cidrs, src = world.identity_addresses(w.identity_ids, cols["identity"])
    lpm = convert.lpm_to(tlpm.build_lpm(cidrs), "cuda")
    return (convert.policy_tables_to(host, "cuda"),
            tv.TupleBatch.from_numpy(**cols, device="cuda"), lpm,
            torch.from_numpy(src.view(np.int32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_STASH_CARD_CASES))
def test_lattice_kernel_stash_cases_match_plain(case):
    """LATTICE against its plain version on the stash-heavy world (both
    stashes used, a tuple for each used entry, the edge words), in every
    layout, with and without counters, in IP mode, and with the stashes
    padded past the shared memory the kernel stages (read where they
    lie)."""
    _need_card()
    from cilium_tpu_torch import kernels

    layout, counters, ip, pad = _STASH_CARD_CASES[case]
    tt, tb, lpm, src = _card_stash_case(layout, pad)
    kw = dict(counters=counters)
    ids = None
    if ip:
        kw.update(lpm=lpm, src_ips=src)
        ids = tlpm.lpm_lookup_plain(lpm, src)
    v, acc = kernels.LATTICE(tt, tb, **kw)
    pv, pacc = tv._lattice_plain(tt, tb, identity=ids, counters=counters)
    torch.cuda.synchronize()
    for c in VERDICT_COLS:
        assert torch.equal(getattr(v, c), getattr(pv, c)), c
    if counters:
        assert torch.equal(acc, pacc)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["wide", "compact"])
def test_lattice_kernel_zipf_hot_counters_match_plain(layout):
    """The counter form on 200,000 tuples drawn Zipf(1.1) from 4,096 of
    the stash-heavy world's lattice tuples: a few hot counter cells take
    most hits (the kernel aggregates a block's equal cells)."""
    _need_card()
    from cilium_tpu_torch import kernels

    w, hosts = _stash_hosts()
    base = world.lattice_tuples(w, 4096, seed=26)
    picks = world.zipf_picks(np.random.default_rng(27), 4096, 200_000, 1.1)
    tb = tv.TupleBatch.from_numpy(**{k: v[picks] for k, v in base.items()},
                                  device="cuda")
    tt = convert.policy_tables_to(hosts[layout], "cuda")
    v, acc = kernels.LATTICE(tt, tb, counters=True)
    pv, pacc = tv._lattice_plain(tt, tb, counters=True)
    torch.cuda.synchronize()
    for c in VERDICT_COLS:
        assert torch.equal(getattr(v, c), getattr(pv, c)), c
    assert torch.equal(acc, pacc)
    assert int(pacc.max()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LPM_MAPS))
def test_lpm_lookup_kernel_matches_plain(case):
    _need_card()
    from cilium_tpu_torch import kernels

    lt = convert.lpm_to(tlpm.build_lpm(LPM_MAPS[case]), "cuda")
    ips = torch.from_numpy(_edge_addresses(
        LPM_MAPS[case], np.random.default_rng(17), 100_000).view(np.int32))
    got = kernels.LPM_LOOKUP(lt, ips.cuda())
    want = tlpm.lpm_lookup_plain(lt, ips.cuda())
    torch.cuda.synchronize()
    assert torch.equal(tv.widen(got), want)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.LPM_LOOKUP(lt, ips)
