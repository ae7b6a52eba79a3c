"""The PyTorch port's verdict memo (engine/memo.py) on the CPU against
the JAX package's: the key and value packing over the u32 range, the
dedup groups, the cache probe / insert lanes / rank updates / insert on
the three row layouts, the memoized lattice (`memo_evaluate`) and the
memoized headline pair (`memo_pair_packed4`) cold, warm, skewed and
overflowing, the LRU eviction case, `VerdictCache` and the
`AsyncBatchDispatcher`.  Every gate is exact integer equality; the
inputs are made from seeds with numpy and handed to both packages.

Cache rows are compared word for word on every bucket row.  XLA's sort
on the CPU orders equal keys as a stable sort does (asserted by
test_xla_sort_is_stable_on_equal_keys), so the representatives and the
same-bucket insert lanes are the reference's.  The scratch row (row
n_rows) is left out: the reference routes entries that do not insert
there through a duplicate-index scatter whose order XLA leaves
implementation-defined, and no probe reads it; the port never writes
it.

The cuda-marked tests at the end hold the memo kernels against their
plain versions on the card; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_memo.py -q -m cuda
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import memo as tm
from cilium_tpu_torch.engine import publish as tpub
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.maps import policymap as tpm
from cilium_tpu_torch.metrics import registry as tmetrics

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)
WIDE_IDS = [1, 2, 3, 4, 5] + [256 + i for i in range(120)] + [65536, 70000]
M32 = 0xFFFFFFFF

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import memo as jvm
    from cilium_tpu.engine import verdict as jv
    from cilium_tpu.engine.verdict import (
        make_counter_buffers as j_counters,
        make_telemetry_buffers as j_telem,
    )
    from cilium_tpu.maps import policymap as jpm
    from torch_parity import (
        assert_same_buffers,
        assert_same_verdicts,
        convert_states,
        jax_host_tables,
        jax_leaves,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _u32(x) -> np.ndarray:
    """A port tensor or a JAX array -> numpy u32 (bool stays bool)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.bool_:
        return a
    return (a.astype(np.int64) & M32).astype(np.uint32)


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref, what=""):
    np.testing.assert_array_equal(_u32(port), _u32(ref), err_msg=what)


def _same_rows(port_rows, ref_rows, what="rows"):
    """Every bucket row word for word (the scratch row left out)."""
    p, r = _u32(port_rows), _u32(ref_rows)
    assert p.shape == r.shape, what
    np.testing.assert_array_equal(p[:-1], r[:-1], err_msg=what)


# -- the word packing ----------------------------------------------------------------


def _key_inputs(rng, n):
    ep = rng.integers(0, 1 << 32, n, dtype=np.int64)
    ep[: n // 4] = rng.integers(0, 64, n // 4)
    ep[n // 4: n // 4 + 8] = [0x80000000, 0x80000001, 0xFFFFFFFF, 1, 0,
                              0x7FFFFFFF, 0x80000002, 2]
    dirn = rng.choice(np.array([0, 1, 2, 255, 0xFFFFFFFF, 0xFFFFFFFE]), n)
    return dict(
        idx=rng.integers(0, 1 << 22, n),
        known=rng.random(n) < 0.8,
        l3_bit=rng.random(n) < 0.5,
        ep=ep.astype(np.uint32).view(np.int32).astype(np.int64),
        dirn=dirn.astype(np.uint32).view(np.int32).astype(np.int64),
        dport=rng.integers(0, 65536, n),
        proto=rng.integers(0, 256, n),
    )


@pytest.mark.parametrize("with_l3", [True, False])
def test_key_words_match_jax(with_l3):
    _need_jax()
    c = _key_inputs(np.random.default_rng(3), 4096)
    l3 = c["l3_bit"] if with_l3 else None
    want = jvm.memo_key_words(
        jnp.asarray(c["idx"], jnp.int32), jnp.asarray(c["known"]),
        None if l3 is None else jnp.asarray(l3),
        jnp.asarray(c["ep"], jnp.int32), jnp.asarray(c["dirn"], jnp.int32),
        jnp.asarray(c["dport"], jnp.int32), jnp.asarray(c["proto"], jnp.int32))
    got = tm.memo_key_words(
        _i64(c["idx"]), torch.from_numpy(c["known"]),
        None if l3 is None else torch.from_numpy(l3), _i64(c["ep"]),
        _i64(c["dirn"]), _i64(c["dport"]), _i64(c["proto"]))
    for g, w in zip(got, want):
        _same(g, w)
    # the collapsed keys the reference packs: bit 31 of the endpoint
    # drops, and a direction word of 2 overlaps the endpoint's bit 0
    one = lambda v: torch.tensor([v], dtype=torch.int64)
    t, f = torch.tensor([True]), torch.tensor([False])

    def k2(ep, d):
        return int(tm.memo_key_words(one(0), t, f, one(ep), one(d), one(80),
                                     one(6))[2])

    assert k2(1, 0) == k2(np.int32(-0x7FFFFFFF).item(), 0)
    assert k2(2, 2) == k2(3, 0)
    assert k2(3, 2) == k2(3, 0)


def test_value_words_match_jax():
    _need_jax()
    rng = np.random.default_rng(4)
    n = 4096
    p = [rng.random(n) < 0.5 for _ in range(3)]
    proxy = rng.integers(0, 65536, n)
    j = np.where(rng.random(n) < 0.5, rng.integers(0, 4096, n),
                 rng.integers(0, 65536, n))
    w0, w1 = jvm.pack_value_words(*(jnp.asarray(x) for x in p),
                                  jnp.asarray(proxy, jnp.int32),
                                  jnp.asarray(j, jnp.int32))
    g0, g1 = tm.pack_value_words(*(torch.from_numpy(x) for x in p),
                                 _i64(proxy), _i64(j))
    _same(g0, w0)
    _same(g1, w1)
    for g, w in zip(tm.unpack_value_words(g0, g1),
                    jvm.unpack_value_words(w0, w1)):
        _same(g, w)


# -- level A -------------------------------------------------------------------------


def _keys(rng, n, spread):
    """[3, n] u32 key words: "random" (equal leading words), "duplicated"
    (24 keys), "all_equal", "all_distinct", "zipf_hot" (Zipf(1.1) over
    256 keys: one hot key), "bit31" (bit 31 set in each word, 40 keys),
    "one_row" (n = 1)."""
    if spread == "duplicated":
        base = rng.integers(0, 1 << 32, (24, 3), dtype=np.int64)
        base[:4, 0] = [0, 0xFFFFFFFF, 1 << 31, 5]
        return base[rng.integers(0, 24, n)].T.astype(np.uint32)
    if spread == "all_equal":
        return np.tile(np.array([[0x80000001], [0xFFFFFFFF], [0x7FFFFFFF]],
                                dtype=np.uint32), (1, n))
    if spread == "all_distinct":
        k = rng.integers(0, 1 << 32, (3, n), dtype=np.int64)
        k[0] = rng.permutation(n) * 2654435761 % (1 << 32)
        return k.astype(np.uint32)
    if spread == "zipf_hot":
        base = rng.integers(0, 1 << 32, (256, 3), dtype=np.int64)
        rank = np.minimum(rng.zipf(1.1, n), 256) - 1
        return base[rank].T.astype(np.uint32)
    if spread == "bit31":
        base = rng.integers(0, 1 << 31, (40, 3), dtype=np.int64) | (1 << 31)
        return base[rng.integers(0, 40, n)].T.astype(np.uint32)
    if spread == "one_row":
        return rng.integers(0, 1 << 32, (3, 1), dtype=np.int64).astype(
            np.uint32)
    k = rng.integers(0, 1 << 32, (3, n), dtype=np.int64).astype(np.uint32)
    k[0] = rng.integers(0, 4, n)  # equal leading words, order by the rest
    return k


_SPREADS = ["random", "duplicated", "all_equal", "all_distinct", "zipf_hot",
            "bit31", "one_row"]


@functools.lru_cache(maxsize=None)
def _jax_groups(spread, rep_cap):
    """(keys [3, 768], n_unique, rep_cap, JAX's dedup_groups), each case
    run through the jitted reference once a module."""
    k = _keys(np.random.default_rng(5), 768, spread)
    n_unique = len(np.unique(k, axis=1).T)
    if rep_cap == "n_unique":
        rep_cap = n_unique
    want = jax.jit(lambda a, b, c: jvm.dedup_groups(a, b, c, rep_cap))(*k)
    return k, n_unique, rep_cap, want


@pytest.mark.parametrize("spread", _SPREADS)
@pytest.mark.parametrize("rep_cap", [768, 16, "n_unique"])
def test_dedup_groups_match_jax(spread, rep_cap):
    _need_jax()
    k, n_unique, rep_cap, want = _jax_groups(spread, rep_cap)
    got = tm.dedup_groups(*(_i64(x) for x in k), rep_cap)
    for name in ("srow", "gid", "rep_orig", "rep_valid"):
        _same(got[name], want[name], name)
    assert got["n_unique"] == int(want["n_unique"]) == n_unique
    assert got["overflow"] == int(want["overflow"])
    assert got["overflow"] == max(n_unique - rep_cap, 0)
    if spread in ("random", "duplicated"):
        assert (got["overflow"] > 0) == (rep_cap == 16)


@pytest.mark.parametrize("spread", _SPREADS)
def test_dedup_rgid_inverts_jax_groups(spread):
    """rgid, each row's group id in row order (MEMO_CACHE's scatter-back
    order), is the inverse of the reference's sorted rows and groups:
    rgid[srow] == gid, over every row."""
    _need_jax()
    k, _, rep_cap, want = _jax_groups(spread, 768)
    got = tm.dedup_groups(*(_i64(x) for x in k), rep_cap)
    srow, gid = np.asarray(want["srow"]), np.asarray(want["gid"])
    assert sorted(srow.tolist()) == list(range(k.shape[1]))
    inverse = np.empty_like(gid)
    inverse[srow] = gid
    _same(got["rgid"], inverse, "rgid")


def test_xla_sort_is_stable_on_equal_keys():
    """Establishes the gate: jax.lax.sort (is_stable=False) on the CPU
    orders equal keys as a stable sort does, both in dedup_groups and
    in bucket_insert_lanes (768 inserts into a 2-row cache), so the
    cache rows can be compared word for word."""
    _need_jax()
    rng = np.random.default_rng(6)
    k = rng.integers(0, 3, (3, 768)).astype(np.uint32)
    g = jax.jit(lambda a, b, c: jvm.dedup_groups(a, b, c, 8))(*k)
    np.testing.assert_array_equal(
        np.asarray(g["srow"]), np.lexsort((np.arange(768), k[2], k[1], k[0])))
    bucket = rng.integers(0, 2, 768).astype(np.int32)
    empty = np.ones((768, 8), bool)
    lane, ok = jax.jit(lambda e, b: jvm.bucket_insert_lanes(e, b, 8))(
        empty, bucket)
    rank = np.zeros(768, np.int64)
    seen = {}
    for i, b in enumerate(bucket):
        rank[i] = seen.get(b, 0)
        seen[b] = rank[i] + 1
    np.testing.assert_array_equal(np.asarray(ok), rank < 8)
    np.testing.assert_array_equal(np.asarray(lane)[rank < 8], rank[rank < 8])


# -- level B -------------------------------------------------------------------------


def _rows(layout, n_rows, e):
    if layout == "legacy":
        return np.full((n_rows + 1, tm.CACHE_WORDS * e), tm.EMPTY, np.uint32)
    return tm.make_cache_rows(n_rows, e, subword=(layout == "subword"))


def _j_round(rows, k, valid, v):
    hit, cv0, cv1, bucket, lane, ok, hlane, rword = jvm.cache_probe(
        rows, *k, valid)
    do = valid & ~hit & ok
    n_rows = rows.shape[0] - 1
    r2 = jvm.apply_rank_updates(rows, bucket, hit, hlane, rword,
                                jnp.where(do, bucket, n_rows), lane, rword, do)
    r3 = jvm.cache_insert(r2, bucket, lane, *k, *v, do)
    return (hit, cv0, cv1, bucket, lane, ok, hlane, rword), r2, r3


def _t_round(rows, k, valid, v):
    hit, cv0, cv1, bucket, lane, ok, hlane, rword = tm.cache_probe(
        rows, *k, valid)
    do = valid & ~hit & ok
    n_rows = rows.shape[0] - 1
    r2 = tm.apply_rank_updates(rows, bucket, hit, hlane, rword,
                               torch.where(do, bucket, n_rows), lane, rword,
                               do)
    r3 = tm.cache_insert(r2, bucket, lane, *k, *v, do)
    return (hit, cv0, cv1, bucket, lane, ok, hlane, rword), r2, r3


_CACHE_OPS_CASES = [
    (layout, entries, n_rows)
    for layout in ("legacy", "rank", "subword")
    for entries, n_rows in ((8, 2), (8, 64), (16, 2), (16, 64))
] + [
    # one bucket (every key ranked past the lanes but the first few) and
    # 32-entry rows
    (layout, entries, n_rows)
    for layout in ("legacy", "rank", "subword")
    for entries, n_rows in ((8, 1), (32, 64), (32, 1))
]


@pytest.mark.parametrize("layout,entries,n_rows", _CACHE_OPS_CASES)
def test_cache_ops_match_jax(layout, entries, n_rows):
    """Four rounds of probe, insert lanes, rank updates and insert over
    keys that recur between rounds (hits, rank bumps, evictions from
    full buckets); each output and the rows after each step equal.  At
    n_rows 1 every key lands in one bucket, 160 keys a round against at
    most 32 lanes."""
    _need_jax()
    rng = np.random.default_rng(entries * 100 + n_rows)
    # one bucket keeps at most 32 keys: a universe little larger than a
    # round's keys makes them recur (hits) there
    u = 170 if n_rows == 1 else 600
    universe = np.unique(np.stack([
        rng.integers(0, 1 << 22, u), rng.integers(0, 1 << 32, u),
        rng.integers(0, 1 << 32, u)], axis=1), axis=0).astype(np.uint32)
    j_rows = jax.device_put(_rows(layout, n_rows, entries))
    t_rows = convert.cache_rows_to(_rows(layout, n_rows, entries), "cpu")
    for rnd in range(4):
        pick = np.sort(rng.choice(len(universe), 160, replace=False))
        k = universe[pick].T
        valid = rng.random(160) < 0.9
        v = (rng.integers(0, 1 << 32, 160).astype(np.uint32),
             rng.integers(0, 8, 160).astype(np.uint32))
        jout, jr2, jr3 = _j_round(j_rows, tuple(jnp.asarray(x) for x in k),
                                  jnp.asarray(valid),
                                  tuple(jnp.asarray(x) for x in v))
        tout, tr2, tr3 = _t_round(t_rows, tuple(_i64(x) for x in k),
                                  torch.from_numpy(valid),
                                  tuple(_i64(x) for x in v))
        names = ("hit", "v0", "v1", "bucket", "ins_lane", "ins_ok",
                 "hit_lane", "rank_word")
        for name, g, w in zip(names, tout, jout):
            if name == "ins_lane":  # meaningful where the insert is ok
                okm = np.asarray(jout[5])
                _same(g.numpy()[okm], np.asarray(w)[okm], f"{rnd} {name}")
            else:
                _same(g, w, f"round {rnd} {name}")
        _same_rows(tr2, jr2, f"round {rnd} rank updates")
        _same_rows(tr3, jr3, f"round {rnd} insert")
        assert torch.equal(tr3[-1], tr2[-1])  # the scratch row is untouched
        if rnd:
            assert bool(np.asarray(jout[0]).any())
        j_rows, t_rows = jr3, tr3


def test_lru_hot_key_survives_cold_collision():
    """The reference's LRU case on the port (a 1-row, 2-lane cache):
    a colliding cold insert into the full bucket evicts the
    least-recently-hit lane, whichever lane the hot key sits in; the
    rows equal the reference's after the same steps."""
    _need_jax()
    one = lambda x: torch.tensor([x], dtype=torch.int64)
    valid = torch.tensor([True])

    def insert(rows, key, jrows):
        k = tuple(one(x) for x in key)
        hit, _, _, bucket, lane, ok, hlane, rword = tm.cache_probe(
            rows, *k, valid)
        assert bool(ok[0])
        rows = tm.apply_rank_updates(rows, bucket, hit & False, hlane, rword,
                                     bucket, lane, rword, valid)
        rows = tm.cache_insert(rows, bucket, lane, *k, one(0xAA), one(1),
                               valid)
        jk = tuple(jnp.asarray([x], jnp.uint32) for x in key)
        jv_ = jnp.asarray([True])
        jhit, _, _, jb, jl, _, jhl, jrw = jvm.cache_probe(jrows, *jk, jv_)
        jrows = jvm.apply_rank_updates(jrows, jb, jhit & False, jhl, jrw, jb,
                                       jl, jrw, jv_)
        jrows = jvm.cache_insert(jrows, jb, jl, *jk,
                                 jnp.asarray([0xAA], jnp.uint32),
                                 jnp.asarray([1], jnp.uint32), jv_)
        return rows, int(lane[0]), jrows

    def hit_once(rows, key, jrows):
        k = tuple(one(x) for x in key)
        hit, _, _, bucket, lane, _, hlane, rword = tm.cache_probe(
            rows, *k, valid)
        rows = tm.apply_rank_updates(rows, bucket, hit, hlane, rword, one(1),
                                     lane, one(0), torch.tensor([False]))
        jk = tuple(jnp.asarray([x], jnp.uint32) for x in key)
        jhit, _, _, jb, jl, _, jhl, jrw = jvm.cache_probe(
            jrows, *jk, jnp.asarray([True]))
        jrows = jvm.apply_rank_updates(
            jrows, jb, jhit, jhl, jrw, jnp.asarray([1], jnp.int32), jl,
            jnp.zeros(1, jnp.uint32), jnp.asarray([False]))
        return rows, bool(hit[0]), jrows

    A, B, C = (5, 7, 9), (6, 7, 9), (8, 7, 9)
    for hot, cold_resident in ((A, B), (B, A)):
        rows = convert.cache_rows_to(tm.make_cache_rows(1, 2), "cpu")
        jrows = jax.device_put(jvm.make_cache_rows(1, 2))
        rows, _, jrows = insert(rows, A, jrows)
        rows, lane_b, jrows = insert(rows, B, jrows)
        assert lane_b == 1
        for _ in range(3):
            rows, h, jrows = hit_once(rows, hot, jrows)
            assert h
        rows, _, jrows = insert(rows, C, jrows)
        rows, hot_alive, jrows = hit_once(rows, hot, jrows)
        assert hot_alive, "hot key evicted by a colliding cold insert"
        _, cold_alive, _ = hit_once(rows, cold_resident, jrows)
        assert not cold_alive, "victim was not the cold lane"
        _same_rows(rows, jrows)


# -- the memoized lattice ------------------------------------------------------------


def _random_state(rng, n_l4=16, n_l3=24):
    state = {}
    ports, protos = [53, 80, 443, 8080, 9090], [6, 17]
    for _ in range(n_l4):
        d = int(rng.integers(0, 2))
        port, proto = int(rng.choice(ports)), int(rng.choice(protos))
        proxy = 15001 if (port + proto + d) % 3 == 0 else 0
        for num_id in rng.choice(WIDE_IDS, size=3, replace=True):
            state[tpm.PolicyKey(int(num_id), port, proto, d)] = (
                tpm.PolicyMapStateEntry(proxy_port=proxy))
        if rng.random() < 0.3:
            state[tpm.PolicyKey(0, port, proto, d)] = tpm.PolicyMapStateEntry(
                proxy_port=proxy)
    for _ in range(n_l3):
        state[tpm.PolicyKey(int(rng.choice(WIDE_IDS)), 0, 0,
                            int(rng.integers(0, 2)))] = (
            tpm.PolicyMapStateEntry())
    return state


def _lattice_world(seed, source, b=768, n_eps=3):
    """(port PolicyTables on the CPU, JAX PolicyTables, tuple columns):
    _build's sizes of the reference's memo tests."""
    rng = np.random.default_rng(seed)
    states = [_random_state(rng) for _ in range(n_eps)]
    jt = jtab.compile_map_states(convert_states(states, tpm, jpm), WIDE_IDS,
                                 identity_pad=256, filter_pad=16)
    if source == "convert":
        host = ttab.PolicyTables(**{
            f.name: np.asarray(getattr(jt, f.name))
            for f in dataclasses.fields(ttab.PolicyTables)})
    else:
        host = ttab.compile_map_states(states, WIDE_IDS, identity_pad=256,
                                       filter_pad=16)
    ids = rng.choice(np.asarray(WIDE_IDS + [999999, 7]), size=b)
    cols = dict(
        ep_index=rng.integers(0, n_eps, size=b),
        identity=ids.astype(np.uint32),
        dport=rng.choice([53, 80, 443, 8080, 9090, 1234], size=b),
        proto=rng.choice([6, 17, 1], size=b),
        direction=rng.integers(0, 2, size=b),
        is_fragment=rng.random(size=b) < 0.1,
    )
    return convert.policy_tables_to(host, "cpu"), jt, cols


def _skew(cols, rng, n_keys):
    picks = rng.integers(0, n_keys, size=len(cols["ep_index"]))
    return {k: np.asarray(v)[picks] for k, v in cols.items()}


def _edges(cols, rng):
    """Rows whose keys collapse: endpoints past 2^31 and direction words
    2 and 255 (and out-of-range endpoints)."""
    out = {k: np.asarray(v).copy() for k, v in cols.items()}
    b = len(out["ep_index"])
    sel = rng.random(b) < 0.3
    ep = out["ep_index"].astype(np.int64)
    out["ep_index"] = np.where(sel & (rng.random(b) < 0.5),
                               ep + (1 << 31), ep).astype(np.uint32)
    out["direction"] = np.where(
        sel, rng.choice([0, 1, 2, 255], b), out["direction"]).astype(np.uint32)
    return out


def _memo_eval_both(pt, jt, cols, t_rows, j_rows, rep_cap):
    j_out = jvm.memo_evaluate_kernel(rep_cap)(
        jt, jv.TupleBatch.from_numpy(**cols), j_rows)
    t_out = tm.memo_evaluate_kernel(rep_cap)(
        pt, tv.TupleBatch.from_numpy(**cols, device="cpu"), t_rows,
        device="cpu")
    (jvd, jrows, jhit, jst), (tvd, trows, thit, tst) = j_out, t_out
    for c in ("allowed", "proxy_port", "match_kind"):
        _same(getattr(tvd, c), getattr(jvd, c), c)
    _same(thit, jhit, "hit")
    _same(tst, jst, "stats")
    _same_rows(trows, jrows)
    return t_out, j_out


@pytest.mark.parametrize("source", ["port", "convert"])
def test_memo_evaluate_matches_jax(source):
    """Uniform cold then warm, a skewed batch, collapsed-key edge rows
    and an overflowing capacity: every verdict column, the hit flags,
    the stats and the rows equal the reference's; without collapsed
    keys the memoized verdicts equal the uncached lattice's."""
    _need_jax()
    pt, jt, cols = _lattice_world(0, source)
    rng = np.random.default_rng(100)
    b = len(cols["ep_index"])
    t_rows = convert.cache_rows_to(tm.make_cache_rows(1 << 8, 8), "cpu")
    j_rows = jax.device_put(jvm.make_cache_rows(1 << 8, 8))
    batches = [("uniform", cols), ("uniform", cols),
               ("skewed", _skew(cols, rng, 24)), ("edges", _edges(cols, rng))]
    for n, (tag, td) in enumerate(batches):
        (tvd, t_rows, thit, tst), (jvd, j_rows, _, _) = _memo_eval_both(
            pt, jt, td, t_rows, j_rows, b)
        assert int(tst[tm.STAT_OVERFLOW]) == 0
        if n == 0:
            assert int(tst[tm.STAT_HIT]) == 0
        if n == 1:
            assert int(tst[tm.STAT_HIT]) == b
        ref = tv.evaluate_batch(
            pt, tv.TupleBatch.from_numpy(**td, device="cpu"), device="cpu")
        jref = jv.evaluate_batch(jt, jv.TupleBatch.from_numpy(**td))
        diff = np.zeros(b, bool)
        jdiff = np.zeros(b, bool)
        for c in ("allowed", "proxy_port", "match_kind"):
            diff |= (getattr(tvd, c) != getattr(ref, c)).numpy()
            jdiff |= np.asarray(getattr(jvd, c)) != np.asarray(getattr(jref, c))
        # collapsed keys share a representative's verdict in both packages
        # (seed 0: one row, endpoint 2^31 + 2, takes endpoint 2's verdict)
        np.testing.assert_array_equal(diff, jdiff)
        assert diff.any() == (tag == "edges"), tag
    # overflow of the groups: the stats report it and the rows come back
    # unchanged
    before = t_rows.clone()
    (_, t_after, _, tst), _ = _memo_eval_both(pt, jt, cols, t_rows, j_rows, 16)
    assert int(tst[tm.STAT_OVERFLOW]) > 0
    assert torch.equal(t_after, before)


def test_warm_cache_carried_across():
    """A cache the reference warmed, carried into the port's storage
    (convert.cache_rows_to) and back out (cache_rows_to_numpy): both
    packages then serve the next batch alike, hits included."""
    _need_jax()
    pt, jt, cols = _lattice_world(1, "port")
    rng = np.random.default_rng(7)
    b = len(cols["ep_index"])
    j_rows = jax.device_put(jvm.make_cache_rows(1 << 6, 8, subword=True))
    _, j_rows, _, _ = jvm.memo_evaluate_kernel(b)(
        jt, jv.TupleBatch.from_numpy(**cols), j_rows)
    warm = np.array(j_rows)
    t_rows = convert.cache_rows_to(warm, "cpu")
    np.testing.assert_array_equal(convert.cache_rows_to_numpy(t_rows), warm)
    (_, _, thit, _), _ = _memo_eval_both(pt, jt, _skew(cols, rng, 40),
                                         t_rows, j_rows, b)
    assert bool(thit.any())
    with pytest.raises(ValueError, match="row layout"):
        convert.cache_rows_to(warm[:, :-2], "cpu")


def test_lru_through_memo_evaluate():
    """The reference's end-to-end LRU case: a hot key served for three
    batches survives bursts of fresh cold keys over a 1-row, 4-lane
    cache; every batch equal to the reference's."""
    _need_jax()
    pt, jt, cols = _lattice_world(9, "port", b=256)
    hot = {k: np.repeat(np.asarray(v)[:1], 256) for k, v in cols.items()}
    t_rows = convert.cache_rows_to(tm.make_cache_rows(1, 4), "cpu")
    j_rows = jax.device_put(jvm.make_cache_rows(1, 4))
    for _ in range(3):
        (_, t_rows, thit, _), (_, j_rows, _, _) = _memo_eval_both(
            pt, jt, hot, t_rows, j_rows, 256)
    assert int(thit.sum()) == 256
    for burst in range(4):
        cold = {k: v.copy() for k, v in hot.items()}
        cold["dport"] = np.full(256, 10000 + 2 * burst, np.int32)
        cold["dport"][128:] = 10001 + 2 * burst
        (_, t_rows, _, tst), (_, j_rows, _, _) = _memo_eval_both(
            pt, jt, cold, t_rows, j_rows, 256)
        assert int(tst[tm.STAT_UNIQUE]) == 2
    (_, t_rows, thit, _), _ = _memo_eval_both(pt, jt, hot, t_rows, j_rows, 256)
    assert int(thit.sum()) == 256


# -- the memoized pair -------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_worlds():
    """(world, port tables, JAX tables) of the SMALL config-5 world's
    headline layout by table source ("port": the port's compilers,
    "convert": the JAX leaves carried across), each built once a
    module."""
    cache = {}

    def get(source):
        if source not in cache:
            _need_jax()
            w = world.make_world(seed=1, **SMALL)
            jt = jax_host_tables(w, subword=True)
            if source == "convert":
                tt = convert.tables_from_numpy(jax_leaves(jt), device="cpu")
            else:
                tt = convert.tables_to(world.headline_tables(w), "cpu")
            cache[source] = (w, tt, jt)
        return cache[source]

    return get


def _hot_pair(w, tt, half, seed, share=0.75, halves=(0, 1)):
    """A Zipf(1.1) pair whose halves in `halves` take one flow that
    counts a lattice hit in a `share` of their rows (world.hot_pair, the
    kinds from the uncached pair)."""
    pair = world.zipf_pairs(w, np.random.default_rng(seed), half, 1, 1.1)[0]
    out = tdp.datapath_step_accum_pair_telem_packed4_stacked(
        tt, torch.from_numpy(pair.view(np.int32)),
        tv.make_counter_buffers(tt.policy), tv.make_telemetry_buffers("cpu"))
    kinds = [out[h].match_kind.numpy() for h in (0, 1)]
    return world.hot_pair(pair, kinds, share, seed + 1, halves)


def _pair_both(tt, jt, pair, t_state, j_state, rep_cap):
    kern = jvm.memo_pair_packed4_kernel(rep_cap)
    j = kern(jt, jax.device_put(pair), j_state["rows"], j_state["acc"],
             j_state["tel"])
    t = tm.memo_pair_packed4(tt, torch.from_numpy(pair.view(np.int32)),
                             t_state["rows"], t_state["acc"], t_state["tel"],
                             rep_cap)
    assert_same_verdicts(t[0], j[0], "memo ingress")
    assert_same_verdicts(t[1], j[1], "memo egress")
    assert_same_buffers(t[2], t[3], j[2], j[3])
    _same_rows(t[4], j[4])
    _same(t[5], j[5], "hit ingress")
    _same(t[6], j[6], "hit egress")
    _same(t[7], j[7], "stats")
    j_state.update(rows=j[4], acc=j[2], tel=j[3])
    t_state.update(rows=t[4], acc=t[2], tel=t[3])
    return t


# test_memo_pair_matches_jax's cases: (table source, traffic)
_PAIR_CASES = {
    "port": ("port", "mixed"),
    "convert": ("convert", "mixed"),
    "zipf_hot": ("port", "hot"),
    "overflow": ("port", "hot_overflow"),
}


@pytest.mark.parametrize("case", list(_PAIR_CASES))
def test_memo_pair_matches_jax(case, pair_worlds):
    """The memoized headline pair on the SMALL config-5 world's compact
    tables, from port-built and carried-across tables: uniform cold then
    warm, two Zipf(1.1) pairs, then an overflowing capacity.  Every
    column, the counters, the telemetry, the rows, the hit flags and
    the stats equal the reference's; without overflow the outputs equal
    the uncached pair's; an overflow leaves counters, telemetry and
    rows as they were.  "zipf_hot": a Zipf pair whose halves each take
    one flow that counts a hit in 3 rows of 4 (one hot counter cell a
    half), cold then warm, then the overflow.  "overflow": the overflow
    falls on a pair whose ingress half alone is hot and fits the
    capacity, its egress half overflowing: nothing of either half is
    committed."""
    source, traffic = _PAIR_CASES[case]
    w, tt, jt = pair_worlds(source)
    half = 192
    if traffic == "mixed":
        pairs = (w.pairs(seed=11, half=half, k=1) * 2
                 + world.zipf_pairs(w, np.random.default_rng(53), half, 2,
                                    1.1))
    else:
        pairs = [_hot_pair(w, tt, half, 57)] * 2
    over = pairs[0]
    if traffic == "hot_overflow":
        over = _hot_pair(w, tt, half, 58, share=1.0, halves=(0,))
    rows = tm.make_cache_rows(1 << 6, 8)
    t_state = dict(rows=convert.cache_rows_to(rows, "cpu"),
                   acc=tv.make_counter_buffers(tt.policy),
                   tel=tv.make_telemetry_buffers("cpu"))
    j_state = dict(rows=jax.device_put(rows),
                   acc=jax.device_put(j_counters(jt.policy)),
                   tel=jax.device_put(j_telem()))
    u_acc = tv.make_counter_buffers(tt.policy)
    u_tel = tv.make_telemetry_buffers("cpu")
    for n, pair in enumerate(pairs):
        t = _pair_both(tt, jt, pair, t_state, j_state, half)
        st = t[7].numpy()
        assert st[tm.STAT_OVERFLOW] == 0 and st[tm.STAT_TUPLES] == 2 * half
        assert (st[tm.STAT_HIT] == 0) == (n == 0)
        assert int(t[5].sum() + t[6].sum()) == st[tm.STAT_HIT]
        ui, ue, u_acc, u_tel = tdp.datapath_step_accum_pair_telem_packed4_stacked(
            tt, torch.from_numpy(pair.view(np.int32)), u_acc, u_tel)
        for got, ref in ((t[0], ui), (t[1], ue)):
            for c in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, c), getattr(ref, c)), c
        assert torch.equal(t[2], u_acc) and torch.equal(t[3], u_tel)
    if traffic != "mixed":  # the hot flows' cells took 3 rows of 4
        assert int(t[2].max()) * 2 > len(pairs) * half
    before = {k: v.clone() for k, v in t_state.items()}
    t = _pair_both(tt, jt, over, t_state, j_state, 8)
    assert int(t[7][tm.STAT_OVERFLOW]) > 0
    for k, v in before.items():
        assert torch.equal(t_state[k], v), k


def test_memo_pair_stamp_flush_serves_no_stale_hit():
    """VerdictCache in front of the pair: a new epoch stamp (one more
    map-state entry, a bumped generation) flushes, the first batch after
    it serves 0 hits and equals the uncached pair on the new tables, the
    next one hits again."""
    w = world.make_world(seed=1, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cpu")
    pair = w.pairs(seed=12, half=256, k=1)[0]
    cache = tm.VerdictCache(n_rows=1 << 6, device="cpu")

    def stamp(gen, t):
        return (gen, ttab.tables_layout_version(t.policy))

    def run(t):
        acc = tv.make_counter_buffers(t.policy)
        tel = tv.make_telemetry_buffers("cpu")
        out = tm.memo_pair_packed4(t, torch.from_numpy(pair.view(np.int32)),
                                   cache.rows, acc, tel, 256)
        cache.rows = out[4]
        return out, cache.account(out[7])

    assert cache.ensure(stamp(1, tt)) and cache.flushes == 0
    assert run(tt)[1]["hits"] == 0
    assert run(tt)[1]["hits"] > 0
    states = [dict(s) for s in w.states]
    states[0][tpm.PolicyKey(257, 4311, 6, 0)] = tpm.PolicyMapStateEntry()
    w2 = dataclasses.replace(w, states=states)
    t2 = convert.tables_to(world.headline_tables(w2), "cpu")
    flushes = tmetrics.verdict_cache_flushes_total.get()
    assert cache.ensure(stamp(2, t2))
    assert cache.flushes == 1
    assert tmetrics.verdict_cache_flushes_total.get() == flushes + 1
    out, row = run(t2)
    assert row["hits"] == 0
    acc = tv.make_counter_buffers(t2.policy)
    tel = tv.make_telemetry_buffers("cpu")
    ui, ue, acc, tel = tdp.datapath_step_accum_pair_telem_packed4_stacked(
        t2, torch.from_numpy(pair.view(np.int32)), acc, tel)
    for got, ref in ((out[0], ui), (out[1], ue)):
        for c in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(got, c), getattr(ref, c)), c
    assert torch.equal(out[2], acc) and torch.equal(out[3], tel)
    assert run(t2)[1]["hits"] > 0


# -- the host owner and the dispatcher --------------------------------------------


def test_verdict_cache_stamp_commit_flush_and_metrics():
    cache = tm.VerdictCache(n_rows=1 << 4, entries=8, device="cpu")
    empty = cache.rows.clone()
    assert cache.nbytes() == 17 * 41 * 4
    m = tmetrics
    before = {n: getattr(m, f"verdict_cache_{n}_total").get()
              for n in ("hits", "misses", "insertions", "flushes")}
    # a fresh buffer adopts the first stamp without a flush
    assert cache.ensure("a") and cache.flushes == 0
    assert not cache.ensure("a")
    stamp, rows = cache.acquire()
    assert stamp == "a"
    dirty = rows.clone()
    dirty[0, 0] = 7
    assert not cache.commit("b", dirty)  # another epoch's rows are dropped
    assert cache.commit("a", dirty) and cache.rows[0, 0] == 7
    row = cache.account(torch.tensor([10, 30, 10, 0, 100], dtype=torch.int32))
    assert row == {"unique": 10, "hits": 30, "insertions": 10, "overflow": 0,
                   "tuples": 100}
    cache.account(np.array([5, 0, 0, 3, 100], np.uint32))  # overflow only
    assert (cache.hits, cache.misses, cache.insertions, cache.overflows,
            cache.tuples, cache.unique) == (30, 70, 10, 3, 100, 10)
    assert cache.hit_rate() == 0.3 and cache.dedup_factor() == 10.0
    # a new stamp flushes the dirty buffer
    assert cache.ensure("b") and cache.flushes == 1
    assert torch.equal(cache.rows, empty)
    cache.rows = dirty
    cache.flush()
    assert cache.stamp is None and cache.flushes == 2
    snap = cache.snapshot()
    assert snap["hits"] == 30 and snap["flushes"] == 2
    assert snap["hit_rate"] == 0.3 and snap["bytes"] == cache.nbytes()
    after = {n: getattr(m, f"verdict_cache_{n}_total").get()
             for n in ("hits", "misses", "insertions", "flushes")}
    assert {n: after[n] - before[n] for n in after} == {
        "hits": 30, "misses": 70, "insertions": 10, "flushes": 2}


def test_async_batch_dispatcher_order_and_drain():
    assert [tpub.next_pow2(n) for n in (0, 1, 2, 3, 64, 65)] == [
        1, 1, 2, 4, 64, 128]

    def pack(x):
        if x == 3:
            raise ValueError("pack 3")
        return (torch.tensor([x]),)

    def dispatch(t):
        if int(t) == 5:
            raise RuntimeError("dispatch 5")
        return t * 2

    d = tpub.AsyncBatchDispatcher(pack, dispatch, depth=2)
    seen = []
    for i in range(7):
        meta = {"i": i}
        done = d.submit((i,), meta)
        assert len(done) == (1 if i >= 2 else 0)
        seen.extend(done)
    seen.extend(d.flush())
    assert [m["i"] for m, _, _ in seen] == list(range(7))
    for m, out, exc in seen:
        if m["i"] in (3, 5):
            assert out is None and exc is not None
        else:
            assert exc is None and int(out) == 2 * m["i"]
    assert d.submitted == 7 and d.failed == 2
    assert d.flush() == []


# -- on the card -----------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


def _card_equal(a, b, what):
    assert a.shape == b.shape, what
    assert torch.equal(a.to(torch.int64) & M32, b.to(torch.int64) & M32), what


@pytest.mark.cuda
@pytest.mark.parametrize("rep_cap", [1 << 15, 64])
def test_memo_dedup_kernel_matches_plain(rep_cap):
    _need_card()
    from cilium_tpu_torch import kernels

    rng = np.random.default_rng(7)
    k = np.concatenate([_keys(rng, 20_000, "duplicated"),
                        _keys(rng, 12_768, "random")], axis=1)
    keys = torch.from_numpy(k.view(np.int32)).cuda()
    before = kernels.MEMO_DEDUP.launches
    got = kernels.MEMO_DEDUP(keys, rep_cap)
    want = tm.dedup_groups(*(tv.widen(keys[i]) for i in range(3)), rep_cap)
    torch.cuda.synchronize()
    for name in ("srow", "gid", "rgid", "rep_orig", "rep_valid"):
        _card_equal(got[name], want[name], name)
    assert int(got["n_unique"]) == want["n_unique"]
    assert int(got["overflow"]) == want["overflow"]
    assert kernels.MEMO_DEDUP.launches == before + 1
    with pytest.raises(ValueError, match="CUDA"):
        kernels.MEMO_DEDUP(keys.cpu(), rep_cap)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["all_equal", "all_distinct", "zipf_hot",
                                    "bit31", "one_row", "duplicated"])
@pytest.mark.parametrize("cap", ["n_unique", "half", "more"])
def test_memo_dedup_kernel_edge_cases(spread, cap):
    """MEMO_DEDUP against its plain version on the CPU test's key sets
    at 300,007 rows (no multiple of the kernel's tiles; one row for
    "one_row"), rep_cap n_unique, half of it (an overflow) and past
    it."""
    _need_card()
    from cilium_tpu_torch import kernels

    k = _keys(np.random.default_rng(11), 300_007, spread)
    keys = torch.from_numpy(np.ascontiguousarray(k).view(np.int32)).cuda()
    wide = [tv.widen(keys[i]) for i in range(3)]
    n_unique = tm.dedup_groups(*wide, 1)["n_unique"]
    rep_cap = {"n_unique": n_unique, "half": max(n_unique // 2, 1),
               "more": n_unique + 5}[cap]
    got = kernels.MEMO_DEDUP(keys, rep_cap)
    want = tm.dedup_groups(*wide, rep_cap)
    torch.cuda.synchronize()
    for name in ("srow", "gid", "rgid", "rep_orig", "rep_valid"):
        _card_equal(got[name], want[name], name)
    assert int(got["n_unique"]) == want["n_unique"]
    assert int(got["overflow"]) == want["overflow"]


def _card_groups(g):
    """dedup_groups' plain dict as MEMO_CACHE takes MEMO_DEDUP's."""
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    out = {n: i32(g[n]) for n in ("srow", "gid", "rgid", "rep_orig")}
    for n in ("n_unique", "overflow"):
        out[n] = torch.tensor([g[n]], dtype=torch.int32, device="cuda")
    return out


@functools.lru_cache(maxsize=None)
def _card_memo_world():
    """A small world's headline tables on the card and a Zipf pair's
    memo keys [2, 3, 60,000] (DATAPATH_PAIR_MEMO's front pass)."""
    from cilium_tpu_torch import kernels

    w = world.make_world(seed=1, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cuda")
    pair = world.zipf_pairs(w, np.random.default_rng(55), 60_000, 1, 1.1)[0]
    pt = torch.from_numpy(pair.view(np.int32)).cuda()
    front = kernels.DATAPATH_PAIR_MEMO.front(tt, pt)
    return tt, front.keys, front.has_l3


_CACHE_CASES = {
    # (layout, entries, n_rows, the halves' keys, their rep_caps)
    **{f"{lay}-{e}": (lay, e, 64, "pair", (None, None))
       for lay in ("legacy", "rank", "subword") for e in (8, 16, 32)},
    "one_bucket": ("rank", 8, 1, "pair", (None, None)),
    "one_key": ("rank", 8, 64, "one_key", (None, None)),
    "rep_cap_full": ("subword", 16, 64, "pair", ("n_unique", "n_unique")),
    "overflow_restore": ("rank", 8, 64, "pair", (None, "half")),
    # more representatives than a block stages hit bits for
    "many_reps": ("rank", 8, 1 << 12, "many", (None, None)),
}


def _card_many_keys(tt):
    """Key words [2, 3, 450,000] of nearly distinct tuples (dports over the
    whole range) from MEMO_KEYS_LATTICE: no L3 bit."""
    from cilium_tpu_torch import kernels

    w = world.make_world(seed=1, **SMALL)
    out = []
    for seed in (12, 13):
        cols = world.lattice_tuples(w, 450_000, seed=seed)
        cols["dport"] = np.random.default_rng(seed).integers(0, 1 << 16,
                                                             450_000)
        batch = tv.TupleBatch.from_numpy(**cols, device="cuda")
        out.append(kernels.MEMO_KEYS_LATTICE.keys(tt.policy, batch.pack()))
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CACHE_CASES))
def test_memo_cache_kernel_matches_plain(case):
    """MEMO_CACHE against memo_cache_plain on both halves of a memoized
    pair (the ingress half copies the rows and commits into the copy,
    the egress half commits in place, accumulates the stats and
    restores the rows after an overflow): v0, v1, hit, the rows and the
    stats, over the three layouts at 8, 16 and 32 entries, every
    representative in one bucket, one key (U = 1), rep_cap = U, an
    overflow of the second half, and more representatives than the
    kernel stages hit bits for in shared memory.  One launch a call."""
    _need_card()
    from cilium_tpu_torch import kernels

    layout, e, n_rows, which, caps = _CACHE_CASES[case]
    tt, keys2, has_l3 = _card_memo_world()
    if which == "one_key":
        keys2 = keys2[:, :, :1].expand(-1, -1, 5000).contiguous()
    if which == "many":
        keys2, has_l3 = _card_many_keys(tt), False
    rows = convert.cache_rows_to(_rows(layout, n_rows, e), "cuda")
    out_rows = torch.empty_like(rows)
    stats = torch.empty(tm.STATS, dtype=torch.int32, device="cuda")
    p_rows, p_stats = rows, torch.zeros(tm.STATS, dtype=torch.int64,
                                        device="cuda")
    for h in (0, 1):
        keys = keys2[h]
        k0, k1, k2 = (tv.widen(keys[i]) for i in range(3))
        n_unique = tm.dedup_groups(k0, k1, k2, 1)["n_unique"]
        cap = {None: keys.shape[1], "n_unique": n_unique,
               "half": max(n_unique // 2, 1)}[caps[h]]
        g = tm.dedup_groups(k0, k1, k2, cap)
        before = kernels.MEMO_CACHE.launches
        v0, v1, hit = kernels.MEMO_CACHE(
            tt.policy, keys, _card_groups(g), rows if h == 0 else out_rows,
            out_rows, stats, rep_cap=cap, has_l3=has_l3, accumulate=h == 1,
            restore=rows if h == 1 else None)
        assert kernels.MEMO_CACHE.launches == before + 1
        pv0, pv1, phit, prow, pst = tm.memo_cache_plain(
            tt.policy, p_rows, (k0, k1, k2), g, k0, ((k1 >> 1) & 1).bool(),
            (k1 & 1).bool() if has_l3 else None, k2 >> 1, k2 & 1, k1 >> 16,
            (k1 >> 8) & 0xFF, cap)
        p_stats = p_stats + pst
        restored = h == 1 and int(p_stats[tm.STAT_OVERFLOW]) != 0
        p_rows = rows if restored else prow
        torch.cuda.synchronize()
        for got, want, what in ((v0, pv0, "v0"), (v1, pv1, "v1"),
                                (hit, phit, "hit"), (out_rows, p_rows, "rows"),
                                (stats, p_stats, "stats")):
            _card_equal(got, want, f"{case} half {h} {what}")
    if case == "overflow_restore":
        assert restored and torch.equal(out_rows, rows)
    if case == "one_bucket":  # ranks past the lanes
        assert n_unique > e
    if case == "many_reps":  # csrc/memo.cu HIT_SMEM_WORDS' bits
        assert n_unique > 12000 * 32


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rank", "subword", "legacy"])
def test_memo_evaluate_kernels_match_plain(layout):
    _need_card()
    w = world.make_world(seed=1, **SMALL)
    pol = convert.policy_tables_to(ttab.split_hot(ttab.repack_l4_subword(
        w.host_tables().policy)), "cuda")
    cols = world.lattice_tuples(w, 20_000, seed=3)
    cols = _edges(_skew(cols, np.random.default_rng(8), 3000),
                  np.random.default_rng(9))
    batch = tv.TupleBatch.from_numpy(**cols, device="cuda")
    rows = convert.cache_rows_to(_rows(layout, 1 << 6, 8), "cuda")
    for rep_cap in (20_000, 20_000, 512):
        k = tm.memo_evaluate(pol, batch, rows, rep_cap)
        p = tm.memo_evaluate_plain(pol, batch, rows, rep_cap)
        torch.cuda.synchronize()
        for c in ("allowed", "proxy_port", "match_kind"):
            _card_equal(getattr(k[0], c), getattr(p[0], c), c)
        _card_equal(k[1], p[1], "rows")
        _card_equal(k[2], p[2], "hit")
        _card_equal(k[3], p[3], "stats")
        rows = k[1]
    assert int(k[3][tm.STAT_OVERFLOW]) > 0


@pytest.mark.cuda
def test_memo_pair_kernels_match_plain():
    _need_card()
    w = world.make_world(seed=1, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cuda")
    half = 50_000
    pairs = (w.pairs(seed=13, half=half, k=1) * 2
             + world.zipf_pairs(w, np.random.default_rng(54), half, 2, 1.1))
    rows = convert.cache_rows_to(tm.make_cache_rows(1 << 8, 8), "cuda")
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc.clone(), tel.clone()
    for n, p in enumerate(pairs + pairs[:1]):
        rep_cap = half if n < len(pairs) else 256
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        k = tm.memo_pair_packed4(tt, pt, rows, acc, tel, rep_cap)
        q = tm.memo_pair_plain(tt, pt, rows, acc_p, tel_p, rep_cap)
        torch.cuda.synchronize()
        if n < len(pairs):
            for got, ref in ((k[0], q[0]), (k[1], q[1])):
                for c in tdp.VERDICT_COLUMNS:
                    _card_equal(getattr(got, c), getattr(ref, c), c)
        else:
            assert int(k[7][tm.STAT_OVERFLOW]) > 0
        for i, what in ((2, "acc"), (3, "telem"), (4, "rows"), (7, "stats")):
            _card_equal(k[i], q[i], what)
        if n < len(pairs):
            _card_equal(k[5], q[5], "hit ingress")
            _card_equal(k[6], q[6], "hit egress")
        rows = k[4]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot", "overflow"])
def test_memo_pair_kernels_hot_cell_match_plain(case):
    """The memoized pair on the card against the plain memoized pair on
    a Zipf(1.1) pair in which one flow that counts a lattice hit takes 3
    rows of 4 of each half (world.hot_pair: one hot counter cell a half,
    whose hits the back pass adds a block at a time), cold then warm;
    "overflow": a pair whose ingress half is all that flow and fits the
    capacity while its egress half overflows it, so that nothing is
    committed."""
    _need_card()
    w = world.make_world(seed=1, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cuda")
    half = 50_000
    zp = world.zipf_pairs(w, np.random.default_rng(56), half, 1, 1.1)[0]
    out = tdp.datapath_pair_plain(
        tt, torch.from_numpy(zp.view(np.int32)).cuda(),
        tv.make_counter_buffers(tt.policy), tv.make_telemetry_buffers("cuda"))
    kinds = [out[h].match_kind.cpu().numpy() for h in (0, 1)]
    if case == "hot":
        runs = [(world.hot_pair(zp, kinds, 0.75, 91), half)] * 2
    else:
        runs = [(world.hot_pair(zp, kinds, 1.0, 92, halves=(0,)), 256)]
    rows = convert.cache_rows_to(tm.make_cache_rows(1 << 8, 8), "cuda")
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc.clone(), tel.clone()
    for pair, rep_cap in runs:
        pt = torch.from_numpy(pair.view(np.int32)).cuda()
        k = tm.memo_pair_packed4(tt, pt, rows, acc, tel, rep_cap)
        q = tm.memo_pair_plain(tt, pt, rows, acc_p, tel_p, rep_cap)
        torch.cuda.synchronize()
        for got, ref in ((k[0], q[0]), (k[1], q[1])):
            for c in tdp.VERDICT_COLUMNS:
                _card_equal(getattr(got, c), getattr(ref, c), c)
        for i, what in ((2, "acc"), (3, "telem"), (4, "rows"), (5, "hit in"),
                        (6, "hit eg"), (7, "stats")):
            _card_equal(k[i], q[i], what)
        rows, acc, tel, acc_p, tel_p = k[4], k[2], k[3], q[2], q[3]
    if case == "hot":  # the two hot cells
        assert int(acc.view(-1).topk(2).values.min()) > half
    else:
        assert int(k[7][tm.STAT_OVERFLOW]) > 0
        assert not acc.any() and not tel.any()
