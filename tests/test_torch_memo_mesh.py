"""The PyTorch port's verdict memo on a mesh (engine/memo_mesh.py) on the
CPU against the JAX package's make_partitioned_memo_evaluator and
make_failover_memo_evaluator, which run on the 8 virtual host devices
tests/conftest.py gives them.  The port runs on a CPU Mesh of the same
(dp, tp), (2, 4) and (4, 2), over `random_map_state` worlds whose tuple
streams repeat keys within and across batch shards.  Every value is an
integer, so equality is exact:

  * the verdict columns, l4_counts, l3_counts, per-chip telemetry, the
    hit flags, the stats row and (failover) replica_hits, over a cold
    and a warm pass that carries the cache, healthy and with a dead
    table column;
  * the cache rows of every coordinate's slice except its scratch row
    (row R_local), a sink the reference writes through a scatter whose
    duplicate-index order is open and never reads, and which the port
    never writes;
  * an overflowing batch: only the cache is specified, and it must come
    back as the reference's (an overflowing row's slices unchanged);
  * the refusal of a table or cache geometry the evaluator was not
    built for.

The cuda-marked tests at the end hold the memo-mesh kernels against
these plain versions on the card.
"""

import numpy as np
import pytest
import torch

from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import memo_mesh as tmm
from cilium_tpu_torch.engine import mesh as tmesh
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.maps import policymap as tpm

try:
    import jax

    from cilium_tpu.compiler import partition as jpart
    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import sharded as jsh
    from cilium_tpu.engine import verdict as jv
    from cilium_tpu.maps import policymap as jpm

    from tests.test_verdict_engine import random_map_state, random_tuples
    from torch_parity import convert_states
except ImportError:  # the card's machine has no JAX
    jax = None

WIDE_IDS = [1, 2, 3, 4, 5] + [256 + i for i in range(120)] + [65536, 70000]
MESHES = [(2, 4), (4, 2)]
R_LOCAL, ENTRIES = 16, 4
B = 768


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _jmesh(dp, tp):
    devs = jax.devices()
    assert len(devs) == 8, "conftest must force 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs).reshape(dp, tp),
                             ("batch", "table"))


def _repeating(rng, n_unique):
    """B tuples drawn with repetition from `n_unique` random ones, so
    keys repeat within and across the batch shards."""
    pool = random_tuples(rng, n_unique, 3, WIDE_IDS)
    pick = rng.integers(0, n_unique, B)
    return {k: np.asarray(v)[pick] for k, v in pool.items()}


@pytest.fixture(scope="module")
def world():
    if jax is None:
        return {}
    rng = np.random.default_rng(11)
    states = [random_map_state(rng, WIDE_IDS, n_l4=16, n_l3=24)
              for _ in range(3)]
    jt = jtab.compile_map_states(states, WIDE_IDS, identity_pad=256,
                                 filter_pad=16)
    tt = ttab.compile_map_states(convert_states(states, jpm, tpm), WIDE_IDS,
                                 identity_pad=256, filter_pad=16)
    out = dict(jt=jt, tt=tt, cold=_repeating(rng, 200),
               warm=_repeating(rng, 260), valid=rng.random(B) < 0.8)
    out["hot"] = _hot(out["tt"], out["cold"])
    return out


def _hot(tt, pool):
    """B tuples of `pool` whose hits crowd a few cells (world.hot_tuples:
    one tuple that hits an L4 entry more than half of them, five others
    most of the rest), by the plain lattice's match kinds on the CPU."""
    from cilium_tpu_torch import world as tworld
    from cilium_tpu_torch.convert import policy_tables_to

    kinds = tv.evaluate_batch(
        policy_tables_to(tt, "cpu"),
        tv.TupleBatch.from_numpy(**pool, device="cpu"),
        device="cpu").match_kind
    return tworld.hot_tuples(pool, kinds.numpy(), B, seed=12)


# the streams of the cold and the warm pass: keys repeating within and
# across the batch shards, and the hot stream for both passes
STREAMS = {"repeating": ("cold", "warm"), "hot": ("hot", "hot")}


def _empty_rows(dp, tp):
    rows = np.full((dp, tp, R_LOCAL + 1, 5 * ENTRIES + 1), 0xFFFFFFFF,
                   np.uint32)
    rows[..., -1] = 0
    return rows


def _check_cache(got, want, tag):
    """Every slice's rows except the scratch row (see the module
    docstring)."""
    g = got.numpy() if isinstance(got, tmesh.PlacedArray) else got
    np.testing.assert_array_equal(np.asarray(g)[:, :, :-1],
                                  np.asarray(want)[:, :, :-1], err_msg=tag)


def _check_out(got, want, tag, n_lead=3):
    for col in ("allowed", "proxy_port", "match_kind"):
        np.testing.assert_array_equal(_np(getattr(got[0], col)),
                                      _np(getattr(want[0], col)),
                                      err_msg=f"{tag} {col}")
    for k in range(1, n_lead):
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]),
                                      err_msg=f"{tag} output {k}")


@pytest.mark.parametrize("dp,tp,stream", [
    pytest.param(2, 4, "repeating", id="2-4"),
    pytest.param(4, 2, "repeating", id="4-2"),
    pytest.param(2, 4, "hot", id="2-4-hot"),
    pytest.param(4, 2, "hot", id="4-2-hot"),
])
def test_partitioned_memo_matches_reference(world, dp, tp, stream):
    """Cold then warm: verdicts, counters, cache, hits, stats and
    telemetry equal to the reference's, the warm pass hitting; on the
    repeating stream and on the hot one (most tuples count into one L4
    cell)."""
    _need_jax()
    jm = _jmesh(dp, tp)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    rows0 = _empty_rows(dp, tp)
    rep_cap = B // dp
    jev = jsh.make_partitioned_memo_evaluator(jm, world["jt"], rows0, rep_cap,
                                              collect_telemetry=True)
    tev = tmm.make_partitioned_memo_evaluator(tm, world["tt"], rows0, rep_cap,
                                              collect_telemetry=True)
    jrows, trows = rows0, rows0
    for tag, key in zip(("cold", "warm"), STREAMS[stream]):
        cols = world[key]
        want = jev(world["jt"], jv.TupleBatch.from_numpy(**cols), jrows)
        got = tev(world["tt"], tv.TupleBatch.from_numpy(**cols,
                                                        device="cpu"), trows)
        _check_out(got, want, tag)
        _check_cache(got[3], want[3], tag)
        for k in (4, 5, 6):
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]),
                                          err_msg=f"{tag} output {k}")
        assert int(np.asarray(want[5])[3]) == 0
        jrows, trows = np.asarray(want[3]), got[3]
    assert int(_np(got[4]).sum()) > 0, "the warm pass must hit"


@pytest.mark.parametrize("dp,tp,dead_col,stream", [
    pytest.param(2, 4, None, "repeating", id="None-2-4"),
    pytest.param(2, 4, 1, "repeating", id="1-2-4"),
    pytest.param(4, 2, None, "repeating", id="None-4-2"),
    pytest.param(4, 2, 1, "repeating", id="1-4-2"),
    pytest.param(2, 4, None, "hot", id="None-2-4-hot"),
    pytest.param(2, 4, 1, "hot", id="1-2-4-hot"),
])
def test_failover_memo_matches_reference(world, dp, tp, dead_col, stream):
    """The router's memo evaluator: cold and warm passes, healthy and
    with a dead table column (its cache slice unread, its inserts
    dropped, its rows served from the backups), valid-masked; on the
    repeating stream and on the hot one."""
    _need_jax()
    jm = _jmesh(dp, tp)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    rows0 = _empty_rows(dp, tp)
    rep_cap = B // dp
    jev = jsh.make_failover_memo_evaluator(jm, world["jt"], rows0, rep_cap,
                                           collect_telemetry=True)
    tev = tmm.make_failover_memo_evaluator(tm, world["tt"], rows0, rep_cap,
                                           collect_telemetry=True)
    jaug = jpart.replicate_table_leaves(world["jt"], tp)
    taug = tpart.replicate_table_leaves(world["tt"], tp)
    alive = np.ones((dp, tp), bool)
    if dead_col is not None:
        alive[:, dead_col] = False
    valid = world["valid"]
    jrows, trows = rows0, rows0
    for tag, key in zip(("cold", "warm"), STREAMS[stream]):
        cols = world[key]
        want = jev(jaug, jv.TupleBatch.from_numpy(**cols), alive, valid,
                   jrows)
        got = tev(taug, tv.TupleBatch.from_numpy(**cols, device="cpu"),
                  alive, valid, trows)
        _check_out(got, want, f"{tag} dead={dead_col}", n_lead=4)
        _check_cache(got[4], want[4], tag)
        for k in (5, 6, 7):
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]),
                                          err_msg=f"{tag} output {k}")
        if dead_col is not None:
            assert int(np.asarray(want[3])) > 0 or tag == "warm"
        jrows, trows = np.asarray(want[4]), got[4]


@pytest.mark.parametrize("failover", [False, True])
def test_memo_overflow_returns_cache_unchanged(world, failover):
    """More distinct keys than rep_cap: the stats report the overflow and
    the cache equals the reference's (the overflowing rows' slices as
    they came in, the port's scratch rows too); the other outputs are
    unspecified."""
    _need_jax()
    dp, tp = 2, 4
    jm = _jmesh(dp, tp)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    rows0 = _empty_rows(dp, tp)
    cols = world["warm"]
    rep_cap = 32
    if failover:
        jev = jsh.make_failover_memo_evaluator(jm, world["jt"], rows0,
                                               rep_cap)
        tev = tmm.make_failover_memo_evaluator(tm, world["tt"], rows0,
                                               rep_cap)
        alive = np.ones((dp, tp), bool)
        valid = np.ones(B, bool)
        want = jev(jpart.replicate_table_leaves(world["jt"], tp),
                   jv.TupleBatch.from_numpy(**cols), alive, valid, rows0)
        got = tev(tpart.replicate_table_leaves(world["tt"], tp),
                  tv.TupleBatch.from_numpy(**cols, device="cpu"), alive,
                  valid, rows0)
        cache_k, stats_k = 4, 6
    else:
        jev = jsh.make_partitioned_memo_evaluator(jm, world["jt"], rows0,
                                                  rep_cap)
        tev = tmm.make_partitioned_memo_evaluator(tm, world["tt"], rows0,
                                                  rep_cap)
        want = jev(world["jt"], jv.TupleBatch.from_numpy(**cols), rows0)
        got = tev(world["tt"], tv.TupleBatch.from_numpy(**cols,
                                                        device="cpu"), rows0)
        cache_k, stats_k = 3, 5
    assert int(np.asarray(want[stats_k])[3]) > 0
    np.testing.assert_array_equal(_np(got[stats_k]), _np(want[stats_k]))
    _check_cache(got[cache_k], want[cache_k], "overflow")
    # the port's cache comes back bit for bit, scratch rows included
    np.testing.assert_array_equal(got[cache_k].numpy(), rows0)


def test_memo_refuses_rebuilt_geometry(world):
    """Tables of another shape class, or cache rows of another geometry,
    are refused by both evaluators, as by the reference's."""
    _need_jax()
    tm = tmesh.make_mesh(2, 4, device="cpu")
    rows0 = _empty_rows(2, 4)
    tb = tv.TupleBatch.from_numpy(**world["cold"], device="cpu")
    part = tmm.make_partitioned_memo_evaluator(tm, world["tt"], rows0, 64)
    fail = tmm.make_failover_memo_evaluator(tm, world["tt"], rows0, 64)
    with pytest.raises(ValueError, match="geometry"):
        part(world["tt"], tb, _empty_rows(2, 4)[:, :, :9])
    with pytest.raises(ValueError, match="geometry"):
        # un-augmented tables are the wrong layout
        fail(world["tt"], tb, np.ones((2, 4), bool), np.ones(B, bool), rows0)
    with pytest.raises(ValueError, match="do not match the mesh"):
        tmm.make_partitioned_memo_evaluator(tm, world["tt"],
                                            _empty_rows(4, 2), 64)


def test_partitioned_cache_layout():
    """make_partitioned_cache: [dp, tp, R + 1, 5e + 1] placed P(batch,
    table), keys EMPTY and the rank word 0; a flush gives fresh rows."""
    tm = tmesh.make_mesh(2, 4, device="cpu")
    cache = tmm.make_partitioned_cache(tm, 8, 4)
    rows = cache.rows
    assert isinstance(rows, tmesh.PlacedArray)
    assert tuple(rows.shape) == (2, 4, 9, 21)
    assert tuple(rows.block(1, 3).shape) == (1, 1, 9, 21)
    host = rows.numpy()
    assert (host[..., :-1] == 0xFFFFFFFF).all() and (host[..., -1] == 0).all()
    assert cache.nbytes() == 2 * 4 * 9 * 21 * 4
    with pytest.raises(ValueError, match="power of two"):
        tmm.make_partitioned_cache(tm, 6, 4)


# -- the kernels on the card ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("failover,stream", [
    pytest.param(False, "pool", id="False"),
    pytest.param(True, "pool", id="True"),
    pytest.param(False, "hot", id="False-hot"),
    pytest.param(True, "hot", id="True-hot"),
    pytest.param(False, "overflow", id="False-overflow"),
    pytest.param(True, "overflow", id="True-overflow"),
])
def test_memo_mesh_kernels_match_plain(failover, stream):
    """The memo step on a CUDA (2, 4) mesh (MESH_MEMO_PROBE,
    MESH_MEMO_COMBINE, MESH_MEMO_INSERT with MEMO_KEYS_LATTICE,
    MEMO_DEDUP and ROUTED_PROBE) against the same step on a CPU mesh,
    cold and warm, every output and the cache rows equal.  Streams: 4096
    picks of 700 tuples; the hot stream of those tuples (world.hot_tuples:
    most tuples count into one counter cell); and the picks at rep_cap 256,
    below each batch row's distinct keys (the rows overflow, so the
    groups past rep_cap take representative rep_cap - 1's words)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cilium_tpu_torch import kernels, world as tworld
    from cilium_tpu_torch.convert import policy_tables_to

    w = tworld.make_world(
        seed=6, n_rules=400, n_endpoints=4, n_identities=512,
        n_cidr_blocks=16, n_vips=4, n_pool=3000, ct_max_entries=4096,
        identity_pad=256, filter_pad=16,
    )
    tables = w.host_tables().policy
    pool = tworld.lattice_tuples(w, 700, seed=3)
    pick = np.random.default_rng(3).integers(0, 700, 4096)
    cols = {k: np.asarray(v)[pick] for k, v in pool.items()}
    if stream == "hot":
        kinds = tv.evaluate_batch(
            policy_tables_to(tables, "cpu"),
            tv.TupleBatch.from_numpy(**pool, device="cpu"),
            device="cpu").match_kind
        cols = tworld.hot_tuples(pool, kinds.numpy(), 4096, seed=3)
    rep_cap = 256 if stream == "overflow" else 1024
    rows0 = _empty_rows(2, 4)
    launches = {k.name: k.launches for k in (
        kernels.MESH_MEMO_PROBE, kernels.MESH_MEMO_COMBINE,
        kernels.MESH_MEMO_INSERT)}
    out = {}
    for dev in ("cpu", "cuda"):
        tm = tmesh.make_mesh(2, 4, device=dev)
        if failover:
            ev = tmm.make_failover_memo_evaluator(tm, tables, rows0, rep_cap,
                                                  collect_telemetry=True)
            aug = tpart.replicate_table_leaves(tables, 4)
            alive = np.ones((2, 4), bool)
            alive[0, 1] = False
            run = lambda b, r: ev(aug, b, alive, np.ones(4096, bool), r)
        else:
            ev = tmm.make_partitioned_memo_evaluator(tm, tables, rows0,
                                                     rep_cap,
                                                     collect_telemetry=True)
            run = lambda b, r: ev(tables, b, r)
        rows, res = rows0, []
        for _ in range(2):
            got = run(tv.TupleBatch.from_numpy(**cols, device=dev), rows)
            rows = got[4 if failover else 3]
            res.append(got)
        out[dev] = res
    torch.cuda.synchronize()
    # two passes: a probe per batch row (its coordinates share the card),
    # an insert per coordinate, a front and a back pass per batch row
    assert kernels.MESH_MEMO_PROBE.launches - launches["mesh_memo_probe"] == 4
    assert kernels.MESH_MEMO_INSERT.launches - launches[
        "mesh_memo_insert"] == 16
    assert kernels.MESH_MEMO_COMBINE.launches - launches[
        "mesh_memo_combine"] == 8
    stats = out["cpu"][1][6 if failover else 5]
    assert (int(stats[tmm.vm.STAT_OVERFLOW]) > 0) == (stream == "overflow")
    for a, b in zip(out["cpu"], out["cuda"]):
        for x, y in zip(a, b):
            if isinstance(x, tmesh.PlacedArray):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
            elif isinstance(x, tv.Verdicts):
                for col in ("allowed", "proxy_port", "match_kind"):
                    np.testing.assert_array_equal(_np(getattr(x, col)),
                                                  _np(getattr(y, col)))
            else:
                np.testing.assert_array_equal(_np(x), _np(y))
