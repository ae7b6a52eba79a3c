"""The PyTorch port's policy lattice on a mesh (engine/mesh.py,
engine/sharded.py, the mesh arguments of engine/publish.py) on the CPU
against the JAX package's, which runs on the 8 virtual host devices
tests/conftest.py gives it.  The port runs on a CPU Mesh of the same
(dp, tp): (4, 2), (2, 4) and (8, 1), on `random_map_state` worlds of
seeds 0 and 1.  Every column is an integer, so equality is exact:

  * every shard's local leaf against the reference's addressable shard
    at the same coordinate;
  * the verdict columns, l4_counts, l3_counts, the per-chip telemetry
    and replica_hits of make_mesh_evaluator, make_partitioned_evaluator,
    make_failover_evaluator (healthy, and with a dead chip whose
    primary rows hold garbage) and make_sharded_evaluator;
  * the stale-geometry refusals;
  * the partitioned, replica and replicated stores through a churn of
    deltas: each step's mode and every shard's leaves equal to the
    reference store's, and both replica copies equal; the replicated
    store's deltas in every copy and the sharded evaluator's verdicts
    over it;
  * the pair step with dense policy tables (K8's dense branch) against
    JAX's `_datapath_core`.

The cuda-marked tests in tests/test_torch_kernel.py hold the mesh
kernels against these plain versions on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.engine import mesh as tmesh
from cilium_tpu_torch.engine import sharded as tsh
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.maps import policymap as tpm

try:
    import jax
    from jax.sharding import NamedSharding as JNamedSharding

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
MESHES = [(4, 2), (2, 4), (8, 1)]
M32 = 0xFFFFFFFF


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64) & M32


def _leaf_equal(got, want) -> bool:
    """A port leaf (int32 tensor: u32 bits, u16 widened) against a JAX
    leaf's numpy data."""
    want = np.asarray(want)
    got = got.cpu().numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    return got.shape == want.shape and np.array_equal(got, want)


def _jmesh(dp, tp):
    devs = jax.devices()
    assert len(devs) == 8, "conftest must force 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs).reshape(dp, tp),
                             ("batch", "table"))


@pytest.fixture(scope="module")
def worlds():
    """Seeds 0 and 1: the same map states through both compilers, and
    768 tuples."""
    if jax is None:
        return {}
    out = {}
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        states = [random_map_state(rng, WIDE_IDS, n_l4=16, n_l3=24)
                  for _ in range(3)]
        jt = jtab.compile_map_states(states, WIDE_IDS, identity_pad=256,
                                     filter_pad=16)
        tt = ttab.compile_map_states(convert_states(states, jpm, tpm),
                                     WIDE_IDS, identity_pad=256,
                                     filter_pad=16)
        cols = random_tuples(rng, 768, 3, WIDE_IDS)
        valid = rng.random(768) < 0.75
        out[seed] = dict(jt=jt, tt=tt, cols=cols, valid=valid,
                         jb=jv.TupleBatch.from_numpy(**cols),
                         tb=tv.TupleBatch.from_numpy(**cols, device="cpu"))
    out["hot"] = _hot_world(out[0])
    return out


def _hot_world(w):
    """World 0's tables with a hot batch of its tuples (world.hot_tuples:
    one tuple that hits an L4 entry makes more than half of the 768, five
    others most of the rest), its valid mask as world 0's."""
    from cilium_tpu_torch import world as tworld
    from cilium_tpu_torch.convert import policy_tables_to

    kinds = tv.evaluate_batch(policy_tables_to(w["tt"], "cpu"), w["tb"],
                              device="cpu").match_kind
    cols = tworld.hot_tuples(w["cols"], kinds.numpy(), 768, seed=13)
    return dict(w, cols=cols, jb=jv.TupleBatch.from_numpy(**cols),
                tb=tv.TupleBatch.from_numpy(**cols, device="cpu"))


@pytest.fixture(scope="module")
def jax_evaluators(worlds):
    """One JAX evaluator of each kind per (dp, tp), built once (the
    geometry of both worlds is the same)."""
    if jax is None:
        return {}
    jt = worlds[0]["jt"]
    out = {}
    for dp, tp in MESHES:
        m = _jmesh(dp, tp)
        out[dp, tp] = dict(
            mesh=m,
            mesh_ev=jsh.make_mesh_evaluator(m, collect_telemetry=True),
            part=jsh.make_partitioned_evaluator(m, jt, collect_telemetry=True),
            fail=jsh.make_failover_evaluator(m, jt, collect_telemetry=True),
            sharded=jv.make_sharded_evaluator(m),
        )
    return out


def _same_verdicts(got, want, where):
    for col in ("allowed", "proxy_port", "match_kind"):
        np.testing.assert_array_equal(_u32(getattr(got, col)),
                                      _u32(getattr(want, col)),
                                      err_msg=f"{where} {col}")


def _same(got, want, where):
    """A whole output tuple: Verdicts first, then integer tensors."""
    assert len(got) == len(want), where
    _same_verdicts(got[0], want[0], where)
    for k, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        a, b = _u32(a), _u32(b)
        assert a.shape == b.shape, (where, k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} output {k}")


def test_mesh_and_specs():
    mesh = tmesh.make_mesh(2, 4, device="cpu")
    assert mesh.shape == {"batch": 2, "table": 4}
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.chip((1, 2)) == 6 and mesh.axis_index("table", (1, 2)) == 2
    assert tuple(tmesh.P()) == () and tuple(tmesh.P(None, "table")) == (
        None, "table")
    assert tmesh.P("table") == ("table",)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(2, 2, devices=["cpu"] * 3)
    sh = tmesh.NamedSharding(mesh, tmesh.P("table"))
    assert sh.slices((8, 3), (1, 2)) == (slice(4, 6), slice(None))
    with pytest.raises(ValueError, match="does not split"):
        sh.slices((6, 3), (0, 0))
    # a replicated tensor already on the device is placed once, a
    # sharded leaf once per (device, block)
    leaf = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    rep = tmesh.place(leaf, tmesh.NamedSharding(mesh, tmesh.P()))
    assert all(t is leaf for t in rep.flat)
    blocks = tmesh.place(leaf, sh)
    assert blocks[0, 1] is blocks[1, 1] and blocks[0, 1] is not blocks[0, 2]
    assert torch.equal(blocks[1, 3], leaf[6:8])
    assert blocks[0, 0].data_ptr() != leaf.data_ptr()


@pytest.mark.parametrize("dp,tp", MESHES)
def test_placement_matches_jax_shards(dp, tp, worlds, jax_evaluators):
    """Every coordinate's local leaf equals the reference's addressable
    shard on the device at the same coordinate, under the partitioned,
    the word-sharded and the replica layouts."""
    _need_jax()
    w = worlds[0]
    jm = jax_evaluators[dp, tp]["mesh"]
    mesh = tmesh.make_mesh(dp, tp, device="cpu")
    pos = {int(d.id): tuple(ix) for ix, d in np.ndenumerate(jm.devices)}
    layouts = (
        (w["tt"], w["jt"], tpart.divisible_partition_specs(w["tt"], tp),
         jpart.divisible_partition_specs(w["jt"], tp)),
        (w["tt"], w["jt"], tsh.table_specs(), jsh.table_specs("batch",
                                                              "table")),
        (tpart.replicate_table_leaves(w["tt"], tp),
         jpart.replicate_table_leaves(w["jt"], tp),
         tpart.divisible_partition_specs(w["tt"], tp),
         jpart.divisible_partition_specs(w["jt"], tp)),
    )
    for tt, jt, tspecs, jspecs in layouts:
        placed = tmesh.place_tables(tt, tmesh.shardings_of(mesh, tspecs))
        seen = set()
        for name in tpart.POLICY_LEAF_NAMES:
            leaf = getattr(jt, name)
            if not isinstance(leaf, np.ndarray) or leaf.ndim == 0:
                continue
            arr = jax.device_put(leaf, JNamedSharding(jm, getattr(jspecs,
                                                                  name)))
            for sh in arr.addressable_shards:
                got = getattr(placed.shard(*pos[int(sh.device.id)]), name)
                key = (id(got), str(sh.index))
                if key in seen:  # a block shared by two coordinates
                    continue
                seen.add(key)
                assert _leaf_equal(got, sh.data), (name, pos)
        per = placed.chip_bytes()
        assert sorted(per) == list(range(dp * tp))


@pytest.mark.parametrize("seed", [0, 1, "hot"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_evaluators_match_jax(dp, tp, seed, worlds, jax_evaluators):
    """The four evaluators on a healthy mesh: every output column; on
    worlds 0 and 1, and on world 0 with a hot batch (most tuples count
    into one L4 cell, where MESH_COMBINE's hits concentrate)."""
    _need_jax()
    w, ev = worlds[seed], jax_evaluators[dp, tp]
    mesh = tmesh.make_mesh(dp, tp, device="cpu")
    tt, jt, tb, jb = w["tt"], w["jt"], w["tb"], w["jb"]
    _same(tsh.make_mesh_evaluator(mesh, collect_telemetry=True)(tt, tb),
          ev["mesh_ev"](jt, jb), f"mesh {dp}x{tp}")
    _same(tsh.make_partitioned_evaluator(mesh, tt, collect_telemetry=True)(
        tt, tb), ev["part"](jt, jb), f"partitioned {dp}x{tp}")
    _same_verdicts(tv.make_sharded_evaluator(mesh)(tt, tb),
                   ev["sharded"](jt, jb), f"sharded {dp}x{tp}")
    alive = np.ones((dp, tp), bool)
    fo = tsh.make_failover_evaluator(mesh, tt, collect_telemetry=True)
    taug = tpart.replicate_table_leaves(tt, tp)
    got = fo(taug, tb, alive, w["valid"])
    want = ev["fail"](jpart.replicate_table_leaves(jt, tp), jb, alive,
                      w["valid"])
    _same(got, want, f"failover {dp}x{tp}")
    # a batch split with its mask, and valid None: the same outputs
    _same(fo(taug, tsh.shard_batch(mesh, tb, valid=w["valid"]), alive, None),
          want, f"failover pre-split {dp}x{tp}")
    assert int(got[3]) == 0
    assert fo.replica_axes == jpart.replica_axes(jt, tp)
    # the per-chip telemetry folds to the mesh total
    from cilium_tpu_torch.telemetry import fold_telemetry_per_chip
    from cilium_tpu_torch.metrics import Registry

    total = fold_telemetry_per_chip(_u32(got[4]), registry=Registry())
    assert int(total[:, tv.TELEM_TOTAL].sum()) == int(w["valid"].sum())


def _garble(aug, tp, col, n, wn):
    """`aug` with table column `col`'s primary regions overwritten."""
    rows = np.array(aug.l4_hash_rows)
    rows[2 * n * col:2 * n * col + n] = 0xDEADBEEF
    words = np.array(aug.l3_allow_bits)
    words[:, :, 2 * wn * col:2 * wn * col + wn] = 0xFFFFFFFF
    return dataclasses.replace(aug, l4_hash_rows=rows, l3_allow_bits=words)


def _same_valid(got, healthy, valid):
    keep = torch.from_numpy(valid)
    for col in ("allowed", "proxy_port", "match_kind"):
        assert torch.equal(getattr(got[0], col)[keep],
                           getattr(healthy[0], col)[keep]), col
    for a, b in zip(got[1:3] + got[4:], healthy[1:3] + healthy[4:]):
        assert torch.equal(a, b)


def _stash_world(w):
    """World 1 with both hashed tables repacked at 4 lanes (2 entries a
    row: 16 exact and 2 wildcard entries spill into the stashes), and
    edge tuples in its first 16 rows: identities past id_direct's two
    regions and outside the universe, negative and huge endpoints and
    directions, dports past 65,535."""
    tt = ttab.repack_l4_subword(w["tt"], lanes=4)
    jt = jtab.repack_l4_subword(w["jt"], lanes=4)
    cols = {k: np.asarray(v).astype(np.int64) for k, v in w["cols"].items()}
    edge = dict(
        identity=[0xFFFFFFFF, 0x7FFFFFFF, (1 << 24) + 70000, (1 << 24) - 1,
                  999999, 1 << 31, (1 << 24) + 200, 7] * 2,
        ep_index=[-1, -2, 1 << 20, 0xFFFFFFFF, 2, 1, 0, -3] * 2,
        direction=[-1, 2, 255, 0xFFFFFFFE, 1, 0, 1, 0] * 2,
        dport=[70000, 65536, 1 << 31, 0xFFFFFFFF, 80, 53, 443, 8080] * 2,
    )
    for k, v in edge.items():
        cols[k][:16] = np.asarray(v, np.int64)
    cols = {k: (v.astype(bool) if k == "is_fragment" else
                (v & M32).astype(np.uint32)) for k, v in cols.items()}
    return dict(tt=tt, jt=jt, cols=cols, valid=w["valid"],
                jb=jv.TupleBatch.from_numpy(**cols),
                tb=tv.TupleBatch.from_numpy(**cols, device="cpu"))


@pytest.fixture(scope="module")
def stash_edges(worlds, jax_evaluators):
    """_stash_world of world 1 and its JAX failover evaluator per (dp,
    tp), built once a module."""
    if jax is None:
        return {}
    w = _stash_world(worlds[1])
    w["fail"] = {k: jsh.make_failover_evaluator(ev["mesh"], w["jt"],
                                                collect_telemetry=True)
                 for k, ev in jax_evaluators.items()}
    return w


@pytest.mark.parametrize("dp,tp,world", [
    pytest.param(4, 2, "seed1", id="4-2"),
    pytest.param(2, 4, "seed1", id="2-4"),
    pytest.param(4, 2, "stash_edges", id="4-2-stash_edges"),
    pytest.param(2, 4, "stash_edges", id="2-4-stash_edges"),
])
def test_failover_dead_chip_matches_jax(dp, tp, world, worlds,
                                        jax_evaluators, stash_edges):
    """Table column 1 dead with its primary regions overwritten with
    garbage (the reference's own test): the outputs equal the
    reference's and the healthy mesh's.  Then chip (0, 1) alone dead,
    its own resident rows garbage: the valid rows' verdicts and every
    counter equal the healthy mesh's, and replica_hits > 0.  The
    "stash_edges" world (_stash_world) takes the same steps with stash
    hits on the exact and wildcard probes and out-of-range tuple
    words."""
    _need_jax()
    if world == "seed1":
        w, ev = worlds[1], jax_evaluators[dp, tp]
    else:
        w, ev = stash_edges, dict(fail=stash_edges["fail"][dp, tp])
    mesh = tmesh.make_mesh(dp, tp, device="cpu")
    tt, jt = w["tt"], w["jt"]
    taug = tpart.replicate_table_leaves(tt, tp)
    jaug = jpart.replicate_table_leaves(jt, tp)
    fo = tsh.make_failover_evaluator(mesh, tt, collect_telemetry=True)
    healthy = fo(taug, w["tb"], np.ones((dp, tp), bool), w["valid"])
    if world != "seed1":  # the stashes are hit
        placed = tmesh.place_tables(taug, tmesh.shardings_of(
            mesh, tpart.divisible_partition_specs(tt, tp)))
        rec = tsh.routed_probe_plain(placed.shard(0, 0), w["tb"], fo.geom, 0,
                                     torch.ones(tp, dtype=torch.bool))
        assert int(((rec[0] & tsh.F_STASH) != 0).sum()) > 0
        assert int(((rec[0] & tsh.F_P3) != 0).sum()) > 0
    n = tt.l4_hash_rows.shape[0] // tp
    wn = tt.l3_allow_bits.shape[-1] // tp
    alive = np.ones((dp, tp), bool)
    alive[:, 1] = False
    got = fo(_garble(taug, tp, 1, n, wn), w["tb"], alive, w["valid"])
    want = ev["fail"](_garble(jaug, tp, 1, n, wn), w["jb"], alive,
                      w["valid"])
    _same(got, want, f"dead column {dp}x{tp}")
    _same_valid(got, healthy, w["valid"])
    assert int(got[3]) > 0

    placed = tmesh.place_tables(taug, tmesh.shardings_of(
        mesh, tpart.divisible_partition_specs(tt, tp)))
    own = placed.shard(0, 1)
    bad_rows = own.l4_hash_rows.clone()
    bad_rows[:n] = -1
    bad_words = own.l3_allow_bits.clone()
    bad_words[:, :, :wn] = -1
    placed.shards[0, 1] = dataclasses.replace(
        own, l4_hash_rows=bad_rows, l3_allow_bits=bad_words)
    alive = np.ones((dp, tp), bool)
    alive[0, 1] = False
    got = fo(placed, w["tb"], alive, w["valid"])
    _same(got, ev["fail"](jaug, w["jb"], alive, w["valid"]),
          f"dead chip {dp}x{tp}")
    _same_valid(got, healthy, w["valid"])
    assert int(got[3]) > 0


def test_stale_geometry_refusals(worlds):
    _need_jax()
    tt = worlds[0]["tt"]
    mesh = tmesh.make_mesh(2, 4, device="cpu")
    tb = worlds[0]["tb"]
    part = tsh.make_partitioned_evaluator(mesh, tt)
    grown = dataclasses.replace(
        tt, l4_hash_rows=np.concatenate([tt.l4_hash_rows] * 2))
    with pytest.raises(ValueError, match="built for table geometry"):
        part(grown, tb)
    dense = dataclasses.replace(tt, l4_hash_rows=None)
    with pytest.raises(ValueError, match="hashed L4"):
        part(dense, tb)
    with pytest.raises(ValueError, match="hashed L4"):
        tsh.make_partitioned_evaluator(mesh, dense)
    with pytest.raises(ValueError, match="hashed L4"):
        tsh.make_failover_evaluator(mesh, dense)
    fo = tsh.make_failover_evaluator(mesh, tt)
    with pytest.raises(ValueError, match="augmented table geometry"):
        fo(tt, tb, np.ones((2, 4), bool), np.ones(768, bool))
    with pytest.raises(ValueError, match="alive must be"):
        fo(tpart.replicate_table_leaves(tt, 4), tb, np.ones((4, 2), bool),
           np.ones(768, bool))
    # tables placed for another evaluator are refused, not re-laid out
    placed = tmesh.place_tables(tt, tmesh.shardings_of(
        mesh, tsh.table_specs()))
    with pytest.raises(ValueError, match="placed with"):
        part(placed, tb)
    with pytest.raises(ValueError, match="does not split"):
        tsh.make_mesh_evaluator(mesh)(tt, tv.TupleBatch.from_numpy(
            **{k: v[:7] for k, v in worlds[0]["cols"].items()},
            device="cpu"))
    no_dense = dataclasses.replace(tt, l4_allow_bits=None)
    with pytest.raises(ValueError, match="dense"):
        tsh.make_mesh_evaluator(mesh)(no_dense, tb)


@pytest.mark.parametrize("kind", ["partitioned", "replica", "replicated"])
def test_stores_match_jax_through_churn(kind):
    """A churn of deltas (the publish tests' schedule, with resets and
    whole-leaf replacements) through the port's and the reference's
    store on a (2, 4) mesh: every step's
    PublishStats mode, scatter and replace counts, and every shard's
    leaves equal; in the replica store each row's two copies stay
    equal."""
    _need_jax()
    from test_torch_publish import churn_run

    mesh = tmesh.make_mesh(2, 4, device="cpu")
    jm = _jmesh(2, 4)
    make_t = getattr(tsh, f"make_{kind}_store")
    make_j = getattr(jsh, f"make_{kind}_store")
    ps, js = make_t(mesh), make_j(jm)
    port_c = ttab.FleetCompiler(identity_pad=256, filter_pad=16)
    ref_c = jtab.FleetCompiler(identity_pad=256, filter_pad=16)
    modes = []
    for step, port, ref, ids in churn_run(5, steps=14):
        pt, _ = port_c.compile(port, ids)
        rt, _ = ref_c.compile(ref, ids)
        pdev, pst = ps.publish(pt, port_c.delta_for(ps.spare_stamp(), pt))
        jdev, jst = js.publish(rt, ref_c.delta_for(js.spare_stamp(), rt))
        assert (pst.mode, pst.scatter_leaves, pst.replaced_leaves) == (
            jst.mode, jst.scatter_leaves, jst.replaced_leaves), step
        modes.append(pst.mode)
        pos = {int(d.id): tuple(ix) for ix, d in np.ndenumerate(jm.devices)}
        for name in tpart.POLICY_LEAF_NAMES:
            leaf = getattr(jdev, name)
            if leaf is None or getattr(leaf, "ndim", 0) == 0:
                continue
            seen = set()
            for sh in leaf.addressable_shards:
                got = getattr(pdev.shard(*pos[int(sh.device.id)]), name)
                if id(got) in seen:  # a block shared by two coordinates
                    continue
                seen.add(id(got))
                assert _leaf_equal(got, sh.data), (kind, step, name)
        if kind == "replica":
            for name, axis in tpart.replica_axes(pt, 4).items():
                for q in range(4):
                    a = getattr(pdev.shard(0, q), name)
                    b = getattr(pdev.shard(0, (q + 1) % 4), name)
                    n = a.shape[axis] // 2
                    assert torch.equal(a.narrow(axis, 0, n),
                                       b.narrow(axis, n, n)), (step, name)
        assert sorted(ps.chip_bytes()) == list(range(8))
        ps.check_current(pdev)
    assert modes.count("delta") > len(modes) // 2


def test_replicated_store_delta_verdicts_match_jax():
    """The reference's mesh delta publish test on the port: deltas
    published into make_replicated_store on an (8, 1) mesh land in
    every coordinate's copy (each leaf equal to the reference store's
    shard and to the single-device host tables), and the sharded
    evaluator's verdicts over the current epoch equal the reference's
    and evaluate_batch's on the host tables."""
    _need_jax()
    from cilium_tpu_torch.convert import policy_tables_to
    from test_torch_publish import churn_run

    mesh = tmesh.make_mesh(8, 1, device="cpu")
    jm = _jmesh(8, 1)
    ps, js = tsh.make_replicated_store(mesh), jsh.make_replicated_store(jm)
    port_c = ttab.FleetCompiler(identity_pad=32, filter_pad=4)
    ref_c = jtab.FleetCompiler(identity_pad=32, filter_pad=4)
    pos = {int(d.id): tuple(ix) for ix, d in np.ndenumerate(jm.devices)}
    modes = []
    for step, port, ref, ids in churn_run(3, steps=8):
        pt, _ = port_c.compile(port, ids)
        rt, _ = ref_c.compile(ref, ids)
        pdev, pst = ps.publish(pt, port_c.delta_for(ps.spare_stamp(), pt))
        jdev, jst = js.publish(rt, ref_c.delta_for(js.spare_stamp(), rt))
        assert pst.mode == jst.mode, step
        modes.append(pst.mode)
        for name in tpart.POLICY_LEAF_NAMES:
            leaf = getattr(jdev, name)
            if leaf is None or getattr(leaf, "ndim", 0) == 0:
                continue
            for sh in leaf.addressable_shards:
                got = getattr(pdev.shard(*pos[int(sh.device.id)]), name)
                assert _leaf_equal(got, sh.data), (step, name)
                assert _leaf_equal(got, getattr(rt, name)), (step, name)
        ps.check_current(pdev)
    assert modes[-1] == "delta" and modes.count("delta") > len(modes) // 2

    rng = np.random.default_rng(3)
    b = 8 * 16
    cols = dict(
        ep_index=rng.integers(0, 5, size=b),
        identity=rng.choice(np.asarray(ids[:40] + [9999], np.uint32),
                            size=b),
        dport=rng.choice(np.asarray([80, 443, 1000, 1001, 7]), size=b),
        proto=rng.choice(np.asarray([6, 17]), size=b),
        direction=rng.integers(0, 2, size=b),
    )
    got = tv.make_sharded_evaluator(mesh)(
        ps.current()[1], tv.TupleBatch.from_numpy(**cols, device="cpu"))
    jb = jv.TupleBatch.from_numpy(**cols)
    _same_verdicts(got, jv.make_sharded_evaluator(jm)(js.current()[1], jb),
                   "replicated store")
    _same_verdicts(got, tv.evaluate_batch(
        policy_tables_to(pt, "cpu"),
        tv.TupleBatch.from_numpy(**cols, device="cpu"), device="cpu"),
        "host tables")


def test_store_digest_refuses_other_partitioning():
    """A delta lands only on an epoch of the same partitioning: the
    digest is part of the layout stamp."""
    _need_jax()
    mesh = tmesh.make_mesh(2, 4, device="cpu")
    store = tsh.make_partitioned_store(mesh)
    fc = ttab.FleetCompiler(identity_pad=256, filter_pad=16)
    key = tpm.PolicyKey(256, 80, 6, tpm.INGRESS)
    st = {key: tpm.PolicyMapStateEntry()}
    for tok in range(2):
        store.publish(fc.compile([(1, st, tok)], WIDE_IDS)[0])
    st = dict(st)
    st[tpm.PolicyKey(257, 81, 6, tpm.INGRESS)] = tpm.PolicyMapStateEntry()
    tables = fc.compile([(1, st, 2)], WIDE_IDS)[0]
    delta = fc.delta_for(store.spare_stamp(), tables)
    store.partition_digest = tpart.replica_partition_digest(ntp=4)
    _, stats = store.publish(tables, delta)
    assert stats.mode == "full"


def test_dispatchers(worlds):
    """The async mesh dispatcher and traced_dispatch give the
    evaluator's own outputs; traced_dispatch records one chip span per
    coordinate."""
    _need_jax()
    from cilium_tpu_torch import tracing

    w = worlds[0]
    mesh = tmesh.make_mesh(2, 4, device="cpu")
    tt = w["tt"]
    ev = tsh.make_partitioned_evaluator(mesh, tt)
    placed = tmesh.place_tables(tt, tmesh.shardings_of(
        mesh, tpart.divisible_partition_specs(tt, 4)))
    want = ev(placed, w["tb"])
    disp = tsh.make_async_mesh_dispatcher(lambda b: ev(placed, b), mesh,
                                          depth=1)
    cols = w["cols"]
    args = tuple(cols[k] for k in ("ep_index", "identity", "dport", "proto",
                                   "direction", "is_fragment"))
    done = disp.submit(args, "a") + disp.submit(args, "b") + disp.flush()
    assert [m for m, _, _ in done] == ["a", "b"]
    for _, out, exc in done:
        assert exc is None
        _same(out, want, "dispatcher")
    traced = tsh.traced_dispatch(ev, mesh, site="test.mesh")
    with tracing.tracer.span("root", site="test"):
        _same(traced(placed, w["tb"]), want, "traced")
    assert traced.__wrapped__ is ev


def test_dense_pair_step_matches_jax():
    """The datapath pair step with policy tables without the hashed L4
    tables (K8's dense branch) against JAX's, on a small world."""
    _need_jax()
    from cilium_tpu_torch import convert, world

    from torch_parity import (
        SMALL,
        assert_same_buffers,
        assert_same_verdicts,
        jax_host_tables,
        jax_leaves,
        jax_run_pairs,
        port_run_pairs,
    )

    w = world.make_world(seed=3, **SMALL)
    jt = jax_host_tables(w, subword=False)
    hashed = ("l4_hash_rows", "l4_hash_stash", "l4_wild_rows",
              "l4_wild_stash")
    jt.policy = dataclasses.replace(jt.policy, **{k: None for k in hashed})
    tt = convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    assert tt.policy.l4_hash_rows is None and tt.policy.port_slot is not None
    pairs = w.pairs(seed=31, half=256, k=2) + w.pairs(seed=32, half=256, k=1,
                                                      zipf=1.2)
    t_outs, t_acc, t_tel = port_run_pairs(tt, pairs)
    j_outs, j_acc, j_tel = jax_run_pairs(jt, pairs)
    for k, (tp_, jp_) in enumerate(zip(t_outs, j_outs)):
        for half in (0, 1):
            assert_same_verdicts(tp_[half], jp_[half], f"pair {k} {half}")
    assert_same_buffers(t_acc, t_tel, j_acc, j_tel)


def test_sharded_evaluator_without_mesh_is_evaluate_batch():
    assert tv.make_sharded_evaluator(None) is tv.evaluate_batch
