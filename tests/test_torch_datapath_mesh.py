"""The PyTorch port's fused datapath on a mesh (engine/datapath_mesh.py,
the datapath families of compiler/partition.py, the owner-masked halves
of the stage modules, the router's datapath half) on the CPU against
the JAX package's, which runs on the 8 virtual host devices
tests/conftest.py gives it.  The port runs on a CPU Mesh of the same
(dp, tp); both get the same tables (the JAX leaves carried across by
convert.host_tables_from_numpy), flows, alive masks and breaker clock.
Every value is an integer: every comparison is exact.

  * the family rules: specs leaf for leaf, replica axes, the augmented
    leaves, the digest, the byte and universe models;
  * the owner-masked halves (`owns=`) on random rows;
  * the per-flow evaluator at tp 1, 2 and 4, healthy, with a chip dead
    and its primary regions poisoned, and with holes in `valid`: the 15
    columns, both counter buffers, replica_hits and the telemetry; the
    pair evaluator on a packed4 pair; the compact layouts, a world
    without range rows (the [B, P] scan), the classic LB and a plane
    the rules replicate;
  * the DatapathStore's modes and bytes through full, delta, scoped and
    record-less publishes, its resident leaves, repair_chip;
  * the router's dispatch_flows healthy, killed, re-split, readmitted
    and in the terminal fold, and a kernel error that propagates with
    no chip blamed (the port alone: the reference folds on any launch
    error).

The cuda-marked tests at the end hold DP_MESH_PROBE and DP_MESH_COMBINE
against their plain versions on the card; they need no JAX:

    python -m pytest --noconftest tests/test_torch_datapath_mesh.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert
from cilium_tpu_torch import faultinject as tfi
from cilium_tpu_torch import kernels as tkern
from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.ct import device as tct
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import datapath_mesh as tdm
from cilium_tpu_torch.engine import failover as tfo
from cilium_tpu_torch.engine import mesh as tmesh
from cilium_tpu_torch.ipcache import lpm as tlpm
from cilium_tpu_torch.lb import device as tlb
from cilium_tpu_torch.resilience import ChipBreakerBank

try:
    import jax

    from cilium_tpu import faultinject as jfi
    from cilium_tpu.compiler import partition as jpart
    from cilium_tpu.ct import device as jct
    from cilium_tpu.engine import datapath as jdp
    from cilium_tpu.engine import datapath_mesh as jdm
    from cilium_tpu.engine import failover as jfo
    from cilium_tpu.ipcache import lpm as jlpm
    from cilium_tpu.lb import device as jlb
    from cilium_tpu.resilience import ChipBreakerBank as JBank

    from torch_parity import SMALL, chaos_storm, jax_host_tables, jax_leaves
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

_CACHE = {}


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")


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


def _jmesh(tp):
    devs = jax.devices()
    assert len(devs) == 8, "conftest must force 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs).reshape(8 // tp, tp),
                             ("batch", "table"))


def _port(jt):
    """JAX host tables -> the port's host tables (the same leaves)."""
    return convert.host_tables_from_numpy(jax_leaves(jt))


def _storm(seed=11, **kw):
    key = ("storm", seed, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = chaos_storm()._fused_world(seed, **kw)
    return _CACHE[key]


def _one_lb_row(jt):
    """The world's inline LB rebuilt as one row (its two services' slots
    side by side): a plane that no table axis above 1 divides."""
    rows = np.asarray(jt.lb.rows).reshape(-1, 2, 64)
    slots = rows.reshape(-1, 64)
    used = slots[slots[:, 0] != 0]
    assert len(used) == 2
    return dataclasses.replace(jt.lb, rows=used.reshape(1, 128),
                               n_buckets=1)


def _world(kind):
    """(JAX host tables, flow maker) of one fused world."""
    key = ("world", kind)
    if key in _CACHE:
        return _CACHE[key]
    if kind in ("storm", "unsharded"):
        jt, parts = _storm(11, identity_pad=192) if kind == "unsharded" \
            else _storm(11)
        if kind == "unsharded":
            jt = dataclasses.replace(jt, lb=_one_lb_row(jt))

        def flows(rng, b, jt=jt, parts=parts):
            return chaos_storm()._fused_flows(rng, b, parts)
    else:
        from cilium_tpu_torch import world

        extra = {"subword": {}, "scan": dict(
            n_cidr_blocks=20, cidr_plens=(8, 12, 16, 20, 24)),
            "classic": dict(big_vip_backends=50)}[kind]
        w = world.make_world(seed=5, **{**SMALL, **extra})
        jt = jax_host_tables(w, subword=True)

        def flows(rng, b, w=w):
            return _pair_cols(w.pairs(seed=int(rng.integers(1 << 30)),
                                      half=b // 2, k=1)[0])
    _CACHE[key] = (jt, flows)
    return _CACHE[key]


def _pair_cols(pair):
    """A packed4 pair [2, 4, B] as flow columns, both halves in turn."""
    out = {c: [] for c in tdp.FLOW_COLUMNS}
    for h in np.asarray(pair).astype(np.int64):
        w2, w3 = h[2], h[3]
        for c, v in (("ep_index", w3 >> 16), ("saddr", h[0]),
                     ("daddr", h[1]), ("sport", w2 >> 16),
                     ("dport", w2 & 0xFFFF), ("proto", (w3 >> 8) & 0xFF),
                     ("direction", (w3 >> 1) & 1),
                     ("is_fragment", (w3 & 1) != 0)):
            out[c].append(v)
    cols = {k: np.concatenate(v) for k, v in out.items()}
    for c in ("saddr", "daddr"):
        cols[c] = cols[c].astype(np.uint32)
    return cols


def _jflows(t):
    return jdp.FlowBatch.from_numpy(**{k: np.asarray(v) for k, v in
                                       t.items()})


def _pflows(t):
    words = np.stack([np.asarray(t[c]).astype(np.int64).astype(np.uint32)
                      for c in tdp.FLOW_COLUMNS])
    return torch.from_numpy(words.view(np.int32))


def _jev(kind, tp, pair=False):
    key = ("jev", kind, tp, pair)
    if key not in _CACHE:
        jt, _ = _world(kind)
        make = (jdm.make_failover_datapath_pair_evaluator if pair
                else jdm.make_failover_datapath_evaluator)
        _CACHE[key] = make(_jmesh(tp), jt, collect_telemetry=True)
    return _CACHE[key]


def _jplace(jt, jm, tp, aug=None):
    aug = jpart.replicate_datapath_leaves(jt, tp) if aug is None else aug
    sh = jpart.datapath_table_shardings(jm, aug)
    return jax.tree.map(lambda leaf, s: jax.device_put(np.asarray(leaf), s),
                        aug, sh)


def _poisoned(jt, tp, victim_col):
    """The augmented tables with the victim column's primary region of
    every augmented plane scribbled over."""
    aug = jpart.replicate_datapath_leaves(jt, tp)

    def poison(arr, axis):
        a = np.array(arr)
        n = a.shape[axis] // (2 * tp)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(victim_col * 2 * n, victim_col * 2 * n + n)
        a[tuple(sl)] = 0xDEADBEEF
        return a

    ups = {}
    for (fam, leaf), axis in jpart.datapath_all_replica_axes(jt, tp).items():
        ups.setdefault(fam, {})[leaf] = poison(
            getattr(getattr(aug, fam), leaf), axis)
    return dataclasses.replace(aug, **{
        fam: dataclasses.replace(getattr(aug, fam), **u)
        for fam, u in ups.items()})


def _same_columns(got, want, where=""):
    for c in tdp.VERDICT_COLUMNS:
        a = getattr(got, c)
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(getattr(want, c))
        if c in tdp.U32_COLUMNS and a.dtype == np.int32:
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, (where, c, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {c}")


def _u32(x):
    return x.cpu().numpy().view(np.uint32)


def _same_out(tout, jout, where):
    """Evaluator outputs: the verdicts, then counters, hits, telemetry."""
    n_v = 2 if len(jout) == 6 else 1
    for k in range(n_v):
        _same_columns(tout[k], jout[k], f"{where} verdicts {k}")
    rest = tout[n_v:]
    jrest = jout[n_v:]
    for name, a, b in zip(("l4", "l3", "hits", "telemetry"), rest, jrest):
        np.testing.assert_array_equal(_u32(a), np.asarray(b),
                                      err_msg=f"{where} {name}")


# -- the family rules --------------------------------------------------------


def test_rule_tables_and_names_match_jax():
    _need_jax()
    for axis in ("table", "other_axis"):
        for fam in ("ct", "lb", "ipcache", "table"):
            t = getattr(tpart, f"default_{fam}_rules")(axis)
            j = getattr(jpart, f"default_{fam}_rules")(axis)
            assert [(p, tuple(s)) for p, s in t] == [
                (p, tuple(s)) for p, s in j]
        for ntp in (None, 1, 2, 4, 8):
            assert tpart.datapath_partition_digest(axis, ntp=ntp) == (
                jpart.datapath_partition_digest(axis, ntp=ntp))
    assert tpart.DATAPATH_REPLICA_LEAVES == jpart.DATAPATH_REPLICA_LEAVES
    for name in ("CT_LEAF_NAMES", "LB_INLINE_LEAF_NAMES",
                 "LB_CLASSIC_LEAF_NAMES"):
        assert getattr(tpart, name) == getattr(jpart, name)
    assert tpart.datapath_partition_digest() != (
        tpart.replica_partition_digest())
    for n in (1, 2, 8):
        for rc in (0, 2, 4):
            assert tpart.datapath_alltoall_bytes_per_tuple(n, rc) == (
                jpart.datapath_alltoall_bytes_per_tuple(n, rc))


def _specs_equal(tspecs, jspecs, where):
    for fam in ("prefilter", "ipcache", "ct", "lb", "policy", "tunnel"):
        tf, jf = getattr(tspecs, fam), getattr(jspecs, fam)
        assert (tf is None) == (jf is None), (where, fam)
        if tf is None:
            continue
        for f in dataclasses.fields(tf):
            t = getattr(tf, f.name)
            if not isinstance(t, tmesh.P):
                continue
            assert tuple(t) == tuple(getattr(jf, f.name)), (where, fam,
                                                            f.name)


@pytest.mark.parametrize("kind", ["storm", "subword", "classic",
                                  "unsharded"])
def test_family_specs_and_replica_axes_match_jax(kind):
    _need_jax()
    jt, _ = _world(kind)
    tt = _port(jt)
    for ntp in (1, 2, 3, 4, 8):
        where = f"{kind} ntp={ntp}"
        _specs_equal(tpart.datapath_partition_specs(tt, ntp),
                     jpart.datapath_partition_specs(jt, ntp), where)
        assert tpart.datapath_replica_axes(tt, ntp) == (
            jpart.datapath_replica_axes(jt, ntp)), where
        assert tpart.datapath_all_replica_axes(tt, ntp) == (
            jpart.datapath_all_replica_axes(jt, ntp)), where


@pytest.mark.parametrize("ntp", [1, 2, 4, 8])
def test_replicated_leaves_and_byte_models_match_jax(ntp):
    _need_jax()
    for kind in ("storm", "subword", "unsharded"):
        jt, _ = _world(kind)
        tt = _port(jt)
        taug = tpart.replicate_datapath_leaves(tt, ntp)
        jaug = jpart.replicate_datapath_leaves(jt, ntp)
        for fam, name, leaf in tdm._table_leaves(taug):
            np.testing.assert_array_equal(
                np.asarray(leaf), np.asarray(getattr(getattr(jaug, fam),
                                                     name)),
                err_msg=f"{kind} {fam}.{name}")
        rows, per, repl, ovh = tpart.datapath_bytes_model(tt, ntp)
        jrows, jper, jrepl, jovh = jpart.datapath_bytes_model(jt, ntp)
        assert rows == jrows and (per, repl, ovh) == (jper, jrepl, jovh)
        for hbm in (1 << 30, 16 << 30):
            assert tpart.datapath_universe_max_identities(
                tt, ntp, hbm_bytes=hbm) == (
                jpart.datapath_universe_max_identities(jt, ntp,
                                                       hbm_bytes=hbm))


def test_geometry_matches_jax():
    _need_jax()
    for kind in ("storm", "subword", "scan", "classic", "unsharded"):
        jt, _ = _world(kind)
        tt = _port(jt)
        assert tdm._geometry(tt) == jdm._geometry(jt), kind
        for ntp in (1, 2, 4):
            g = tdm._fused_geom(tt, ntp, "table")
            jg = jdm._fused_geom(jt, ntp, "table")
            assert {k: g[k] for k in jg} == jg, (kind, ntp)
    bad = dataclasses.replace(_port(_world("storm")[0]), ipcache=None)
    with pytest.raises((ValueError, AttributeError)):
        tdm._check_fused_world(bad)


# -- the owner-masked halves ------------------------------------------------


def _owns(rng, b):
    return rng.random(b) < 0.5


@pytest.mark.parametrize("half", ["ct", "lb", "ipcache", "range"])
def test_owner_masked_halves_match_jax(half):
    """Each half with a random ownership mask on random rows: equal to
    the reference's, and exactly zero where the shard does not own."""
    _need_jax()
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    b = 64
    owns = _owns(rng, b)
    t_owns = torch.from_numpy(owns)
    if half in ("ct", "lb"):
        for kind in ("storm", "subword"):
            jt, _ = _world(kind)
            if half == "ct":
                rows = np.asarray(jt.ct.buckets)[rng.integers(
                    0, jt.ct.buckets.shape[0], b)]
                ew = int(getattr(jt.ct, "entry_words", 5))
                ne = rows.shape[1] // ew
                pick = rng.integers(0, ne, b)
                keys = [rows[np.arange(b), k * ne + pick].astype(np.uint32)
                        for k in range(3)]
                w3 = rows[np.arange(b), 3 * ne + pick].astype(np.uint32)
                if ew == 4:
                    w3 = w3 >> 16
                w3r = (w3 ^ 1).astype(np.uint32)
                got = tct.ct_probe_row_parts(
                    torch.from_numpy(rows.view(np.int32)),
                    *(torch.from_numpy(k.astype(np.int64)) for k in keys),
                    torch.from_numpy(w3.astype(np.int64)),
                    torch.from_numpy(w3r.astype(np.int64)), owns=t_owns,
                    entry_words=ew)
                want = jct.ct_probe_row_parts(
                    jnp.asarray(rows), *(jnp.asarray(k) for k in keys),
                    jnp.asarray(w3), jnp.asarray(w3r),
                    owns=jnp.asarray(owns), entry_words=ew)
            else:
                rows = np.asarray(jt.lb.rows)[rng.integers(
                    0, jt.lb.rows.shape[0], b)]
                s = rng.integers(0, 2, b)
                vip = rows[np.arange(b), 64 * s].astype(np.uint32)
                w1 = rows[np.arange(b), 64 * s + 1].astype(np.uint32)
                got = tlb.lb_inline_slot(
                    torch.from_numpy(rows.view(np.int32)),
                    torch.from_numpy(vip.astype(np.int64)),
                    torch.from_numpy(w1.astype(np.int64)), owns=t_owns)
                want = jlb.lb_inline_slot(jnp.asarray(rows),
                                          jnp.asarray(vip), jnp.asarray(w1),
                                          owns=jnp.asarray(owns))
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(
                    g_.numpy().astype(np.int64) & 0xFFFFFFFF,
                    np.asarray(w_).astype(np.int64) & 0xFFFFFFFF,
                    err_msg=f"{half} {kind}")
                zero = g_.numpy()[~owns]
                assert not zero.any(), (half, kind)
        return
    for kind in ("storm", "subword"):
        jt, _ = _world(kind)
        ipc = jt.ipcache
        tipc = _port(jt).ipcache
        if half == "ipcache":
            rows = np.asarray(ipc.buckets)[rng.integers(
                0, ipc.buckets.shape[0], b)]
            per = ipc.bucket_entries or (32 if ipc.l3_planes else 64)
            ips = rows[np.arange(b), rng.integers(0, per, b)].astype(
                np.uint32)
            ing = rng.random(b) < 0.5
            got = tlpm.ipcache_bucket_parts(
                tipc, torch.from_numpy(rows.view(np.int32)),
                torch.from_numpy(ips.astype(np.int64)),
                ingress=torch.from_numpy(ing), owns=t_owns)
            want = jlpm.ipcache_bucket_parts(
                ipc, jnp.asarray(rows), jnp.asarray(ips),
                ingress=jnp.asarray(ing), owns=jnp.asarray(owns))
        else:
            rows = np.asarray(ipc.range_rows)[rng.integers(
                0, ipc.range_rows.shape[0], b)]
            widths = tuple(getattr(ipc, "range_widths", ()) or ())
            planes = 5 if ipc.l3_planes else 3
            sp = int(ipc.range_class_plens[0])
            w0 = rows[np.arange(b), 0].astype(np.uint32)
            got = tlpm.range_row_parts(
                torch.from_numpy(rows.view(np.int32)),
                torch.from_numpy(w0.astype(np.int64)), sp, planes,
                owns=t_owns, widths=widths)
            want = jlpm.range_row_parts(
                jnp.asarray(rows), jnp.asarray(w0), sp, planes,
                owns=jnp.asarray(owns), widths=widths)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(
                g_.numpy().astype(np.int64) & 0xFFFFFFFF,
                np.asarray(w_).astype(np.int64) & 0xFFFFFFFF,
                err_msg=f"{half} {kind}")
            assert not g_.numpy()[~owns].any(), (half, kind)


# -- the evaluators -------------------------------------------------------------


@pytest.mark.parametrize("case", ["healthy", "dead", "holes"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fused_evaluator_matches_jax(tp, case):
    """The per-flow evaluator against the reference's on the storm
    world: healthy; a chip dead with its primary regions poisoned
    (replica gathers serve, counted per (tuple, shard)); holes in
    `valid` (counters and telemetry count only the valid flows)."""
    _need_jax()
    jt, mk = _world("storm")
    dp = 8 // tp
    rng = np.random.default_rng(100 + tp)
    t = mk(rng, 256)
    jm = _jmesh(tp)
    alive = np.ones((dp, tp), bool)
    valid = np.ones(256, bool)
    aug = None
    if case == "dead":
        aug = _poisoned(jt, tp, tp - 1)
        alive[:, tp - 1] = False
    if case == "holes":
        valid[::5] = False
    jdev = _jplace(jt, jm, tp, aug)
    jout = _jev("storm", tp)(jdev, _jflows(t), alive, valid)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    tev = tdm.make_failover_datapath_evaluator(tm, _port(jt),
                                               collect_telemetry=True)
    taug = (tpart.replicate_datapath_leaves(_port(jt), tp) if aug is None
            else _port(aug))
    tout = tev(taug, _pflows(t), alive, torch.from_numpy(valid))
    _same_out(tout, jout, f"tp={tp} {case}")
    if case == "dead":
        assert int(tout[3]) > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_pair_evaluator_matches_jax(tp):
    """The packed4 pair (ingress half with no service probe and no LB)
    against the reference's, healthy and with a chip dead."""
    _need_jax()
    jt, mk = _world("storm")
    dp = 8 // tp
    rng = np.random.default_rng(200 + tp)
    b = 128
    halves = []
    for d in (0, 1):
        t = mk(rng, b)
        t["direction"] = np.full(b, d)
        halves.append(t)
    pair = np.stack([jdp.pack_flow_records4(**t) for t in halves])
    jm = _jmesh(tp)
    jev = _jev("storm", tp, pair=True)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    tev = tdm.make_failover_datapath_pair_evaluator(tm, _port(jt))
    valid = np.ones((2, b), bool)
    valid[1, ::3] = False
    for dead in (False, True):
        alive = np.ones((dp, tp), bool)
        aug = None
        if dead:
            aug = _poisoned(jt, tp, 1)
            alive[:, 1] = False
        jout = jev(_jplace(jt, jm, tp, aug), pair, alive, valid)
        taug = (tpart.replicate_datapath_leaves(_port(jt), tp) if aug is None
                else _port(aug))
        tout = tev(taug, torch.from_numpy(pair.view(np.int32)), alive,
                   torch.from_numpy(valid))
        _same_out(tout, jout, f"pair tp={tp} dead={dead}")


@pytest.mark.parametrize("kind,tp", [("subword", 4), ("scan", 2),
                                     ("classic", 4), ("unsharded", 4)])
def test_fused_layouts_match_jax(kind, tp):
    """The compact sub-word layouts, a world without range rows (the
    [B, P] scan), the classic LB (replicated, one full select) and a
    world whose LB rows and L3 words the table axis does not divide
    (read on one shard, not summed tp times); healthy and with a chip
    dead."""
    _need_jax()
    jt, mk = _world(kind)
    dp = 8 // tp
    tt = _port(jt)
    if kind == "unsharded":
        axes = tpart.datapath_all_replica_axes(tt, tp)
        assert ("lb", "rows") not in axes
        assert ("policy", "l3_allow_bits") not in axes
    if kind == "scan":
        assert tt.ipcache.range_rows is None
    rng = np.random.default_rng(300)
    t = mk(rng, 256)
    jm = _jmesh(tp)
    tm = tmesh.make_mesh(dp, tp, device="cpu")
    tev = tdm.make_failover_datapath_evaluator(tm, tt,
                                               collect_telemetry=True)
    valid = np.ones(256, bool)
    valid[::7] = False
    for dead in (False, True):
        alive = np.ones((dp, tp), bool)
        aug = None
        if dead:
            aug = _poisoned(jt, tp, 1)
            alive[0, 1] = False
        jout = _jev(kind, tp)(_jplace(jt, jm, tp, aug), _jflows(t), alive,
                              valid)
        taug = (tpart.replicate_datapath_leaves(tt, tp) if aug is None
                else _port(aug))
        tout = tev(taug, _pflows(t), alive, torch.from_numpy(valid))
        _same_out(tout, jout, f"{kind} dead={dead}")


def _hot_cells(t, kinds, n_eps, rng):
    """A hot-cell batch from flow columns `t` and the match kinds they take:
    three fifths copies of one L4-counting flow (one (ep, dir, slot) cell),
    a fifth copies of one L3-counting flow (one L3 cell); of the hot L4
    copies, 16 with ep or direction words past their range (ep n_eps and
    -1, direction 2 and -1: jax's scatter drops them or counts them from
    the end); the rows shuffled."""
    b = len(kinds)
    hot4 = int(np.nonzero((kinds == 1) | (kinds == 3))[0][0])
    hot3 = int(np.nonzero(kinds == 2)[0][0])
    out = {k: np.array(v).copy() for k, v in t.items()}
    for k in out:
        out[k][: 3 * b // 5] = t[k][hot4]
        out[k][3 * b // 5: 4 * b // 5] = t[k][hot3]
    out["ep_index"] = out["ep_index"].astype(np.int64)
    out["direction"] = out["direction"].astype(np.int64)
    out["ep_index"][0:4], out["ep_index"][4:8] = n_eps, -1
    out["direction"][8:12], out["direction"][12:16] = 2, -1
    perm = rng.permutation(b)
    return {k: v[perm] for k, v in out.items()}


def _slot_past_kg(policy, j, kg):
    """`policy` (JAX host tables' numpy leaves) with every hashed L4 entry
    whose slot is j given slot kg + 5, past the l4_meta plane: the flows
    that hit one count nowhere (jax's scatter drops the index) and read
    l4_meta at its last slot (its gather clamps)."""
    up = {}
    for rows_f, stash_f in (("l4_hash_rows", "l4_hash_stash"),
                            ("l4_wild_rows", "l4_wild_stash")):
        rows = np.array(getattr(policy, rows_f))
        stash = np.array(getattr(policy, stash_f))
        ew = stash.shape[1]
        e = rows.shape[1] // ew
        if ew == 2:  # the compact w1: j in bits 19-30, bit 31 an empty lane
            for w1 in (rows[:, e:2 * e], stash[:, 1:2]):
                hit = ((w1 >> 19) & 0xFFF) == j
                hit &= (w1 >> 31) == 0
                w1[hit] = (w1[hit] & ~np.uint32(0xFFF << 19)) | np.uint32(
                    (kg + 5) << 19)
        else:  # the wide value: j << 16 | proxy
            for v in (rows[:, 2 * e:3 * e], stash[:, 2:3]):
                hit = (v >> 16) == j
                v[hit] = (v[hit] & 0xFFFF) | np.uint32((kg + 5) << 16)
        up[rows_f], up[stash_f] = rows, stash
    return dataclasses.replace(policy, **up)


def _hot_world():
    """The storm world with a second L4 flow's slot put past kg
    (_slot_past_kg) and a hot-cell batch of 256 flows (_hot_cells) that
    carries 16 copies of that flow."""
    key = ("hot",)
    if key in _CACHE:
        return _CACHE[key]
    jt, mk = _world("storm")
    rng = np.random.default_rng(400)
    t = mk(rng, 256)
    tev = tdm.make_failover_datapath_evaluator(
        tmesh.make_mesh(8, 1, device="cpu"), _port(jt))
    v = tev(tpart.replicate_datapath_leaves(_port(jt), 1), _pflows(t),
            np.ones((8, 1), bool), None)[0]
    kinds = v.match_kind.numpy()
    slots = v.l4_slot.numpy()
    n_eps, _, kg = np.asarray(jt.policy.l4_meta).shape
    hot = _hot_cells(t, kinds, n_eps, rng)
    l4 = np.nonzero((kinds == 1) | (kinds == 3))[0]
    hot4 = int(slots[l4[0]])
    other = next(int(i) for i in l4 if 0 < slots[i] != hot4)
    for k in hot:  # 16 rows of the flow whose slot the tables move
        hot[k][16:32] = np.asarray(t[k])[other]
    jt = dataclasses.replace(jt, policy=_slot_past_kg(jt.policy,
                                                      int(slots[other]), kg))
    _CACHE[key] = (jt, hot, kg)
    return _CACHE[key]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_combine_hot_cells_match_jax(tp):
    """DP_MESH_COMBINE's counting edges through the per-flow evaluator
    against the reference's (_hot_world): most flows on one (ep, dir,
    slot) cell and a fifth on one L3 cell, ep and direction words past
    their range, slots past kg, and holes in `valid`; every column,
    both counter buffers, the replica count and the telemetry equal."""
    _need_jax()
    jt, t, kg = _hot_world()
    dp = 8 // tp
    valid = np.ones(256, bool)
    valid[::7] = False
    alive = np.ones((dp, tp), bool)
    jout = _jev("storm", tp)(_jplace(jt, _jmesh(tp), tp), _jflows(t), alive,
                             valid)
    tev = tdm.make_failover_datapath_evaluator(
        tmesh.make_mesh(dp, tp, device="cpu"), _port(jt),
        collect_telemetry=True)
    tout = tev(tpart.replicate_datapath_leaves(_port(jt), tp), _pflows(t),
               alive, torch.from_numpy(valid))
    _same_out(tout, jout, f"hot tp={tp}")
    l4, l3 = _u32(tout[1]), _u32(tout[2])
    assert l4.max() >= 100 and l3.max() >= 30, (l4.max(), l3.max())
    assert (tout[0].l4_slot.numpy() >= kg).any()


def test_evaluator_refuses_other_geometry():
    _need_jax()
    jt, _ = _world("storm")
    tt = _port(jt)
    tm = tmesh.make_mesh(4, 2, device="cpu")
    tev = tdm.make_failover_datapath_evaluator(tm, tt)
    small = dataclasses.replace(tt, policy=dataclasses.replace(
        tt.policy, l4_hash_rows=np.asarray(tt.policy.l4_hash_rows)[:16]))
    flows = _pflows(_world("storm")[1](np.random.default_rng(1), 8))
    with pytest.raises(ValueError, match="another table geometry"):
        tev(tpart.replicate_datapath_leaves(small, 2), flows,
            np.ones((4, 2), bool))
    # an epoch placed on another mesh's layout
    other = tdm.make_failover_datapath_evaluator(
        tmesh.make_mesh(2, 4, device="cpu"), tt)
    md = tdm.place_datapath(tpart.replicate_datapath_leaves(tt, 4),
                            other.shardings)
    with pytest.raises(ValueError, match="the evaluator takes"):
        tev(md, flows, np.ones((4, 2), bool))


# -- the store ----------------------------------------------------------------


def _churn(jt, parts, rng, step):
    """One CT write-back step and one ipcache upsert on the storm world's
    host state (the reference test's churn); returns the new JAX
    tables."""
    storm = chaos_storm()
    t = storm._fused_flows(rng, 128, parts)
    ref, _, _ = jdp.datapath_step_with_counters(jt, _jflows(t))
    jdp.apply_ct_writeback_host(
        parts["ct"], np.asarray(ref.ct_create), np.asarray(ref.ct_delete),
        np.asarray(ref.final_daddr), np.asarray(ref.final_dport),
        t["saddr"], t["sport"], t["proto"], t["direction"],
        np.asarray(ref.rev_nat), np.asarray(ref.lb_slave), now=step + 1,
        orig_daddr=t["daddr"], orig_dport=t["dport"])
    parts["ipc_map"][f"10.66.0.{step + 1}/32"] = parts["ids"][
        step % len(parts["ids"])]
    return parts["build"]()


def _resident_equal(store, jaug, tp):
    """Every coordinate's block of every leaf equals the augmented host
    tables."""
    dev = store.current()
    sh = dev.shardings
    for fam, name, leaf in tdm._table_leaves(jaug):
        full = np.asarray(leaf)
        if full.ndim == 0:
            continue
        s = getattr(getattr(sh, fam), name)
        for coord in dev.mesh.coords():
            block = getattr(getattr(dev.shard(*coord), fam), name)
            want = full[s.slices(full.shape, coord)]
            got = block.numpy()
            if want.dtype == np.uint32:
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=f"{fam}.{name} {coord}")


def test_datapath_store_matches_jax():
    """Full, then three churn steps on the row-diff delta (bytes below a
    tenth of a full upload, equal to the reference's), the resident
    blocks equal to the augmented host tables, repair_chip's bytes."""
    _need_jax()
    tp = 2
    jt, parts = chaos_storm()._fused_world(23, n_ids=32)
    jm = _jmesh(tp)
    tm = tmesh.make_mesh(4, tp, device="cpu")
    jstore = jdm.DatapathStore(jm)
    tstore = tdm.DatapathStore(tm)
    rng = np.random.default_rng(23)
    for step in range(5):
        if step >= 2:
            jt = _churn(jt, parts, rng, step)
        _, js = jstore.publish(jt)
        _, ts = tstore.publish(_port(jt))
        assert (ts.mode, ts.bytes_h2d, ts.scattered_rows,
                ts.replaced_leaves) == (js.mode, js.bytes_h2d,
                                        js.scattered_rows,
                                        js.replaced_leaves), step
        assert ts.mode == ("full" if step < 2 else "delta")
        if step >= 2:
            assert ts.bytes_h2d < tstore.full_bytes() / 10
    assert tstore.full_bytes() == jstore.full_bytes()
    jaug = jpart.replicate_datapath_leaves(jt, tp)
    _resident_equal(tstore, _port(jaug), tp)
    for col in range(tp):
        assert tstore.repair_chip(col) == jstore.repair_chip(col)
    _resident_equal(tstore, _port(jaug), tp)
    chip = tstore.chip_bytes()
    assert sorted(chip) == list(range(8)) and min(chip.values()) > 0


def test_datapath_store_scoped_and_record_less_publishes_match_jax():
    """Change records scope the diff (the rows named, True re-places a
    leaf); a record-less publish in between falls back to the full row
    diff; a repair after poisoning restores a column."""
    _need_jax()
    tp = 4
    jt, parts = chaos_storm()._fused_world(29, n_ids=32)
    jm = _jmesh(tp)
    tm = tmesh.make_mesh(2, tp, device="cpu")
    jstore = jdm.DatapathStore(jm)
    tstore = tdm.DatapathStore(tm)
    for _ in range(2):
        jstore.publish(jt)
        tstore.publish(_port(jt))
    rng = np.random.default_rng(29)

    def ct_record(old, new):
        a, b = np.asarray(old.ct.buckets), np.asarray(new.ct.buckets)
        return np.flatnonzero(np.any(a != b, axis=1))

    modes = []
    for step in range(5):
        new = _churn(jt, parts, rng, step)
        rec = {"ct": {"buckets": ct_record(jt, new), "stash": True},
               "ipcache": {"buckets": True, "stash": True}}
        if step == 2:
            rec = None  # no warranty: the full row diff
        jt = new
        _, js = jstore.publish(new, changes=rec)
        _, ts = tstore.publish(_port(new), changes=rec)
        assert (ts.mode, ts.bytes_h2d, ts.scattered_rows,
                ts.replaced_leaves) == (js.mode, js.bytes_h2d,
                                        js.scattered_rows,
                                        js.replaced_leaves), step
        modes.append(ts.mode)
    assert modes == ["delta", "delta-scoped", "delta", "delta",
                     "delta-scoped"], modes
    jaug = jpart.replicate_datapath_leaves(jt, tp)
    _resident_equal(tstore, _port(jaug), tp)
    # poison column 2's blocks of the live epoch, repair them back
    dev = tstore.current()
    for coord in dev.mesh.coords():
        if coord[1] == 2:
            dev.shard(*coord).ct.buckets.fill_(-1)
    assert tstore.repair_chip(2) == jstore.repair_chip(2)
    _resident_equal(tstore, _port(jaug), tp)


# -- the router -------------------------------------------------------------------


def _host_fold(pkg, dt):
    """A terminal fold: the single-device step on the host tables, its
    columns as numpy."""
    if pkg == "jax":
        def fold(*cols):
            names = tdp.FLOW_COLUMNS
            v = jdp.datapath_step(dt, _jflows(dict(zip(names, cols))))
            return jdp.DatapathVerdicts(**{
                c: np.asarray(getattr(v, c)) for c in tdp.VERDICT_COLUMNS})
        return fold

    tables = convert.tables_to(_port(dt), "cpu")

    def tfold(*cols):
        t = dict(zip(tdp.FLOW_COLUMNS, cols))
        v = tdp.datapath_step(tables, tdp.flow_batch_from_packed(
            _pflows(t)))
        out = {}
        for c in tdp.VERDICT_COLUMNS:
            a = getattr(v, c).numpy()
            out[c] = a.view(np.uint32) if c in tdp.U32_COLUMNS else a
        return tdp.DatapathVerdicts(**out)
    return tfold


class Routers:
    """Both routers over the same fused world, breakers on one clock."""

    def __init__(self, seed=31, tp=4, folds=True):
        jt, parts = chaos_storm()._fused_world(seed, n_ids=32)
        self.jt, self.parts = jt, parts
        self.tp, self.dp = tp, 8 // tp
        self.clock = Clock()
        kw = dict(recovery_timeout=1.0, failure_threshold=1,
                  clock=self.clock)
        self.jbank, self.tbank = JBank(**kw), ChipBreakerBank(**kw)
        self.jr = jfo.ChipFailoverRouter(_jmesh(tp), jt.policy,
                                         bank=self.jbank,
                                         collect_telemetry=True)
        self.tr = tfo.ChipFailoverRouter(
            tmesh.make_mesh(self.dp, tp, device="cpu"), _port(jt).policy,
            bank=self.tbank, collect_telemetry=True)
        self.jr.attach_datapath(jt, host_fold=_host_fold("jax", jt)
                                if folds else None)
        self.tr.attach_datapath(_port(jt), host_fold=_host_fold("port", jt)
                                if folds else None)
        self.rng = np.random.default_rng(seed)
        self.flows = chaos_storm()._fused_flows(self.rng, 200, parts)

    def publish(self, jt):
        self.jt = jt
        _, js = self.jr.publish_datapath(jt)
        _, ts = self.tr.publish_datapath(_port(jt))
        assert (ts.mode, ts.bytes_h2d) == (js.mode, js.bytes_h2d)

    def dispatch(self, tag, degraded=False):
        jres = self.jr.dispatch_flows(**self.flows)
        tres = self.tr.dispatch_flows(**self.flows)
        _same_columns(tres.verdicts, jres.verdicts, tag)
        want, _, _ = jdp.datapath_step_with_counters(self.jt,
                                                     _jflows(self.flows))
        _same_columns(tres.verdicts, want, f"{tag} vs single device")
        for f in ("l4_counts", "l3_counts", "telemetry", "alive"):
            a, b = getattr(tres, f), getattr(jres, f)
            assert (a is None) == (b is None), (tag, f)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b),
                                              err_msg=f"{tag} {f}")
        for f in ("replica_hits", "rerouted", "degraded", "rebalanced_chips",
                  "rebalance_bytes"):
            assert getattr(tres, f) == getattr(jres, f), (tag, f)
        assert tres.degraded == degraded, tag
        for f in dataclasses.fields(self.tr.stats):
            if f.name != "last_rebalance_ms":
                assert getattr(self.tr.stats, f.name) == getattr(
                    self.jr.stats, f.name), (tag, f.name)
        assert self.tr.chip_states() == self.jr.chip_states(), tag
        return tres

    def arm(self, spec):
        tfi.arm("engine.dispatch", spec)
        jfi.arm("engine.dispatch", spec)


def test_router_dispatch_flows_matches_jax():
    """Healthy; a chip killed through the fault seam (replicas serve, no
    host fold); its backup dead too (the row re-splits); a publish while
    the chips are out, then readmission with the datapath repair (bytes
    below a full upload, equal to the reference's)."""
    _need_jax()
    r = Routers()
    healthy = r.dispatch("healthy")
    assert healthy.replica_hits == 0 and not healthy.rerouted
    victim = int(r.tr.ordinals[0, 1])
    r.arm(f"raise:chip={victim}")
    killed = r.dispatch("killed")
    assert killed.replica_hits > 0 and not killed.degraded
    assert victim in r.tr._dp_out
    backup = int(r.tr.ordinals[0, 2])
    for bank in (r.jbank, r.tbank):
        bank.record_failure(backup, "test kill")
    split = r.dispatch("re-split")
    assert split.rerouted and not split.degraded
    r.publish(_churn(r.jt, r.parts, r.rng, 0))
    tfi.disarm("engine.dispatch")
    jfi.disarm("engine.dispatch")
    for bank in (r.jbank, r.tbank):
        bank.breaker(backup).reset()
    r.clock.now += 2.0
    back = r.dispatch("readmitted")
    assert victim in back.rebalanced_chips and back.rebalance_bytes > 0
    assert not r.tr._dp_out and r.tbank.state(victim) == "closed"
    again = r.dispatch("steady")
    assert again.replica_hits == 0


@pytest.mark.parametrize("folds", [True, False])
def test_router_terminal_flow_fold(folds):
    """Every chip out: the host datapath fold serves the batch, or
    without one the dispatch raises, in both packages."""
    _need_jax()
    r = Routers(seed=37, folds=folds)
    for o in range(8):
        for bank in (r.jbank, r.tbank):
            bank.record_failure(o, "outage")
    if folds:
        res = r.dispatch("terminal", degraded=True)
        assert r.tr.stats.degraded_batches == 1
        assert res.l4_counts is None
    else:
        with pytest.raises(RuntimeError, match="no host datapath fold"):
            r.jr.dispatch_flows(**r.flows)
        with pytest.raises(RuntimeError, match="no host datapath fold"):
            r.tr.dispatch_flows(**r.flows)


def test_dispatch_flows_empty_batch_and_unattached():
    _need_jax()
    r = Routers(seed=41)
    empty = {k: np.asarray(v)[:0] for k, v in r.flows.items()}
    tres = r.tr.dispatch_flows(**empty)
    jres = r.jr.dispatch_flows(**empty)
    _same_columns(tres.verdicts, jres.verdicts, "empty")
    assert r.tr.stats.batches == r.jr.stats.batches == 0
    bare = tfo.ChipFailoverRouter(tmesh.make_mesh(2, 4, device="cpu"),
                                  _port(r.jt).policy)
    with pytest.raises(RuntimeError, match="attach_datapath"):
        bare.dispatch_flows(**r.flows)
    with pytest.raises(RuntimeError, match="attach_datapath"):
        bare.publish_datapath(_port(r.jt))


def _kernel_failure(*a, **kw):
    raise tkern.KernelError("dp_mesh_probe launch failed: CUDA error 700")


@pytest.mark.parametrize("where", ["dispatch", "repair"])
def test_kernel_error_propagates_without_blame(where):
    """A kernel that fails to build or launch, in the fused evaluator or
    in the datapath repair at readmission, is no dead chip: the error
    propagates, no breaker opens, nothing is folded, and a half-open
    chip's probe slot comes back (the port alone: the reference folds on
    any launch error)."""
    _need_jax()
    r = Routers(seed=43)
    victim = int(r.tr.ordinals[1, 1])
    r.tbank.record_failure(victim, "test kill")
    assert victim in r.tr._dp_out
    if where == "dispatch":
        r.tr._dp_ev = _kernel_failure
    else:
        r.tr.dp_store.repair_chip = _kernel_failure
    r.clock.now += 2.0
    with pytest.raises(tkern.KernelError):
        r.tr.dispatch_flows(**r.flows)
    assert r.tr.stats.degraded_batches == 0
    assert r.tbank.open_chips() == (victim,)
    assert r.tbank.snapshot()[victim]["half_open_inflight"] == 0
    if where == "repair":
        assert victim in r.tr._dp_out


# -- the kernels on the card -------------------------------------------------------


def _card_world():
    from cilium_tpu_torch import world

    w = world.make_world(seed=3, n_rules=400, n_endpoints=4,
                         n_identities=512, n_cidr_blocks=16, n_vips=4,
                         n_pool=3000, ct_max_entries=4096, identity_pad=256,
                         filter_pad=16)
    return w, world.headline_tables(w)


def _hot_cells_on_card(w, host, dp, tp):
    """The per-flow evaluator on a CUDA mesh against the same on a CPU
    mesh on a hot-cell batch (_hot_cells) of dp x 1027 flows, an odd
    batch row, with holes in `valid`, healthy; every output equal."""
    rng = np.random.default_rng(dp)
    t = _pair_cols(w.pairs(seed=9, half=dp * 1027 // 2, k=1)[0])
    b = len(t["saddr"])
    aug = tpart.replicate_datapath_leaves(host, tp)
    alive = np.ones((dp, tp), bool)
    cpu = tmesh.make_mesh(dp, tp, device="cpu")
    ev = tdm.make_failover_datapath_evaluator(cpu, host)
    kinds = ev(tdm.place_datapath(aug, ev.shardings), _pflows(t), alive,
               None)[0].match_kind.numpy()
    hot = _pflows(_hot_cells(t, kinds, int(host.policy.l4_meta.shape[0]),
                             rng))
    valid = torch.arange(b) % 7 != 0
    outs = []
    for dev in ("cuda", "cpu"):
        m = tmesh.make_mesh(dp, tp, device=dev)
        ev = tdm.make_failover_datapath_evaluator(m, host,
                                                  collect_telemetry=True)
        outs.append(ev(tdm.place_datapath(aug, ev.shardings), hot.to(dev),
                       alive, valid.to(dev)))
    torch.cuda.synchronize()
    got, want = outs
    for c in tdp.VERDICT_COLUMNS:
        assert torch.equal(getattr(got[0], c).cpu(), getattr(want[0], c)), c
    for a, b_ in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b_)
    assert _u32(want[1]).max() >= b // 4


@pytest.mark.cuda
@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2)])
def test_dp_mesh_kernels_match_plain_on_card(dp, tp):
    """Both evaluators on a CUDA mesh (DP_MESH_PROBE, DP_MESH_COMBINE)
    against the same evaluators on a CPU mesh (the plain versions),
    healthy and with a chip dead, and the per-flow evaluator on a
    hot-cell batch of odd rows with holes in `valid` (_hot_cells_on_card)
    on this mesh and on (dp x tp, 1); every output equal."""
    _need_card()
    w, host = _card_world()
    words = _pflows(_pair_cols(w.pairs(seed=7, half=2048, k=1)[0]))
    pair = torch.from_numpy(w.pairs(seed=8, half=2048, k=1)[0].view(np.int32))
    aug = tpart.replicate_datapath_leaves(host, tp)
    before = (tkern.DP_MESH_PROBE.launches, tkern.DP_MESH_COMBINE.launches)
    for dead in (False, True):
        alive = np.ones((dp, tp), bool)
        if dead:
            alive[0, 1] = False
        valid = torch.arange(4096) % 9 != 0
        outs = []
        for dev in ("cuda", "cpu"):
            m = tmesh.make_mesh(dp, tp, device=dev)
            ev = tdm.make_failover_datapath_evaluator(m, host,
                                                      collect_telemetry=True)
            pev = tdm.make_failover_datapath_pair_evaluator(m, host)
            md = tdm.place_datapath(aug, ev.shardings)
            outs.append((ev(md, words.to(dev), alive, valid.to(dev)),
                         pev(md, pair.to(dev), alive, None)))
        torch.cuda.synchronize()
        for got, want in zip(outs[0], outs[1]):
            n_v = 2 if len(got) == 6 else 1
            for k in range(n_v):
                for c in tdp.VERDICT_COLUMNS:
                    assert torch.equal(getattr(got[k], c).cpu(),
                                       getattr(want[k], c)), (dead, c)
            for a, b in zip(got[n_v:], want[n_v:]):
                assert torch.equal(a.cpu(), b), dead
    # a hot-cell batch of odd rows, on this mesh and on one of tp = 1
    _hot_cells_on_card(w, host, dp, tp)
    _hot_cells_on_card(w, host, dp * tp, 1)
    assert tkern.DP_MESH_PROBE.launches > before[0]
    assert tkern.DP_MESH_COMBINE.launches > before[1]


@pytest.mark.cuda
def test_dp_mesh_probe_refuses_bad_inputs_on_card():
    _need_card()
    w, host = _card_world()
    m = tmesh.make_mesh(2, 2)
    ev = tdm.make_failover_datapath_evaluator(m, host)
    md = tdm.place_datapath(tpart.replicate_datapath_leaves(host, 2),
                            ev.shardings)
    flows = torch.zeros((8, 64), dtype=torch.int32, device="cuda")
    alive = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="previous round"):
        tkern.DP_MESH_PROBE(1, md.shard(0, 0), flows, 0, None, alive, 0,
                            ev.geom)
    with pytest.raises(ValueError, match="flows must be"):
        tkern.DP_MESH_PROBE(0, md.shard(0, 0), flows[:4], 0, None, alive, 0,
                            ev.geom)
