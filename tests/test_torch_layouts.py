"""The fused IPv4 datapath over the table layouts the agent's builders
pick past their thresholds, the port against the JAX package on the
CPU, with tolerance 0 (every value is an integer).  Small worlds that
each cross one threshold, and one that crosses all of them:

  eps36      36 endpoints (more than 32): the idx ipcache without L3
             planes, probe 2 from l3_allow_bits;
  pf141      141 prefilter CIDRs (more than 128): DIR-24-8 prefilter;
  lb50       one VIP with 50 backends (more than 40): the classic LB;
  plens7     CIDR blocks over 5 more prefix lengths (7 in all, more than
             4): the [B, P] range scan, with L3 planes;
  ranges523  520 /24 CIDR blocks (523 ranges, more than 512): a
             DIR-24-8 ipcache, the generic identity branch;
  node       all of them together (world.node_world at a small size);
  pf141eps36, lb50eps36, pf141lb50, pf141r523, lb50r523, pf141lb50r523
             two or three of them together: with the worlds above, each
             of the datapath kernels' 12 layout instantiations.

Builders leaf for leaf (both packages refuse a service past 64
backends); each plain stage function (prefilter_drop, lb_select_batch,
ipcache_lookup_fused, the generic lookup, _probes) against its JAX
function, with edge inputs; the pair step on every world from both
table sources (the port's builders, and the JAX leaves carried across
by tables_from_numpy); every single-batch form and replay() on the
node world.  The `cuda`-marked twins hold DATAPATH_PAIR, PERSISTENT_PAIR,
DATAPATH_STEP and the memoized pair against their plain versions on
every layout and replay()
on the card against the plain loop; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_layouts.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch import replay as trp
from cilium_tpu_torch.compiler.tables import split_hot
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import memo as tmemo
from cilium_tpu_torch.engine import verdict as tvd
from cilium_tpu_torch.ipcache import lpm as tlpm
from cilium_tpu_torch.lb import device as tlb
from cilium_tpu_torch.lb import service as tsvc
from cilium_tpu_torch.native.loader import encode_flow_records
from cilium_tpu_torch import prefilter as tpf

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu import prefilter as jpf
    from cilium_tpu import replay as jrp
    from cilium_tpu.engine import datapath as jdp
    from cilium_tpu.engine import verdict as jvd
    from cilium_tpu.ipcache import lpm as jlpm
    from cilium_tpu.lb import device as jlb
    from cilium_tpu.lb import service as jsvc
    from torch_parity import (
        assert_same_buffers,
        assert_same_leaves,
        assert_same_verdicts,
        convert_mgr,
        jax_host_tables,
        jax_leaves,
        jax_run_pairs,
        port_run_pairs,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

BASE = dict(n_rules=400, n_identities=512, n_vips=4, n_pool=3000,
            ct_max_entries=4096, identity_pad=256, filter_pad=16,
            n_endpoints=4, n_cidr_blocks=16)
WORLDS = {
    "eps36": dict(n_endpoints=36),
    "pf141": dict(n_blocklist=140),
    "lb50": dict(big_vip_backends=50),
    "plens7": dict(n_cidr_blocks=20, cidr_plens=(8, 12, 16, 20, 24)),
    "ranges523": dict(n_cidr_blocks=520),
    "node": dict(n_endpoints=40, n_cidr_blocks=30, n_blocklist=140,
                 big_vip_backends=50,
                 cidr_plens=(8, 12, 16, 20, 24, 28)),
    # the rest of the 12 layout instantiations
    "pf141eps36": dict(n_blocklist=140, n_endpoints=36),
    "lb50eps36": dict(big_vip_backends=50, n_endpoints=36),
    "pf141lb50": dict(n_blocklist=140, big_vip_backends=50),
    "pf141r523": dict(n_blocklist=140, n_cidr_blocks=520),
    "lb50r523": dict(big_vip_backends=50, n_cidr_blocks=520),
    "pf141lb50r523": dict(n_blocklist=140, big_vip_backends=50,
                          n_cidr_blocks=520),
}
# the layout each world's tables take: (prefilter, LB, ipcache), the
# ipcache as (L3 planes, range classes) or "dir24_8"
LAYOUTS = {
    "eps36": ("PrefilterRanges", "LBInline", (False, True)),
    "pf141": ("LPMTables", "LBInline", (True, True)),
    "lb50": ("PrefilterRanges", "LBTables", (True, True)),
    "plens7": ("PrefilterRanges", "LBInline", (True, False)),
    "ranges523": ("PrefilterRanges", "LBInline", "dir24_8"),
    "node": ("LPMTables", "LBTables", (False, False)),
    "pf141eps36": ("LPMTables", "LBInline", (False, True)),
    "lb50eps36": ("PrefilterRanges", "LBTables", (False, True)),
    "pf141lb50": ("LPMTables", "LBTables", (True, True)),
    "pf141r523": ("LPMTables", "LBInline", "dir24_8"),
    "lb50r523": ("PrefilterRanges", "LBTables", "dir24_8"),
    "pf141lb50r523": ("LPMTables", "LBTables", "dir24_8"),
}


def _layout_name(name):
    """The kernels' instantiation name (kernels.layout_name) of the
    layout LAYOUTS gives world `name`."""
    pf, lb, ipc = LAYOUTS[name]
    return "/".join((
        {"PrefilterRanges": "ranges", "LPMTables": "dir24_8"}[pf],
        {"LBInline": "inline", "LBTables": "classic"}[lb],
        "generic" if ipc == "dir24_8" else (
            "idx_planes" if ipc[0] else "idx")))

_CACHE = {}


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


def _world(name):
    key = ("world", name)
    if key not in _CACHE:
        _CACHE[key] = world.make_world(seed=5, **{**BASE, **WORLDS[name]})
    return _CACHE[key]


def _tables(name, subword=True):
    """(world, JAX tables, port-built tables on the host, the same on
    the CPU, the JAX leaves carried across), for the last two (world,
    layout) pairs asked for: a DIR-24-8 plane is 64 MB in each copy."""
    key = ("tables", name, subword)
    if key not in _CACHE:
        w = _world(name)
        jt = jax_host_tables(w, subword=subword)
        host = w.host_tables()
        if subword:
            host = tdp.subword_datapath_tables(host)
        held = [k for k in _CACHE if k[0] == "tables"]
        for old in held[:-1]:
            del _CACHE[old]
        _CACHE[key] = (w, jt, host, convert.tables_to(host, "cpu"),
                       convert.tables_from_numpy(jax_leaves(jt),
                                                 device="cpu"))
    return _CACHE[key]


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _as_i64(x):
    return np.asarray(x).astype(np.int64)


# -- builders ----------------------------------------------------------------------


def test_thresholds_match_reference():
    """Each builder switches at the reference's threshold: 128 prefilter
    CIDRs, 512 ranges, 4 prefix lengths, 32 endpoints, 40 backends
    (inline) and 64 (classic, which both packages refuse past)."""
    _need_jax()
    for n, form in ((128, tpf.PrefilterRanges), (129, tlpm.LPMTables)):
        cidrs = [f"100.{a // 256}.{a % 256}.0/24" for a in range(n)]
        got = tpf.build_prefilter(cidrs)
        assert isinstance(got, form)
        assert_same_leaves(got, jpf.build_prefilter(cidrs))
    for n, form in ((512, tlpm.IPCacheDevice), (513, tlpm.LPMTables)):
        m = {f"100.{a // 256}.{a % 256}.0/24": 300 + a for a in range(n)}
        m["10.0.0.1/32"] = 7
        got = tlpm.build_ipcache(m)
        assert isinstance(got, form)
        assert_same_leaves(got, jlpm.build_ipcache(m))
    for plens, classes in (((8, 12, 16, 24), True), ((8, 12, 16, 20, 24),
                                                     False)):
        m = {f"{20 + k}.0.0.0/{p}": 50 + k for k, p in enumerate(plens)}
        got = tlpm.build_ipcache(m)
        assert (got.range_rows is not None) == classes
        assert_same_leaves(got, jlpm.build_ipcache(m))
    for eps, planes in ((32, True), (33, False)):
        w = world.make_world(seed=3, **{**BASE, "n_endpoints": eps})
        host = w.host_tables()
        assert host.ipcache.l3_planes == planes
        assert_same_leaves(host, jax_host_tables(w, subword=False))
    for n, form in ((40, tlb.LBInline), (41, tlb.LBTables),
                    (64, tlb.LBTables)):
        mgr = tsvc.ServiceManager()
        mgr.upsert(tsvc.L3n4Addr("172.16.9.9", 80, 6), [
            tsvc.L3n4Addr(f"10.9.{j // 200}.{j % 200 + 1}", 8000 + j, 6)
            for j in range(n)])
        got = tlb.compile_lb(mgr)
        assert isinstance(got, form)
        assert_same_leaves(got, jlb.compile_lb(convert_mgr(mgr, jsvc)))
    mgr.upsert(tsvc.L3n4Addr("172.16.9.8", 80, 6), [
        tsvc.L3n4Addr(f"10.8.0.{j + 1}", 80, 6) for j in range(65)])
    with pytest.raises(ValueError, match="more than 64"):
        tlb.compile_lb(mgr)
    with pytest.raises(ValueError, match="more than 64"):
        jlb.compile_lb(convert_mgr(mgr, jsvc))


# -- each plain stage against its JAX function ------------------------------------


def test_prefilter_drop_matches_jax():
    _need_jax()
    rng = np.random.default_rng(1)
    for name in ("eps36", "node"):
        w, jt, host, _, _ = _tables(name, False)
        ips = np.concatenate([w.pool["saddr"], _u32(rng, 4000)])
        got = tpf.prefilter_drop(convert.tables_to(host, "cpu").prefilter,
                                 torch.from_numpy(ips.view(np.int32)))
        want = jpf.prefilter_drop(jt.prefilter, jnp.asarray(ips))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


def _lb_inputs(w, rng, n=3000):
    vips = [s.frontend.ip_u32() for s in w.mgr.by_frontend.values()]
    daddr = np.where(rng.random(n) < 0.7, rng.choice(vips, n),
                     _u32(rng, n)).astype(np.uint32)
    dport = np.where(rng.random(n) < 0.9, 80, rng.integers(0, 65536, n))
    # CT slaves: none, within the count, past it, negative
    ct_slave = rng.choice([0, 1, 2, 3, 40, 41, 50, 63, 64, 65, 99, -1,
                           -7], n)
    return dict(saddr=_u32(rng, n), daddr=daddr,
                sport=rng.integers(0, 65536, n), dport=dport,
                proto=np.where(rng.random(n) < 0.9, 6, 17),
                ct_slave=ct_slave)


def _lb_both(jtab, ttab, inp):
    j_in = {k: jnp.asarray(v.astype(np.uint32 if k in ("saddr", "daddr")
                                    else np.int32))
            for k, v in inp.items()}
    t_in = {k: torch.from_numpy(v.astype(np.int64)) for k, v in inp.items()}
    want = jlb.lb_select_batch(jtab, **j_in)
    got = tlb.lb_select_batch(ttab, **t_in)
    for g, wv, name in zip(got, want,
                           ("found", "slave", "daddr", "dport", "rev_nat")):
        np.testing.assert_array_equal(_as_i64(g.numpy()), _as_i64(wv),
                                      err_msg=name)
    return got


def test_lb_classic_select_matches_jax():
    """The classic select, CT stickiness at and past the count included,
    then on rows whose meta and backend-row words are out of range (a
    count past 64 backends, a row index past the table and negative as
    int32): the reference's clip and masked lane sums."""
    _need_jax()
    w, jt, host, _, _ = _tables("lb50", False)
    rng = np.random.default_rng(2)
    inp = _lb_inputs(w, rng)
    got = _lb_both(jt.lb, convert.tables_to(host, "cpu").lb, inp)
    assert got[0].sum() > 500 and (got[1] > 40).any()
    bad = dataclasses.replace(host.lb, buckets=host.lb.buckets.copy())
    p = tlb.SVC_PER_BUCKET
    for r, c in zip(*np.nonzero(bad.buckets[:, :p] != 0)):
        meta, row = bad.buckets[r, 2 * p + c], bad.buckets[r, 3 * p + c]
        bad.buckets[r, 2 * p + c] = (meta & 0xFFFF0000) | 100
        bad.buckets[r, 3 * p + c] = (0xFFFFFFF0, 1000, row)[c % 3]
    jbad = dataclasses.replace(jt.lb, buckets=bad.buckets.copy())
    got = _lb_both(jbad, convert.plane_to(bad, "cpu"), inp)
    assert (got[1] > 64).any()


@pytest.mark.parametrize("name,subword", [
    ("eps36", True),  # no planes, range classes, sub-word
    ("node", False),  # no planes, the scan, u32
    ("plens7", True),  # planes, the scan, sub-word
])
def test_ipcache_lookup_matches_jax(name, subword):
    _need_jax()
    w, jt, host, _, _ = _tables(name, subword)
    rng = np.random.default_rng(3)
    ips = np.concatenate([w.pool["saddr"], w.pool["daddr"], _u32(rng, 2000)])
    ing = rng.random(len(ips)) < 0.5
    dev = convert.tables_to(host, "cpu").ipcache
    if dev.l3_planes:
        want = jlpm.ipcache_lookup_fused(jt.ipcache, jnp.asarray(ips),
                                         ingress=jnp.asarray(ing))
    else:
        want = jlpm.ipcache_lookup_fused(jt.ipcache, jnp.asarray(ips))
    got = tlpm.ipcache_lookup_fused(dev, torch.from_numpy(ips.view(np.int32)),
                                    torch.from_numpy(ing))
    np.testing.assert_array_equal(got[0].numpy(), _as_i64(want[0]))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_array_equal(got[1].numpy(), _as_i64(want[1]))
    assert (got[0] == 0).any() and (got[0] != 0).sum() > len(ips) // 4


@pytest.mark.parametrize("form", ["dir24_8", "classes", "scan"])
def test_generic_lookup_matches_jax(form):
    """The generic form's lookup (the reference's _lookup_kernel): a
    DIR-24-8 ipcache, and raw-identity IPCacheDevices with range
    classes or the scan."""
    _need_jax()
    name = {"dir24_8": "ranges523", "classes": "eps36", "scan": "plens7"}[form]
    w = _world(name)
    rng = np.random.default_rng(4)
    ips = np.concatenate([w.pool["saddr"], w.pool["daddr"], _u32(rng, 2000)])
    jtab = jlpm.build_ipcache(w.ipc_map)
    ttab = convert.plane_to(tlpm.build_ipcache(w.ipc_map), "cpu")
    got = tlpm.lookup_plain(ttab, torch.from_numpy(ips.view(np.int32)))
    want = jlpm._lookup_kernel(jtab, jnp.asarray(ips))
    np.testing.assert_array_equal(got.numpy(), _as_i64(want))
    assert (got == 0).any() and (got != 0).any()


def test_probes_match_jax_on_both_paths():
    """_probes with idx_known = (idx, known) and no L3 bit (the
    l3_allow_bits read) and with raw identities (_index_identity), over
    edge endpoints (at and past E, negative) and directions (2, 255,
    -1)."""
    _need_jax()
    w, jt, host, _, _ = _tables("eps36", False)
    pol_t = convert.tables_to(host, "cpu").policy
    rng = np.random.default_rng(5)
    n = 4000
    ids = np.asarray(w.identity_ids, np.uint32)
    ident = np.where(rng.random(n) < 0.9, rng.choice(ids, n),
                     _u32(rng, n)).astype(np.uint32)
    ep = rng.choice([0, 1, 5, 35, 36, 40, -1, -36], n).astype(np.int32)
    d = rng.choice([0, 1, 0, 1, 2, 255, -1], n).astype(np.int32)
    dport = rng.integers(0, 70000, n).astype(np.int32)
    proto = rng.choice([6, 17, 300], n).astype(np.int32)
    frag = np.zeros(n, bool)
    jb = jvd.TupleBatch(jnp.asarray(ep), jnp.asarray(ident),
                        jnp.asarray(dport), jnp.asarray(proto),
                        jnp.asarray(d), jnp.asarray(frag))
    t = [torch.from_numpy(a.astype(np.int64)) for a in (ep, d, dport, proto)]
    # jitted, as inside the datapath: XLA gathers wrap and clamp
    probes = jax.jit(lambda pol, b, ik: jvd._probes(pol, b, idx_known=ik))
    want = probes(jt.policy, jb, None)
    got = tvd._probes(pol_t, *t, identity=torch.from_numpy(
        ident.astype(np.int64)))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(_as_i64(g.numpy()), _as_i64(wv))
    idx, known = want[5], jnp.asarray(rng.random(n) < 0.8)
    want = probes(jt.policy, jb, (idx, known))
    got = tvd._probes(pol_t, *t, idx_known=(
        torch.from_numpy(_as_i64(idx)), torch.from_numpy(np.array(known))))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(_as_i64(g.numpy()), _as_i64(wv))
    assert np.asarray(want[1]).any()


# -- the datapath ----------------------------------------------------------------


def _edge_flows(w) -> np.ndarray:
    """Every pool flow, then 96 of them again: 32 with direction 2, 32
    with 255, 16 with an endpoint past the axis and 16 with endpoint
    0xFFFFFFFF (-1 as int32); [8, B] u32."""
    packed = trp.pack_flow_pool(w.pool)
    more = packed[:, :96].copy()
    d = tdp.FLOW_COLUMNS.index("direction")
    e = tdp.FLOW_COLUMNS.index("ep_index")
    more[d, :32] = 2
    more[d, 32:64] = 255
    more[e, 64:80] = 77
    more[e, 80:96] = 0xFFFFFFFF
    return np.concatenate([packed, more], axis=1)


def _records(w, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(w.pool["saddr"]), n)
    pool = {c: w.pool[c][rows] for c in tdp.FLOW_COLUMNS}
    buf = encode_flow_records(
        ep_id=pool["ep_index"].astype(np.int64) + 100,
        identity=np.zeros(n, np.uint32),
        **{c: pool[c] for c in tdp.FLOW_COLUMNS if c != "ep_index"})
    return buf, {100 + e: e for e in range(w.meta["endpoints"])}


_FORMS = ("datapath_step_accum", "datapath_step_accum_ingress",
          "datapath_step_accum_egress")
_REPLAY_FIELDS = ("total", "allowed", "denied", "redirected", "batches")


# the worlds whose tables also run every single-batch form: the node
# world crosses every threshold, ranges523 takes the generic branch
FULL = ("node", "ranges523")


def _datapath_outputs(mod, ver, tables, w, pack, replay_kw, forms):
    """The pair step (uniform and Zipf pairs, carries threaded), with
    `forms` every single-batch form over the edge flows, and replay() of
    600 records with counters and telemetry, through one package's entry
    points (mod: engine.datapath, ver: engine.verdict, pack: the flow
    splitter of that package)."""
    out = {}
    pairs = w.pairs(seed=11, half=256, k=1) + w.pairs(seed=12, half=256, k=1,
                                                      zipf=1.2)
    out["pairs"] = (jax_run_pairs if mod is jdp else port_run_pairs)(
        tables, pairs)
    if forms:
        flows = pack(_edge_flows(w))
        out["step"] = (mod.datapath_step(tables, flows),)
        out["with_counters"] = mod.datapath_step_with_counters(tables, flows)
        for name in _FORMS:
            out[name] = getattr(mod, name)(
                tables, flows, ver.make_counter_buffers(tables.policy) + 3)
        out["telem"] = mod.datapath_step_telem(tables, flows)
        tel0 = (jvd.make_telemetry_buffers() if mod is jdp
                else tvd.make_telemetry_buffers("cpu"))
        out["accum_telem"] = mod.datapath_step_accum_telem(
            tables, flows, ver.make_counter_buffers(tables.policy), tel0 + 5)
    buf, ep_map = _records(w, 600, 9)
    out["replay"] = (jrp if mod is jdp else trp).replay(
        tables, buf, batch_size=256, ep_map=ep_map, collect_telemetry=True,
        **replay_kw)
    return out


def _u32_of(x):
    return (x.numpy().view(np.uint32) if isinstance(x, torch.Tensor)
            else np.asarray(x))


# the worlds whose test_datapath_matches_jax case runs in
# tests/test_torch_layouts_mixed.py, so that --dist loadfile gives the
# two halves of the cases to two workers
MIXED = ("ranges523", "pf141eps36", "lb50eps36", "pf141lb50", "pf141r523",
         "lb50r523", "pf141lb50r523")


@pytest.mark.parametrize("name", sorted(set(WORLDS) - set(MIXED)))
def test_datapath_matches_jax(name):
    """Each world's tables take the reference's layouts, leaf for leaf,
    wide and sub-word; then on the sub-word tables, port-built and
    carried across: the pair step, replay()
    and, on the FULL worlds, every single-batch form, column for column,
    with the counters and the telemetry exact."""
    check_datapath_matches_jax(name)


def check_datapath_matches_jax(name):
    """test_datapath_matches_jax's case for world `name`."""
    _need_jax()
    forms = name in FULL
    for subword in (False, True):
        w, jt, host, port, carried = _tables(name, subword)
        assert_same_leaves(host, jt)
        pf, lb, ipc = LAYOUTS[name]
        assert type(host.prefilter).__name__ == pf
        assert type(host.lb).__name__ == lb
        if ipc == "dir24_8":
            assert isinstance(host.ipcache, tlpm.LPMTables)
        else:
            assert host.ipcache.values_are_idx
            assert (host.ipcache.l3_planes,
                    host.ipcache.range_rows is not None) == ipc
            assert bool(host.ipcache.bucket_entries) == subword
        if not subword:
            continue
        want = _datapath_outputs(
            jdp, jvd, jt, w,
            lambda p: jdp.flow_batch_from_packed(jnp.asarray(p)), {}, forms)
        for tt in (port, carried):
            got = _datapath_outputs(
                tdp, tvd, tt, w,
                lambda p: tdp.flow_batch_from_packed(
                    torch.from_numpy(p.view(np.int32))), {"device": "cpu"},
                forms)
            _assert_same_outputs(got, want, name)


def _assert_same_outputs(got, want, name):
    (j_outs, jacc, jtel), (t_outs, acc, tel) = want["pairs"], got["pairs"]
    for (ji, je), (ti, te) in zip(j_outs, t_outs):
        assert_same_verdicts(ti, ji, f"{name} pair ingress")
        assert_same_verdicts(te, je, f"{name} pair egress")
    assert_same_buffers(acc, tel, jacc, jtel)
    for form in got.keys() - {"pairs", "replay"}:
        (t0, *tb), (j0, *jb) = got[form], want[form]
        assert_same_verdicts(t0, j0, f"{name} {form}")
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(_u32_of(a), _u32_of(b),
                                          err_msg=f"{name} {form}")
    (ts, tl4, tl3), (js, jl4, jl3) = got["replay"], want["replay"]
    for f in _REPLAY_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(tl4, jl4)
    np.testing.assert_array_equal(tl3, jl3)
    np.testing.assert_array_equal(ts.telemetry, js.telemetry)
    assert ts.batches == 3 and 0 < ts.allowed < 600
    assert tel.numpy()[:, 18].sum() > 0  # ipcache misses


def test_worlds_take_every_layout_instantiation():
    """The worlds' layouts (held by test_datapath_matches_jax) are the
    12 instantiations of the datapath kernels, so the card test below
    runs each of them; and on the CPU tables of a few worlds
    kernels.datapath_layout names the instantiation LAYOUTS gives."""
    from cilium_tpu_torch import kernels

    assert ({_layout_name(n) for n in WORLDS}
            == {kernels.layout_name(i) for i in range(12)})
    for name in ("pf141eps36", "lb50r523"):
        host = tdp.subword_datapath_tables(_world(name).host_tables())
        tables = convert.tables_to(host, "cpu")
        assert (kernels.datapath_layout(tables).split("+")[0]
                == _layout_name(name))


# -- on the card -----------------------------------------------------------------


def _card_cases():
    for name in sorted(WORLDS):
        for subword in (False, True):
            yield name, subword


@pytest.mark.cuda
@pytest.mark.parametrize("name,subword", list(_card_cases()))
def test_kernels_match_plain_on_every_layout(name, subword):
    """DATAPATH_PAIR over two pairs, PERSISTENT_PAIR over four of 4,999
    flows a half and DATAPATH_STEP in each form over the edge flows, as
    a pack and picked from them as a pool (the row-major copy passed in
    or made by the wrapper; picks at the last row, past it and with bit
    31 set), and the memoized pair (DATAPATH_PAIR_MEMO's front and back
    passes with MEMO_DEDUP and MEMO_CACHE) on a uniform pair cold and
    warm, a Zipf pair and the Zipf pair at a capacity it overflows, on
    the card, against the plain versions on the same device inputs:
    columns, counters, telemetry (and the memo's rows, hit flags and
    stats)."""
    _need_card()
    from cilium_tpu_torch import kernels

    w = _world(name)
    host = w.host_tables()
    if subword:
        host = tdp.subword_datapath_tables(host)
    host.policy = split_hot(host.policy)
    tt = convert.tables_to(host, "cuda")
    assert kernels.datapath_layout(tt).split("+")[0] == _layout_name(name)
    acc_k = tvd.make_counter_buffers(tt.policy)
    tel_k = tvd.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    for p in w.pairs(seed=9, half=5000, k=2):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        ki, ke, acc_k, tel_k = kernels.DATAPATH_PAIR(tt, pt, acc_k, tel_k)
        pi, pe, acc_p, tel_p = tdp.datapath_pair_plain(tt, pt, acc_p, tel_p)
        for got, want in ((ki, pi), (ke, pe)):
            for col in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), col
    assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p)
    # PERSISTENT_PAIR at K = 4 on 4,999 flows a half (not a multiple of
    # a block's 256)
    stacked = torch.from_numpy(np.stack(w.pairs(seed=10, half=4999, k=4))
                               .view(np.int32)).cuda()
    acc_k = tvd.make_counter_buffers(tt.policy)
    tel_k = tvd.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    ki, ke, acc_k, tel_k = kernels.PERSISTENT_PAIR(tt, stacked, acc_k, tel_k)
    pi, pe, acc_p, tel_p = tdp.persistent_pair_plain(tt, stacked, acc_p,
                                                     tel_p)
    for got, want in ((ki, pi), (ke, pe)):
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(got, col), getattr(want, col)), col
    assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p)
    packed = torch.from_numpy(_edge_flows(w).view(np.int32)).cuda()
    n = int(packed.shape[1])
    picks = np.random.default_rng(11).integers(0, n, 3001).astype(np.int64)
    picks[:6] = (n - 1, n, n + 7, 1 << 31, (1 << 32) - 1, 0x9000_0000)
    picks = torch.from_numpy(picks.astype(np.uint32).view(np.int32)).cuda()
    runs = ((None, None, tdp.flow_batch_from_packed(packed)),
            (picks, None, tdp.pool_flows(packed, picks)),
            (picks, tdp.pool_rows_of(packed), tdp.pool_flows(packed, picks)))
    for pks, rows, flows in runs:
        for form in (dict(), dict(emit_sec_id=False), dict(static_dir=0),
                     dict(static_dir=1)):
            acc_k = tvd.make_counter_buffers(tt.policy) + 1
            tel_k = tvd.make_telemetry_buffers("cuda") + 2
            acc_p, tel_p = acc_k.clone(), tel_k.clone()
            got = kernels.DATAPATH_STEP(tt, packed, pks, acc=acc_k,
                                        telem=tel_k, pool_rows=rows, **form)
            want = tdp.datapath_step_plain(tt, flows, acc=acc_p, telem=tel_p,
                                           **form)
            case = (pks is not None, rows is not None, form)
            for col in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), (
                    case, col)
            assert torch.equal(acc_k, acc_p), case
            assert torch.equal(tel_k, tel_p), case
    uni = w.pairs(seed=13, half=5000, k=1)[0]
    zp = world.zipf_pairs(w, np.random.default_rng(54), 5000, 1, 1.1)[0]
    rows = convert.cache_rows_to(tmemo.make_cache_rows(1 << 8, 8), "cuda")
    acc_k = tvd.make_counter_buffers(tt.policy)
    tel_k = tvd.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    for n, (pair, cap) in enumerate(((uni, 5000), (uni, 5000), (zp, 5000),
                                     (zp, 64))):
        pt = torch.from_numpy(pair.view(np.int32)).cuda()
        k = tmemo.memo_pair_packed4(tt, pt, rows, acc_k, tel_k, cap)
        q = tmemo.memo_pair_plain(tt, pt, rows, acc_p, tel_p, cap)
        for got, want in ((k[0], q[0]), (k[1], q[1])):
            for col in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), (
                    n, col)
        for i in range(2, 8):
            assert torch.equal(k[i], q[i]), (n, i)
        assert (int(k[7][tmemo.STAT_OVERFLOW]) > 0) == (cap == 64), n
        rows, acc_k, tel_k, acc_p, tel_p = k[4], k[2], k[3], q[2], q[3]


@pytest.mark.cuda
@pytest.mark.parametrize("churn", [False, True])
def test_replay_on_card_matches_plain_on_node_world(churn):
    """replay() on the card against replay() on the CPU over the node
    world's tables: stats, counters, telemetry; in churn mode every CT
    entry."""
    import copy

    _need_card()
    w = _world("node")
    host = tdp.subword_datapath_tables(w.host_tables())
    buf, ep_map = _records(w, 5000, 4)
    res = []
    for dev in ("cuda", "cpu"):
        ct = copy.deepcopy(w.ct) if churn else None
        if ct is not None:
            ct.now = lambda: 0
        st, l4, l3 = trp.replay(convert.tables_to(host, dev), buf, 1024,
                                ep_map=ep_map, ct_map=ct,
                                collect_telemetry=True, device=dev)
        res.append((st, l4, l3, ct))
    (a, a4, a3, act), (b, b4, b3, bct) = res
    for f in ("total", "allowed", "denied", "redirected", "batches",
              "ct_created", "ct_deleted", "rounds", "intents"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a4, b4)
    np.testing.assert_array_equal(a3, b3)
    if churn:
        assert act.entries == bct.entries and a.ct_created > 0
    else:
        np.testing.assert_array_equal(a.telemetry, b.telemetry)
