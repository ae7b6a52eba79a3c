"""The PyTorch port's persistent pair program (K13) and its dispatcher on
the CPU against the JAX package's: `persistent_pair_program(k)` for K in
{1, 3} on the SMALL world (tables built by the port or carried across
from the JAX builders, wide and sub-word layouts) and on the storm
world's sub-word tables, and `PersistentPairDispatcher` with 7 pairs at
K = 3 (2 super-launches and a remainder of one pair): all 15 verdict
columns, the counter and telemetry carry, the launches, the
`datapath_persistent_*` metric deltas and the site's jit-cache calls.
Every value is an integer; the tolerance is 0.

The cuda-marked tests at the end hold PERSISTENT_PAIR against its plain
version on the card: through the dispatcher, with K not dividing the
pair count; and on edge tables (every stash filled and hit, 4,999 flows
a half, 2,000 flows on one counter cell, with and without overlay
mode) at K = 1 and K = 4, DATAPATH_PAIR beside it.  They need no JAX and
skip here:

    python -m pytest --noconftest tests/test_torch_persistent.py -q -m cuda
"""

import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler.tables import split_hot
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.metrics import registry as tmetrics

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax

    from cilium_tpu.engine import datapath as jdp
    from cilium_tpu.engine.verdict import (
        make_counter_buffers as j_counters,
        make_telemetry_buffers as j_telem,
    )
    from cilium_tpu.metrics import registry as jmetrics
    from torch_parity import (
        assert_same_buffers,
        assert_same_verdicts,
        chaos_storm,
        jax_host_tables,
        jax_leaves,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _port_tables(w, layout, source, jt):
    if source == "convert":
        return convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    host = w.host_tables()
    if layout == "subword":
        host = tdp.subword_datapath_tables(host)
    host.policy = split_hot(host.policy)
    return convert.tables_to(host, "cpu")


def _run_both(jt, tt, pairs, k):
    """The super-batch of `pairs` through both programs from fresh
    carries, compared column by column and buffer by buffer."""
    stacked = np.stack(pairs)
    j_i, j_e, jacc, jtel = jdp.persistent_pair_program(k)(
        jt, jax.device_put(stacked), jax.device_put(j_counters(jt.policy)),
        jax.device_put(j_telem()),
    )
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cpu")
    t_i, t_e, acc, tel = tdp.persistent_pair_program(k)(
        tt, torch.from_numpy(stacked.view(np.int32)), acc, tel)
    assert tuple(t_i.allowed.shape) == (k, stacked.shape[-1])
    assert_same_verdicts(t_i, j_i, f"K={k} ingress")
    assert_same_verdicts(t_e, j_e, f"K={k} egress")
    assert_same_buffers(acc, tel, jacc, jtel)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("source,layout", [("port", "wide"),
                                           ("convert", "subword")])
def test_persistent_program_matches_jax(k, source, layout):
    """Uniform and Zipf pairs in one super-batch, both table sources."""
    _need_jax()
    w = world.make_world(seed=2, **SMALL)
    jt = jax_host_tables(w, subword=(layout == "subword"))
    tt = _port_tables(w, layout, source, jt)
    pairs = (w.pairs(seed=50, half=160, k=k - k // 2)
             + w.pairs(seed=51, half=160, k=k // 2, zipf=1.3))
    _run_both(jt, tt, pairs, k)


def test_persistent_program_matches_jax_on_subword_storm_world():
    """The storm world's sub-word tables (every plane packed) carried
    across, with its own flow shapes, at K = 3."""
    _need_jax()
    storm = chaos_storm()
    dt, parts = storm._fused_world(7)
    jt, report = jdp.subword_datapath_tables(dt)
    assert all(v == "packed" for v in report.values()), report
    tt = convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(3):
        pair = np.empty((2, 4, 192), np.uint32)
        for half in range(2):
            f = storm._fused_flows(rng, 192, parts)
            f["direction"] = np.full(192, half)
            pair[half] = tdp.pack_flow_records4(**f)
        pairs.append(pair)
    _run_both(jt, tt, pairs, 3)


def _site_calls(metrics, site):
    return (metrics.jit_cache_hits.get(site)
            + metrics.jit_cache_misses.get(site))


def test_dispatcher_counts_match_jax():
    """7 pairs at K = 3 through both dispatchers: the results, the carry,
    2 super-launches, the datapath_persistent_* deltas (2 launches, 6
    pairs) and 2 calls at the site, as tests/test_subword.py counts
    them for the reference."""
    _need_jax()
    w = world.make_world(seed=3, **SMALL)
    jt = jax_host_tables(w, subword=True)
    tt = _port_tables(w, "subword", "port", jt)
    pairs = (w.pairs(seed=60, half=128, k=4)
             + w.pairs(seed=61, half=128, k=3, zipf=1.3))
    site = "test.torch.persistent.counts"
    before = []
    for m in (jmetrics, tmetrics):
        before.append((_site_calls(m, site),
                       m.datapath_persistent_launches.get(),
                       m.datapath_persistent_pairs.get()))
    jd = jdp.PersistentPairDispatcher(
        jt, 3, jax.device_put(j_counters(jt.policy)),
        jax.device_put(j_telem()), site=site)
    td = tdp.PersistentPairDispatcher(
        tt, 3, tv.make_counter_buffers(tt.policy),
        tv.make_telemetry_buffers("cpu"), site=site)
    j_got, t_got = [], []
    for p in pairs:
        j_got.extend(jd.submit(p))
        t_got.extend(td.submit(p))
        assert len(j_got) == len(t_got)
    j_rem, jacc, jtel = jd.flush()
    t_rem, acc, tel = td.flush()
    j_got += j_rem
    t_got += t_rem
    assert td.launches == jd.launches == 2
    deltas = []
    for m, (calls0, l0, p0) in zip((jmetrics, tmetrics), before):
        deltas.append((_site_calls(m, site) - calls0,
                       m.datapath_persistent_launches.get() - l0,
                       m.datapath_persistent_pairs.get() - p0))
    assert deltas[0] == deltas[1] == (2, 2, 6), deltas
    assert len(t_got) == len(pairs)
    for (ji, je), (ti, te) in zip(j_got, t_got):
        assert_same_verdicts(ti, ji, "ingress")
        assert_same_verdicts(te, je, "egress")
    assert_same_buffers(acc, tel, jacc, jtel)


def test_dispatcher_k1_runs_no_remainder():
    """K = 1: every pair is a super-launch and flush has nothing left;
    the first launch class is the site's one miss."""
    w = world.make_world(seed=4, **SMALL)
    host = tdp.subword_datapath_tables(w.host_tables())
    host.policy = split_hot(host.policy)
    tt = convert.tables_to(host, "cpu")
    pairs = w.pairs(seed=70, half=96, k=3)
    site = "test.torch.persistent.k1"
    m0 = tmetrics.jit_cache_misses.get(site)
    h0 = tmetrics.jit_cache_hits.get(site)
    r0 = _site_calls(tmetrics, site + ".remainder")
    td = tdp.PersistentPairDispatcher(
        tt, 1, tv.make_counter_buffers(tt.policy),
        tv.make_telemetry_buffers("cpu"), site=site)
    got = [r for p in pairs for r in td.submit(p)]
    rem, acc, tel = td.flush()
    assert rem == [] and len(got) == 3 and td.launches == 3
    assert _site_calls(tmetrics, site + ".remainder") == r0
    assert tmetrics.jit_cache_hits.get(site) - h0 == 3 - (
        tmetrics.jit_cache_misses.get(site) - m0)
    acc_p = tv.make_counter_buffers(tt.policy)
    tel_p = tv.make_telemetry_buffers("cpu")
    for p, (gi, ge) in zip(pairs, got):
        pi, pe, acc_p, tel_p = tdp.datapath_pair_plain(
            tt, torch.from_numpy(p.view(np.int32)), acc_p, tel_p)
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(gi, col), getattr(pi, col)), col
            assert torch.equal(getattr(ge, col), getattr(pe, col)), col
    assert torch.equal(acc, acc_p) and torch.equal(tel, tel_p)


def test_program_refuses_another_k():
    w = world.make_world(seed=4, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cpu")
    pairs = torch.from_numpy(np.stack(w.pairs(seed=1, half=32, k=2))
                             .view(np.int32))
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cpu")
    with pytest.raises(ValueError):
        tdp.persistent_pair_program(3)(tt, pairs, acc, tel)


def test_dispatcher_refuses_pairs_of_another_shape():
    """The dispatcher reuses its host stack across super-batches; pairs
    of another width in one super-batch raise, as np.stack does, where a
    copy into the stack would broadcast them."""
    w = world.make_world(seed=4, **SMALL)
    tt = convert.tables_to(world.headline_tables(w), "cpu")
    td = tdp.PersistentPairDispatcher(
        tt, 2, tv.make_counter_buffers(tt.policy),
        tv.make_telemetry_buffers("cpu"), site="test.torch.persistent.shape")
    assert len(td.submit(w.pairs(seed=1, half=32, k=1)[0])) == 0
    with pytest.raises(ValueError):
        td.submit(w.pairs(seed=2, half=1, k=1)[0])


# -- on the card ---------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


@pytest.mark.cuda
def test_persistent_kernel_matches_plain_version():
    """7 pairs at K = 3 through the dispatcher on the card (2
    PERSISTENT_PAIR launches, 1 DATAPATH_PAIR remainder) against 7
    plain pair steps; then one super-batch straight through the kernel
    against persistent_pair_plain."""
    _need_card()
    from cilium_tpu_torch import kernels

    w = world.make_world(seed=2, **SMALL)
    tables = convert.tables_to(world.headline_tables(w), "cuda")
    pairs = (w.pairs(seed=9, half=20_000, k=4)
             + w.pairs(seed=10, half=20_000, k=3, zipf=1.2))
    p0, d0 = kernels.PERSISTENT_PAIR.launches, kernels.DATAPATH_PAIR.launches
    disp = tdp.PersistentPairDispatcher(
        tables, 3, tv.make_counter_buffers(tables.policy),
        tv.make_telemetry_buffers("cuda"))
    got = [r for p in pairs for r in disp.submit(p)]
    rem, acc, tel = disp.flush()
    got += rem
    torch.cuda.synchronize()
    assert kernels.PERSISTENT_PAIR.launches - p0 == 2
    assert kernels.DATAPATH_PAIR.launches - d0 == 1
    acc_p = tv.make_counter_buffers(tables.policy)
    tel_p = tv.make_telemetry_buffers("cuda")
    for p, (gi, ge) in zip(pairs, got):
        pi, pe, acc_p, tel_p = tdp.datapath_pair_plain(
            tables, torch.from_numpy(p.view(np.int32)).cuda(), acc_p, tel_p)
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(gi, col), getattr(pi, col)), col
            assert torch.equal(getattr(ge, col), getattr(pe, col)), col
    assert torch.equal(acc, acc_p) and torch.equal(tel, tel_p)

    stacked = torch.from_numpy(np.stack(pairs[:4]).view(np.int32)).cuda()
    acc_k = tv.make_counter_buffers(tables.policy)
    tel_k = tv.make_telemetry_buffers("cuda")
    acc_q, tel_q = acc_k.clone(), tel_k.clone()
    ki, ke, acc_k, tel_k = kernels.PERSISTENT_PAIR(tables, stacked, acc_k,
                                                   tel_k)
    qi, qe, acc_q, tel_q = tdp.persistent_pair_plain(tables, stacked, acc_q,
                                                     tel_q)
    torch.cuda.synchronize()
    for got_v, want_v in ((ki, qi), (ke, qe)):
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(got_v, col), getattr(want_v, col)), col
    assert torch.equal(acc_k, acc_q) and torch.equal(tel_k, tel_q)


def _edge_tables(w, overlay: bool):
    """The world's tables with every stash filled and hit: its CT rows cut
    to 12 lanes and its L4 rows to 4 (both spill into their stashes), its
    ipcache stash 64 copies of /32s the pairs' flows look up (ingress
    sources, egress destinations); with `overlay` a tunnel map over the
    /24s of 32 egress destinations (host numpy)."""
    import dataclasses
    import ipaddress

    from cilium_tpu_torch.compiler.tables import repack_l4_subword
    from cilium_tpu_torch.ct.device import compact_ct_snapshot
    from cilium_tpu_torch.ipcache.lpm import subword_ipcache
    from cilium_tpu_torch.tunnel import TunnelMap

    wide = w.host_tables()
    pool = w.pool
    ips = np.concatenate([
        np.unique(pool["saddr"][pool["direction"] == 0])[:32],
        np.unique(pool["daddr"][pool["direction"] == 1])[:32]])
    rng = np.random.default_rng(8)
    stash = np.stack([ips, rng.integers(1, 200, ips.size),
                      rng.integers(0, 1 << 32, ips.size),
                      rng.integers(0, 1 << 32, ips.size)], axis=1)
    ipc = subword_ipcache(wide.ipcache)
    ipc = dataclasses.replace(ipc, stash=stash.astype(np.uint32))
    tunnel = None
    if overlay:
        tm = TunnelMap()
        for k, ip in enumerate(np.unique(pool["daddr"][pool["direction"] == 1])
                               [:32]):
            net = ipaddress.IPv4Network((int(ip) & 0xFFFFFF00, 24))
            tm.set_tunnel_endpoint(str(net), f"192.168.{k}.1")
        tunnel = tm.tables()
    return tdp.DatapathTables(
        prefilter=wide.prefilter, ipcache=ipc,
        ct=compact_ct_snapshot(wide.ct, lanes=12), lb=wide.lb,
        policy=split_hot(repack_l4_subword(wide.policy, lanes=4)),
        tunnel=tunnel)


@pytest.mark.cuda
@pytest.mark.parametrize("overlay", [False, True])
def test_pair_kernel_matches_plain_on_edge_tables(overlay):
    """PERSISTENT_PAIR at K = 1 and K = 4 and DATAPATH_PAIR against their
    plain versions on _edge_tables: 4,999 flows a half (a multiple of
    neither 256 nor 4), the first 2,000 of each half one flow repeated
    (one counter cell takes 2,000 hits a pair), every stash hit; columns,
    counters and telemetry."""
    _need_card()
    from cilium_tpu_torch import kernels

    w = world.make_world(seed=4, **SMALL)
    tables = convert.tables_to(_edge_tables(w, overlay), "cuda")
    assert tables.ct.stash.shape[0] > 1
    assert tables.policy.l4_hash_stash.shape[0] > 1
    assert tables.ipcache.stash.shape[0] == 64
    pairs = np.stack(w.pairs(seed=21, half=4999, k=4))
    pairs[:, :, :, :2000] = pairs[:, :, :, :1]
    stacked = torch.from_numpy(pairs.view(np.int32)).cuda()
    for k in (1, 4):
        acc_k = tv.make_counter_buffers(tables.policy)
        tel_k = tv.make_telemetry_buffers("cuda")
        acc_p, tel_p = acc_k.clone(), tel_k.clone()
        ki, ke, acc_k, tel_k = kernels.PERSISTENT_PAIR(tables, stacked[:k],
                                                       acc_k, tel_k)
        pi, pe, acc_p, tel_p = tdp.persistent_pair_plain(
            tables, stacked[:k], acc_p, tel_p)
        torch.cuda.synchronize()
        for got, want in ((ki, pi), (ke, pe)):
            for col in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), (
                    k, col)
        assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p), k
    assert int(acc_k.max()) >= 2000
    if overlay:
        assert bool((ke.tunnel_endpoint != 0).any())
    acc_k = tv.make_counter_buffers(tables.policy)
    tel_k = tv.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    ki, ke, acc_k, tel_k = kernels.DATAPATH_PAIR(tables, stacked[0], acc_k,
                                                 tel_k)
    pi, pe, acc_p, tel_p = tdp.datapath_pair_plain(tables, stacked[0], acc_p,
                                                   tel_p)
    torch.cuda.synchronize()
    for got, want in ((ki, pi), (ke, pe)):
        for col in tdp.VERDICT_COLUMNS:
            assert torch.equal(getattr(got, col), getattr(want, col)), col
    assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p)
