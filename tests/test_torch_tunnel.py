"""The PyTorch port's tunnel (overlay) stage on the CPU against the JAX
package, with tolerance 0 (every value is an integer): TunnelMap's two
lowered forms leaf for leaf, `tunnel_select` and `tunnel_select6` on
random and edge addresses, and the v4 datapath in overlay mode, the
pair form (15 DatapathVerdicts columns, the counter buffer and the
telemetry buffer) and the single-batch `datapath_step`, on the SMALL
config-5 world with a tunnel map, tables carried across from the JAX
builders or built by the port.  The cuda-marked tests at the end hold
DATAPATH_PAIR and DATAPATH_STEP in overlay mode against their plain
versions on the card; they need no JAX and skip here:

    python -m pytest --noconftest tests/test_torch_tunnel.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch import tunnel as ttun
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.ipcache.lpm6 import ip6_limbs

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)

try:
    import jax.numpy as jnp

    from cilium_tpu import tunnel as jtun
    from cilium_tpu.engine import datapath as jdp
    from torch_parity import (
        assert_same_buffers,
        assert_same_leaves,
        assert_same_verdicts,
        jax_host_tables,
        jax_leaves,
        jax_run_pairs,
        port_run_pairs,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jnp = None


def _need_jax():
    if jnp is None:
        pytest.skip("JAX is not installed")


def _overlay(n_nodes=64):
    """world.tunnel_map's first nodes plus pod CIDRs over the SMALL
    world's cluster addresses (10.0.0.0/23) and endpoints
    (10.250.0.0/24), one of them nested in another, node IPs on both
    sides of 2^31: (port map, JAX map)."""
    tm = world.tunnel_map(n_nodes)
    for prefix, node in (("10.0.0.0/24", "192.168.250.1"),
                         ("10.0.1.0/24", "10.9.9.9"),
                         ("10.0.1.128/25", "172.31.0.1"),
                         ("10.250.0.0/24", "255.255.255.254")):
        tm.set_tunnel_endpoint(prefix, node)
    jm = jtun.TunnelMap() if jnp is not None else None
    if jm is not None:
        for prefix, ip in tm.snapshot().items():
            jm.set_tunnel_endpoint(prefix, ip)
    return tm, jm


def test_tunnel_map_tables_match_jax():
    _need_jax()
    tm, jm = _overlay()
    assert_same_leaves(tm.tables(), jm.tables(), "tunnel")
    assert_same_leaves(tm.tables6(), jm.tables6(), "tunnel6")
    for m in (tm, jm):
        m.delete_tunnel_endpoint("10.0.1.0/24")
        assert m.set_tunnel_endpoint("fd00:1::/64", "2001:db8::1") is None
    assert tm.snapshot() == jm.snapshot()
    assert_same_leaves(tm.tables(), jm.tables(), "after delete")
    empty, jempty = ttun.TunnelMap(), jtun.TunnelMap()
    assert_same_leaves(empty.tables(), jempty.tables(), "empty")
    assert_same_leaves(empty.tables6(), jempty.tables6(), "empty6")
    full = world.tunnel_map()
    assert len(full.snapshot()) == 2 * world.TUNNEL_NODES
    with pytest.raises(ValueError, match="exceeds"):
        full.set_tunnel_endpoint("10.252.0.0/24", "192.168.0.9")


def test_tunnel_select_matches_jax():
    _need_jax()
    tm, jm = _overlay()
    rng = np.random.default_rng(3)
    n = 2048
    ips = np.concatenate([
        (0x0AFB0000 | rng.integers(0, 1 << 16, n // 4)),
        (0x0A000000 | rng.integers(0, 1 << 9, n // 4)),
        (0x0AFA0000 | rng.integers(0, 1 << 8, n // 4)),
        rng.integers(0, 1 << 32, n // 4 - 2), [0, 0xFFFFFFFF],
    ]).astype(np.uint32)
    t4 = convert.plane_to(tm.tables(), "cpu")
    for local in (0, int(0xC0A80001), 0x0A090909):
        want = np.asarray(jtun.tunnel_select(jm.tables(), jnp.asarray(ips),
                                             local))
        got = ttun.tunnel_select(t4, torch.from_numpy(ips.view(np.int32)),
                                 local)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        if local == 0:
            assert (want != 0).sum() > n // 4
            assert (want > 0x7FFFFFFF).any()
            assert ((want > 0) & (want < 1 << 31)).any()
    addrs = [f"2001:db8:{i >> 8:x}:{i & 0xFF:x}::1"
             for i in rng.integers(0, 4096, n)]
    addrs[:4] = ["::", "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff",
                 "2001:db8::", "2001:db8:0:10::ffff"]
    limbs = np.array([ip6_limbs(a) for a in addrs], np.uint32)
    t6 = convert.plane_to(tm.tables6(), "cpu")
    for local in (0, int(0xC0A80001)):
        want6 = np.asarray(jtun.tunnel_select6(jm.tables6(),
                                               jnp.asarray(limbs), local))
        got6 = ttun.tunnel_select6(t6, torch.from_numpy(limbs.view(np.int32)),
                                   local)
        np.testing.assert_array_equal(got6.numpy().astype(np.uint32), want6)
    assert 0 < (want6 != 0).sum() < n


def _overlay_tables(w, layout, source, jm, tm):
    """(JAX tables, port tables) of world `w` in overlay mode."""
    jt = dataclasses.replace(jax_host_tables(w, subword=(layout == "compact")),
                             tunnel=jm.tables())
    if source == "convert":
        return jt, convert.tables_from_numpy(jax_leaves(jt), "cpu")
    host = w.host_tables() if layout == "wide" else world.headline_tables(w)
    return jt, convert.tables_to(
        dataclasses.replace(host, tunnel=tm.tables()), "cpu")


@pytest.mark.parametrize("source", ["port", "convert"])
@pytest.mark.parametrize("layout", ["compact", "wide"])
def test_pair_step_in_overlay_mode_matches_jax(layout, source):
    """The pair form: only the egress half carries tunnel endpoints;
    columns, counters and telemetry equal JAX's."""
    _need_jax()
    tm, jm = _overlay()
    w = world.make_world(seed=3, **SMALL)
    jt, tt = _overlay_tables(w, layout, source, jm, tm)
    assert tt.tunnel is not None
    pairs = w.pairs(seed=13, half=256, k=2) + w.pairs(seed=14, half=256, k=1,
                                                      zipf=1.2)
    j_outs, jacc, jtel = jax_run_pairs(jt, pairs)
    t_outs, acc, tel = port_run_pairs(tt, pairs)
    for n, ((ji, je), (ti, te)) in enumerate(zip(j_outs, t_outs)):
        assert_same_verdicts(ti, ji, f"pair {n} ingress")
        assert_same_verdicts(te, je, f"pair {n} egress")
        assert not ti.tunnel_endpoint.any()
    assert_same_buffers(acc, tel, jacc, jtel)
    tunnelled = sum(int((te.tunnel_endpoint != 0).sum()) for _, te in t_outs)
    assert tunnelled > 64


@pytest.mark.parametrize("source", ["port", "convert"])
def test_datapath_step_in_overlay_mode_matches_jax(source):
    """The single-batch form over every pool flow and rows whose
    direction is 2 (not ingress: LB and tunnel apply)."""
    _need_jax()
    from cilium_tpu_torch import replay as trp

    tm, jm = _overlay()
    w = world.make_world(seed=4, **SMALL)
    jt, tt = _overlay_tables(w, "wide", source, jm, tm)
    packed = trp.pack_flow_pool(w.pool)
    more = packed[:, :256].copy()
    more[tdp.FLOW_COLUMNS.index("direction")] = 2
    packed = np.concatenate([packed, more], axis=1)
    jo = jdp.datapath_step(jt, jdp.flow_batch_from_packed(jnp.asarray(packed)))
    to = tdp.datapath_step(
        tt, tdp.flow_batch_from_packed(torch.from_numpy(packed.view(np.int32))))
    assert_same_verdicts(to, jo, "datapath_step overlay")
    tun = to.tunnel_endpoint.numpy()
    assert (tun[-256:] != 0).any() and (tun != 0).sum() > 64
    assert not tun[:-256][w.pool["direction"] == 0].any()


def test_overlay_tables_move_with_their_tunnel_leaf():
    tm, _ = _overlay(8)
    w = world.make_world(seed=1, **dict(SMALL, n_pool=300))
    host = dataclasses.replace(w.host_tables(), tunnel=tm.tables())
    moved = convert.tables_to(host, "cpu")
    assert isinstance(moved.tunnel, ttun.TunnelTables)
    assert moved.tunnel.endpoint.dtype == torch.int32
    np.testing.assert_array_equal(moved.tunnel.base.numpy().view(np.uint32),
                                  tm.tables().base)
    assert convert.tables_to(w.host_tables(), "cpu").tunnel is None


# -- on the card ----------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["compact", "wide"])
def test_overlay_kernels_match_plain(layout):
    """DATAPATH_PAIR and DATAPATH_STEP with a tunnel map against their
    plain versions on the card, and the same kernels without one still
    write zero endpoints."""
    _need_card()
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.engine import verdict

    tm, _ = _overlay()
    w = world.make_world(seed=2, **SMALL)
    host = w.host_tables() if layout == "wide" else world.headline_tables(w)
    tables = convert.tables_to(
        dataclasses.replace(host, tunnel=tm.tables()), "cuda")
    acc_k = verdict.make_counter_buffers(tables.policy)
    tel_k = verdict.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    tunnelled = 0
    for p in w.pairs(seed=9, half=20_000, k=2):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        ki, ke, acc_k, tel_k = kernels.DATAPATH_PAIR(tables, pt, acc_k, tel_k)
        pi, pe, acc_p, tel_p = tdp.datapath_pair_plain(tables, pt, acc_p,
                                                       tel_p)
        torch.cuda.synchronize()
        for got, want in ((ki, pi), (ke, pe)):
            for col in tdp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), col
        tunnelled += int((ke.tunnel_endpoint != 0).sum())
    assert torch.equal(acc_k, acc_p) and torch.equal(tel_k, tel_p)
    assert tunnelled > 0
    pool = convert.flow_pool_to(w.pool, "cuda")
    picks = torch.arange(pool.shape[1], dtype=torch.int32, device="cuda")
    got = kernels.DATAPATH_STEP(tables, pool, picks)
    want = tdp.datapath_step_plain(
        tables, tdp.flow_batch_from_packed(pool[:, picks.long()]))
    for col in tdp.VERDICT_COLUMNS:
        assert torch.equal(getattr(got, col), getattr(want, col)), col
    assert (got.tunnel_endpoint != 0).any()
    bare = dataclasses.replace(tables, tunnel=None)
    assert not kernels.DATAPATH_STEP(bare, pool, picks).tunnel_endpoint.any()
