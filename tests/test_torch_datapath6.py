"""The PyTorch port's fused IPv6 datapath on the CPU against the JAX
package: the v6 builders leaf for leaf (build_ipcache6,
build_prefilter6, compile_ct6, compile_lb6, config6_world's tables),
the stage functions (ipcache6_lookup, lb6_select_batch,
ct6_lookup_batch) on edge inputs, all 13 Datapath6Verdicts columns of
`datapath6_step(..., device="cpu")` against the jitted
`cilium_tpu.engine.datapath6.datapath6_step` (the JAX tests' worlds, a
small config6_world with its conntrack and tunnel variants, the
mixed-family batch), and apply_ct_writeback6.  Every value is an
integer: the tolerance is 0.  The cuda-marked tests at the end hold
DATAPATH6 against its plain version on the card; they need no JAX and
skip here:

    python -m pytest --noconftest tests/test_torch_datapath6.py -q -m cuda
"""

import dataclasses
import ipaddress
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, world
from cilium_tpu_torch.ct import table as tct
from cilium_tpu_torch.engine import datapath6 as td6
from cilium_tpu_torch.ipcache import lpm6 as tlpm6
from cilium_tpu_torch.lb import device6 as tlb6
from cilium_tpu_torch.lb import service as tsvc
from cilium_tpu_torch.maps import policymap as tpm

try:
    import jax.numpy as jnp

    from cilium_tpu.compiler.tables import compile_map_states as j_compile
    from cilium_tpu.ct import table as jct
    from cilium_tpu.engine import datapath6 as jd6
    from cilium_tpu.ipcache import lpm6 as jlpm6
    from cilium_tpu.lb import device6 as jlb6
    from cilium_tpu.lb import service as jsvc
    from cilium_tpu.maps import policymap as jpm
    from tests.test_verdict_engine import random_map_state
    from torch_parity import (
        assert_same_leaves,
        convert_ct,
        convert_mgr,
        convert_states,
        port_inputs,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jnp = None

IDENTITY_IDS = [1, 2, 3, 4, 5, 256, 257, 300, 1000]
V6_POOL = [
    "2001:db8::1", "2001:db8::2", "2001:db8:1::10", "2001:db8:1:2::3",
    "fd00::1", "fd00:aaaa::7", "2600:1::9",
]
IPCACHE6 = {
    "2001:db8::/32": 256,
    "2001:db8:1::/48": 257,
    "2001:db8:1:2::/64": 300,
    "2001:db8:1:2::3/128": 1000,
    "fd00::/8": 5,
}
PREFILTER6 = ["2600:1::/32"]
EDGE6 = ["::", "::1", "ffff:ffff::", "ffff::1",
         "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff",
         "ffff:ffff:ffff:ffff:ffff:ffff:ffff:fffe"]
DIRECTIONS = [0, 1, 2, 5, -1]
PORTS = [53, 80, 443, 8443, 65535, 65536 + 443, 70000, -5, -65536 + 80]


def _need_jax():
    if jnp is None:
        pytest.skip("JAX is not installed")


def _limbs(addrs):
    return np.array([tlpm6.ip6_limbs(a) for a in addrs], np.uint32)


def _addr_int(ip):
    return int(ipaddress.IPv6Address(ip))


def _leaves(obj):
    """A JAX table dataclass (nested) as {field: numpy, scalar or dict},
    the input of convert.*_from_numpy."""
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _leaves(v)
        elif v is None or isinstance(v, (bool, int, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _same_verdicts6(port, ref, where=""):
    for col in td6.VERDICT6_COLUMNS:
        got = getattr(port, col).cpu().numpy()
        want = np.asarray(getattr(ref, col))
        if col in td6.U32_COLUMNS6:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, (where, col, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {col}")


def _both_steps(jtables, flows, ptables=None):
    """The JAX step and the port's plain step (on tables carried across
    from the JAX leaves, or `ptables` built by the port) on the same
    numpy flows."""
    jout = jd6.datapath6_step(jtables, jd6.FlowBatch6.from_numpy(**flows))
    if ptables is None:
        ptables = convert.datapath6_tables_from_numpy(_leaves(jtables), "cpu")
    pout = td6.datapath6_step(
        ptables, td6.FlowBatch6.from_numpy(**flows, device="cpu"),
        device="cpu")
    return jout, pout


def _jax_ct(entries):
    ct = jct.CTMap()
    for saddr, daddr, sport, dport, proto, d in entries:
        ct.create(jct.CTTuple(_addr_int(daddr), _addr_int(saddr), dport,
                              sport, proto), d)
    return ct


# (saddr, daddr, sport, dport, proto, CT direction: 0 ingress, 1 egress,
# 2 service)
ESTABLISHED = [
    ("2001:db8::1", "2001:db8:1::10", 4001, 80, 6, 0),
    ("fd00::1", "2001:db8:1:2::3", 4002, 443, 6, 1),
    ("2001:db8::2", "2001:db8::2", 5000, 5000, 17, 1),  # equal pairs
    ("2001:db8:1::10", "2001:db8::1", 80, 4001, 6, 2),
]


def _cpu(plane):
    return convert.plane_to(plane, "cpu")


def _fused_world(seed, with_lb, directions=(0, 1), ports=(53, 80, 443, 8080)):
    """The JAX test's fused world (tests/test_datapath6.py:83, and with
    `with_lb` its service of :271), flows over `directions` and
    `ports`: (JAX tables, numpy flows, JAX states, JAX ct, JAX mgr)."""
    rng = np.random.default_rng(seed)
    n_eps = 3
    states = [random_map_state(rng, IDENTITY_IDS, n_l4=10, n_l3=10)
              for _ in range(n_eps)]
    for st in states:  # the backends' identities at the backend port
        st[jpm.PolicyKey(257, 8443, 6, jpm.EGRESS)] = jpm.PolicyMapStateEntry()
    policy = j_compile(states, IDENTITY_IDS, 32, 16)
    ct = _jax_ct(ESTABLISHED)
    mgr = jsvc.ServiceManager()
    mgr.upsert(jsvc.L3n4Addr("fd00:5::100", 443, 6),
               [jsvc.L3n4Addr(b, 8443, 6)
                for b in ("2001:db8:1::10", "2001:db8:1:2::3")])
    tables = jd6.Datapath6Tables(
        prefilter=jd6.build_prefilter6(PREFILTER6),
        ipcache=jlpm6.build_ipcache6(IPCACHE6),
        ct=jd6.compile_ct6(ct),
        policy=policy,
        lb=jlb6.compile_lb6(mgr) if with_lb else None,
    )
    n = 384
    pool = V6_POOL + ["fd00:5::100"] + EDGE6
    s = [str(rng.choice(pool)) for _ in range(n)]
    d = [str(rng.choice(pool)) for _ in range(n)]
    flows = dict(
        ep_index=rng.integers(0, n_eps, size=n),
        saddr=_limbs(s), daddr=_limbs(d),
        sport=rng.choice([4001, 4002, 5000, 80], size=n),
        dport=rng.choice(list(ports), size=n),
        proto=rng.choice([6, 17], size=n),
        direction=rng.choice(list(directions), size=n),
        is_fragment=rng.random(size=n) < 0.05,
    )
    # a third of the rows replay a conntrack entry, forward or (for the
    # two datapath directions) reversed: ESTABLISHED and REPLY hits
    for i in np.nonzero(rng.random(n) < 0.33)[0]:
        sa, da, sp, dp, pr, d = ESTABLISHED[int(rng.integers(len(ESTABLISHED)))]
        if d < 2 and rng.random() < 0.5:
            sa, da, sp, dp, d = da, sa, dp, sp, 1 - d
        flows["saddr"][i], flows["daddr"][i] = _limbs([sa, da])
        flows["sport"][i], flows["dport"][i] = sp, dp
        flows["proto"][i], flows["direction"][i] = pr, d
    return tables, flows, states, ct, mgr


# -- builders -------------------------------------------------------------------


def test_ipcache6_and_prefilter6_builders_match_jax():
    _need_jax()
    w = world.config6_world(64)
    for mapping in (IPCACHE6, w.ipc_map, {"ffff::/16": 500}, {}):
        assert_same_leaves(tlpm6.build_ipcache6(mapping),
                           jlpm6.build_ipcache6(mapping), "ipcache6")
    # 130 /128s in 16 buckets: the stash fills
    crowd = {f"2001:db8:7::{i + 1:x}/128": 2000 + i for i in range(300)}
    got = tlpm6.build_ipcache6(crowd)
    assert_same_leaves(got, jlpm6.build_ipcache6(crowd), "crowded")
    for cidrs in (PREFILTER6, [], PREFILTER6 + ["10.0.0.0/8", "fd00::/8",
                                                "::/0", "2001:db8::1/128"]):
        assert_same_leaves(td6.build_prefilter6(cidrs),
                           jd6.build_prefilter6(cidrs), "prefilter6")
    with pytest.raises(ValueError):
        tlpm6.build_ipcache6({"ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff/128": 7})
    assert tlpm6.limbs_of_int(2**128 - 2) == jlpm6.limbs_of_int(2**128 - 2)
    assert tlpm6.int_of_limbs(tlpm6.ip6_limbs("fd00::1")) == _addr_int("fd00::1")
    for p in range(0, 129, 7):
        assert tlpm6._mask_limbs(p) == jlpm6._mask_limbs(p)


def test_compile_ct6_and_lb6_match_jax():
    _need_jax()
    ct = _jax_ct(ESTABLISHED)
    assert_same_leaves(td6.compile_ct6(convert_ct(ct, tct)),
                       jd6.compile_ct6(ct), "ct6")
    # a crowded map: a small max_entries puts many entries in one row
    small = jct.CTMap(max_entries=8)
    for i in range(200):
        small.entries[jct.CTTuple(
            _addr_int(f"2001:db8::{i + 1:x}"), _addr_int("fd00::1"),
            80, 1000 + i, 6, i % 3)] = jct.CTEntry(rev_nat_index=i, slave=i % 5)
    assert_same_leaves(td6.compile_ct6(convert_ct(small, tct)),
                       jd6.compile_ct6(small), "ct6 crowded")
    mgr = jsvc.ServiceManager()
    for i in range(40):
        mgr.upsert(jsvc.L3n4Addr(f"fd00:9::{i + 1:x}", 80 + i % 3, 6),
                   [jsvc.L3n4Addr(f"2001:db8:b::{j + 1:x}", 9000 + j, 6)
                    for j in range(1 + i % 12)])
    mgr.upsert(jsvc.L3n4Addr("10.0.0.1", 80, 6),
               [jsvc.L3n4Addr("10.0.0.2", 80, 6)])  # v4: not lowered
    assert_same_leaves(tlb6.compile_lb6(convert_mgr(mgr, tsvc)),
                       jlb6.compile_lb6(mgr), "lb6")
    w = world.config6_world(64)
    assert_same_leaves(tlb6.compile_lb6(w.mgr),
                       jlb6.compile_lb6(convert_mgr(w.mgr, jsvc)), "lb6 c6")
    big = tsvc.ServiceManager()
    big.upsert(tsvc.L3n4Addr("fd00::1", 80, 6),
               [tsvc.L3n4Addr(f"2001:db8::{j + 1:x}", 80, 6)
                for j in range(13)])
    with pytest.raises(ValueError, match="backends"):
        tlb6.compile_lb6(big)


def _bench_config6_draws(n, seed=29):
    """bench.py config6's draws (:2814-2875) as it makes them."""
    rng = np.random.default_rng(seed)
    ids = list(range(4096, 8192))
    addrs = [f"2001:db8:{i >> 8:x}:{i & 0xFF:x}::{(i % 9) + 1:x}"
             for i in range(len(ids))]
    ports = rng.choice(np.arange(1000, 30000), size=64, replace=False)
    limbs = np.array([jlpm6.ip6_limbs(a) for a in addrs], np.uint32)
    pick = rng.integers(0, len(addrs), size=n)
    saddr = limbs[pick]
    to_vip = rng.random(n) < 0.1
    dpick = rng.integers(0, len(addrs), size=n)
    daddr = limbs[dpick]
    daddr[to_vip] = jlpm6.ip6_limbs("fd00:77::1")
    direction = (rng.random(n) < 0.5).astype(np.int64)
    direction[to_vip] = 1
    dport = rng.choice(ports, size=n).astype(np.int64)
    dport[to_vip] = 443
    sport = rng.integers(1024, 60000, size=n)
    sample = rng.integers(0, n, size=256)
    return ports, dict(saddr=saddr, daddr=daddr, sport=sport, dport=dport,
                       direction=direction), sample


def _jax_config6_tables(w, ct=None, tunnel=None):
    """The JAX builders on a World6's map-level inputs."""
    return jd6.Datapath6Tables(
        prefilter=jd6.build_prefilter6(w.prefilter_cidrs),
        ipcache=jlpm6.build_ipcache6(w.ipc_map),
        ct=jd6.compile_ct6(ct if ct is not None else jct.CTMap()),
        policy=j_compile(convert_states(w.states, tpm, jpm), w.identity_ids,
                         identity_pad=w.identity_pad),
        tunnel=tunnel,
        lb=jlb6.compile_lb6(convert_mgr(w.mgr, jsvc)),
    )


def test_config6_world_matches_bench_and_jax_builders():
    """config6_world repeats bench.py's draws, and its tables equal the
    JAX builders' leaf for leaf."""
    _need_jax()
    n = 4096
    w = world.config6_world(n)
    ports, draws, sample = _bench_config6_draws(n)
    for k, v in draws.items():
        np.testing.assert_array_equal(w.flows[k], v, err_msg=k)
    np.testing.assert_array_equal(w.sample, sample)
    st = w.states[0]
    assert len(w.identity_ids) == 4096 and len(w.ipc_map) == 4097
    assert {k.dest_port for k in st if k.traffic_direction == 0} <= set(
        int(p) for p in ports) | {0}
    assert tpm.PolicyKey(4099, 8443, 6, 1) in st
    assert_same_leaves(w.host_tables(), _jax_config6_tables(w), "config6")


# -- stage functions ----------------------------------------------------------------


def test_ipcache6_lookup_matches_jax_on_edges():
    _need_jax()
    w = world.config6_world(64)
    probes = (V6_POOL + EDGE6 + ["2001:db8:1:2::4", "2600:1:2::5"]
              + w.addrs[:50] + ["2001:db8:0:1::", "fd00:77::1"])
    limbs = _limbs(probes)
    for mapping in (IPCACHE6, w.ipc_map, {"ffff::/16": 500},
                    {"::/0": 9, "ffff:ffff::/32": 11}, {}):
        want = np.asarray(jlpm6.ipcache6_lookup(
            jlpm6.build_ipcache6(mapping), jnp.asarray(limbs)))
        dev = _cpu(tlpm6.build_ipcache6(mapping))
        got = tlpm6.ipcache6_lookup(dev, torch.from_numpy(limbs.view(np.int32)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # the all-ones address exact-hits the empty lanes (value 0) and so
    # shadows its covering range; ffff:ffff:: does not
    dev = _cpu(tlpm6.build_ipcache6({"ffff::/16": 500}))
    got = tlpm6.ipcache6_lookup(
        dev, torch.from_numpy(_limbs(["ffff:ffff::", EDGE6[4]]).view(np.int32)))
    assert got.tolist() == [500, 0]
    assert tlpm6.lookup_host6({"ffff::/16": 500}, EDGE6[4]) == 500


def test_lb6_select_matches_jax_on_edges():
    _need_jax()
    rng = np.random.default_rng(9)
    mgr = jsvc.ServiceManager()
    vips = [f"fd00:9::{i + 1}" for i in range(19)]
    for i, vip in enumerate(vips):
        mgr.upsert(jsvc.L3n4Addr(vip, 80 + (i % 3), 6),
                   [jsvc.L3n4Addr(f"2001:db8:b::{j + 1}", 9000 + j, 6)
                    for j in range(1 + i % 5)])
    mgr.upsert(jsvc.L3n4Addr("fd00:9::99", 80, 6), [])  # no backends
    jt = jlb6.compile_lb6(mgr)
    tt = _cpu(tlb6.LB6Inline(**_leaves(jt)))
    n = 512
    dsts = [str(rng.choice(vips + ["2001:db8::77", "fd00:9::99"]))
            for _ in range(n)]
    cols = [
        _limbs([f"2001:db8:c::{int(rng.integers(1, 99))}" for _ in range(n)]),
        _limbs(dsts),
        rng.choice([1024, 60000, 65535, 65536 + 7, -3], size=n).astype(np.int32),
        rng.choice([80, 81, 82, 83, 65536 + 80, -65536 + 81, 70000],
                   size=n).astype(np.int32),
        rng.choice([6, 6, 17, 256 + 6, -250], size=n).astype(np.int32),
    ]
    ct_slave = rng.choice([0, 1, 2, 3, 5, 6, 40000], size=n).astype(np.int32)
    for slave_in in (None, ct_slave):
        want = jlb6.lb6_select_batch(
            jt, *(jnp.asarray(c) for c in cols),
            ct_slave=None if slave_in is None else jnp.asarray(slave_in))
        got = tlb6.lb6_select_batch(
            tt, *(torch.from_numpy(c.view(np.int32)) for c in cols),
            ct_slave=None if slave_in is None else torch.from_numpy(slave_in))
        for g, x in zip(got, want):
            x = np.asarray(x)
            np.testing.assert_array_equal(g.numpy().astype(x.dtype), x)
    assert n // 8 < np.asarray(want[0]).sum() < n
    # the flow hash leaves dport unmasked; the host oracle masks it
    fh = tlb6.flow_hash6(*(torch.from_numpy(c.view(np.int32)) for c in cols))
    jfh = np.asarray(jlb6.flow_hash6(*(jnp.asarray(c) for c in cols)))
    np.testing.assert_array_equal(fh.numpy().astype(np.uint32), jfh)
    svc = mgr.lookup(jsvc.L3n4Addr(vips[4], 81, 6))
    assert tlb6.slave_for_host(svc, "2001:db8::1", vips[4], 5000, 81, 6) == (
        jlb6.slave_for_host(svc, "2001:db8::1", vips[4], 5000, 81, 6))


def test_ct6_lookup_matches_jax_on_edges():
    _need_jax()
    tables, flows, _, ct, _ = _fused_world(3, True)
    jt = tables.ct
    tt = convert.datapath6_tables_from_numpy(_leaves(tables), "cpu").ct
    rng = np.random.default_rng(5)
    n = 512
    est = [e for e in ESTABLISHED]
    rows = rng.integers(0, len(est), size=n)
    swap = rng.random(n) < 0.5
    s = [est[r][1] if sw else est[r][0] for r, sw in zip(rows, swap)]
    d = [est[r][0] if sw else est[r][1] for r, sw in zip(rows, swap)]
    sp = np.array([est[r][3] if sw else est[r][2] for r, sw in zip(rows, swap)])
    dp = np.array([est[r][2] if sw else est[r][3] for r, sw in zip(rows, swap)])
    sp = np.where(rng.random(n) < 0.2, sp + 65536, sp)  # masked to 16 bits
    dp = np.where(rng.random(n) < 0.1, dp - 131072, dp)
    cols = [_limbs(d), _limbs(s), dp.astype(np.int32), sp.astype(np.int32),
            np.array([est[r][4] for r in rows], np.int32)
            + np.where(rng.random(n) < 0.1, 256, 0).astype(np.int32),
            rng.choice(DIRECTIONS, size=n).astype(np.int32)]
    related = rng.random(n) < 0.2
    for rel in (None, related):
        want = jd6.ct6_lookup_batch(
            jt, *(jnp.asarray(c) for c in cols),
            related_icmp=None if rel is None else jnp.asarray(rel))
        got = td6.ct6_lookup_batch(
            tt, *(torch.from_numpy(c.view(np.int32)) for c in cols),
            related_icmp=None if rel is None else torch.from_numpy(rel))
        for g, x in zip(got, want):
            x = np.asarray(x)
            np.testing.assert_array_equal(g.numpy().astype(x.dtype), x)
        res = np.asarray(want[0])
        assert {0, 1, 2} <= set(res.tolist()), np.bincount(res)


# -- the whole program --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_lb", [False, True])
def test_datapath6_matches_jax_on_fused_worlds(seed, with_lb):
    """tests/test_datapath6.py:83's world, with and without :271's
    service, over directions {0, 1, 2, 5, -1} and ports past 16 bits
    and below 0; tables carried across and built by the port."""
    _need_jax()
    tables, flows, states, ct, mgr = _fused_world(
        seed, with_lb, directions=DIRECTIONS, ports=PORTS)
    jout, pout = _both_steps(tables, flows)
    _same_verdicts6(pout, jout, "carried")
    inp = port_inputs(states, ct, mgr)
    from cilium_tpu_torch.compiler.tables import compile_map_states

    own = td6.Datapath6Tables(
        prefilter=td6.build_prefilter6(PREFILTER6),
        ipcache=tlpm6.build_ipcache6(IPCACHE6),
        ct=td6.compile_ct6(inp["ct"]),
        policy=compile_map_states(inp["states"], IDENTITY_IDS, 32, 16),
        lb=tlb6.compile_lb6(inp["mgr"]) if with_lb else None,
    )
    _, pown = _both_steps(tables, flows, convert.datapath6_tables_to(own, "cpu"))
    _same_verdicts6(pown, jout, "port-built")
    res = np.asarray(jout.ct_result)
    assert {0, 1, 2} <= set(res.tolist())
    assert np.asarray(jout.pre_dropped).any()
    if with_lb:
        assert (np.asarray(jout.lb_slave) > 0).any()


def test_datapath6_lb_world_and_writeback_match_jax():
    """tests/test_datapath6.py:271: DNAT to a hashed backend, the
    write-back (created and deleted counts, the resulting map), then
    the second pass's stickiness and ESTABLISHED."""
    _need_jax()
    rng = np.random.default_rng(4)
    state = {
        jpm.PolicyKey(257, 8443, 6, jpm.EGRESS): jpm.PolicyMapStateEntry(),
        jpm.PolicyKey(1000, 8443, 6, jpm.EGRESS): jpm.PolicyMapStateEntry(),
    }
    policy = j_compile([state], IDENTITY_IDS, 32, 16)
    mgr = jsvc.ServiceManager()
    mgr.upsert(jsvc.L3n4Addr("fd00:5::100", 443, 6),
               [jsvc.L3n4Addr(b, 8443, 6)
                for b in ("2001:db8:1::10", "2001:db8:1:2::3")])
    jct_map = jct.CTMap()
    tables = jd6.Datapath6Tables(
        prefilter=jd6.build_prefilter6(PREFILTER6),
        ipcache=jlpm6.build_ipcache6(IPCACHE6),
        ct=jd6.compile_ct6(jct_map), policy=policy,
        lb=jlb6.compile_lb6(mgr),
    )
    n = 64
    srcs = [str(rng.choice(V6_POOL[:4])) for _ in range(n)]
    flows = dict(
        ep_index=np.zeros(n, np.int32), saddr=_limbs(srcs),
        daddr=_limbs(["fd00:5::100"] * n),
        sport=rng.integers(1024, 60000, size=n), dport=np.full(n, 443),
        proto=np.full(n, 6), direction=np.ones(n, np.int64),
    )
    jout, pout = _both_steps(tables, flows)
    _same_verdicts6(pout, jout, "pass 1")
    tct_map = tct.CTMap()
    jres = jd6.apply_ct_writeback6(jct_map, jout,
                                   jd6.FlowBatch6.from_numpy(**flows))
    pres = td6.apply_ct_writeback6(
        tct_map, pout, td6.FlowBatch6.from_numpy(**flows, device="cpu"))
    assert pres == jres == (2 * n, 0)
    assert_same_leaves(td6.compile_ct6(tct_map), jd6.compile_ct6(jct_map), "ct")
    tables2 = dataclasses.replace(tables, ct=jd6.compile_ct6(jct_map))
    jout2, pout2 = _both_steps(tables2, flows)
    _same_verdicts6(pout2, jout2, "pass 2")
    assert (np.asarray(jout2.ct_result) == jct.CT_ESTABLISHED).all()


def test_apply_ct_writeback6_matches_jax_with_deletes():
    """Creates in odd directions, deletes of ESTABLISHED flows policy
    now denies, a map that fills: the same counts and the same map."""
    _need_jax()
    tables, flows, _, ct, _ = _fused_world(
        7, True, directions=DIRECTIONS, ports=PORTS)
    jout, pout = _both_steps(tables, flows)
    assert np.asarray(jout.ct_delete).any() and np.asarray(jout.ct_create).any()
    for cap in (jct.MAX_ENTRIES_LOCAL, 24):
        jmap = _jax_ct(ESTABLISHED)
        jmap.max_entries = cap
        tmap = convert_ct(jmap, tct)
        jres = jd6.apply_ct_writeback6(jmap, jout,
                                       jd6.FlowBatch6.from_numpy(**flows))
        tres = td6.apply_ct_writeback6(
            tmap, pout, td6.FlowBatch6.from_numpy(**flows, device="cpu"))
        assert tres == jres
        assert sorted(tuple(dataclasses.astuple(k)) for k in tmap.entries) == (
            sorted(tuple(dataclasses.astuple(k)) for k in jmap.entries))
        for k, v in jmap.entries.items():
            e = tmap.entries[tct.CTTuple(*dataclasses.astuple(k))]
            assert (e.rev_nat_index, e.slave) == (v.rev_nat_index, v.slave)


@pytest.fixture(scope="module")
def config6_small():
    if jnp is None:
        pytest.skip("JAX is not installed")
    w = world.config6_world(2048)
    return w, _jax_config6_tables(w)


def test_datapath6_matches_jax_on_config6(config6_small):
    """A small config6_world through both programs, and bench's
    composed oracle on the first 64 of its 256 rows."""
    from cilium_tpu_torch.compiler.tables import RESERVED_WORLD
    from cilium_tpu_torch.engine.oracle import policy_can_access

    w, jt = config6_small
    jout, pout = _both_steps(jt, w.flows)
    _same_verdicts6(pout, jout, "config6")
    _, pown = _both_steps(jt, w.flows,
                          convert.datapath6_tables_to(w.host_tables(), "cpu"))
    _same_verdicts6(pown, jout, "config6 port-built")
    allowed, slave = pout.allowed.numpy(), pout.lb_slave.numpy()
    f = w.flows
    for i in w.sample[:64]:
        s = tlpm6.int_of_limbs(f["saddr"][i])
        d = tlpm6.int_of_limbs(f["daddr"][i])
        s, d = str(ipaddress.IPv6Address(s)), str(ipaddress.IPv6Address(d))
        dirn, eff_d, eff_p = int(f["direction"][i]), d, int(f["dport"][i])
        if dirn == 1:
            svc = tlb6.lb6_lookup_host(w.mgr, d, eff_p, 6)
            if svc is not None and svc.backends:
                sl = tlb6.slave_for_host(svc, s, d, int(f["sport"][i]), eff_p, 6)
                assert int(slave[i]) == sl
                eff_d = svc.backends[sl - 1].addr.ip
                eff_p = svc.backends[sl - 1].addr.port
        sec = tlpm6.lookup_host6(w.ipc_map, s if dirn == 0 else eff_d)
        v = policy_can_access(w.states[0], sec or RESERVED_WORLD, eff_p, 6,
                              dirn)
        assert bool(allowed[i]) == v.allowed, i
    assert 0 < int(allowed.sum()) < len(allowed)


def test_datapath6_matches_jax_on_config6_ct_variant(config6_small):
    """The conntrack variant: a slice written back, CT6 recompiled,
    then the slice and its reverses (ESTABLISHED, REPLY, stickiness)."""
    w, jt = config6_small
    count = 1024
    head = {k: v[:count] for k, v in w.flows.items()}
    jout, pout = _both_steps(jt, head)
    tmap, second = world.config6_ct_pass(w.flows, pout, count)
    jmap = jct.CTMap()
    assert jd6.apply_ct_writeback6(
        jmap, jout, jd6.FlowBatch6.from_numpy(**head)) == (len(tmap.entries), 0)
    jt2 = dataclasses.replace(jt, ct=jd6.compile_ct6(jmap))
    assert_same_leaves(td6.compile_ct6(tmap), jt2.ct, "ct6 variant")
    jout2, pout2 = _both_steps(jt2, second)
    _same_verdicts6(pout2, jout2, "ct variant")
    res = np.asarray(jout2.ct_result)
    assert {1, 2} <= set(res[:count].tolist()) | set(res[count:].tolist())
    assert (res[count:] == 2).sum() > 0 and (res[:count] == 1).sum() > 0
    sticky = np.asarray(jout2.lb_slave)[:count]
    np.testing.assert_array_equal(sticky, np.asarray(jout.lb_slave))


def test_datapath6_matches_jax_on_config6_tunnel_variant(config6_small):
    from cilium_tpu.tunnel import TunnelMap as JTunnelMap

    w, jt = config6_small
    tm = world.tunnel_map()
    jtm = JTunnelMap()
    for prefix, ip in tm.snapshot().items():
        jtm.set_tunnel_endpoint(prefix, ip)
    jt2 = dataclasses.replace(jt, tunnel=jtm.tables6())
    assert_same_leaves(tm.tables6(), jt2.tunnel, "tunnel6")
    jout, pout = _both_steps(jt2, w.flows)
    _same_verdicts6(pout, jout, "tunnel variant")
    _, pown = _both_steps(jt2, w.flows, convert.datapath6_tables_to(
        w.host_tables(tunnel=tm), "cpu"))
    _same_verdicts6(pown, jout, "tunnel variant port-built")
    assert (np.asarray(jout.tunnel_endpoint) != 0).sum() > 0


# -- config 6's edges (world.v6_edge_world) -------------------------------------


@pytest.fixture(scope="module")
def edge_world():
    """world.v6_edge_world and the JAX program's tables on its arrays:
    JAX's builders on its maps (the policy, prefilter, LB, tunnel map and
    the unedited ipcache6 leaf for leaf the port's), then the edited
    ipcache6 and CT6 arrays as they are."""
    if jnp is None:
        pytest.skip("JAX is not installed")
    from cilium_tpu.tunnel import TunnelMap as JTunnelMap

    e = world.v6_edge_world()
    jtm = JTunnelMap()
    for prefix, ip in e.tunnel.snapshot().items():
        jtm.set_tunnel_endpoint(prefix, ip)
    jt = _jax_config6_tables(e.w, tunnel=jtm.tables6())
    h = e.tables
    for plane in ("prefilter", "policy", "tunnel", "lb"):
        assert_same_leaves(getattr(h, plane), getattr(jt, plane), plane)
    assert_same_leaves(tlpm6.build_ipcache6(e.w.ipc_map), jt.ipcache,
                       "ipcache6")

    def arrays(jplane, plane):
        return dataclasses.replace(jplane, **{
            f.name: getattr(plane, f.name) for f in dataclasses.fields(jplane)})

    return e, dataclasses.replace(jt, ipcache=arrays(jt.ipcache, h.ipcache),
                                  ct=arrays(jt.ct, h.ct))


def test_datapath6_matches_jax_on_edge_world(edge_world):
    """All 13 columns on the edge world (the stashes in use, duplicate and
    near-miss keys, the all-ones address, tied ranges, nested tunnel
    ranges), and the plain version the same on its tables padded past
    what DATAPATH6 stages (world.v6_unstaged)."""
    e, jt = edge_world
    jout, pout = _both_steps(jt, e.flows,
                             convert.datapath6_tables_to(e.tables, "cpu"))
    _same_verdicts6(pout, jout, "edges")
    padded = td6.datapath6_plain(
        convert.datapath6_tables_to(world.v6_unstaged(e.tables), "cpu"),
        td6.FlowBatch6.from_numpy(**e.flows, device="cpu"))
    for col in td6.VERDICT6_COLUMNS:
        assert torch.equal(getattr(padded, col), getattr(pout, col)), col
    assert {0, 1, 2} <= set(np.asarray(jout.ct_result).tolist())
    assert len(set(np.asarray(jout.tunnel_endpoint).tolist()) - {0}) >= 2
    assert (np.asarray(jout.lb_slave) > 0).any()
    assert np.asarray(jout.pre_dropped).any()


def test_stage_lookups_match_jax_on_edge_world(edge_world):
    """ipcache6_lookup, tunnel_select6 and ct6_lookup_batch against JAX's
    on the edge world's probe addresses and flows, with the sums the
    edits make: a key in its row and in the stash, twice in one row, the
    near misses (which add nothing), the all-ones address (the stash's
    all-ones row of value 7), the tied /48s."""
    from cilium_tpu.tunnel import tunnel_select6 as jtunnel_select6
    from cilium_tpu_torch.tunnel import tunnel_select6

    e, jt = edge_world
    pt = convert.datapath6_tables_to(e.tables, "cpu")
    pr = e.probes
    probes = list(pr.values()) + [
        "2001:db8:77::5", "2001:db8:77:1::9", "2001:db8:0:7::3",
        "2001:db8:0:7:1::4", "2001:db8:0:8::5", "2001:db8:0:9::1"]
    limbs = _limbs(probes)
    want = np.asarray(jlpm6.ipcache6_lookup(jt.ipcache, jnp.asarray(limbs)))
    got = tlpm6.ipcache6_lookup(pt.ipcache,
                                torch.from_numpy(limbs.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    v = dict(zip(probes, want.tolist()))
    ipc = e.w.ipc_map
    assert v[pr["both"]] == ipc[pr["both"] + "/128"] + 7777
    assert v[pr["dup"]] == ipc[pr["dup"] + "/128"] + 8888
    assert v[pr["near"]] == ipc[pr["near"] + "/128"]
    assert v[pr["crowd_stashed"]] == ipc[pr["crowd_stashed"] + "/128"]
    assert v[pr["ones"]] == 7
    assert v["2001:db8:77::5"] == 4100 + 4103
    assert v["2001:db8:77:1::9"] == 4101
    want = np.asarray(jtunnel_select6(jt.tunnel, jnp.asarray(limbs)))
    got = tunnel_select6(pt.tunnel, torch.from_numpy(limbs.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert len(set(want.tolist()) - {0}) >= 3
    f = e.flows
    cols = [f["daddr"], f["saddr"], f["dport"], f["sport"], f["proto"],
            f["direction"]]
    cols = [np.asarray(c).astype(np.int64).astype(np.int32) if c.ndim == 1
            else c for c in cols]
    want = jd6.ct6_lookup_batch(jt.ct, *(jnp.asarray(c) for c in cols))
    got = td6.ct6_lookup_batch(
        pt.ct, *(torch.from_numpy(c.view(np.int32)) for c in cols))
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_array_equal(g.numpy().astype(x.dtype), x)
    assert {0, 1, 2} <= set(np.asarray(want[0]).tolist())


def test_mixed_family_batch_matches_jax():
    """tests/test_datapath6.py:180: each family through its own program
    over one shared policy; both families' columns equal JAX's, and
    the verdicts are family-invariant."""
    _need_jax()
    from cilium_tpu.ct.device import compile_ct as j_compile_ct
    from cilium_tpu.engine import datapath as jdp
    from cilium_tpu.ipcache.lpm import build_ipcache, specialize_ipcache_to_idx
    from cilium_tpu.lb.device import compile_lb_inline
    from cilium_tpu.prefilter import build_prefilter
    from cilium_tpu_torch.engine import datapath as tdp
    from torch_parity import assert_same_verdicts

    rng = np.random.default_rng(7)
    states = [random_map_state(rng, IDENTITY_IDS, n_l4=8, n_l3=6)]
    policy = j_compile(states, IDENTITY_IDS, 32, 16)
    t4 = jdp.DatapathTables(
        prefilter=build_prefilter({}),
        ipcache=specialize_ipcache_to_idx(
            build_ipcache({"10.0.0.1/32": 257}), policy),
        ct=j_compile_ct(jct.CTMap()),
        lb=compile_lb_inline(jsvc.ServiceManager()),
        policy=policy,
    )
    t6 = jd6.Datapath6Tables(
        prefilter=jd6.build_prefilter6([]),
        ipcache=jlpm6.build_ipcache6({"2001:db8::99/128": 257}),
        ct=jd6.compile_ct6(jct.CTMap()), policy=policy,
    )
    n = 64
    dports = rng.choice([53, 80, 443], size=n)
    protos = rng.choice([6, 17], size=n)
    common = dict(ep_index=np.zeros(n, np.int32), sport=np.full(n, 5555),
                  dport=dports, proto=protos, direction=np.zeros(n, np.int32))
    f4 = dict(common, saddr=np.full(n, 0x0A000001, np.uint32),
              daddr=np.full(n, 0x0A090909, np.uint32))
    f6 = dict(common, saddr=_limbs(["2001:db8::99"] * n),
              daddr=_limbs(["2001:db8::1"] * n))
    j4 = jdp.datapath_step(t4, jdp.FlowBatch.from_numpy(**f4))
    leaves = {p: _leaves(getattr(t4, p))
              for p in ("prefilter", "ipcache", "ct", "lb", "policy")}
    p4 = tdp.datapath_step(
        convert.tables_from_numpy(leaves, "cpu"),
        tdp.FlowBatch(**{k: torch.from_numpy(np.asarray(v).astype(np.int64))
                         for k, v in f4.items()},
                      is_fragment=torch.zeros(n, dtype=torch.bool)))
    assert_same_verdicts(p4, j4, "v4")
    j6, p6 = _both_steps(t6, f6)
    _same_verdicts6(p6, j6, "v6")
    np.testing.assert_array_equal(p4.allowed.numpy(), p6.allowed.numpy())
    np.testing.assert_array_equal(p4.match_kind.numpy(), p6.match_kind.numpy())


def test_datapath6_step_defaults_to_the_card():
    """device=None means the card: without one it raises; tables and
    flows must lie on the device asked for."""
    w = world.config6_world(32)
    tables = convert.datapath6_tables_to(w.host_tables(), "cpu")
    flows = td6.FlowBatch6.from_numpy(**w.flows, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td6.datapath6_step(tables, flows)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td6.FlowBatch6.from_numpy(**w.flows)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.datapath6_tables_to(w.host_tables())
    else:
        with pytest.raises(ValueError, match="must be tensors on"):
            td6.datapath6_step(tables, flows)
    out = td6.datapath6_step(tables, flows, device="cpu")
    assert out.final_daddr.shape == (32, 4)
    moved = convert.flow_batch6_to(flows, "cpu")
    assert torch.equal(moved.saddr, flows.saddr)


# -- on the card ----------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


def _card_equal(got, want):
    for col in td6.VERDICT6_COLUMNS:
        assert torch.equal(getattr(got, col), getattr(want, col)), col


def _edge_flows(w, n, seed):
    """config6_world's addresses and the edges, in every direction and
    with ports and protos past their fields."""
    rng = np.random.default_rng(seed)
    pool = w.addrs[:64] + [world.CONFIG6_VIP, "2600:1::9", "fd00::1"] + EDGE6
    return dict(
        ep_index=rng.choice([0, 0, 0, 1, -1], size=n),
        saddr=_limbs([pool[i] for i in rng.integers(0, len(pool), n)]),
        daddr=_limbs([pool[i] for i in rng.integers(0, len(pool), n)]),
        sport=rng.choice([1024, 8443, 65536 + 1, -2], size=n),
        dport=rng.choice(PORTS + [8443], size=n),
        proto=rng.choice([6, 17, 256 + 6, -1], size=n),
        direction=rng.choice(DIRECTIONS, size=n),
        is_fragment=rng.random(n) < 0.05,
    )


@pytest.mark.cuda
def test_datapath6_kernel_matches_plain():
    """DATAPATH6 against the plain version on the card: config 6 with
    and without the tunnel map and the LB, its conntrack variant, the
    dense lattice branch, edge flows, and the edge world's tables staged
    and read in place; one launch a call."""
    _need_card()
    import dataclasses as dc

    from cilium_tpu_torch import kernels

    w = world.config6_world(1 << 15)
    tm = world.tunnel_map()
    host = w.host_tables(tunnel=tm)
    full = convert.datapath6_tables_to(host, "cuda")
    variants = {
        "tunnel": full,
        "plain": dc.replace(full, tunnel=None),
        "no_lb": dc.replace(full, lb=None),
        "dense": dc.replace(full, policy=dc.replace(
            full.policy, l4_hash_rows=None, l4_hash_stash=None,
            l4_wild_rows=None, l4_wild_stash=None)),
    }
    batches = [w.flows, _edge_flows(w, 1 << 12, 1)]
    before = kernels.DATAPATH6.launches
    calls = 0
    for name, tables in variants.items():
        for f in batches:
            flows = td6.FlowBatch6.from_numpy(**f, device="cuda")
            got = td6.datapath6_step(tables, flows)
            want = td6.datapath6_plain(tables, flows)
            torch.cuda.synchronize()
            _card_equal(got, want)
            calls += 1
    # the edge world (world.v6_edge_world, an odd batch) with its small
    # tables staged, and padded past what a block stages (read in place)
    e = world.v6_edge_world(n=2051)
    ef = td6.FlowBatch6.from_numpy(**e.flows, device="cuda")
    for host in (e.tables, world.v6_unstaged(e.tables)):
        tables = convert.datapath6_tables_to(host, "cuda")
        got = td6.datapath6_step(tables, ef)
        torch.cuda.synchronize()
        _card_equal(got, td6.datapath6_plain(tables, ef))
        calls += 1
    first = td6.datapath6_step(
        full, td6.FlowBatch6.from_numpy(**{
            k: v[:4096] for k, v in w.flows.items()}, device="cuda"))
    ct, second = world.config6_ct_pass(w.flows, first, 4096)
    ct_tables = dc.replace(full, ct=convert.plane_to(td6.compile_ct6(ct),
                                                     "cuda"))
    flows2 = td6.FlowBatch6.from_numpy(**second, device="cuda")
    got = td6.datapath6_step(ct_tables, flows2)
    _card_equal(got, td6.datapath6_plain(ct_tables, flows2))
    assert (got.ct_result == 2).any() and (got.ct_result == 1).any()
    assert kernels.DATAPATH6.launches == before + calls + 2


@pytest.mark.cuda
def test_datapath6_kernel_refuses_what_it_does_not_take():
    _need_card()
    import dataclasses as dc

    from cilium_tpu_torch import kernels

    w = world.config6_world(256)
    tables = convert.datapath6_tables_to(w.host_tables(), "cuda")
    flows = td6.FlowBatch6.from_numpy(**w.flows, device="cuda")
    kernels.DATAPATH6(tables, flows)
    cpu_flows = td6.FlowBatch6.from_numpy(**w.flows, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.DATAPATH6(tables, cpu_flows)
    with pytest.raises(ValueError, match="dtype"):
        kernels.DATAPATH6(tables, dc.replace(flows, sport=flows.sport.long()))
    with pytest.raises(ValueError, match="shape"):
        kernels.DATAPATH6(tables, dc.replace(flows, saddr=flows.saddr[:, :3]))
    bad_ct = dc.replace(tables.ct, n_buckets=tables.ct.n_buckets * 2)
    with pytest.raises(ValueError):
        kernels.DATAPATH6(dc.replace(tables, ct=bad_ct), flows)
