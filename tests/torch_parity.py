"""Shared helpers of the PyTorch port's parity tests: the same world
as objects of both packages, table comparison leaf by leaf, and
verdict comparison column by column.  Imported by tests/test_torch_*.py
(the only files that import both cilium_tpu and cilium_tpu_torch)."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

import jax

from cilium_tpu.ct import table as jct_table
from cilium_tpu.engine import datapath as jdp
from cilium_tpu.lb import service as jsvc
from cilium_tpu.maps import policymap as jpm
from cilium_tpu_torch.ct import table as tct_table
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.lb import service as tsvc
from cilium_tpu_torch.maps import policymap as tpm

TOOLS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")

SMALL = dict(
    n_rules=400, n_endpoints=4, n_identities=512, n_cidr_blocks=16,
    n_vips=4, n_pool=3000, ct_max_entries=4096, identity_pad=256,
    filter_pad=16,
)


def chaos_storm():
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import chaos_storm

    return chaos_storm


def convert_states(states, pm_from, pm_to):
    return [
        {
            pm_to.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                            k.traffic_direction):
            pm_to.PolicyMapStateEntry(proxy_port=v.proxy_port)
            for k, v in st.items()
        }
        for st in states
    ]


def convert_ct(ct, mod_to):
    out = mod_to.CTMap(max_entries=ct.max_entries)
    for k, v in ct.entries.items():
        out.entries[mod_to.CTTuple(
            k.daddr, k.saddr, k.dport, k.sport, k.nexthdr, k.flags
        )] = mod_to.CTEntry(
            rev_nat_index=v.rev_nat_index, slave=v.slave,
            orig_daddr=v.orig_daddr, orig_dport=v.orig_dport,
        )
    return out


def convert_mgr(mgr, mod_to):
    out = mod_to.ServiceManager()
    for svc in sorted(mgr.by_frontend.values(), key=lambda s: s.id):
        fe = svc.frontend
        out.upsert(
            mod_to.L3n4Addr(fe.ip, fe.port, fe.protocol),
            [mod_to.L3n4Addr(b.addr.ip, b.addr.port, b.addr.protocol)
             for b in svc.backends],
        )
    return out


def jax_inputs(world):
    """A port World's map-level inputs as cilium_tpu objects."""
    return dict(
        states=convert_states(world.states, tpm, jpm),
        ct=convert_ct(world.ct, jct_table),
        mgr=convert_mgr(world.mgr, jsvc),
    )


def port_inputs(states, ct, mgr):
    """cilium_tpu map-level inputs as the port's objects."""
    return dict(
        states=convert_states(states, jpm, tpm),
        ct=convert_ct(ct, tct_table),
        mgr=convert_mgr(mgr, tsvc),
    )


def jax_host_tables(world, subword: bool):
    """The JAX builders on a port World's inputs, each plane in the
    layout its dispatching builder picks, as the daemon assembles them
    (cilium_tpu/daemon.py:2255)."""
    from cilium_tpu.compiler.tables import compile_map_states
    from cilium_tpu.ct.device import compile_ct
    from cilium_tpu.ipcache.lpm import build_ipcache, specialize_ipcache_to_idx
    from cilium_tpu.lb.device import compile_lb
    from cilium_tpu.prefilter import build_prefilter

    inp = jax_inputs(world)
    pol = compile_map_states(
        inp["states"], world.identity_ids, identity_pad=world.identity_pad,
        filter_pad=world.filter_pad,
    )
    tables = jdp.DatapathTables(
        prefilter=build_prefilter(world.prefilter_cidrs),
        ipcache=specialize_ipcache_to_idx(build_ipcache(world.ipc_map), pol),
        ct=compile_ct(inp["ct"]),
        lb=compile_lb(inp["mgr"]),
        policy=pol,
    )
    if subword:
        tables, report = jdp.subword_datapath_tables(tables, strict=True)
    return tables


def assert_same_leaves(port, ref, path="tables"):
    """Every field of the port's dataclass equals the reference's:
    arrays with np.array_equal (dtype included), scalars with ==."""
    for f in dataclasses.fields(port):
        mine = getattr(port, f.name)
        theirs = getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(mine):
            assert_same_leaves(mine, theirs, where)
        elif isinstance(mine, torch.Tensor):
            want = np.asarray(theirs)
            got = mine.cpu().numpy()
            if want.dtype == np.uint32:
                got = got.view(np.uint32)
            elif want.dtype == np.uint16:
                got = got.astype(np.uint16)
            assert got.shape == want.shape, where
            assert np.array_equal(got, want), where
        elif isinstance(mine, np.ndarray) or isinstance(theirs, np.ndarray):
            assert mine is not None and theirs is not None, where
            a, b = np.asarray(mine), np.asarray(theirs)
            assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
            assert np.array_equal(a, b), where
        else:
            assert mine == theirs, (where, mine, theirs)


def jax_leaves(tables) -> dict:
    """A JAX DatapathTables as {plane: {leaf: numpy or scalar}}."""
    out = {}
    for plane in ("prefilter", "ipcache", "ct", "lb", "policy"):
        obj = getattr(tables, plane)
        leaves = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None or isinstance(v, (bool, int, tuple)):
                leaves[f.name] = v
            else:
                leaves[f.name] = np.asarray(v)
        out[plane] = leaves
    tun = tables.tunnel
    out["tunnel"] = None if tun is None else {
        f.name: np.asarray(getattr(tun, f.name))
        for f in dataclasses.fields(tun)
    }
    return out


def assert_same_verdicts(port_out, jax_out, where=""):
    for col in tdp.VERDICT_COLUMNS:
        got = getattr(port_out, col).cpu().numpy()
        want = np.asarray(getattr(jax_out, col))
        if col in tdp.U32_COLUMNS:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, (where, col, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {col}")


def assert_same_buffers(acc, telem, jacc, jtelem):
    np.testing.assert_array_equal(acc.cpu().numpy().view(np.uint32),
                                  np.asarray(jacc))
    np.testing.assert_array_equal(telem.cpu().numpy().view(np.uint32),
                                  np.asarray(jtelem))


def jax_run_pairs(tables, pairs):
    """The JAX pair step over `pairs` from fresh carries."""
    from cilium_tpu.engine.verdict import (
        make_counter_buffers,
        make_telemetry_buffers,
    )

    acc = jax.device_put(make_counter_buffers(tables.policy))
    tel = jax.device_put(make_telemetry_buffers())
    outs = []
    for p in pairs:
        oi, oe, acc, tel = jdp.datapath_step_accum_pair_telem_packed4_stacked(
            tables, jax.device_put(p), acc, tel
        )
        outs.append((oi, oe))
    return outs, acc, tel


def port_run_pairs(tables, pairs):
    """The port's pair step over `pairs` from fresh carries (CPU)."""
    from cilium_tpu_torch.engine.verdict import (
        make_counter_buffers,
        make_telemetry_buffers,
    )

    acc = make_counter_buffers(tables.policy)
    tel = make_telemetry_buffers(acc.device)
    outs = []
    for p in pairs:
        oi, oe, acc, tel = tdp.datapath_step_accum_pair_telem_packed4_stacked(
            tables, torch.from_numpy(p.view(np.int32)), acc, tel
        )
        outs.append((oi, oe))
    return outs, acc, tel


# -- L7 ------------------------------------------------------------------------


def l7_leaves(obj):
    """A JAX L7 table object (HTTPTables, KafkaTables, FleetL7, DFA,
    StridedDFA) as the nested dict of numpy leaves and Python scalars
    that convert.*_from_numpy take."""
    from cilium_tpu.l7.kafka import Interner

    if obj is None:
        return None
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, list):
        return [l7_leaves(v) for v in obj]
    if isinstance(obj, Interner):
        return dict(obj._ids)
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name in ("specs", "device_rules"):
                out[f.name] = [dataclasses.asdict(s) for s in v]
            elif f.name == "host_rules":
                continue
            else:
                out[f.name] = l7_leaves(v)
        return out
    return obj


def assert_same_l7(port, ref, path="l7"):
    """Every leaf of a port L7 object equals the reference's: arrays
    (numpy, or tensors with u32 bits in int32 and u16 in int32) equal
    in shape, dtype and value; lists element by element; the interner
    by its map; rule specs field by field; scalars with ==."""
    if dataclasses.is_dataclass(port) and not isinstance(port, type):
        for f in dataclasses.fields(port):
            assert_same_l7(getattr(port, f.name), getattr(ref, f.name),
                           f"{path}.{f.name}")
    elif isinstance(port, torch.Tensor):
        want = np.asarray(ref)
        got = port.cpu().numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        elif want.dtype == np.uint16:
            got = got.astype(np.uint16)
        assert got.shape == want.shape, path
        assert np.array_equal(got, want), path
    elif isinstance(port, np.ndarray):
        want = np.asarray(ref)
        assert port.dtype == want.dtype, (path, port.dtype, want.dtype)
        assert port.shape == want.shape, path
        assert np.array_equal(port, want), path
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for k, (a, b) in enumerate(zip(port, ref)):
            assert_same_l7(a, b, f"{path}[{k}]")
    elif hasattr(port, "_ids"):
        assert port._ids == ref._ids, path
    else:
        assert port == ref, (path, port, ref)


def as_spec(spec, module):
    """A rule spec as `module`'s spec class (the reference's or the
    port's), field for field."""
    cls = (module.HTTPRuleSpec if hasattr(module, "HTTPRuleSpec")
           else module.KafkaRuleSpec)
    return cls(**dataclasses.asdict(spec))


def as_torch(arrays, device="cpu"):
    """numpy arrays -> tensors (u32 as int32 with the same bits)."""
    from cilium_tpu_torch.device import array_tensor

    return tuple(array_tensor(a, device) for a in arrays)


M32 = 0xFFFFFFFF


def _leaf_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_same_tables_low32(want, got):
    """A reference table set (PolicyTables, IPCacheDevice; host arrays
    or a device epoch) against the port's, leaf for leaf; the
    generation stamp by its low 32 bits (the high 32 carry a
    per-process compiler nonce) and u32 leaves the port carries as
    int32 tensors by their bits."""
    assert type(want).__name__ == type(got).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "generation":
            assert int(_leaf_np(a)) & M32 == int(_leaf_np(b)) & M32
            continue
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        if isinstance(a, (int, float, bool, str, tuple)):
            assert a == b, f.name
            continue
        a, b = _leaf_np(a), _leaf_np(b)
        assert a.shape == b.shape, f.name
        if a.dtype != b.dtype:
            a, b = a.astype(np.int64) & M32, b.astype(np.int64) & M32
        assert np.array_equal(a, b), f.name


def assert_same_states(want, got):
    """Two map states (dicts or MapStateArrays of either package):
    keys, proxy ports and counters equal."""
    w = jpm.MapStateArrays.from_dict(want)
    g = tpm.MapStateArrays.from_dict(got)
    assert np.array_equal(w.keys_packed, g.keys_packed)
    assert np.array_equal(w.proxy, g.proxy)
    assert np.array_equal(w.packets, g.packets)
    assert np.array_equal(w.bytes, g.bytes)
