"""The PyTorch port's table builders and primitives against the JAX
package's, on the same inputs: every leaf np.array_equal, every static
field equal.  Inputs: the fused-datapath storm world's map states
(tools/chaos_storm.py _fused_world) and small cilium_tpu_torch.world
worlds handed to both packages."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

from cilium_tpu.compiler import tables as jtables
from cilium_tpu.ct import device as jct
from cilium_tpu.engine import hashtable as jhash
from cilium_tpu.engine import subword as jsw
from cilium_tpu.ipcache import lpm as jlpm
from cilium_tpu.lb import device as jlb
from cilium_tpu import prefilter as jpf
from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler import tables as ttables
from cilium_tpu_torch.ct import device as tct
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import hashtable as thash
from cilium_tpu_torch.engine import subword as tsw
from cilium_tpu_torch.ipcache import lpm as tlpm
from cilium_tpu_torch.lb import device as tlb
from cilium_tpu_torch import prefilter as tpf

from torch_parity import (
    SMALL,
    assert_same_leaves,
    chaos_storm,
    jax_host_tables,
    jax_inputs,
    jax_leaves,
    port_inputs,
)

_EDGES = np.array(
    [0, 1, 0xFF, 0x100, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
    np.uint32,
)


def _u32_sweep(seed, n):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [_EDGES, rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    )


@pytest.mark.parametrize("kw", [1, 2, 4])
def test_fnv1a_full_u32_range(kw):
    """The plain FNV-1a equals the host hash over the whole u32 range,
    the top of the range (where int32 bits are negative) included."""
    vals = _u32_sweep(kw, 1 << 14)
    words = np.stack([np.roll(vals, s) for s in range(kw)], axis=1)
    want = jhash._fnv1a_host(words)
    got = thash.fnv1a(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(thash._fnv1a_host(words), want)


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32])
def test_unpack_lanes_full_range(width):
    """pack/unpack at every supported width over the full field range
    (exhaustive below 16 bits; boundaries + a dense sample above),
    through the port's numpy and tensor unpacks, against the JAX
    package's numpy unpack."""
    if width <= 8:
        vals = np.arange(1 << width, dtype=np.uint64)
    else:
        vals = np.unique(np.concatenate([
            _EDGES.astype(np.uint64) & ((1 << width) - 1),
            _u32_sweep(width, 4096).astype(np.uint64) & ((1 << width) - 1),
        ]))
    for entries in (1, 7, 8, 16, 33):
        cols = np.resize(vals, (3, entries)).astype(np.uint32)
        packed = tsw.pack_lanes(cols, width)
        np.testing.assert_array_equal(packed, jsw.pack_lanes(cols, width))
        assert packed.shape[-1] == tsw.lanes_for(entries, width)
        assert tsw.lanes_for(entries, width) == jsw.lanes_for(entries, width)
        want = jsw.unpack_lanes_np(packed, width, entries)
        np.testing.assert_array_equal(tsw.unpack_lanes_np(packed, width, entries), want)
        got = tsw.unpack_lanes(torch.from_numpy(packed.view(np.int32)), width, entries)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    if width < 32:
        with pytest.raises(ValueError):
            tsw.pack_lanes(np.array([1 << width], np.uint32), width)
    for m in (0, 3, 15, 16, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF):
        assert tsw.width_for_max(m) == jsw.width_for_max(m)


def _compare_builders(states_j, states_t, ids, ipc_map, ct_j, ct_t, mgr_j,
                      mgr_t, prefilter, identity_pad, filter_pad):
    """Every builder of the slice, port vs JAX, chained as the
    datapath uses them."""
    pol_j = jtables.compile_map_states(
        states_j, ids, identity_pad=identity_pad, filter_pad=filter_pad
    )
    pol_t = ttables.compile_map_states(
        states_t, ids, identity_pad=identity_pad, filter_pad=filter_pad
    )
    assert_same_leaves(pol_t, pol_j, "compile_map_states")
    sub_j = jtables.repack_l4_subword(pol_j)
    sub_t = ttables.repack_l4_subword(pol_t)
    assert_same_leaves(sub_t, sub_j, "repack_l4_subword")
    assert_same_leaves(
        ttables.split_hot(sub_t), jtables.split_hot(sub_j), "split_hot"
    )

    ipc_j = jlpm.build_ipcache(ipc_map)
    ipc_t = tlpm.build_ipcache(ipc_map)
    assert_same_leaves(ipc_t, ipc_j, "build_ipcache")
    idx_j = jlpm.specialize_ipcache_to_idx(ipc_j, pol_j)
    idx_t = tlpm.specialize_ipcache_to_idx(ipc_t, pol_t)
    assert_same_leaves(idx_t, idx_j, "specialize_ipcache_to_idx")
    assert idx_t.l3_planes
    assert_same_leaves(
        tlpm.subword_ipcache(idx_t), jlpm.subword_ipcache(idx_j),
        "subword_ipcache",
    )

    snap_j = jct.compile_ct(ct_j)
    snap_t = tct.compile_ct(ct_t)
    assert_same_leaves(snap_t, snap_j, "compile_ct")
    for lanes in (tct.CT_COMPACT_LANES, 12):
        assert_same_leaves(
            tct.compact_ct_snapshot(snap_t, lanes=lanes),
            jct.compact_ct_snapshot(snap_j, lanes=lanes),
            f"compact_ct_snapshot[{lanes}]",
        )
    assert_same_leaves(
        tlb.compile_lb_inline(mgr_t), jlb.compile_lb_inline(mgr_j),
        "compile_lb_inline",
    )
    assert_same_leaves(
        tpf.build_prefilter(prefilter), jpf.build_prefilter(prefilter),
        "build_prefilter",
    )


@pytest.mark.parametrize("seed", [3, 11])
def test_builders_match_on_storm_world(seed):
    """_fused_world's map states, ipcache, CT, services and prefilter,
    converted to the port's objects."""
    storm = chaos_storm()
    _, parts = storm._fused_world(seed)
    t = port_inputs(parts["states"], parts["ct"], parts["mgr"])
    _compare_builders(
        parts["states"], t["states"], parts["ids"], parts["ipc_map"],
        parts["ct"], t["ct"], parts["mgr"], t["mgr"], ["9.9.9.0/24"],
        identity_pad=256, filter_pad=16,
    )


@pytest.mark.parametrize("seed", [1, 2])
def test_builders_match_on_port_world(seed):
    """A small cilium_tpu_torch.world world, converted to cilium_tpu
    objects."""
    w = world.make_world(seed=seed, **SMALL)
    j = jax_inputs(w)
    _compare_builders(
        j["states"], w.states, w.identity_ids, w.ipc_map, j["ct"], w.ct,
        j["mgr"], w.mgr, w.prefilter_cidrs, identity_pad=w.identity_pad,
        filter_pad=w.filter_pad,
    )
    # the world exercises what the headline path reads
    tables = world.headline_tables(w)
    assert len(tables.ipcache.range_class_plens) == 3
    assert tables.ipcache.value_width == 16
    assert tables.policy.port_slot is None


def test_narrow_lanes_spill_to_stashes():
    """Narrow rows force the L4 and CT overflow stashes to fill: the
    port's placement of the spill equals the reference's."""
    w = world.make_world(seed=4, **SMALL)
    jt = jax_host_tables(w, subword=False)
    tt = w.host_tables()
    l4_t = ttables.repack_l4_subword(tt.policy, lanes=4)
    l4_j = jtables.repack_l4_subword(jt.policy, lanes=4)
    assert_same_leaves(l4_t, l4_j, "repack_l4_subword[4]")
    assert l4_t.l4_hash_stash.shape[0] > 1
    ct_t = tct.compact_ct_snapshot(tt.ct, lanes=12)
    assert_same_leaves(ct_t, jct.compact_ct_snapshot(jt.ct, lanes=12), "ct[12]")
    assert ct_t.stash.shape[0] > 1


def test_refusals_match_reference():
    """Where the reference keeps a wide layout the port refuses the
    same way; where the reference falls back to DIR-24-8 (more than 512
    ranges for the ipcache, more than 128 CIDRs for the prefilter) the
    port builds the same tables."""
    w = world.make_world(seed=1, **SMALL)
    pol = w.host_tables().policy
    many = [type(w.states[0])(w.states[0]) for _ in range(300)]
    big = ttables.compile_map_states(many, w.identity_ids, identity_pad=256,
                                     filter_pad=16)
    with pytest.raises(ValueError, match="8-bit"):
        ttables.repack_l4_subword(big)
    with pytest.raises(ValueError):
        jtables.repack_l4_subword(
            jtables.compile_map_states(
                jax_inputs(w)["states"] * 75, w.identity_ids,
                identity_pad=256, filter_pad=16,
            )
        )
    ranges = {f"100.{a}.{b}.0/24": 5 for a in range(3) for b in range(200)}
    got = tlpm.build_ipcache(ranges)
    assert isinstance(got, tlpm.LPMTables)
    assert_same_leaves(got, jlpm.build_ipcache(ranges), "build_ipcache")
    cidrs = [f"100.{a}.0.0/16" for a in range(200)]
    got = tpf.build_prefilter(cidrs)
    assert isinstance(got, tlpm.LPMTables)
    assert_same_leaves(got, jpf.build_prefilter(cidrs), "build_prefilter")
    assert pol.l4_hash_rows is not None


def test_tables_from_numpy_carries_jax_tables():
    """convert.tables_from_numpy on the JAX tables' leaves gives the
    same device tables as the port's own builders."""
    w = world.make_world(seed=2, **SMALL)
    jt = jax_host_tables(w, subword=True)
    carried = convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    built = tdp.subword_datapath_tables(w.host_tables())
    assert_same_leaves(convert.tables_to(built, "cpu"), built, "tables_to")
    assert_same_leaves(carried, jt, "tables_from_numpy")
    leaves = jax_leaves(jt)
    leaves["ct"]["buckets"] = torch.zeros(1)
    with pytest.raises(TypeError, match="numpy"):
        convert.tables_from_numpy(leaves, device="cpu")
