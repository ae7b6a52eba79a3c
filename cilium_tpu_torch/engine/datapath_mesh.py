"""One datapath, one mesh: the fused IPv4 pipeline over partitioned N+1
tables (the reference's engine/datapath_mesh.py).

engine/datapath.py runs the fused pipeline (prefilter, LB/DNAT, CT,
ipcache, lattice) on one device with every table whole.  Here every
hashed bucket-row plane the pipeline gathers shards along the mesh's
table axis under the family rules of compiler/partition.py and joins
the N+1 replica placement: the CT bucket rows, the ipcache's /32 bucket
rows and range-class rows, the inline LB rows, and the policy's hashed
L4 rows and L3 words.  Each shard holds its slice and its left
neighbour's backup copy.

The reference runs `_fused_core` as one `shard_map` step with a
table-axis psum after each routed probe.  Here the step is four rounds
per batch row, each one launch per shard (DP_MESH_PROBE, csrc/
datapath_mesh.cu, or `dp_mesh_probe_plain` on the CPU), then one
combine per batch row (DP_MESH_COMBINE, or `dp_mesh_combine_plain`):

  S  (not for a static-ingress half) the CT bucket row of the original
     tuple, on its owner, probed for the service-scope key;
  L  (same) the inline LB row on its owner, with the service CT slave
     from S (the classic layout, replicated, is one full select);
  F  the flow-key CT probe against S's row, the routed ipcache bucket,
     one routed row per range class (or the [B, P] scan without them);
  P  the replica-aware lattice with `idx` and `known` from F
     (sharded.failover_lattice_parts);

and the combine: the lattice sum and `_combine`, the bpf_lxc combine,
the tunnel select, the 15 DatapathVerdicts columns, the counters
(l4_counts, l3_counts) and the [2, 20] telemetry row.

A round writes a partial record int32 per tuple, and the next round
(or the combine) reads its batch row's tp records and sums them: the
table-axis psum.  Row 0 of a record is flags (ORed), the other rows are
u32 values (summed).  Each owner writes its plane's masked parts, so
the sum is the single-device result; what every shard would compute
alike (the stashes, the scan, the wildcard probe, the derived
addresses and indices) shard 0 alone writes into its record.  A plane
the rules replicate (its rows do not split over tp) is owned by shard
0 alone for the same reason: its result is read once, not added up tp
times.  The F_REPLICA bit of a record is its own shard's: each round
ORs it into the shard's next record, so the combine counts (tuple,
shard) pairs served from a backup region, as the reference's
`replica_hits` does.

`DatapathStore` is the publication half: two device epochs of the
augmented tables (`MeshDatapath`), a row-diff delta or a change-scoped
publish into the spare, written by REPAIR_SCATTER on the card
(engine/publish.py route_repair and repair_scatter), the per-chip
repair of a readmitted chip, and the relayout window of a live reshard
(engine/reshard.py): `begin_relayout` stages the target mesh's layout in
the spare slot, every moved row zeroed, `relayout_scatter` streams the
moved rows in through REPAIR_SCATTER, a publish during the window patches
the live slot in place, and `cutover_relayout` flips the staged epoch
live and rebinds the store to the target mesh.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch import tracing
from cilium_tpu_torch.compiler import partition
from cilium_tpu_torch.device import MASK32, narrow, widen
from cilium_tpu_torch.engine.datapath import (
    DatapathTables,
    DatapathVerdicts,
    FlowBatch,
    flow_batch_from_packed,
    flow_batch_from_packed4,
    pack_flow_batch,
)
from cilium_tpu_torch.engine.mesh import NamedSharding, PartitionSpec as P
from cilium_tpu_torch.engine.mesh import place
from cilium_tpu_torch.engine.publish import (
    next_pow2,
    repair_scatter,
    route_repair,
)
from cilium_tpu_torch.engine.sharded import (
    _as_tensor,
    _routed_geom,
    failover_lattice_parts,
    fold_l3_aug,
    l3_counts,
    l4_counts,
)
from cilium_tpu_torch.maps.policymap import EGRESS, INGRESS

__all__ = [
    "DatapathStore",
    "MeshDatapath",
    "make_failover_datapath_evaluator",
    "make_failover_datapath_pair_evaluator",
]

ROUND_S, ROUND_L, ROUND_F, ROUND_P = 0, 1, 2, 3
RECORD_ROWS = (3, 5, 12, 10)
FORM_WORDS, FORM_PACKED4 = 0, 1  # flows [8, B] words or a packed4 half
F_REPLICA = 4  # every round: served from a backup region on this shard
S_FWD, S_REV = 1, 2  # round S: the service key's forward, reverse hit
L_FOUND = 1  # round L: a service with backends
F_CT_FWD, F_CT_REV, F_EXACT, F_CLASS0 = 1, 2, 8, 16  # round F; class c 16 << c
P_P1, P_P2, P_P3, P_KNOWN, P_MISS = 1, 2, 8, 16, 32  # round P


def _routed_rows(rows_l, bucket, ntp, my_col, alive_row, sharded,
                 n_global):
    """One routed bucket-row gather with N+1 replica fallback: the owner
    of each bucket's row (the backup owner, the next shard over, where
    `alive_row` says the primary is dead) reads its local row; every
    other shard gets a zero row.  A plane the rules replicate is owned by
    shard 0 alone (the reference's every shard, whose psum it skips).
    Returns (rows [B, lanes], owns bool [B], served_from_backup bool
    [B])."""
    if not sharded:
        owns = torch.full(bucket.shape, my_col == 0, dtype=torch.bool,
                          device=bucket.device)
        bl, rep = bucket, torch.zeros_like(owns)
    else:
        n = n_global // ntp
        p = bucket // n
        ap = alive_row[p]
        owner = torch.where(ap, p, (p + partition.REPLICA_BACKUP_OFFSET)
                            % ntp)
        owns = owner == my_col
        bl = ((bucket - p * n) + torch.where(ap, 0, n)).clamp(0, 2 * n - 1)
        rep = owns & ~ap
    rows = torch.zeros((int(bucket.shape[0]),) + tuple(rows_l.shape[1:]),
                       dtype=rows_l.dtype, device=rows_l.device)
    rows[owns] = rows_l[bl[owns]]
    return rows, owns, rep


def _geometry(dtables: DatapathTables) -> tuple:
    """The geometry the evaluators route by: any change (a hash plane
    regrown, a stash crossing a size class, another range-class
    schedule, a layout or sub-word width flip) rebuilds the evaluator
    and full-uploads the store."""
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice
    from cilium_tpu_torch.lb.device import LBInline

    ipc, lb = dtables.ipcache, dtables.lb
    dev = isinstance(ipc, IPCacheDevice)
    return (
        tuple(np.shape(dtables.ct.buckets)),
        type(ipc).__name__,
        tuple(np.shape(ipc.buckets)) if dev else (),
        None if not dev or ipc.range_rows is None
        else tuple(np.shape(ipc.range_rows)),
        tuple(ipc.range_class_plens) if dev else (),
        bool(getattr(ipc, "l3_planes", False)),
        int(getattr(ipc, "world_plus1", 0)),
        type(lb).__name__,
        tuple(np.shape(lb.rows)) if isinstance(lb, LBInline)
        else tuple(np.shape(lb.buckets)),
        type(dtables.prefilter).__name__,
        tuple(np.shape(dtables.policy.l4_hash_rows)),
        tuple(np.shape(dtables.policy.l3_allow_bits)),
        int(getattr(dtables.ct, "entry_words", 5)),
        (int(getattr(ipc, "bucket_entries", 0)),
         int(getattr(ipc, "value_width", 32)),
         int(getattr(ipc, "l3_width", 32)),
         tuple(getattr(ipc, "range_widths", ()) or ())) if dev else (),
        int(np.shape(dtables.policy.l4_hash_stash)[-1]),
        int(np.shape(dtables.policy.l4_wild_stash)[-1]),
    )


def _check_fused_world(dtables: DatapathTables) -> None:
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

    if dtables.policy.l4_hash_rows is None:
        raise ValueError(
            "fused mesh datapath requires the hashed L4 entry tables")
    ipc = dtables.ipcache
    if not isinstance(ipc, IPCacheDevice) or not ipc.values_are_idx:
        raise ValueError(
            "fused mesh datapath requires an idx-form IPCacheDevice "
            "(specialize_ipcache_to_idx); the DIR-24-8 fallback is "
            "host-compiled for range-heavy worlds only")


def _fused_geom(dtables: DatapathTables, ntp: int, table_axis: str) -> dict:
    """What the rounds route by (the reference's keys): per plane the
    global row count and whether the divisibility-checked rules shard
    it, the sub-word widths, the lattice geometry; plus the range-class
    schedule and the lattice's RouteGeom (`route`)."""
    from cilium_tpu_torch.lb.device import LBInline

    rep_axes = partition.datapath_replica_axes(dtables, ntp, table_axis)
    pol, ipc = dtables.policy, dtables.ipcache
    pol_axes = partition.replica_axes(pol, ntp, table_axis)
    rows_sharded = "l4_hash_rows" in pol_axes
    l3_sharded = "l3_allow_bits" in pol_axes
    _, route = _routed_geom(pol, ntp, table_axis, failover=True)
    w_global = int(np.shape(pol.l3_allow_bits)[-1])
    n_rows = int(np.shape(pol.l4_hash_rows)[0])
    lb_inline = isinstance(dtables.lb, LBInline)
    return {
        "ntp": ntp,
        "ct_sharded": ("ct", "buckets") in rep_axes,
        "ct_ew": int(getattr(dtables.ct, "entry_words", 5)),
        "range_widths": tuple(getattr(ipc, "range_widths", ()) or ()),
        "n_ct": int(np.shape(dtables.ct.buckets)[0]),
        "lb_inline": lb_inline,
        "lb_sharded": ("lb", "rows") in rep_axes,
        "n_lb": int(np.shape(dtables.lb.rows)[0]) if lb_inline else 0,
        "ipc_sharded": ("ipcache", "buckets") in rep_axes,
        "n_ipc": int(np.shape(ipc.buckets)[0]),
        "range_sharded": ("ipcache", "range_rows") in rep_axes,
        "n_range": (0 if ipc.range_rows is None
                    else int(np.shape(ipc.range_rows)[0])),
        "range_planes": 5 if ipc.l3_planes else 3,
        "world_plus1": int(ipc.world_plus1),
        "rows_sharded": rows_sharded,
        "l3_sharded": l3_sharded,
        "n_rows_global": n_rows,
        "n_row_shard": n_rows // ntp if rows_sharded else 0,
        "w_global": w_global,
        "wn": w_global // ntp if l3_sharded else 0,
        "n_ids": w_global * 32,
        "class_plens": tuple(int(p) for p in ipc.range_class_plens)
        if ipc.range_rows is not None else (),
        "route": route,
    }


# -- the tables on the mesh ---------------------------------------------------


@dataclass
class MeshDatapath:
    """A DatapathTables placed on a mesh: `shards` [dp, tp] holds each
    coordinate's DatapathTables, whose array leaves are its local
    blocks (coordinates on one device share a replicated leaf and a
    block); `shardings` the DatapathTables of NamedSharding; `shapes`
    each array leaf's global shape by (family, leaf)."""

    mesh: object
    shardings: DatapathTables
    shards: np.ndarray
    shapes: Dict[Tuple[str, str], tuple]

    def shard(self, b: int, t: int) -> DatapathTables:
        return self.shards[b, t]

    def leaf_shape(self, fam: str, name: str) -> Optional[tuple]:
        return self.shapes.get((fam, name))

    def chip_bytes(self) -> Dict[int, int]:
        """Bytes of the tensors each coordinate holds (shared or not)."""
        per = {}
        for coord in self.mesh.coords():
            total = 0
            for _, _, v in _table_leaves(self.shards[coord]):
                if isinstance(v, torch.Tensor):
                    total += v.numel() * v.element_size()
            per[self.mesh.chip(coord)] = total
        return per


def _table_leaves(dtables):
    """(family, leaf, value) of every leaf of a DatapathTables that the
    reference's pytree flattens (arrays and the policy's generation
    stamp), families in the reference's order."""
    for fam in ("prefilter", "ipcache", "ct", "lb", "policy", "tunnel"):
        obj = getattr(dtables, fam)
        if obj is None:
            continue
        for name in _family_leaf_names(obj):
            v = getattr(obj, name)
            if v is not None:
                yield fam, name, v


def place_datapath(tables: DatapathTables,
                   shardings: DatapathTables) -> MeshDatapath:
    """Host (numpy) or device tables placed leaf by leaf under
    `shardings`."""
    mesh = None
    placed: Dict[Tuple[str, str], np.ndarray] = {}
    shapes = {}
    cache: dict = {}
    for fam, name, leaf in _table_leaves(tables):
        sh = getattr(getattr(shardings, fam), name)
        mesh = sh.mesh
        placed[(fam, name)] = place(leaf, sh, cache)
        shapes[(fam, name)] = tuple(np.shape(leaf))
    shards = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        shards[coord] = _with_leaves(tables, {
            k: v[coord] for k, v in placed.items()})
    return MeshDatapath(mesh=mesh, shardings=shardings, shards=shards,
                        shapes=shapes)


def _with_leaves(dtables, leaves: Dict[Tuple[str, str], object]):
    """`dtables` with the (family, leaf) values of `leaves` set."""
    fams: Dict[str, dict] = {}
    for (fam, name), v in leaves.items():
        fams.setdefault(fam, {})[name] = v
    return dataclasses.replace(dtables, **{
        fam: dataclasses.replace(getattr(dtables, fam), **ups)
        for fam, ups in fams.items()})


def _placed(tables, shardings) -> MeshDatapath:
    """Host tables placed under `shardings`; an epoch already on the mesh
    must lie under them."""
    if not isinstance(tables, MeshDatapath):
        return place_datapath(tables, shardings)
    for fam, name in tables.shapes:
        want = getattr(getattr(shardings, fam), name)
        got = getattr(getattr(tables.shardings, fam), name)
        if got.mesh != want.mesh or tuple(got.spec) != tuple(want.spec):
            raise ValueError(
                f"tables placed with {fam}.{name} under {tuple(got.spec)!r}, "
                f"the evaluator takes {tuple(want.spec)!r} on its mesh")
    return tables


# -- the rounds and the combine, plain versions -------------------------------


def _flows(flows_t: torch.Tensor, form: int) -> FlowBatch:
    return (flow_batch_from_packed(flows_t) if form == FORM_WORDS
            else flow_batch_from_packed4(flows_t))


def _ingress(f: FlowBatch, static_dir):
    if static_dir is None:
        return f.direction == INGRESS
    return torch.full_like(f.direction, static_dir == INGRESS,
                           dtype=torch.bool)


def _psum(prev):
    """The table-axis sum of a round's records: (flags ORed, the value
    rows summed as u32), int64."""
    flags = widen(prev[0][0])
    vals = widen(prev[0][1:])
    for p in prev[1:]:
        flags = flags | widen(p[0])
        vals = (vals + widen(p[1:])) & MASK32
    return flags, vals


def _own_replica(prev, t: int):
    return (widen(prev[t][0]) & F_REPLICA) != 0


def _record(flags, *rows) -> torch.Tensor:
    return torch.stack([narrow(flags)] + [narrow(r) for r in rows])


def _as_i32(u):
    """u32 values (int64) as the int32 values they hold."""
    return narrow(u).to(torch.int64)


def _ct_bucket(f: FlowBatch, n_ct: int):
    from cilium_tpu_torch.ct.device import _normalize
    from cilium_tpu_torch.engine.hashtable import fnv1a

    lo_a, hi_a, lo_p, hi_p, _ = _normalize(f.daddr, f.saddr, f.dport, f.sport)
    h = fnv1a(torch.stack([lo_a, hi_a, (lo_p << 16) | hi_p,
                           widen(f.proto) & 0xFF], dim=1))
    return h & (n_ct - 1)


def _ct_parts(tab, rows, owns, f: FlowBatch, daddr, dport, direction,
              t: int, g: dict):
    """One routed CT probe's parts: the owner's row parts, plus on shard
    0 the stash's.  Returns (fwd_found, rev_found, fwd_val, rev_val)."""
    from cilium_tpu_torch.ct.device import (
        ct_probe_keys,
        ct_probe_row_parts,
        ct_probe_stash_parts,
    )

    keys = ct_probe_keys(daddr, f.saddr, dport, f.sport, f.proto, direction)
    rf, rr, rfv, rrv = ct_probe_row_parts(rows, *keys[:5], owns=owns,
                                          entry_words=g["ct_ew"])
    if t == 0:
        sf, sr, sfv, srv = ct_probe_stash_parts(tab.ct, *keys[:5])
        rf, rr = rf | sf, rr | sr
        rfv, rrv = (rfv + sfv) & MASK32, (rrv + srv) & MASK32
    return rf, rr, rfv, rrv


def _ct_result(ff, rf, fv, rv):
    """ct_probe_combine of summed parts (no RELATED probe): (result u8,
    rev_nat, slave)."""
    from cilium_tpu_torch.ct.device import ct_probe_combine

    return ct_probe_combine(ff, rf, fv, rv, torch.zeros_like(ff))


def _round_s(tab, f, prev, alive_row, t, g, static_dir):
    from cilium_tpu_torch.ct.table import CT_SERVICE

    rows, owns, rep = _routed_rows(
        tab.ct.buckets, _ct_bucket(f, g["n_ct"]), g["ntp"], t, alive_row,
        g["ct_sharded"], g["n_ct"])
    ff, rf, fv, rv = _ct_parts(tab, rows, owns, f, f.daddr, f.dport,
                               torch.full_like(f.direction, CT_SERVICE), t, g)
    flags = ff.long() * S_FWD | rf.long() * S_REV | rep.long() * F_REPLICA
    return _record(flags, fv, rv)


def _round_l(tab, f, prev, alive_row, t, g, static_dir):
    from cilium_tpu_torch.engine.hashtable import fnv1a
    from cilium_tpu_torch.lb.device import (
        flow_hash,
        lb_inline_slot,
        lb_inline_stash_slot,
        lb_select_batch,
        lb_service_key,
        lb_slot_outputs,
    )

    flags, vals = _psum(prev)
    _, _, svc_slave = _ct_result((flags & S_FWD) != 0, (flags & S_REV) != 0,
                                 vals[0], vals[1])
    zero = torch.zeros_like(f.saddr)
    rep = torch.zeros_like(f.saddr, dtype=torch.bool)
    found = rep
    out = [zero, zero, zero, zero]
    if g["lb_inline"]:
        vip, w1 = lb_service_key(f.daddr, f.dport, f.proto)
        fh = flow_hash(f.saddr, f.daddr, f.sport, f.dport, f.proto)
        bucket = fnv1a(torch.stack([vip, w1], dim=1)) & (g["n_lb"] - 1)
        rows, owns, rep = _routed_rows(
            tab.lb.rows, bucket, g["ntp"], t, alive_row, g["lb_sharded"],
            g["n_lb"])
        slot, row_found = lb_inline_slot(rows, vip, w1, owns=owns)
        found, *out = lb_slot_outputs(slot, row_found, fh,
                                      ct_slave=svc_slave)
        if t == 0:
            s_slot, s_found = lb_inline_stash_slot(tab.lb, vip, w1)
            f_s, *out_s = lb_slot_outputs(s_slot, s_found, fh,
                                          ct_slave=svc_slave)
            found = found | f_s
            out = [(widen(a) + widen(b)) & MASK32 for a, b in zip(out, out_s)]
    elif t == 0:
        # the classic layout replicates whole: one full select, on shard 0
        found, *out = lb_select_batch(tab.lb, f.saddr, f.daddr, f.sport,
                                      f.dport, f.proto, ct_slave=svc_slave)
    rep = rep | _own_replica(prev, t)
    return _record(found.long() * L_FOUND | rep.long() * F_REPLICA,
                   *(widen(o) for o in out))


def _range_parts(tab, sec_ip, alive_row, t, g):
    """The range classes' parts of one shard: [(hit, val)] per class
    (the owner's row parts), or without range rows the [B, P] scan's
    (found, value) as one class, on shard 0.  Returns (classes, served
    from a backup region)."""
    from cilium_tpu_torch.ipcache.lpm import (
        _range_scan,
        range_class_key,
        range_row_parts,
    )

    ipc = tab.ipcache
    rep = torch.zeros_like(sec_ip, dtype=torch.bool)
    zero = torch.zeros_like(sec_ip)
    if g["n_range"] == 0:
        if t != 0:
            return [(rep, zero)], rep
        found, val, _, _ = _range_scan(ipc, sec_ip)
        return [(found, torch.where(found, val, 0))], rep
    classes = []
    for sp in g["class_plens"]:
        w0, h = range_class_key(sec_ip, sp)
        rows, owns, rep_c = _routed_rows(
            ipc.range_rows, h & (g["n_range"] - 1), g["ntp"], t, alive_row,
            g["range_sharded"], g["n_range"])
        hit, val, _, _ = range_row_parts(rows, w0, sp, g["range_planes"],
                                         owns=owns, widths=g["range_widths"])
        classes.append((hit, val))
        rep = rep | rep_c
    return classes, rep


def _round_f(tab, f, prev, alive_row, t, g, static_dir):
    from cilium_tpu_torch.engine.hashtable import fnv1a
    from cilium_tpu_torch.ipcache.lpm import (
        ipcache_bucket_parts,
        ipcache_stash_parts,
    )

    ingress = _ingress(f, static_dir)
    eff_daddr, eff_dport = widen(f.daddr), f.dport
    zero = torch.zeros_like(f.saddr)
    rev_nat = lb_slave = zero
    rep = torch.zeros_like(ingress)
    if static_dir != INGRESS:
        flags, vals = _psum(prev)
        do_lb = ~ingress & ((flags & L_FOUND) != 0)
        eff_daddr = torch.where(do_lb, vals[1], eff_daddr)
        eff_dport = torch.where(do_lb, _as_i32(vals[2]), eff_dport)
        rev_nat = torch.where(do_lb, vals[3], 0)
        lb_slave = torch.where(do_lb, vals[0], 0)
        rep = _own_replica(prev, t)
    rows, owns, rep_ct = _routed_rows(
        tab.ct.buckets, _ct_bucket(f, g["n_ct"]), g["ntp"], t, alive_row,
        g["ct_sharded"], g["n_ct"])
    cf, cr, cfv, crv = _ct_parts(tab, rows, owns, f, eff_daddr, eff_dport,
                                 f.direction, t, g)
    ipc = tab.ipcache
    sec_ip = torch.where(ingress, widen(f.saddr), eff_daddr)
    bucket = fnv1a(sec_ip[:, None]) & (g["n_ipc"] - 1)
    rows, owns, rep_ip = _routed_rows(
        ipc.buckets, bucket, g["ntp"], t, alive_row, g["ipc_sharded"],
        g["n_ipc"])
    bf, bv, _ = ipcache_bucket_parts(ipc, rows, sec_ip, ingress=ingress,
                                     owns=owns)
    if t == 0:
        sf, sv, _ = ipcache_stash_parts(ipc, sec_ip, ingress=ingress)
        bf, bv = bf | sf, (bv + sv) & MASK32
    classes, rep_r = _range_parts(tab, sec_ip, alive_row, t, g)
    rep = rep | rep_ct | rep_ip | rep_r
    flags = (cf.long() * F_CT_FWD | cr.long() * F_CT_REV
             | rep.long() * F_REPLICA | bf.long() * F_EXACT)
    vals = [zero] * 4
    for c, (hit, val) in enumerate(classes):
        flags = flags | hit.long() * (F_CLASS0 << c)
        vals[c] = val
    head = (eff_daddr, eff_dport, rev_nat, lb_slave)
    if t != 0:
        head = (zero,) * 4
    return _record(flags, cfv, crv, bv, *vals, *head)


def _round_p(tab, f, prev, alive_row, t, g, static_dir):
    from cilium_tpu_torch.ipcache.lpm import UNKNOWN_IDX, range_take_fold

    flags, vals = _psum(prev)
    ct_res, _, _ = _ct_result((flags & F_CT_FWD) != 0,
                              (flags & F_CT_REV) != 0, vals[0], vals[1])
    exact_found = (flags & F_EXACT) != 0
    n_classes = max(len(g["class_plens"]), 1)
    zero = torch.zeros_like(vals[2])
    classes = [((flags & (F_CLASS0 << c)) != 0, vals[3 + c], zero, zero)
               for c in range(n_classes)]
    range_found, range_val, _, _ = range_take_fold(classes, zero)
    looked = torch.where(exact_found, vals[2],
                         torch.where(range_found, range_val, 0))
    n_pad = int(tab.policy.id_table.shape[0])
    miss = looked == 0
    vp = torch.where(miss, g["world_plus1"], looked)
    known = (vp != 0) & (vp != int(UNKNOWN_IDX))
    idx = torch.where(known, vp - 1, n_pad - 1)
    eff_daddr, eff_dport = vals[7], _as_i32(vals[8])
    lat = failover_lattice_parts(
        tab.policy, f.ep_index, f.direction, eff_dport.clamp(0, 65535),
        f.proto.clamp(0, 255), idx, known, g["route"], t, alive_row,
        solo=True)
    head = t == 0
    found = lat["found"] | (lat["s_found"] & head)
    val = (lat["val"] + torch.where(lat["s_found"] & head, lat["s_val"], 0)
           ) & MASK32
    rep = _own_replica(prev, t) | lat["replica"]
    flags_p = (found.long() * P_P1 | lat["p2"].long() * P_P2
               | rep.long() * F_REPLICA)
    if head:
        flags_p = (flags_p | lat["hit3"].long() * P_P3
                   | known.long() * P_KNOWN | miss.long() * P_MISS)
        tail = (lat["val3"], idx, ct_res.to(torch.int64), eff_daddr,
                eff_dport, vals[9], vals[10])
    else:
        tail = (zero,) * 7
    lcol = torch.where(lat["p2"], lat["lcol"], 0)
    return _record(flags_p, val, tail[0], lcol, *tail[1:])


_ROUNDS = (_round_s, _round_l, _round_f, _round_p)


def dp_mesh_probe_plain(rnd: int, tab: DatapathTables, flows: torch.Tensor,
                        form: int, prev, alive_row: torch.Tensor, t: int,
                        g: dict, static_dir=None) -> torch.Tensor:
    """DP_MESH_PROBE's plain version: shard t's step of round `rnd`
    (ROUND_S, _L, _F, _P) for one batch row.  `tab` is the shard's
    DatapathTables (its local blocks), `flows` the row's flows (int32
    [8, B] words, or a packed4 half [4, B] with `form` FORM_PACKED4),
    `prev` the previous round's tp records of the row (None for the
    first), `alive_row` the row's chip health bool [tp], `static_dir`
    None (each flow its own direction), INGRESS or EGRESS.  Returns the
    shard's record int32 [RECORD_ROWS[rnd], B]."""
    return _ROUNDS[rnd](tab, _flows(flows, form), prev, alive_row, t, g,
                        static_dir)


def dp_mesh_combine_plain(parts, tab: DatapathTables, flows: torch.Tensor,
                          form: int, g: dict, valid=None, static_dir=None,
                          telemetry: bool = True):
    """DP_MESH_COMBINE's plain version: one batch row's tp round-P
    records (on the row's device) and shard 0's tables -> (the 15
    DatapathVerdicts columns, l4 [E, 2, Kg], l3 [E, 2, l3_shards *
    c_local], telemetry [2, 20] or None, the (tuple, shard) pairs served
    from a backup region [] int32), counters as u32 bits in int32, all
    masked by `valid` [B] where given."""
    from cilium_tpu_torch.compiler.tables import l4_entry_words
    from cilium_tpu_torch.ct.table import (
        CT_ESTABLISHED,
        CT_NEW,
        CT_RELATED,
        CT_REPLY,
    )
    from cilium_tpu_torch.engine.verdict import (
        _combine,
        _gather_ix,
        l4hash_value_decode,
        telemetry_masks,
    )
    from cilium_tpu_torch.prefilter import prefilter_drop
    from cilium_tpu_torch.tunnel import tunnel_select

    f = _flows(flows, form)
    pol, route = tab.policy, g["route"]
    ep, dirn = f.ep_index.to(torch.int64), f.direction.to(torch.int64)
    flags = [widen(p[0]) for p in parts]
    any_f = flags[0]
    val1 = torch.zeros_like(any_f)
    for fl, p in zip(flags, parts):
        any_f = any_f | fl
        val1 = (val1 + widen(p[1])) & MASK32
    head = parts[0]
    p1 = ((flags[0] & P_KNOWN) != 0) & ((any_f & P_P1) != 0)
    p2 = (any_f & P_P2) != 0
    p3 = (flags[0] & P_P3) != 0
    proxy, j = l4hash_value_decode(pol, ep, dirn, p1, val1, p3,
                                   widen(head[2]), l4_entry_words(pol))
    pol_allow, v_proxy, kind = _combine(p1, p2, p3, proxy, f.is_fragment)
    ok = (torch.ones_like(p1) if valid is None
          else valid.to(device=p1.device, dtype=torch.bool))
    l4 = l4_counts(pol, ep, dirn, kind, j, ok)
    l3 = l3_counts(pol, ep, dirn, kind, [(fl & P_P2) != 0 for fl in flags],
                   [p[3] for p in parts], ok, route)

    idx = widen(head[4])
    ct_res = head[5].to(torch.uint8)
    eff_daddr, eff_dport = widen(head[6]), head[7].to(torch.int64)
    rev_nat, lb_slave = head[8].to(torch.int64), head[9].to(torch.int64)
    miss = (flags[0] & P_MISS) != 0
    ingress = _ingress(f, static_dir)
    pre_drop = prefilter_drop(tab.prefilter, f.saddr)
    pass_ct = (ct_res == CT_REPLY) | (ct_res == CT_RELATED)
    allowed = ~pre_drop & (pass_ct | pol_allow)
    ct_delete = (ct_res == CT_ESTABLISHED) & ~pol_allow & ~pass_ct & ~pre_drop
    ct_create = (ct_res == CT_NEW) & allowed
    proxy_out = torch.where(
        pol_allow & ((ct_res == CT_NEW) | (ct_res == CT_ESTABLISHED))
        & allowed, v_proxy, 0)
    if tab.tunnel is not None and static_dir != INGRESS:
        tunnel_ep = torch.where(allowed & ~ingress,
                                tunnel_select(tab.tunnel, eff_daddr), 0)
    else:
        tunnel_ep = torch.zeros_like(eff_daddr)
    n_pad = int(pol.id_table.shape[0])
    out = DatapathVerdicts(
        allowed=allowed.to(torch.uint8),
        proxy_port=proxy_out.to(torch.int32),
        match_kind=kind,
        ct_result=ct_res,
        pre_dropped=pre_drop,
        sec_id=pol.id_table[_gather_ix(_as_i32(idx), n_pad)],
        final_daddr=narrow(eff_daddr),
        final_dport=eff_dport.to(torch.int32),
        rev_nat=rev_nat.to(torch.int32),
        lb_slave=lb_slave.to(torch.int32),
        ct_create=ct_create,
        ct_delete=ct_delete,
        tunnel_endpoint=narrow(tunnel_ep),
        l4_slot=j.to(torch.int32),
        ipcache_miss=miss,
    )
    served = torch.zeros((), dtype=torch.int64, device=p1.device)
    for fl in flags:
        served = served + (((fl & F_REPLICA) != 0) & ok).sum()
    trow = None
    if telemetry:
        masks = telemetry_masks(pre_drop, ct_res, kind, allowed, ct_delete,
                                proxy_out, lb_slave, miss)
        ing_v = ingress & ok
        row_in = torch.stack([(m & ing_v).sum() for m in masks])
        total = torch.stack([(m & ok).sum() for m in masks])
        trow = narrow(torch.stack([row_in, total - row_in]))
    return out, l4, l3, trow, narrow(served)


# -- dispatch: the kernel on a CUDA device, the plain version on the CPU ----


def _probe(rnd, tab, flows, form, prev, alive_row, t, g, static_dir):
    if flows.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DP_MESH_PROBE(rnd, tab, flows, form, prev, alive_row,
                                     t, g, static_dir)
    return dp_mesh_probe_plain(rnd, tab, flows, form, prev, alive_row, t, g,
                               static_dir)


def _combine_row(parts, tab, flows, form, g, valid, static_dir, telemetry):
    if flows.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DP_MESH_COMBINE(parts, tab, flows, form, g, valid,
                                       static_dir, telemetry)
    return dp_mesh_combine_plain(parts, tab, flows, form, g, valid,
                                 static_dir, telemetry)


def _on(cache: dict, x: torch.Tensor, dev) -> torch.Tensor:
    """`x` on `dev`, contiguous, once per device."""
    key = str(dev)
    if key not in cache:
        cache[key] = x.to(dev).contiguous()
    return cache[key]


def _fused_core(md: MeshDatapath, b: int, flows: torch.Tensor, form: int,
                valid, alive_row: torch.Tensor, g: dict, static_dir,
                telemetry: bool):
    """The reference's `_fused_core` for batch row `b`, one coordinate at
    a time: rounds S and L (not for a static-ingress half), F and P, one
    probe per shard each (each round's records are the next one's psum),
    then the combine on the row's first device.  Returns the combine's
    (DatapathVerdicts, l4, l3, telemetry row or None, replica pairs)."""
    mesh = md.mesh
    tp = mesh.devices.shape[1]
    rounds = ((ROUND_F, ROUND_P) if static_dir == INGRESS
              else (ROUND_S, ROUND_L, ROUND_F, ROUND_P))
    fl, al = {}, {}
    prev = None
    for rnd in rounds:
        recs = []
        for t in range(tp):
            dev = mesh.devices[b, t]
            here = None if prev is None else [
                p if p.device == dev else p.to(dev) for p in prev]
            recs.append(_probe(rnd, md.shard(b, t), _on(fl, flows, dev), form,
                               here, _on(al, alive_row, dev), t, g,
                               static_dir))
        prev = recs
    row_dev = mesh.devices[b, 0]
    parts = [p if p.device == row_dev else p.to(row_dev) for p in prev]
    v = None if valid is None else _on({}, valid, row_dev)
    return _combine_row(parts, md.shard(b, 0), _on(fl, flows, row_dev), form,
                        g, v, static_dir, telemetry)


def _split(x: torch.Tensor, dp: int, what: str):
    n = int(x.shape[-1])
    if n % dp:
        raise ValueError(f"a batch of {n} {what} does not split over {dp} "
                         f"batch shards")
    k = n // dp
    return [x[..., b * k:(b + 1) * k] for b in range(dp)]


def _alive_rows(alive, dp: int, tp: int) -> torch.Tensor:
    a = _as_tensor(alive, torch.bool, torch.device("cpu"))
    if tuple(a.shape) != (dp, tp):
        raise ValueError(f"alive must be [{dp}, {tp}]")
    return a


def _gather_rows(outs, home, g: dict):
    """The rows' combines -> (DatapathVerdicts, l4, l3 global, replica
    hits, telemetry rows [dp, 2, 20] or None)."""
    v = DatapathVerdicts(**{
        c.name: torch.cat([getattr(o[0], c.name).to(home) for o in outs])
        for c in dataclasses.fields(DatapathVerdicts)})
    l4 = narrow(torch.stack([o[1].to(home) for o in outs]).sum(
        dim=0, dtype=torch.int64))
    l3 = narrow(torch.stack([o[2].to(home) for o in outs]).sum(
        dim=0, dtype=torch.int64))
    if g["l3_sharded"]:
        l3 = narrow(widen(fold_l3_aug(widen(l3), g["ntp"])))
    hits = narrow(torch.stack([o[4].to(home) for o in outs]).to(
        torch.int64).sum())
    trows = (None if outs[0][3] is None
             else torch.stack([o[3].to(home) for o in outs]))
    return v, l4, l3, hits, trows


def _check_rows(md: MeshDatapath, g: dict) -> None:
    got = md.leaf_shape("policy", "l4_hash_rows")[0]
    want = g["n_rows_global"] * (2 if g["rows_sharded"] else 1)
    if got != want:
        raise ValueError(
            f"fused datapath evaluator was built for another table "
            f"geometry (hash rows {want} != {got}); rebuild with "
            f"make_failover_datapath_evaluator")


def _evaluator_setup(mesh, dtables, batch_axis, table_axis):
    _check_fused_world(dtables)
    ntp = int(mesh.shape[table_axis])
    dp = int(mesh.shape[batch_axis])
    g = _fused_geom(dtables, ntp, table_axis)
    # the augmented leaves split as the un-augmented ones do
    shardings = partition.datapath_table_shardings(mesh, dtables, table_axis)
    return dp, ntp, g, shardings


def make_failover_datapath_evaluator(mesh, dtables: DatapathTables,
                                     batch_axis: str = "batch",
                                     table_axis: str = "table",
                                     collect_telemetry: bool = False):
    """The fused failover datapath over the N+1 augmented tables
    (partition.replicate_datapath_leaves), with the failover lattice's
    two routing inputs: `alive` bool [dp, tp] chip health and `valid`
    bool [B] (the router's re-split filler is not valid).

    Returns run(tables_aug, flows, alive, valid) -> (DatapathVerdicts,
    l4_counts [E, 2, Kg], l3_counts [E, 2, N] global (fold_l3_aug
    applied), replica_hits [] int32 (valid (tuple, shard) pairs served
    from a backup region)[, per-chip telemetry [dp, 2, 20]]), counters
    as u32 bits in int32: equal on the valid tuples to the
    single-device fused program (`datapath_step_with_counters`, sec_id
    the identity) whatever the survivor set, as long as one owner of
    every slice is alive.  `tables_aug` is a MeshDatapath (the store's
    epoch) or host augmented tables (placed per call); `flows` a
    FlowBatch or an int32 [8, B] word pack, B a multiple of dp; `valid`
    None takes every flow as valid.  `dtables` (un-augmented) fix the
    geometry."""
    dp, ntp, g, shardings = _evaluator_setup(mesh, dtables, batch_axis,
                                             table_axis)

    def run(tables_aug, flows, alive, valid=None):
        md = _placed(tables_aug, shardings)
        _check_rows(md, g)
        packed = flows if isinstance(flows, torch.Tensor) else (
            pack_flow_batch(flows))
        if packed.dim() != 2 or packed.shape[0] != 8:
            raise ValueError("flows must be a FlowBatch or [8, B] words")
        rows = _split(packed, dp, "flows")
        vrows = None if valid is None else _split(
            _as_tensor(valid, torch.bool, packed.device), dp, "valid flags")
        alive_t = _alive_rows(alive, dp, ntp)
        outs = [_fused_core(md, b, rows[b], FORM_WORDS,
                          None if vrows is None else vrows[b], alive_t[b], g,
                          None, collect_telemetry)
                for b in range(dp)]
        v, l4, l3, hits, trows = _gather_rows(outs, mesh.devices[0, 0], g)
        out = (v, l4, l3, hits)
        return out + ((trows,) if collect_telemetry else ())

    run.geometry = _geometry(dtables)
    run.geom = g
    run.shardings = shardings
    return run


def make_failover_datapath_pair_evaluator(mesh, dtables: DatapathTables,
                                          batch_axis: str = "batch",
                                          table_axis: str = "table",
                                          collect_telemetry: bool = True):
    """The packed4 pair shape of the fused failover datapath: a [2, 4, B]
    pair (half 0 the ingress half, run with no service CT probe and no
    LB, as datapath_step_accum_ingress runs it; half 1 the egress half)
    in one call, counters and telemetry over both halves.

    Returns run(tables_aug, pair, alive, valid [2, B]) -> (out_ingress,
    out_egress, l4_counts, l3_counts (global), replica_hits[, telemetry
    rows [dp, 2, 20] over both halves]); sec_id is the identity, as the
    reference's pair program writes it."""
    dp, ntp, g, shardings = _evaluator_setup(mesh, dtables, batch_axis,
                                             table_axis)

    def run(tables_aug, pair, alive, valid=None):
        md = _placed(tables_aug, shardings)
        _check_rows(md, g)
        pair_t = pair if isinstance(pair, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(pair).astype(np.uint32)).view(
                np.int32))
        if pair_t.dim() != 3 or tuple(pair_t.shape[:2]) != (2, 4):
            raise ValueError(f"pair must be [2, 4, B], got "
                             f"{tuple(pair_t.shape)}")
        alive_t = _alive_rows(alive, dp, ntp)
        vt = None if valid is None else _as_tensor(valid, torch.bool,
                                                   pair_t.device)
        halves = []
        for h, static_dir in ((0, INGRESS), (1, EGRESS)):
            rows = _split(pair_t[h], dp, "flows")
            vrows = None if vt is None else _split(vt[h], dp, "valid flags")
            halves.append([
                _fused_core(md, b, rows[b], FORM_PACKED4,
                          None if vrows is None else vrows[b], alive_t[b], g,
                          static_dir, collect_telemetry)
                for b in range(dp)])
        home = mesh.devices[0, 0]
        vi, l4i, l3i, hi, ti = _gather_rows(halves[0], home, g)
        ve, l4e, l3e, he, te = _gather_rows(halves[1], home, g)
        out = (vi, ve, narrow(widen(l4i) + widen(l4e)),
               narrow(widen(l3i) + widen(l3e)),
               narrow(hi.to(torch.int64) + he.to(torch.int64)))
        if collect_telemetry:
            out = out + (narrow(widen(ti) + widen(te)),)
        return out

    run.geometry = _geometry(dtables)
    run.geom = g
    run.shardings = shardings
    return run


# -- publication: the datapath epochs and their row-diff delta ----------------


@dataclass
class DatapathPublishStats:
    epoch: int
    mode: str  # "full" | "delta" | "delta-scoped"
    bytes_h2d: int
    seconds: float
    scattered_rows: int = 0
    replaced_leaves: int = 0


def _nbytes(tree) -> int:
    return sum(int(np.asarray(v).nbytes) for _, _, v in _table_leaves(tree))


class DatapathStore:
    """Two device epochs of the fused datapath over the partitioned N+1
    layout, ping-ponging as the policy plane's DeviceTableStore does: a
    publish lands in the spare slot while batches dispatched against the
    current one finish on it, then the slots flip.

    Publication is a row diff: each sharded plane's new augmented host
    rows are compared with the spare slot's retained snapshot and only
    the changed rows are written (in augmented coordinates, so a row's
    primary and backup copies stay equal), by REPAIR_SCATTER on the
    card, one segment per leaf and block; a replicated leaf is placed
    again only when it changed.  A geometry or partitioning change
    uploads in full, and the caller rebuilds the evaluator, which
    closes over the same geometry.  A change record (`publish(...,
    changes=)`) scopes the diff to the rows it names."""

    def __init__(self, mesh, table_axis: str = "table") -> None:
        self.mesh = mesh
        self.table_axis = table_axis
        self.ntp = int(mesh.shape[table_axis])
        self.partition_digest = partition.datapath_partition_digest(
            table_axis, ntp=self.ntp)
        self._lock = threading.Lock()
        # each slot: {"dev": MeshDatapath, "host": augmented host tables
        # (the diff base and the repair's source), "geom", "digest",
        # "epoch"}
        self._slots: List[Optional[dict]] = [None, None]
        self._cur = 0
        self.epoch = 0
        self._shardings = None
        # per-epoch change records (None: that publish was full-diffed)
        self._change_log: Dict[int, object] = {}
        # the open relayout window (begin_relayout): the spare slot holds
        # the target layout, and publish() patches the live slot
        self._relayout: Optional[dict] = None

    # -- internals -----------------------------------------------------------

    def _full_place(self, aug: DatapathTables):
        self._shardings = partition.datapath_table_shardings(
            self.mesh, aug, self.table_axis)
        dev = place_datapath(aug, self._shardings)
        _sync(self.mesh)
        return dev, _nbytes(aug)

    def _scatter(self, dev: MeshDatapath, payloads) -> None:
        """Write `payloads` into the epoch `dev` in place (`segments`),
        REPAIR_SCATTER on the card, the devices synchronized before and
        after."""
        from cilium_tpu_torch.kernels import MAX_SCATTER_SEGMENTS

        by_dev = segments(dev, payloads)
        _sync(dev.mesh)
        for segs in by_dev.values():
            for k in range(0, len(segs), MAX_SCATTER_SEGMENTS):
                repair_scatter(segs[k:k + MAX_SCATTER_SEGMENTS])
        _sync(dev.mesh)

    def _replace(self, dev: MeshDatapath, fam: str, name: str, arr) -> None:
        """Place a changed replicated (or whole) leaf anew into `dev`."""
        sharding = getattr(getattr(dev.shardings, fam), name, None)
        if not isinstance(sharding, NamedSharding):
            sharding = NamedSharding(dev.mesh, P())
        blocks = place(arr, sharding)
        for coord in dev.mesh.coords():
            dev.shards[coord] = _with_leaves(dev.shards[coord],
                                             {(fam, name): blocks[coord]})
        dev.shapes[(fam, name)] = tuple(np.shape(arr))

    # -- API -----------------------------------------------------------------

    def publish(self, dtables: DatapathTables, changes=None
                ) -> Tuple[MeshDatapath, DatapathPublishStats]:
        """Install `dtables` (host, un-augmented) as the serving datapath
        epoch, into the spare slot, then flip.  Steady-state churn (CT
        write-back, ipcache upserts, LB backend flips, policy deltas)
        rides the row diff against the spare's retained snapshot; a
        geometry change uploads in full.

        `changes` is an optional change record, {family: {leaf: row
        index array (of the un-augmented sharded axis) | True}}: the
        diff then compares only the rows named (True re-places the
        leaf), and the caller warrants every other leaf unchanged since
        the previous publish.  Records are logged per epoch so the
        ping-pong unions the ones since the spare's epoch; a record-less
        publish in between falls back to the full diff."""
        _check_fused_world(dtables)
        with self._lock, tracing.tracer.span(
                "datapath.publish", site="engine.datapath_mesh") as sp:
            t0 = time.perf_counter()
            geom = _geometry(dtables)
            self.epoch += 1
            self._change_log[self.epoch] = changes
            for e in list(self._change_log):
                if e <= self.epoch - 8:
                    del self._change_log[e]
            if self._relayout is not None and not self._relayout["broken"]:
                # the spare slot is the staged reshard target: the churn
                # lands on the live slot
                dev, stats = self._publish_relayout_locked(dtables, geom, sp)
                stats.seconds = time.perf_counter() - t0
                return dev, stats
            spare_i = self._cur ^ 1
            spare = self._slots[spare_i]
            union = (None if spare is None
                     else self._union_changes(spare.get("epoch", 0)))
            if (spare is None or geom != spare["geom"]
                    or spare["digest"] != self.partition_digest):
                aug = partition.replicate_datapath_leaves(
                    dtables, self.ntp, self.table_axis)
                dev, nbytes = self._full_place(aug)
                stats = DatapathPublishStats(epoch=self.epoch, mode="full",
                                             bytes_h2d=nbytes, seconds=0.0)
                slot = self._slot(dev, aug, geom)
            elif union is not None:
                dev, stats = self._publish_scoped(dtables, spare, union)
                slot = dict(spare, dev=dev, geom=geom, epoch=self.epoch)
            else:
                aug = partition.replicate_datapath_leaves(
                    dtables, self.ntp, self.table_axis)
                dev, stats = self._publish_delta(aug, spare)
                slot = self._slot(dev, aug, geom)
            self._slots[spare_i] = slot
            self._cur = spare_i
            stats.seconds = time.perf_counter() - t0
            sp.attrs.update(mode=stats.mode, epoch=stats.epoch,
                            bytes_h2d=stats.bytes_h2d,
                            scattered_rows=stats.scattered_rows)
            return dev, stats

    def _slot(self, dev, aug, geom) -> dict:
        """A slot of the store's current layout."""
        return {"dev": dev, "host": aug, "geom": geom,
                "digest": self.partition_digest, "epoch": self.epoch,
                "ntp": self.ntp}

    def _publish_relayout_locked(self, dtables, geom, sp):
        """A publish while a relayout window is open (the caller holds the
        lock): the live slot takes the churn through the row diff,
        written in place at a stream boundary; a geometry or digest change
        uploads the live slot in full and marks the window broken, the
        plan's restart signal."""
        live_i = self._cur
        live = self._slots[live_i]
        aug = partition.replicate_datapath_leaves(dtables, self.ntp,
                                                  self.table_axis)
        if (live is None or geom != live["geom"]
                or live["digest"] != self.partition_digest):
            dev, nbytes = self._full_place(aug)
            stats = DatapathPublishStats(epoch=self.epoch, mode="full",
                                         bytes_h2d=nbytes, seconds=0.0)
            self._relayout["broken"] = True
            sp.attrs["relayout_broken"] = True
        else:
            dev, stats = self._publish_delta(aug, live)
        self._slots[live_i] = self._slot(dev, aug, geom)
        sp.attrs.update(mode=stats.mode, epoch=stats.epoch,
                        bytes_h2d=stats.bytes_h2d,
                        scattered_rows=stats.scattered_rows, relayout=True)
        return dev, stats

    def _union_changes(self, spare_epoch: int):
        """The union of the change records of every publish since the
        spare slot's epoch, or None when one of them has none."""
        union: Dict[str, Dict[str, object]] = {}
        for e in range(spare_epoch + 1, self.epoch + 1):
            rec = self._change_log.get(e)
            if rec is None:
                return None
            for fam, leafmap in rec.items():
                dst = union.setdefault(fam, {})
                for leaf, idx in leafmap.items():
                    prev = dst.get(leaf)
                    if idx is True or prev is True:
                        dst[leaf] = True
                    elif prev is None:
                        dst[leaf] = np.asarray(idx, np.int64)
                    else:
                        dst[leaf] = np.concatenate(
                            [prev, np.asarray(idx, np.int64)])
        return union

    def _publish_scoped(self, dtables: DatapathTables, spare: dict, changes):
        """The O(change) publish: only the rows the records name are
        compared with, and written into, the spare slot's retained
        snapshot and device epoch; a sharded row lands at its primary and
        its backup position; True re-places the whole leaf."""
        dev, aug_host = spare["dev"], spare["host"]
        rep_axes = partition.datapath_all_replica_axes(aug_host, self.ntp,
                                                       self.table_axis)
        n_rows = bytes_h2d = replaced = 0
        payloads = []
        for fam, leafmap in changes.items():
            new_f, host_f = getattr(dtables, fam), getattr(aug_host, fam)
            for leaf, rec in leafmap.items():
                new_arr = np.asarray(getattr(new_f, leaf))
                host_leaf = np.asarray(getattr(host_f, leaf))
                axis = rep_axes.get((fam, leaf))
                if axis is None or rec is True:
                    if axis is not None:
                        new_arr = partition.replicate_shard_axis(
                            new_arr, self.ntp, axis)
                    if host_leaf.shape == new_arr.shape and np.array_equal(
                            host_leaf, new_arr):
                        continue
                    self._replace(dev, fam, leaf, new_arr)
                    setattr(host_f, leaf, new_arr)
                    bytes_h2d += int(new_arr.nbytes)
                    replaced += 1
                    continue
                idx = np.unique(np.asarray(rec, np.int64))
                nb = new_arr.shape[axis] // self.ntp
                primary, backup = partition.replica_positions(idx, nb,
                                                              self.ntp)
                rows = np.take(new_arr, idx, axis=axis)
                prev_rows = np.take(host_leaf, primary, axis=axis)
                moved = (np.moveaxis(rows, axis, 0).reshape(len(idx), -1)
                         != np.moveaxis(prev_rows, axis, 0).reshape(
                             len(idx), -1))
                chg = np.flatnonzero(np.any(moved, axis=1))
                if chg.size == 0:
                    continue
                rows = np.take(rows, chg, axis=axis)
                aug_idx = np.concatenate([primary[chg], backup[chg]])
                aug_rows = np.concatenate([rows, rows], axis=axis)
                size = next_pow2(aug_idx.size)
                if size != aug_idx.size:
                    pad = size - aug_idx.size
                    aug_idx = np.concatenate(
                        [aug_idx, np.repeat(aug_idx[-1:], pad)])
                    aug_rows = np.concatenate(
                        [aug_rows, np.repeat(np.take(aug_rows, [-1],
                                                     axis=axis), pad,
                                             axis=axis)], axis=axis)
                # the retained snapshot stays exact: the next diff's base
                # and the chip repair's source
                host_leaf[(slice(None),) * axis + (aug_idx,)] = aug_rows
                payloads.append((fam, leaf, axis, aug_idx, aug_rows))
                n_rows += int(chg.size)
                bytes_h2d += int(aug_rows.nbytes + aug_idx.nbytes)
        if payloads:
            self._scatter(dev, payloads)
        return dev, DatapathPublishStats(
            epoch=self.epoch, mode="delta-scoped", bytes_h2d=bytes_h2d,
            seconds=0.0, scattered_rows=n_rows, replaced_leaves=replaced)

    def _publish_delta(self, aug: DatapathTables, spare: dict):
        dev = spare["dev"]
        payloads, replaced, n_rows, bytes_h2d = row_diff(
            aug, spare["host"], partition.datapath_all_replica_axes(
                aug, self.ntp, self.table_axis))
        for fam, name, arr in replaced:
            self._replace(dev, fam, name, arr)
        if payloads:
            self._scatter(dev, payloads)
        return dev, DatapathPublishStats(
            epoch=self.epoch, mode="delta", bytes_h2d=bytes_h2d, seconds=0.0,
            scattered_rows=n_rows, replaced_leaves=len(replaced))

    def _repair_slot(self, slot: dict, col: int) -> int:
        """One column's owned regions of one slot, in the slot's own
        layout (its ntp, and its epoch's mesh: the source epoch before a
        reshard's cutover, the staged target during the window); a column
        the slot's layout lacks has nothing to repair."""
        aug = slot["host"]
        ntp = int(slot["ntp"])
        if col >= ntp:
            return 0
        rep_axes = partition.datapath_all_replica_axes(aug, ntp,
                                                       self.table_axis)
        payloads, bytes_h2d = [], 0
        for (fam, name), axis in rep_axes.items():
            host_leaf = np.asarray(getattr(getattr(aug, fam), name))
            per = host_leaf.shape[axis] // ntp
            idx = np.arange(col * per, (col + 1) * per, dtype=np.int64)
            rows = np.take(host_leaf, idx, axis=axis)
            payloads.append((fam, name, axis, idx, rows))
            bytes_h2d += int(rows.nbytes + idx.nbytes)
        if payloads:
            self._scatter(slot["dev"], payloads)
        return bytes_h2d

    def repair_chip(self, col: int) -> int:
        """Rewrite one table column's owned augmented regions of every
        sharded plane, in both epochs, from each slot's retained host
        snapshot: the datapath half of the readmission rebalance (the
        chip missed publishes into both slots while out).  The epochs are
        written in place at a stream boundary (the devices synchronized
        before and after).  Returns the bytes shipped: one column's
        slices, never a full upload."""
        with self._lock:
            bytes_h2d = 0
            for slot in self._slots:
                if slot is not None:
                    bytes_h2d += self._repair_slot(slot, col)
            return bytes_h2d

    # -- live resharding (engine/reshard.py drives these) --------------------

    def begin_relayout(self, dtables: DatapathTables, target_mesh):
        """Open a relayout window toward `target_mesh`: place the fused
        world laid out for the target table-axis size into the SPARE slot
        while the live epoch keeps serving, every moved augmented row
        (compiler.partition.datapath_reshard_moved_rows) zeroed, so the
        epoch becomes whole only as relayout_scatter streams them in.
        Returns the moved-row sets {(family, leaf): (axis, index array)}:
        the plan's work queue."""
        _check_fused_world(dtables)
        with self._lock, tracing.tracer.span(
                "datapath.begin_relayout", site="engine.datapath_mesh") as sp:
            if self._relayout is not None:
                raise RuntimeError("datapath relayout window already open")
            if self._slots[self._cur] is None:
                raise RuntimeError("no live datapath epoch to reshard from")
            ntp_dst = int(target_mesh.shape[self.table_axis])
            aug = partition.replicate_datapath_leaves(dtables, ntp_dst,
                                                      self.table_axis)
            moved = partition.datapath_reshard_moved_rows(
                dtables, self.ntp, ntp_dst, self.table_axis)
            digest = partition.datapath_partition_digest(self.table_axis,
                                                         ntp=ntp_dst)
            shardings = partition.datapath_table_shardings(
                target_mesh, aug, self.table_axis)
            zeroed = {}
            for (fam, name), (axis, idx) in moved.items():
                idx = np.asarray(idx, np.int64)
                if idx.size:
                    arr = np.array(np.asarray(getattr(getattr(aug, fam),
                                                      name)))
                    arr[(slice(None),) * int(axis) + (idx,)] = 0
                    zeroed[(fam, name)] = arr
            seed = _with_leaves(aug, zeroed) if zeroed else aug
            dev = place_datapath(seed, shardings)
            _sync(target_mesh)
            self.epoch += 1
            self._slots[self._cur ^ 1] = {
                "dev": dev, "host": aug, "geom": _geometry(dtables),
                "digest": digest, "epoch": self.epoch, "ntp": ntp_dst}
            self._relayout = {"epoch": self.epoch, "mesh": target_mesh,
                              "ntp": ntp_dst, "digest": digest,
                              "shardings": shardings, "broken": False}
            sp.attrs.update(epoch=self.epoch, ntp_src=self.ntp,
                            ntp_dst=ntp_dst)
            return moved

    def relayout_state(self) -> Optional[dict]:
        with self._lock:
            rel = self._relayout
            if rel is None:
                return None
            return {"epoch": rel["epoch"], "ntp": rel["ntp"],
                    "broken": bool(rel["broken"])}

    def _staged_locked(self) -> dict:
        """The staged target slot of an open, unbroken window."""
        rel = self._relayout
        if rel is None or rel["broken"]:
            raise RuntimeError("no open datapath relayout window")
        slot = self._slots[self._cur ^ 1]
        if slot is None or slot["epoch"] != rel["epoch"]:
            raise RuntimeError("staged datapath relayout epoch is gone")
        return slot

    def relayout_scatter(self, row_sets) -> int:
        """One bounded migration step: the rows of `row_sets` ({(family,
        leaf): (axis, index array)}, augmented target coordinates) of the
        staged target epoch, written from its retained host tables by
        REPAIR_SCATTER (route_repair), as repair_chip writes a column.
        Returns the bytes shipped (the rows and the pow2-padded
        indices)."""
        with self._lock:
            slot = self._staged_locked()
            aug = slot["host"]
            payloads, bytes_h2d = [], 0
            for fam, name in sorted(row_sets):
                axis, idx = row_sets[(fam, name)]
                idx = np.asarray(idx, np.int64)
                if idx.size == 0:
                    continue
                size = next_pow2(idx.size)
                if size != idx.size:
                    idx = np.concatenate(
                        [idx, np.repeat(idx[-1:], size - idx.size)])
                rows = np.take(np.asarray(getattr(getattr(aug, fam), name)),
                               idx, axis=axis)
                payloads.append((fam, name, int(axis), idx, rows))
                bytes_h2d += int(rows.nbytes + idx.nbytes)
            if payloads:
                self._scatter(slot["dev"], payloads)
            return bytes_h2d

    def relayout_update(self, dtables: DatapathTables):
        """The churn dual-apply's staged half: fold a new fused world into
        the staged target's retained host tables and return the sharded
        rows whose contents changed ({(family, leaf): (axis, augmented
        index array)}) for the plan to re-queue; a changed replicated
        leaf is placed on the staged epoch at once.  A geometry or shape
        change marks the window broken and returns None."""
        _check_fused_world(dtables)
        with self._lock:
            slot = self._staged_locked()
            rel = self._relayout
            if _geometry(dtables) != slot["geom"]:
                rel["broken"] = True
                return None
            ntp = rel["ntp"]
            aug = partition.replicate_datapath_leaves(dtables, ntp,
                                                      self.table_axis)
            prev = slot["host"]
            rep_axes = partition.datapath_all_replica_axes(aug, ntp,
                                                           self.table_axis)
            changed: Dict[tuple, tuple] = {}
            replaced = []
            for fam, name, new_arr in _table_leaves(aug):
                new_np = np.asarray(new_arr)
                prev_np = np.asarray(getattr(getattr(prev, fam), name))
                if new_np.shape != prev_np.shape:
                    rel["broken"] = True
                    return None
                axis = rep_axes.get((fam, name))
                if axis is not None:
                    mn = np.moveaxis(new_np, axis, 0)
                    mp = np.moveaxis(prev_np, axis, 0)
                    chg = np.flatnonzero(np.any(
                        mn.reshape(mn.shape[0], -1)
                        != mp.reshape(mp.shape[0], -1), axis=1))
                    if chg.size:
                        changed[(fam, name)] = (int(axis), chg)
                elif not np.array_equal(new_np, prev_np):
                    replaced.append((fam, name, new_np))
            for fam, name, arr in replaced:
                self._replace(slot["dev"], fam, name, arr)
            if replaced:
                _sync(rel["mesh"])
            slot["host"] = aug
            return changed

    def cutover_relayout(self) -> int:
        """Flip the staged target epoch live and rebind the store to the
        target mesh, ntp and digest.  The old live epoch stays as the
        source-layout spare, which the next publish uploads in full (its
        digest differs).  Refused while the window is broken.  Returns
        the new live epoch."""
        with self._lock, tracing.tracer.span(
                "datapath.cutover_relayout",
                site="engine.datapath_mesh") as sp:
            if self._relayout is None:
                raise RuntimeError("no open datapath relayout window")
            if self._relayout["broken"]:
                raise RuntimeError("datapath relayout window broken; cutover "
                                   "refused: restart the migration")
            slot = self._staged_locked()
            rel = self._relayout
            self._cur ^= 1
            self._relayout = None
            self.mesh = rel["mesh"]
            self.ntp = rel["ntp"]
            self.partition_digest = rel["digest"]
            self._shardings = rel["shardings"]
            # the change records were kept against source-layout epochs
            self._change_log.clear()
            sp.attrs.update(epoch=slot["epoch"], ntp=self.ntp)
            return slot["epoch"]

    def rollback_relayout(self) -> bool:
        """Drop the staged target epoch (the live source layout was never
        written by the migration).  Returns True when a window was
        open."""
        with self._lock:
            rel = self._relayout
            if rel is None:
                return False
            slot = self._slots[self._cur ^ 1]
            if slot is not None and slot["epoch"] == rel["epoch"]:
                self._slots[self._cur ^ 1] = None
            self._relayout = None
            return True

    def current(self) -> Optional[MeshDatapath]:
        with self._lock:
            slot = self._slots[self._cur]
            return None if slot is None else slot["dev"]

    def host_augmented(self) -> Optional[DatapathTables]:
        with self._lock:
            slot = self._slots[self._cur]
            return None if slot is None else slot["host"]

    def full_bytes(self) -> int:
        with self._lock:
            slot = self._slots[self._cur]
            return 0 if slot is None else _nbytes(slot["host"])

    def chip_bytes(self) -> Dict[int, int]:
        """Resident bytes of the current epoch by coordinate ordinal."""
        with self._lock:
            slot = self._slots[self._cur]
            return {} if slot is None else slot["dev"].chip_bytes()


def row_diff(aug: DatapathTables, prev: DatapathTables, rep_axes):
    """The row diff of two augmented host tables (the delta publish):
    (payloads [(family, leaf, axis, augmented index, rows)] of the
    sharded leaves' changed rows, padded to a power of two by repeating
    the last; replaced [(family, leaf, array)] of the other leaves that
    changed; the rows; the bytes shipped)."""
    payloads, replaced, n_rows, nbytes = [], [], 0, 0
    for fam, name, new_arr in _table_leaves(aug):
        new_np = np.asarray(new_arr)
        prev_np = np.asarray(getattr(getattr(prev, fam), name))
        axis = rep_axes.get((fam, name))
        if axis is not None and new_np.shape == prev_np.shape:
            # the rows of the sharded axis that changed, in augmented
            # coordinates (a changed row's two copies both change)
            mn = np.moveaxis(new_np, axis, 0)
            mp = np.moveaxis(prev_np, axis, 0)
            changed = np.flatnonzero(np.any(
                mn.reshape(mn.shape[0], -1) != mp.reshape(mp.shape[0], -1),
                axis=1))
            if changed.size == 0:
                continue
            size = next_pow2(changed.size)
            if size != changed.size:
                changed = np.concatenate(
                    [changed, np.repeat(changed[-1:], size - changed.size)])
            rows = np.take(new_np, changed, axis=axis)
            payloads.append((fam, name, axis, changed, rows))
            n_rows += int(changed.size)
            nbytes += int(rows.nbytes + changed.nbytes)
        elif new_np.shape != prev_np.shape or not np.array_equal(new_np,
                                                                 prev_np):
            replaced.append((fam, name, new_np))
            nbytes += int(new_np.nbytes)
    return payloads, replaced, n_rows, nbytes


def segments(dev: MeshDatapath, payloads) -> Dict[str, list]:
    """`payloads` [(family, leaf, axis, global augmented index, rows)]
    routed to the blocks of the epoch `dev` that hold their rows
    (publish.route_repair): REPAIR_SCATTER's segments (dst, axis, local
    index, rows), one per leaf and distinct block, by device."""
    from cilium_tpu_torch.convert import _leaf_to
    from cilium_tpu_torch.device import array_tensor

    by_dev: Dict[str, list] = {}
    for fam, name, axis, idx, rows in payloads:
        shape = dev.leaf_shape(fam, name)
        sharding = getattr(getattr(dev.shardings, fam), name)
        seen = set()
        for coord in dev.mesh.coords():
            dst = getattr(getattr(dev.shards[coord], fam), name)
            if id(dst) in seen:
                continue
            seen.add(id(dst))
            routed = route_repair(idx, rows, axis, shape, sharding, coord)
            if routed is None:
                continue
            by_dev.setdefault(str(dst.device), []).append(
                (dst, axis, array_tensor(routed[0], dst.device),
                 _leaf_to(np.ascontiguousarray(routed[1]), dst.device)))
    return by_dev


def _sync(mesh) -> None:
    for d in sorted({str(d) for d in mesh.devices.flat
                     if torch.device(d).type == "cuda"}):
        torch.cuda.synchronize(d)


def _family_leaf_names(obj) -> tuple:
    """The array leaf names of a table family, in the reference's
    flatten order (compiler/partition.py's name tables)."""
    from cilium_tpu_torch.compiler.tables import PolicyTables
    from cilium_tpu_torch.ct.device import CTSnapshot
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice, LPMTables
    from cilium_tpu_torch.lb.device import LBInline, LBTables
    from cilium_tpu_torch.prefilter import PrefilterRanges

    if isinstance(obj, CTSnapshot):
        return partition.CT_LEAF_NAMES
    if isinstance(obj, IPCacheDevice):
        return partition.IPCACHE_LEAF_NAMES
    if isinstance(obj, LBInline):
        return partition.LB_INLINE_LEAF_NAMES
    if isinstance(obj, LBTables):
        return partition.LB_CLASSIC_LEAF_NAMES
    if isinstance(obj, PrefilterRanges):
        return ("base", "mask")
    if isinstance(obj, LPMTables):
        return ("l1", "l2")
    if isinstance(obj, PolicyTables):
        return partition.POLICY_LEAF_NAMES
    return tuple(f.name for f in dataclasses.fields(obj))
