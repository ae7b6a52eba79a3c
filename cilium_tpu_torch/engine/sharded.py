"""Mesh-sharded verdict evaluation over a (batch x table) mesh (the
reference's engine/sharded.py, its lattice evaluators).

Two parallel axes: `batch` splits the tuples (no communication) and
`table` splits the identity-major leaves.  The reference runs each
evaluator as one `shard_map` step; here the step is an explicit loop
over the mesh coordinates (engine/mesh.py):

  * every shard (b, t) runs its PROBE on its own device over batch row
    b: MESH_PROBE (the word-sharded dense lattice of
    make_mesh_evaluator) or ROUTED_PROBE (the routed gathers of
    make_partitioned_evaluator and, in failover mode, of
    make_failover_evaluator).  A probe writes a partial record int32
    per tuple: row 0 the flags (F_*), then MESH_PROBE's proxy and slot
    ([4, Bb]) or ROUTED_PROBE's owner's exact value, stash value and
    wildcard value ([5, Bb]), and last the tuple's L3 counter column in
    this shard's slice;
  * the table-axis psum of those columns is MESH_COMBINE, one per batch
    row on the row's device (the tp partial records copied there if
    they are not already): the sums and ORs, the lattice combine, the
    L4-slot counters, the L3 counters on the word's owner only, the
    row's [2, TELEM_COLS] telemetry and, in failover mode, the tuples
    served from a backup region, all `valid`-masked;
  * the batch-axis psum of the counters is a sum of the rows' buffers,
    the all-gather of the per-chip telemetry rows a torch.stack.

A coordinate on a CUDA device launches the kernels (kernels.py,
csrc/mesh.cu) or raises; on the CPU the plain versions here run.  The
probes' and the combine's plain versions are `mesh_probe_plain`,
`routed_probe_plain` and `mesh_combine_plain`.

The memo evaluators of the reference's module are in engine/memo_mesh.py.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from cilium_tpu_torch.compiler import partition
from cilium_tpu_torch.compiler.tables import (
    L4H_WILD_IDX,
    PolicyTables,
    l4_entry_words,
)
from cilium_tpu_torch.device import MASK32, narrow, widen
from cilium_tpu_torch.engine.hashtable import fnv1a
from cilium_tpu_torch.engine.mesh import (
    MeshTables,
    NamedSharding,
    PartitionSpec as P,
    place_tables,
    shardings_of,
)
from cilium_tpu_torch.engine.oracle import (
    MATCH_L3,
    MATCH_L4,
    MATCH_L4_WILD,
)
from cilium_tpu_torch.engine.verdict import (
    TupleBatch,
    Verdicts,
    _accumulate_counters,
    _combine,
    _gather_ix,
    _index,
    _index_identity,
    _l4hash_probe,
    _tuple_batch_from_packed,
    evaluate_batch,
    l4hash_probe_keys,
    l4hash_row_parts,
    l4hash_stash_parts,
    l4hash_value_decode,
    telemetry_masks,
)

# flags of a partial record's row 0
F_P1 = 1  # mesh: probe 1 on this shard; routed: the owner's exact hit
F_P2 = 2  # probe 2 on this shard (the word's owner)
F_REPLICA = 4  # served from a backup region (failover)
F_P3 = 8  # probe 3 (mesh) / the wildcard hit (routed)
F_KNOWN = 16  # the identity is known (routed)
F_STASH = 32  # the exact key is in the replicated stash (routed)
MODE_MESH, MODE_ROUTED = 0, 1


@dataclass(frozen=True)
class RouteGeom:
    """What a probe and the combine route by, fixed when an evaluator
    is built: `mode` MODE_MESH or MODE_ROUTED; `ntp` the table-axis
    size; whether the hashed rows and the L3 words shard; the global
    bucket count; rows and words per shard in the resident layout
    (doubled by the replica layout); the failover flag with the
    un-augmented rows and words per shard; the identity pad; the L3
    counter columns per shard slice and how many slices count."""

    mode: int
    ntp: int
    rows_sharded: bool = False
    l3_sharded: bool = True
    n_rows_global: int = 0
    n_local: int = 0
    w_local: int = 0
    failover: bool = False
    n_row_shard: int = 0
    wn: int = 0
    n_ids: int = 0
    c_local: int = 0
    l3_shards: int = 1


# -- specs, shardings, stores ------------------------------------------------


def table_specs(batch_axis: str = "batch",
                table_axis: str = "table") -> PolicyTables:
    """The word-sharded mesh's specs: the allow-bit word axes along
    `table_axis`, everything else (the hashed entry plane too)
    replicated."""
    del batch_axis
    return PolicyTables(
        id_table=P(), id_direct=P(), id_lo_len=P(), port_slot=P(),
        l4_meta=P(), l4_allow_bits=P(None, None, None, table_axis),
        l3_allow_bits=P(None, None, table_axis), generation=P(),
        l4_hash_rows=P(), l4_hash_stash=P(), l4_wild_rows=P(),
        l4_wild_stash=P(),
    )


def replicated_table_shardings(mesh) -> PolicyTables:
    """Every PolicyTables leaf replicated across `mesh` (the sharded
    evaluator's layout)."""
    r = NamedSharding(mesh, P())
    return PolicyTables(**{f.name: r for f in dataclasses.fields(
        PolicyTables)})


def batch_specs(batch_axis: str = "batch") -> TupleBatch:
    s = P(batch_axis)
    return TupleBatch(ep_index=s, identity=s, dport=s, proto=s,
                      direction=s, is_fragment=s)


def make_replicated_store(mesh):
    """DeviceTableStore whose epochs replicate across `mesh`: a delta
    publish scatters the same rows into every device's copy."""
    from cilium_tpu_torch.engine.publish import DeviceTableStore

    return DeviceTableStore(shardings=replicated_table_shardings(mesh))


def make_partitioned_store(mesh, table_axis: str = "table"):
    """DeviceTableStore whose epochs partition across `mesh` under the
    rule table (compiler/partition.py): each identity-major leaf's
    slice lives on its shard, small leaves replicate, and a delta
    publish writes each row into its owning shard only.  The rule
    table's digest is folded into every epoch's layout stamp."""
    from cilium_tpu_torch.engine.publish import DeviceTableStore

    return DeviceTableStore(
        shardings_fn=lambda t: partition.table_shardings(mesh, t,
                                                         table_axis),
        partition_digest=partition.partition_digest(
            partition.default_table_rules(table_axis)),
    )


def make_replica_store(mesh, table_axis: str = "table"):
    """make_partitioned_store under the N+1 replica placement: every
    epoch carries the augmented layout (partition.replicate_table_leaves)
    and every delta writes each changed row at its primary and its
    backup position (partition.replica_delta), so both copies stay
    equal.  The replica digest is folded into the layout stamp."""
    from cilium_tpu_torch.engine.publish import DeviceTableStore

    ntp = int(mesh.shape[table_axis])
    return DeviceTableStore(
        shardings_fn=lambda aug: partition.table_shardings(mesh, aug,
                                                           table_axis),
        partition_digest=partition.replica_partition_digest(table_axis,
                                                            ntp=ntp),
        transform_fn=lambda t: partition.replicate_table_leaves(
            t, ntp, table_axis),
        delta_transform_fn=lambda d, pre: partition.replica_delta(
            d, pre, ntp, table_axis),
    )


# -- the batch on the mesh ----------------------------------------------------


class ShardedBatch:
    """A TupleBatch split over the batch axis: row b's slice (and its
    `valid` mask) on each device of mesh row b, placed once per
    device."""

    def __init__(self, mesh, packed_rows: List[torch.Tensor],
                 valid_rows: Optional[List[torch.Tensor]] = None) -> None:
        self.mesh = mesh
        self.size = sum(int(p.shape[1]) for p in packed_rows)
        self._rows: List[Dict[str, TupleBatch]] = []
        self._valid: List[Dict[str, torch.Tensor]] = []
        for b, packed in enumerate(packed_rows):
            here, vhere = {}, {}
            for t in range(mesh.devices.shape[1]):
                dev = mesh.devices[b, t]
                if str(dev) in here:
                    continue
                here[str(dev)] = _tuple_batch_from_packed(
                    packed.to(dev).contiguous())
                if valid_rows is not None:
                    vhere[str(dev)] = valid_rows[b].to(dev).contiguous()
            self._rows.append(here)
            self._valid.append(vhere)
        self.has_valid = valid_rows is not None

    def on(self, b: int, dev) -> TupleBatch:
        return self._rows[b][str(dev)]

    def valid_on(self, b: int, dev) -> Optional[torch.Tensor]:
        return self._valid[b][str(dev)] if self.has_valid else None


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def shard_batch(mesh, batch, valid=None,
                batch_axis: str = "batch") -> ShardedBatch:
    """`batch` (TupleBatch) and the optional `valid` mask [B] split into
    the mesh's batch rows, B a multiple of the batch-axis size (as
    shard_map requires).  A ShardedBatch passes through (with `valid`
    added if given)."""
    if isinstance(batch, ShardedBatch) and valid is None:
        return batch
    dp = int(mesh.shape[batch_axis])
    if isinstance(batch, ShardedBatch):
        packed = torch.cat([batch.on(b, mesh.devices[b, 0]).pack()
                            for b in range(dp)], dim=1)
    else:
        packed = batch.pack()
    b_total = int(packed.shape[1])
    if b_total % dp:
        raise ValueError(f"a batch of {b_total} tuples does not split over "
                         f"{dp} batch shards")
    n = b_total // dp
    rows = [packed[:, b * n:(b + 1) * n] for b in range(dp)]
    vrows = None
    if valid is not None:
        v = _as_tensor(valid, torch.bool, packed.device)
        if tuple(v.shape) != (b_total,):
            raise ValueError(f"valid must be [{b_total}]")
        vrows = [v[b * n:(b + 1) * n] for b in range(dp)]
    return ShardedBatch(mesh, rows, vrows)


def placed(tables, shardings) -> MeshTables:
    """`tables` on the mesh under `shardings`: PolicyTables (host or
    device) are placed, MeshTables must already lie so."""
    if isinstance(tables, MeshTables):
        for f in dataclasses.fields(PolicyTables):
            want = getattr(shardings, f.name)
            if (tables.mesh != want.mesh
                    or tuple(tables.spec(f.name)) != tuple(want.spec)):
                raise ValueError(
                    f"tables placed with {f.name} under "
                    f"{tables.spec(f.name)!r}, the evaluator takes "
                    f"{want.spec!r} on its mesh")
        return tables
    return place_tables(tables, shardings)


def _shape(tables, name: str) -> Optional[tuple]:
    if isinstance(tables, MeshTables):
        return tables.leaf_shape(name)
    leaf = getattr(tables, name)
    return None if leaf is None else tuple(leaf.shape)


# -- the probes and the combine, plain versions --------------------------------


def _cols(batch: TupleBatch):
    return (batch.ep_index.to(torch.int64), batch.direction.to(torch.int64),
            batch.dport.to(torch.int64).clamp(0, 65535),
            batch.proto.to(torch.int64).clamp(0, 255))


def _record(flags, *rows) -> torch.Tensor:
    return torch.stack([narrow(flags)] + [narrow(r) for r in rows])


def mesh_probe_plain(tab, batch: TupleBatch, w_off: int) -> torch.Tensor:
    """MESH_PROBE's plain version: the shard-local step of the
    word-sharded mesh (the reference's make_mesh_evaluator body).
    `tab` holds the replicated id_direct/port_slot/l4_meta and this
    shard's word slices of l4_allow_bits and l3_allow_bits, whose first
    word is `w_off`.  Returns the partial record [4, Bb] int32: flags
    (F_P1, F_P2 on this shard; F_P3), proxy, slot j, L3 column."""
    ep, dirn, _, _ = _cols(batch)
    idx, word, bit, known, j, has_port = _index(tab, batch)
    e_count, _, kg = tab.l4_meta.shape
    epg, dg, jg = (_gather_ix(ep, e_count), _gather_ix(dirn, 2),
                   _gather_ix(j, kg))
    meta = widen(tab.l4_meta[epg, dg, jg])
    w_local = int(tab.l3_allow_bits.shape[2])
    wl = word - w_off
    in_shard = (wl >= 0) & (wl < w_local)
    wl = wl.clamp(0, w_local - 1)
    exact = widen(tab.l4_allow_bits[epg, dg, jg, wl])
    p1 = known & has_port & in_shard & ((exact >> bit) & 1).bool()
    l3 = widen(tab.l3_allow_bits[epg, dg, wl])
    p2 = known & in_shard & ((l3 >> bit) & 1).bool()
    p3 = has_port & (meta & 1).bool()
    lcol = (idx - w_off * 32).clamp(0, w_local * 32 - 1)
    flags = p1.long() * F_P1 | p2.long() * F_P2 | p3.long() * F_P3
    return _record(flags, meta >> 1, j, lcol)


def failover_lattice_parts(tab, ep, dirn, dport, proto, idx, known,
                           g: RouteGeom, t: int,
                           alive_row: Optional[torch.Tensor] = None,
                           solo: bool = False) -> dict:
    """Shard t's part of the routed lattice with the identity index
    given (the reference's failover_lattice_probes before its psums, in
    the form the fused datapath calls it: `idx` int64 and `known` bool
    [B] from the routed ipcache; routed_probe_plain derives them from
    id_direct).  `ep` and `dirn` are the tuples' int64 words, `dport`
    and `proto` clipped.  The exact key's bucket is compared on its
    owner (in failover mode the backup owner when `alive_row`, this
    batch row's chip health [tp], says the primary is dead) and the L3
    word read on its owner.  A plane the rules replicate is owned by
    every shard, or with `solo` by shard 0 alone (then a sum over the
    table axis reads one shard's result).  Returns {found, val (the
    owner's exact hit and value), s_found, s_val (the stash), hit3, val3
    (the wildcard probe), p2 (the L3 bit on its owner), replica (served
    from a backup region), lcol (the L3 counter column in this shard's
    slice)}."""
    ew = l4_entry_words(tab)
    ep32, d32 = ep & MASK32, dirn & MASK32
    w0, w1 = l4hash_probe_keys(ew, ep32, d32, idx, dport, proto)
    bucket = fnv1a(torch.stack([w0, w1], dim=1)) & (g.n_rows_global - 1)
    off = partition.REPLICA_BACKUP_OFFSET
    none = torch.zeros_like(known)
    replica = none
    if g.rows_sharded and g.failover:
        n = g.n_row_shard
        p = bucket // n
        ap = alive_row[p]
        owns = torch.where(ap, p, (p + off) % g.ntp) == t
        bl = ((bucket - p * n) + torch.where(ap, 0, n)).clamp(0, 2 * n - 1)
        replica = owns & ~ap
    elif g.rows_sharded:
        bl = bucket - t * g.n_local
        owns = (bl >= 0) & (bl < g.n_local)
        bl = bl.clamp(0, g.n_local - 1)
    else:
        owns, bl = (none | (t == 0)) if solo else ~none, bucket
    found, val = l4hash_row_parts(tab.l4_hash_rows[bl], w0, w1, ew)
    found = found & owns
    val = torch.where(owns, val, 0)
    s_found, s_val = l4hash_stash_parts(tab.l4_hash_stash, w0, w1, ew)
    hit3, val3 = _l4hash_probe(
        tab.l4_wild_rows, tab.l4_wild_stash, ep32, d32,
        torch.full_like(idx, int(L4H_WILD_IDX)), dport, proto)

    word, bit = idx >> 5, idx & 31
    w_res = int(tab.l3_allow_bits.shape[2])
    if g.l3_sharded and g.failover:
        wn, gcols = g.wn, g.wn * 32
        wp = word // wn
        apw = alive_row[wp]
        owns_w = torch.where(apw, wp, (wp + off) % g.ntp) == t
        wl = ((word - wp * wn) + torch.where(apw, 0, wn)).clamp(0, 2 * wn - 1)
        replica = replica | (owns_w & ~apw)
        lcol = (idx - wp * gcols).clamp(0, gcols - 1) + torch.where(
            apw, 0, gcols)
    elif g.l3_sharded:
        wl = word - t * g.w_local
        owns_w = (wl >= 0) & (wl < g.w_local)
        wl = wl.clamp(0, g.w_local - 1)
        lcol = (idx - t * g.w_local * 32).clamp(0, g.w_local * 32 - 1)
    else:
        owns_w = (none | (t == 0)) if solo else ~none
        wl = word
        lcol = idx.clamp(0, g.n_ids - 1)
    e_count = int(tab.l3_allow_bits.shape[0])
    l3 = widen(tab.l3_allow_bits[_gather_ix(ep, e_count),
                                 _gather_ix(dirn, 2),
                                 _gather_ix(wl, w_res)])
    p2 = known & owns_w & ((l3 >> bit) & 1).bool()
    return dict(found=found, val=val, s_found=s_found, s_val=s_val,
                hit3=hit3, val3=val3, p2=p2, replica=replica, lcol=lcol)


def routed_probe_plain(tab, batch: TupleBatch, g: RouteGeom, t: int,
                       alive_row: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """ROUTED_PROBE's plain version: shard t's step of the routed
    lattice (the reference's make_partitioned_evaluator body, and in
    failover mode failover_lattice_probes with `alive_row` [tp], this
    batch row's chip health): the identity index from id_direct, then
    failover_lattice_parts.  The FNV-1a bucket's owner compares its row
    (a shard that does not own it contributes 0); the stash and
    wildcard probes are replicated; the L3 word is read on its owner.
    Returns the partial record [5, Bb] int32: flags (F_P1 the owner's
    hit, F_P2, F_REPLICA, F_P3 the wildcard hit, F_KNOWN, F_STASH), the
    owner's value, the stash value, the wildcard value, the L3
    column."""
    ep, dirn, dport, proto = _cols(batch)
    idx, known = _index_identity(tab, widen(batch.identity))
    r = failover_lattice_parts(tab, ep, dirn, dport, proto, idx, known, g,
                               t, alive_row)
    flags = (r["found"].long() * F_P1 | r["p2"].long() * F_P2
             | r["replica"].long() * F_REPLICA | r["hit3"].long() * F_P3
             | known.long() * F_KNOWN | r["s_found"].long() * F_STASH)
    return _record(flags, r["val"], r["s_val"], r["val3"], r["lcol"])


def routed_lattice(parts, tab, ep, dirn):
    """The table-axis psum of ROUTED_PROBE's tp records and the lattice
    inputs it gives (the reference's failover_lattice_probes after its
    psums): (probe1, probe2, probe3, proxy, j), `ep` and `dirn` the
    tuples' int64 words."""
    flags = [widen(p[0]) for p in parts]
    any_of = functools.reduce(lambda x, y: x | y, flags)
    head = parts[0]
    found1 = ((any_of & F_P1) != 0) | ((flags[0] & F_STASH) != 0)
    val1 = widen(head[2])
    for p in parts:
        val1 = val1 + widen(p[1])
    val1 = val1 & MASK32
    p1 = ((flags[0] & F_KNOWN) != 0) & found1
    p3 = (flags[0] & F_P3) != 0
    proxy, j = l4hash_value_decode(tab, ep, dirn, p1, val1, p3,
                                   widen(head[3]), l4_entry_words(tab))
    return p1, (any_of & F_P2) != 0, p3, proxy, j


def mesh_combine_plain(parts, tab, batch: TupleBatch, g: RouteGeom,
                       valid: Optional[torch.Tensor] = None,
                       telemetry: bool = True):
    """MESH_COMBINE's plain version: the table-axis psum of one batch
    row's tp partial records (on the row's device), the lattice
    combine and the counter and telemetry epilogue (the reference's
    _counts_and_telemetry, and failover_counts with `valid`).  `tab`
    gives l4_meta (the compact layout's proxy).  Returns (Verdicts,
    l4 [E, 2, Kg], l3 [E, 2, l3_shards * c_local], telemetry [2,
    TELEM_COLS] or None, replica tuples [] int32), counters as u32 bits
    in int32."""
    flags = [widen(p[0]) for p in parts]
    ep, dirn, _, _ = _cols(batch)
    frag = batch.is_fragment.bool()

    def any_of(bit):
        out = (flags[0] & bit) != 0
        for f in flags[1:]:
            out = out | ((f & bit) != 0)
        return out

    head = parts[0]
    if g.mode == MODE_MESH:
        p1, p2, p3 = any_of(F_P1), any_of(F_P2), (flags[0] & F_P3) != 0
        proxy, j = widen(head[1]), head[2].to(torch.int64)
    else:
        p1, p2, p3, proxy, j = routed_lattice(parts, tab, ep, dirn)
    allowed, proxy_out, kind = _combine(p1, p2, p3, proxy, frag)
    v = Verdicts(allowed=allowed.to(torch.uint8),
                 proxy_port=proxy_out.to(torch.int32), match_kind=kind)
    ok = torch.ones_like(p2) if valid is None else valid.bool()
    l4, trow = l4_counts_and_telemetry(v, tab, ep, dirn, j, ok, telemetry)
    l3 = l3_counts(tab, ep, dirn, kind, [(f & F_P2) != 0 for f in flags],
                   [p[-1] for p in parts], ok, g)
    served = torch.zeros((), dtype=torch.int64, device=head.device)
    for f in flags:
        served = served + (((f & F_REPLICA) != 0) & ok).sum()
    return v, l4, l3, trow, narrow(served)


def l4_counts_and_telemetry(v: Verdicts, tab, ep, dirn, j, ok,
                            telemetry: bool):
    """The combine's epilogue shared with the memo on the mesh: the
    L4-slot counters [E, 2, Kg] of the `ok` tuples and, with
    `telemetry`, their [2, TELEM_COLS] rows (ingress, egress), u32 bits
    in int32 (None without)."""
    kind = v.match_kind
    l4 = l4_counts(tab, ep, dirn, kind, j, ok)
    if not telemetry:
        return l4, None
    zeros = torch.zeros_like(dirn)
    masks = telemetry_masks(zeros, zeros, kind, v.allowed.bool(), zeros,
                            v.proxy_port.to(torch.int64), zeros, zeros)
    ingress = (dirn == 0) & ok
    row_in = torch.stack([(m & ingress).sum() for m in masks])
    total = torch.stack([(m & ok).sum() for m in masks])
    return l4, narrow(torch.stack([row_in, total - row_in]))


def l4_counts(tab, ep, dirn, kind, j, ok) -> torch.Tensor:
    """The L4 half of the counter epilogue (the reference's
    failover_counts): the L4-slot hits of the `ok` tuples at [ep, dir,
    j], [E, 2, Kg] u32 bits in int32."""
    e_count, _, kg = tab.l4_meta.shape
    l4 = torch.zeros((e_count, 2, kg), dtype=torch.int32, device=kind.device)
    hit_l4 = ((kind == MATCH_L4) | (kind == MATCH_L4_WILD)) & ok
    _accumulate_counters(l4, ep, dirn, j, hit_l4)
    return l4


def l3_counts(tab, ep, dirn, kind, p2_parts, lcol_parts, ok,
              g: RouteGeom) -> torch.Tensor:
    """The L3 half of the failover counter epilogue: the L3 hits of the
    `ok` tuples on the shard that read the word (`p2_parts[t]`), at its
    augmented local column `lcol_parts[t]` of slice t (fold_l3_aug folds
    them back), or at the global column on a replicated plane (one
    slice); [E, 2, l3_shards * c_local] u32 bits in int32."""
    e_count = int(tab.l4_meta.shape[0])
    l3 = torch.zeros((e_count, 2, g.l3_shards * g.c_local),
                     dtype=torch.int32, device=kind.device)
    hit_l3 = (kind == MATCH_L3) & ok
    for t in range(g.l3_shards):
        _accumulate_counters(l3, ep, dirn,
                             t * g.c_local + lcol_parts[t].to(torch.int64),
                             hit_l3 & p2_parts[t])
    return l3


# -- dispatch: the kernel on a CUDA device, the plain version on the CPU ----


def _mesh_probe(tab, batch, w_off):
    if batch.ep_index.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.MESH_PROBE(tab, batch, w_off)
    return mesh_probe_plain(tab, batch, w_off)


def _routed_probe(tab, batch, g, t, alive_row):
    if batch.ep_index.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.ROUTED_PROBE(tab, batch, g, t, alive_row)
    return routed_probe_plain(tab, batch, g, t, alive_row)


def _mesh_combine(parts, tab, batch, g, valid, telemetry):
    if batch.ep_index.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.MESH_COMBINE(parts, tab, batch, g, valid, telemetry)
    return mesh_combine_plain(parts, tab, batch, g, valid, telemetry)


def _run(mesh, mt: MeshTables, sb: ShardedBatch, g: RouteGeom, probe,
         telemetry: bool):
    """The step over every coordinate: probes, then one combine per
    batch row on its first device; then the batch-axis sums on the
    mesh's first device.  Returns (Verdicts, l4, l3, trows or None,
    replica tuples)."""
    dp, tp = mesh.devices.shape
    home = mesh.devices[0, 0]
    outs = []
    for b in range(dp):
        row_dev = mesh.devices[b, 0]
        parts = []
        for t in range(tp):
            dev = mesh.devices[b, t]
            part = probe(mt.shard(b, t), sb.on(b, dev), (b, t))
            parts.append(part if part.device == row_dev else part.to(row_dev))
        outs.append(_mesh_combine(parts, mt.shard(b, 0), sb.on(b, row_dev),
                                  g, sb.valid_on(b, row_dev), telemetry))

    def gather(k):
        return [o[k].to(home) for o in outs]

    v = Verdicts(*(torch.cat([getattr(o[0], c).to(home) for o in outs])
                   for c in ("allowed", "proxy_port", "match_kind")))
    l4 = torch.stack(gather(1)).sum(dim=0, dtype=torch.int64)
    l3 = torch.stack(gather(2)).sum(dim=0, dtype=torch.int64)
    trows = torch.stack(gather(3)) if telemetry else None
    served = torch.stack(gather(4)).to(torch.int64).sum()
    return v, narrow(l4), narrow(l3), trows, narrow(served)


# -- the evaluators ------------------------------------------------------------


def make_mesh_evaluator(mesh, batch_axis: str = "batch",
                        table_axis: str = "table",
                        collect_telemetry: bool = False):
    """The word-sharded dense lattice over a (batch x table) mesh:
    fn(tables, batch) -> (Verdicts, l4_counts [E, 2, Kg], l3_counts
    [E, 2, N][, per-chip telemetry [dp, 2, TELEM_COLS]]).  The index
    tables replicate and resolve each tuple's global identity index and
    L4 slot; each shard tests only the l4_allow_bits and l3_allow_bits
    words it owns (MESH_PROBE), and MESH_COMBINE ORs the hits over the
    table axis.  `tables` are PolicyTables with the dense port_slot and
    l4_allow_bits (host or device; placed per call) or MeshTables placed
    under table_specs; W must divide by the table-axis size."""
    shardings = shardings_of(mesh, table_specs(batch_axis, table_axis))
    tp = int(mesh.shape[table_axis])

    def step(tables, batch):
        if _shape(tables, "l4_allow_bits") is None or _shape(
                tables, "port_slot") is None:
            raise ValueError("the word-sharded mesh evaluator reads the "
                             "dense port_slot and l4_allow_bits planes")
        w = _shape(tables, "l3_allow_bits")[2]
        if w % tp:
            raise ValueError(f"{w} identity words do not split over {tp} "
                             f"table shards")
        g = mesh_geom(w, tp)
        mt = placed(tables, shardings)
        sb = shard_batch(mesh, batch, batch_axis=batch_axis)
        v, l4, l3, trows, _ = _run(
            mesh, mt, sb, g,
            lambda tab, bl, c: _mesh_probe(tab, bl, c[1] * g.w_local),
            collect_telemetry)
        return (v, l4, l3) + ((trows,) if collect_telemetry else ())

    return step


def mesh_geom(n_words: int, tp: int) -> RouteGeom:
    """The word-sharded mesh's geometry for W = `n_words` over `tp`
    shards."""
    wl = n_words // tp
    return RouteGeom(mode=MODE_MESH, ntp=tp, w_local=wl, c_local=wl * 32,
                     l3_shards=tp, n_ids=n_words * 32)


def _routed_geom(tables, ntp: int, table_axis: str, failover: bool):
    specs = partition.divisible_partition_specs(tables, ntp, table_axis)
    rows_sharded = table_axis in tuple(specs.l4_hash_rows)
    l3_sharded = table_axis in tuple(specs.l3_allow_bits)
    n_rows = int(tables.l4_hash_rows.shape[0])
    w = int(tables.l3_allow_bits.shape[-1])
    n_ids = w * 32
    n_shard = n_rows // ntp if rows_sharded else n_rows
    w_shard = w // ntp if l3_sharded else w
    if failover:
        return specs, RouteGeom(
            mode=MODE_ROUTED, ntp=ntp, rows_sharded=rows_sharded,
            l3_sharded=l3_sharded, n_rows_global=n_rows,
            n_local=2 * n_shard if rows_sharded else n_rows,
            w_local=2 * w_shard if l3_sharded else w, failover=True,
            n_row_shard=n_shard if rows_sharded else 0,
            wn=w_shard if l3_sharded else 0, n_ids=n_ids,
            c_local=2 * w_shard * 32 if l3_sharded else n_ids,
            l3_shards=ntp if l3_sharded else 1)
    return specs, RouteGeom(
        mode=MODE_ROUTED, ntp=ntp, rows_sharded=rows_sharded,
        l3_sharded=l3_sharded, n_rows_global=n_rows, n_local=n_shard,
        w_local=w_shard, n_ids=n_ids, c_local=w_shard * 32,
        l3_shards=ntp if l3_sharded else 1)


def make_partitioned_evaluator(mesh, tables, batch_axis: str = "batch",
                               table_axis: str = "table",
                               collect_telemetry: bool = False):
    """The routed lattice over identity-SHARDED tables (the rule layer's
    divisible specs): the hashed L4 rows shard along the bucket-row axis
    and the L3 words along the word axis.  Each tuple's bucket and word
    are read on their owning shard (ROUTED_PROBE; the others contribute
    a masked zero) and MESH_COMBINE sums the columns over the table
    axis: each key lives in exactly one shard, so the sums are exact.
    `tables` gives the shapes the routing is built for; the returned
    fn(tables, batch) refuses any other geometry.  Returns (Verdicts,
    l4_counts, l3_counts[, per-chip telemetry]) as make_mesh_evaluator.
    Needs the hashed entry tables."""
    if tables.l4_hash_rows is None:
        raise ValueError(
            "partitioned evaluator requires the hashed L4 entry tables "
            "(hand-built dense tables: use make_mesh_evaluator)")
    ntp = int(mesh.shape[table_axis])
    specs, g = _routed_geom(tables, ntp, table_axis, failover=False)
    shardings = shardings_of(mesh, specs)
    built_geom = (tuple(tables.l4_hash_rows.shape),
                  tuple(tables.l3_allow_bits.shape))

    def run(tables_in, batch):
        if _shape(tables_in, "l4_hash_rows") is None:
            raise ValueError("partitioned evaluator requires the hashed L4 "
                             "entry tables")
        got = (_shape(tables_in, "l4_hash_rows"),
               _shape(tables_in, "l3_allow_bits"))
        if got != built_geom:
            raise ValueError(
                f"partitioned evaluator was built for table geometry "
                f"{built_geom} but called with {got}; rebuild with "
                f"make_partitioned_evaluator")
        mt = placed(tables_in, shardings)
        sb = shard_batch(mesh, batch, batch_axis=batch_axis)
        v, l4, l3, trows, _ = _run(
            mesh, mt, sb, g,
            lambda tab, bl, c: _routed_probe(tab, bl, g, c[1], None),
            collect_telemetry)
        return (v, l4, l3) + ((trows,) if collect_telemetry else ())

    run.geom = g
    return run


def fold_l3_aug(l3_aug, ntp: int) -> torch.Tensor:
    """[E, 2, ntp * 2g] chip-major (primary region, then backup region,
    per chip) -> the global [E, 2, N]: slice p is chip p's primary
    region plus chip (p + offset)'s backup region."""
    a = torch.as_tensor(l3_aug)
    g = a.shape[-1] // (2 * ntp)
    blocks = a.reshape(a.shape[0], a.shape[1], ntp, 2 * g)
    back = torch.roll(blocks[..., g:], -partition.REPLICA_BACKUP_OFFSET,
                      dims=2)
    return (blocks[..., :g] + back).reshape(a.shape[0], a.shape[1], ntp * g)


def make_failover_evaluator(mesh, tables, batch_axis: str = "batch",
                            table_axis: str = "table",
                            collect_telemetry: bool = False):
    """The replica-aware routed lattice (the per-chip failure domain's
    device half) over the N+1 AUGMENTED tables
    (partition.replicate_table_leaves), with two routing inputs:
    `alive` bool [dp, tp] (a tuple whose bucket or word's primary owner
    is dead reads the backup copy on the next shard over) and `valid`
    bool [B] (padding excluded from counters and telemetry).  Returns
    fn(tables_aug, batch, alive, valid) -> (Verdicts, l4_counts,
    l3_counts [E, 2, N] global, replica_hits (valid tuples served from
    a backup region)[, per-chip telemetry]).  `tables` are the
    un-augmented tables the geometry is built from.  `valid` None takes
    a ShardedBatch's own mask (shard_batch(..., valid=)), or every tuple
    as valid."""
    if tables.l4_hash_rows is None:
        raise ValueError(
            "failover evaluator requires the hashed L4 entry tables")
    ntp = int(mesh.shape[table_axis])
    dp = int(mesh.shape[batch_axis])
    rep_axes = partition.replica_axes(tables, ntp, table_axis)
    specs, g = _routed_geom(tables, ntp, table_axis, failover=True)
    shardings = shardings_of(mesh, specs)
    built_geom = (tuple(tables.l4_hash_rows.shape),
                  tuple(tables.l3_allow_bits.shape))
    n_rows, w = built_geom[0][0], built_geom[1][-1]
    aug = (n_rows * 2 if g.rows_sharded else n_rows,
           w * 2 if g.l3_sharded else w)

    def run(tables_aug, batch, alive, valid):
        if _shape(tables_aug, "l4_hash_rows") is None:
            raise ValueError("failover evaluator requires the hashed L4 "
                             "entry tables")
        got = (_shape(tables_aug, "l4_hash_rows")[0],
               _shape(tables_aug, "l3_allow_bits")[-1])
        if got != aug:
            raise ValueError(
                f"failover evaluator was built for augmented table "
                f"geometry {aug} (from un-augmented {built_geom}) but "
                f"called with {got}; rebuild with make_failover_evaluator")
        mt = placed(tables_aug, shardings)
        sb = shard_batch(mesh, batch, valid=valid, batch_axis=batch_axis)
        alive_t = _as_tensor(alive, torch.bool, torch.device("cpu"))
        if tuple(alive_t.shape) != (dp, ntp):
            raise ValueError(f"alive must be [{dp}, {ntp}]")
        rows = {}

        def probe(tab, bl, c):
            dev = bl.ep_index.device
            key = (c[0], str(dev))
            if key not in rows:
                rows[key] = alive_t[c[0]].to(dev)
            return _routed_probe(tab, bl, g, c[1], rows[key])

        v, l4, l3, trows, served = _run(mesh, mt, sb, g, probe,
                                        collect_telemetry)
        if g.l3_sharded:
            l3 = fold_l3_aug(l3, ntp)
        out = (v, l4, l3, served)
        return out + ((trows,) if collect_telemetry else ())

    run.replica_axes = rep_axes
    run.geom = g
    return run


# -- serving helpers -----------------------------------------------------------


def make_async_mesh_dispatcher(step, mesh, batch_axis: str = "batch",
                               depth: int = 1):
    """Double-buffered dispatch over a mesh evaluator
    (publish.AsyncBatchDispatcher over SPMD batches): the host packs and
    splits batch N + 1 over the mesh's batch rows while the devices run
    batch N.  `step` is batch -> result with the tables bound;
    `submit((ep_index, identity, dport, proto, direction[,
    is_fragment]), meta)` stages a ShardedBatch; results drain one
    batch behind in submission order."""
    from cilium_tpu_torch.engine.publish import AsyncBatchDispatcher
    from cilium_tpu_torch.engine.verdict import pack_tuples

    dp = int(mesh.shape[batch_axis])

    def pack(ep_index, identity, dport, proto, direction, is_fragment=None):
        packed = torch.from_numpy(pack_tuples(
            ep_index, identity, dport, proto, direction,
            is_fragment).view(np.int32))
        b = int(packed.shape[1])
        if b % dp:
            raise ValueError(f"a batch of {b} tuples does not split over "
                             f"{dp} batch shards")
        n = b // dp
        return (ShardedBatch(mesh, [packed[:, i * n:(i + 1) * n]
                                    for i in range(dp)]),)

    return AsyncBatchDispatcher(pack, step, depth=depth)


def traced_dispatch(step, mesh, site: str = "engine.sharded"):
    """A mesh evaluator under the span plane: each call opens a
    `mesh.dispatch` span that waits for the devices (so it covers the
    execution, not the enqueue) and records per-chip `chip.dispatch`
    children that partition it; the wrapped step counts its calls at
    `site`."""
    from cilium_tpu_torch import tracing

    n_chips = mesh.size
    cuda = sorted({str(d) for d in mesh.devices.flat
                   if torch.device(d).type == "cuda"})
    tracked = tracing.track_jit(step, site)

    def dispatch(tables, batch, *rest):
        rows = int(batch.size if isinstance(batch, ShardedBatch)
                   else batch.ep_index.shape[0])
        with tracing.tracer.span("mesh.dispatch", site=site,
                                 attrs={"chips": n_chips,
                                        "rows": rows}) as sp:
            out = tracked(tables, batch, *rest)
            for d in cuda:
                torch.cuda.synchronize(d)
        tracing.record_chip_spans(tracing.tracer, sp, n_chips, rows, site)
        return out

    dispatch.__wrapped__ = step
    return dispatch
