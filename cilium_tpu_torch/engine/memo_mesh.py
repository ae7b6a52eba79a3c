"""The verdict memo on a (batch x table) mesh (the reference's
engine/sharded.py make_partitioned_cache, make_partitioned_memo_evaluator
and make_failover_memo_evaluator: K21's memo).

The cache's bucket rows shard along the table axis like l4_hash_rows:
coordinate (b, t) holds rows [t * R_local, (t + 1) * R_local) of the
global bucket space of its batch row, plus a private scratch row, as one
[1, 1, R_local + 1, 5e + 1] block of the [dp, tp, R_local + 1, 5e + 1]
rows (an engine.mesh.PlacedArray).  Batch rows warm their own copies.

One batch row's step, the reference's `shard_map` body as a loop:

  * the memo key words of the row's tuples (memo.memo_key_words; on the
    card MEMO_KEYS_LATTICE) and their dedup (memo.dedup_groups; on the
    card MEMO_DEDUP), once per batch row: the reference computes the same
    groups on every table chip of the row from the same inputs;
  * MESH_MEMO_PROBE once per batch row and device, for the row's
    coordinates on that device (on one card, one launch per row): the
    representatives sorted by bucket once, then those whose bucket a
    coordinate owns (global bucket // R_local; in failover mode a dead
    owner owns nothing and its keys miss) are compared over the e lanes
    of its slice, and the owner's insert lane is picked as
    memo.bucket_insert_lanes does.  Each coordinate gets a record [4,
    rep_cap]: hit, cv0, cv1 (owner only) and lane | ok << 8 (on the
    bucket's coordinate);
  * MESH_MEMO_COMBINE's front pass per row: the table-axis sum of the tp
    records (only one coordinate contributes to a slot, so the sum is
    the reference's psum), the hit masked by rep_valid, the ascending
    compaction of the missed representatives (jnp.nonzero with size
    miss_cap and fill rep_cap) and the [6, miss_cap] pack of their
    tuples;
  * ROUTED_PROBE per coordinate on the missed representatives only
    (engine/sharded.py, in failover mode with the row's alive vector);
  * MESH_MEMO_COMBINE's back pass per row: the routed records' lattice
    (sharded.routed_lattice) packed into value words, the scatter-back
    to every tuple (memo.scatter_back), the combine, the counters, the
    telemetry row, the replica count (backup gathers of live miss slots)
    and the stats row;
  * MESH_MEMO_INSERT per coordinate: a copy of its slice with the missed
    representatives it owns inserted, when its batch row did not
    overflow.

Where the port differs from the reference, and why nothing reads it:
the scratch row (row R_local of a slice) is never written.  The
reference routes every insert a coordinate does not own there through
a scatter whose duplicate-index order XLA leaves open; no probe reads
that row.  The hit-rank word stays 0: the mesh cache keeps the rotation
eviction (memo.bucket_insert_lanes without a rank word).

On a CUDA device the kernels run (kernels.py, csrc/mesh.cu) or raise;
on the CPU the plain versions here run: `memo_probe_plain`,
`memo_front_plain`, `memo_back_plain` and `memo_insert_plain`.  Every
word is a u32 held in int32 tensors; the plain code widens to int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cilium_tpu_torch.device import MASK32, narrow, widen
from cilium_tpu_torch.engine import memo as vm
from cilium_tpu_torch.engine import sharded as sh
from cilium_tpu_torch.engine.hashtable import fnv1a
from cilium_tpu_torch.engine.mesh import (
    NamedSharding,
    PartitionSpec as P,
    PlacedArray,
    place_array,
    shardings_of,
)
from cilium_tpu_torch.engine.oracle import MATCH_L3
from cilium_tpu_torch.engine.verdict import (
    Verdicts,
    _combine,
    _index_identity,
    _tuple_batch_from_packed,
)
from cilium_tpu_torch.compiler import partition

# a probe record's rows
REC_HIT, REC_CV0, REC_CV1, REC_INS = 0, 1, 2, 3
INS_OK = 1 << 8  # the insert word: lane | INS_OK when the rank < e


@dataclass(frozen=True)
class MemoGeom:
    """What the memo stages route by, fixed when an evaluator is built:
    bucket rows per coordinate (R_local), the table-axis size, lanes per
    row and row words, the compaction capacities, failover mode."""

    c_local: int
    ntp: int
    entries: int
    width: int
    rep_cap: int
    miss_cap: int
    failover: bool

    @property
    def c_global(self) -> int:
        return self.c_local * self.ntp


def _scalar(x) -> int:
    return int(torch.as_tensor(x).reshape(-1)[0])


def _groups64(g: dict) -> dict:
    """MEMO_DEDUP's or dedup_groups' output with int64 index tensors and
    int counts."""
    return dict(srow=g["srow"].long(), gid=g["gid"].long(),
                rep_orig=g["rep_orig"].long(), rep_valid=g["rep_valid"],
                n_unique=_scalar(g["n_unique"]),
                overflow=_scalar(g["overflow"]))


def _rep_keys(keys, g):
    """The representatives' key words and their global buckets, int64
    [rep_cap] each (slots past n_unique repeat a real key)."""
    r = g["rep_orig"][:-1]
    rk = [widen(keys[w])[r] for w in range(3)]
    return rk, fnv1a(torch.stack(rk, dim=1))


# -- the stages, plain versions -------------------------------------------------


def memo_probe_plain(rows: dict, keys, g, mg: MemoGeom,
                     alive_row=None) -> dict:
    """MESH_MEMO_PROBE's plain version: {t: coordinate t's record int32
    [4, rep_cap]} over the slices `rows` {t: [R_local + 1, W]} for the
    row's key words int32 [3, B] and dedup groups `g` (_probe_one)."""
    return {int(t): _probe_one(r, keys, g, mg, int(t), alive_row)
            for t, r in rows.items()}


def _probe_one(rows, keys, g, mg: MemoGeom, t: int,
               alive_row=None) -> torch.Tensor:
    """Coordinate t's record over its slice.  For a valid representative
    whose bucket the coordinate owns (and, in failover mode, whose owner
    `alive_row` [tp] says is alive): hit, cv0, cv1 (the summed value
    words of the hit lanes); for one whose bucket lies in its slice and
    whose rank among the row's representatives of its bucket is below e:
    lane | INS_OK, the lane memo.bucket_insert_lanes picks over the owned
    empty lanes.  Every other word is 0."""
    g = _groups64(g)
    e, c_local = mg.entries, mg.c_local
    (rk0, rk1, rk2), h = _rep_keys(keys, g)
    bucket = h & (mg.c_global - 1)
    pc = bucket // c_local
    valid = torch.arange(mg.rep_cap, device=bucket.device) < min(
        g["n_unique"], mg.rep_cap)
    mine = (pc == t) & valid
    owns = mine
    if mg.failover:
        owns = owns & alive_row.bool()[pc.clamp(0, mg.ntp - 1)]
    cl = (bucket - pc * c_local).clamp(0, c_local - 1)
    crow = widen(rows[cl])
    lane_hit = ((crow[:, :e] == rk0[:, None]) & (crow[:, e:2 * e] == rk1[:, None])
                & (crow[:, 2 * e:3 * e] == rk2[:, None]) & owns[:, None])
    hit = lane_hit.any(dim=1)
    cv0 = torch.where(lane_hit, crow[:, 3 * e:4 * e], 0).sum(dim=1) & MASK32
    cv1 = torch.where(lane_hit, crow[:, 4 * e:5 * e], 0).sum(dim=1) & MASK32
    lane, ok = vm.bucket_insert_lanes(
        (crow[:, :e] == int(vm.EMPTY)) & owns[:, None], bucket, e)
    ins = torch.where(mine & ok, lane | INS_OK, 0)
    return narrow(torch.stack([hit.long(), cv0, cv1, ins]))


def memo_front_plain(records, g, packed, mg: MemoGeom) -> dict:
    """MESH_MEMO_COMBINE's front pass, plain: the table-axis sum of the
    row's tp probe records, the hit masked by rep_valid, the missed
    representatives' ascending positions (padded with rep_cap to
    miss_cap) and the [6, miss_cap] pack of their tuples (padding slots
    take tuple rep_orig[rep_cap] = 0).  Returns {"rep": int32 [4,
    rep_cap] (hit, cv0, cv1, insert word), "miss_pos": int32 [miss_cap],
    "n_miss": int32 [1], "miss_pack": int32 [6, miss_cap]}."""
    g = _groups64(g)
    total = widen(records[0])
    for rec in records[1:]:
        total = total + widen(rec)
    total = total & MASK32
    hit = (total[REC_HIT] > 0) & g["rep_valid"]
    total[REC_HIT] = hit.long()
    miss = g["rep_valid"] & ~hit
    miss_pos = vm._nonzero_padded(miss, mg.miss_cap, mg.rep_cap)
    m_orig = g["rep_orig"][miss_pos]
    return {"rep": narrow(total), "miss_pos": narrow(miss_pos),
            "n_miss": narrow(miss.sum().reshape(1)),
            "miss_pack": packed[:, m_orig].contiguous()}


def _l3_columns(idx, alive_row, rg: sh.RouteGeom):
    """Each tuple's L3 counter column in the row's [E, 2, l3_shards *
    c_local] buffer: on the word's serving owner (its primary, or in
    failover mode the backup next over when the primary is dead) at the
    owner's local column; (column, owned) int64 and bool [B]."""
    word = idx >> 5
    if not rg.l3_sharded:
        return idx.clamp(0, rg.c_local - 1), torch.ones_like(word,
                                                             dtype=torch.bool)
    if rg.failover:
        g32 = rg.wn * 32
        wp = word // rg.wn
        apw = alive_row.bool()[wp.clamp(0, rg.ntp - 1)]
        owner = torch.where(apw, wp,
                            (wp + partition.REPLICA_BACKUP_OFFSET) % rg.ntp)
        lcol = (idx - wp * g32).clamp(0, g32 - 1) + torch.where(apw, 0, g32)
        return owner * rg.c_local + lcol, wp < rg.ntp
    owner = word // rg.w_local
    lcol = (idx - owner * rg.c_local).clamp(0, rg.c_local - 1)
    return owner * rg.c_local + lcol, owner < rg.ntp


def memo_back_plain(front, rparts, tab, g, packed, keys, mg: MemoGeom,
                    rg: sh.RouteGeom, valid=None, alive_row=None,
                    telemetry: bool = True):
    """MESH_MEMO_COMBINE's back pass, plain: the missed representatives'
    lattice from the tp ROUTED_PROBE records `rparts` ([5, miss_cap]
    each) packed into value words, the scatter-back to the row's tuples,
    the combine, the counters (`valid`-masked in failover mode), the
    telemetry row, the replica count and the stats row.  Returns
    (Verdicts, l4 [E, 2, Kg], l3 [E, 2, l3_shards * c_local], telemetry
    [2, TELEM_COLS] or None, replica int32 [1], hit bool [B], stats
    int32 [5], mv int32 [2, miss_cap]), counters as u32 bits."""
    g = _groups64(g)
    rep = widen(front["rep"])
    miss_pos = front["miss_pos"].long()
    n_miss = _scalar(front["n_miss"])
    mpack = front["miss_pack"]
    m_ep, m_dir = mpack[0].long(), mpack[4].long()
    p1, p2, p3, proxy, j = sh.routed_lattice(rparts, tab, m_ep, m_dir)
    mv0, mv1 = vm.pack_value_words(p1, p2, p3, proxy, j)
    hit = rep[REC_HIT].bool()
    v0, v1, tuple_hit = vm.scatter_back(g, mg.rep_cap, hit, rep[REC_CV0],
                                        rep[REC_CV1], miss_pos, mv0, mv1)
    probe1, probe2, probe3, t_proxy, t_j = vm.unpack_value_words(v0, v1)
    frag = packed[5] != 0
    allowed, proxy_out, kind = _combine(probe1, probe2, probe3, t_proxy, frag)
    v = Verdicts(allowed=allowed.to(torch.uint8),
                 proxy_port=proxy_out.to(torch.int32), match_kind=kind)
    ep, dirn = packed[0].long(), packed[4].long()
    ok = (torch.ones_like(allowed) if valid is None or not mg.failover
          else valid.bool())
    l4, trow = sh.l4_counts_and_telemetry(v, tab, ep, dirn, t_j, ok,
                                          telemetry)
    col, owned = _l3_columns(widen(keys[0]), alive_row, rg)
    l3 = torch.zeros((int(tab.l4_meta.shape[0]), 2,
                      rg.l3_shards * rg.c_local), dtype=torch.int32,
                     device=allowed.device)
    sh._accumulate_counters(l3, ep, dirn, col,
                            probe2 & owned & (kind == MATCH_L3) & ok)
    live = torch.arange(mg.miss_cap, device=allowed.device) < n_miss
    replica = torch.zeros((), dtype=torch.int64, device=allowed.device)
    if mg.failover:
        for part in rparts:
            replica = replica + (((widen(part[0]) & sh.F_REPLICA) != 0)
                                 & live).sum()
    overflow = g["overflow"] + max(n_miss - mg.miss_cap, 0)
    ins_ok = (vm.pad_rep(rep[REC_INS], miss_pos) & INS_OK) != 0
    inserts = int((live & ins_ok).sum()) if overflow == 0 else 0
    hits = tuple_hit & ok if mg.failover else tuple_hit
    stats = torch.tensor(
        [g["n_unique"], int(hits.sum()), inserts, overflow,
         int(ok.sum()) if mg.failover else int(ep.shape[0])],
        dtype=torch.int64, device=allowed.device)
    return (v, l4, l3, trow, narrow(replica.reshape(1)), tuple_hit,
            narrow(stats), narrow(torch.stack([mv0, mv1])))


def memo_insert_plain(rows, front, mv, stats, keys, g, mg: MemoGeom, t: int,
                      alive_row=None) -> torch.Tensor:
    """MESH_MEMO_INSERT's plain version: a copy of coordinate t's slice
    `rows` with each live missed representative it owns (its bucket in
    the slice, its owner alive in failover mode, its rank below e)
    written at its insert lane: k0, k1, k2, mv0, mv1.  When the row's
    stats show an overflow the copy is returned unchanged."""
    out = rows.clone()
    if _scalar(stats[vm.STAT_OVERFLOW]) != 0:
        return out
    g = _groups64(g)
    e, c_local = mg.entries, mg.c_local
    miss_pos = front["miss_pos"].long()
    n = min(_scalar(front["n_miss"]), mg.miss_cap)
    (rk0, rk1, rk2), h = _rep_keys(keys, g)
    ins = widen(front["rep"][REC_INS])
    bucket = h & (mg.c_global - 1)
    pc = bucket // c_local
    own = ((pc == t) & ((ins & INS_OK) != 0))
    if mg.failover:
        own = own & alive_row.bool()[pc.clamp(0, mg.ntp - 1)]
    s_ix = torch.nonzero(own[miss_pos[:n]]).reshape(-1)
    sel = miss_pos[s_ix]
    row_ix = bucket[sel] - t * c_local
    lane = ins[sel] & 0xFF
    wide = widen(out)
    for c, w in enumerate((rk0[sel], rk1[sel], rk2[sel],
                           widen(mv[0])[s_ix], widen(mv[1])[s_ix])):
        wide[row_ix, lane + c * e] = w
    return narrow(wide)


# -- dispatch: the kernels on a CUDA device, the plain versions on the CPU --


def _cuda(t) -> bool:
    return t.device.type == "cuda"


def _keys(tab, packed):
    if _cuda(packed):
        from cilium_tpu_torch import kernels

        return kernels.MEMO_KEYS_LATTICE.keys(
            None, packed, view=kernels._shard_view(tab, packed.device,
                                                   dense=False))
    idx, known = _index_identity(tab, widen(packed[1]))
    k = vm.memo_key_words(idx, known, None, packed[0].long(),
                          packed[4].long(),
                          packed[2].long().clamp(0, 65535),
                          packed[3].long().clamp(0, 255))
    return narrow(torch.stack(k))


def _dedup(keys, rep_cap: int) -> dict:
    if _cuda(keys):
        from cilium_tpu_torch import kernels

        return kernels.MEMO_DEDUP(keys, rep_cap)
    return vm.dedup_groups(*(widen(k) for k in keys), rep_cap)


def _probe(rows, keys, g, mg, alive_row):
    if _cuda(keys):
        from cilium_tpu_torch import kernels

        return kernels.MESH_MEMO_PROBE(rows, keys, g, mg, alive_row)
    return memo_probe_plain(rows, keys, g, mg, alive_row)


def _front(records, g, packed, mg):
    if _cuda(packed):
        from cilium_tpu_torch import kernels

        return kernels.MESH_MEMO_COMBINE.front(records, g, packed, mg)
    return memo_front_plain(records, g, packed, mg)


def _back(front, rparts, tab, g, packed, keys, mg, rg, valid, alive_row,
          telemetry):
    if _cuda(packed):
        from cilium_tpu_torch import kernels

        return kernels.MESH_MEMO_COMBINE.back(front, rparts, tab, g, packed,
                                              keys, mg, rg, valid, alive_row,
                                              telemetry)
    return memo_back_plain(front, rparts, tab, g, packed, keys, mg, rg, valid,
                           alive_row, telemetry)


def _insert(rows, front, mv, stats, keys, g, mg, t, alive_row):
    if _cuda(rows):
        from cilium_tpu_torch import kernels

        return kernels.MESH_MEMO_INSERT(rows, front, mv, stats, keys, g, mg,
                                        t, alive_row)
    return memo_insert_plain(rows, front, mv, stats, keys, g, mg, t,
                             alive_row)


def _on(x, dev):
    """A tensor, or a dict of tensors and ints, on `dev`."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.device != dev:
        return x.to(dev)
    return x


# -- the step over the mesh ------------------------------------------------------


def _memo_run(mesh, mt, sb, rg: sh.RouteGeom, mg: MemoGeom, cache_in,
              alive_t, telemetry: bool):
    """The memo step over every coordinate (see the module docstring).
    Returns (Verdicts, l4, l3, replica [], cache' PlacedArray, hit [B],
    stats int32 [5], trows or None), the row outputs gathered on the
    mesh's first device."""
    dp, tp = mesh.devices.shape
    home = mesh.devices[0, 0]
    outs, blocks = [], np.empty((dp, tp), dtype=object)
    for b in range(dp):
        row_dev = mesh.devices[b, 0]
        tab0 = mt.shard(b, 0)
        packed = sb.on(b, row_dev).pack()
        valid = sb.valid_on(b, row_dev)
        alive_row = None if alive_t is None else alive_t[b].to(row_dev)
        keys = _keys(tab0, packed)
        g = _dedup(keys, mg.rep_cap)
        here = {}

        def local(dev):
            # the row's keys, groups and alive vector on `dev`, once
            key = str(dev)
            if key not in here:
                here[key] = (_on(keys, dev), _on(g, dev),
                             None if alive_row is None else alive_row.to(dev))
            return here[key]

        # one probe per device of the row, over its coordinates' slices
        by_dev = {}
        for t in range(tp):
            dev = mesh.devices[b, t]
            by_dev.setdefault(str(dev), (dev, {}))[1][t] = (
                cache_in.block(b, t).reshape(-1, mg.width))
        records = [None] * tp
        for dev, rows in by_dev.values():
            k_t, g_t, a_t = local(dev)
            for t, rec in _probe(rows, k_t, g_t, mg, a_t).items():
                records[t] = _on(rec, row_dev)
        front = _front(records, g, packed, mg)
        miss = _tuple_batch_from_packed(front["miss_pack"])
        rparts = []
        for t in range(tp):
            dev = mesh.devices[b, t]
            batch_t = (miss if dev == row_dev else
                       _tuple_batch_from_packed(front["miss_pack"].to(dev)))
            rparts.append(_on(sh._routed_probe(
                mt.shard(b, t), batch_t, rg, t, local(dev)[2]), row_dev))
        out = _back(front, rparts, tab0, g, packed, keys, mg, rg, valid,
                    alive_row, telemetry)
        stats, mv = out[6], out[7]
        for t in range(tp):
            dev = mesh.devices[b, t]
            k_t, g_t, a_t = local(dev)
            block = cache_in.block(b, t)
            new = _insert(block.reshape(-1, mg.width), _on(front, dev),
                          _on(mv, dev), _on(stats, dev), k_t, g_t, mg, t, a_t)
            blocks[b, t] = new.reshape(block.shape)
        outs.append(out)

    def gather(k):
        return [o[k].to(home) for o in outs]

    v = Verdicts(*(torch.cat([getattr(o[0], c).to(home) for o in outs])
                   for c in ("allowed", "proxy_port", "match_kind")))
    l4 = narrow(torch.stack(gather(1)).sum(dim=0, dtype=torch.int64))
    l3 = narrow(torch.stack(gather(2)).sum(dim=0, dtype=torch.int64))
    trows = torch.stack(gather(3)) if telemetry else None
    replica = narrow(torch.stack(gather(4)).to(torch.int64).sum())
    hit = torch.cat(gather(5))
    stats = narrow(torch.stack(gather(6)).to(torch.int64).sum(dim=0))
    cache_out = PlacedArray(sharding=cache_in.sharding, blocks=blocks,
                            shape=cache_in.shape)
    return v, l4, l3, replica, cache_out, hit, stats, trows


def _cache_geom(mesh, cache_rows, batch_axis, table_axis):
    ndp, ntp = int(mesh.shape[batch_axis]), int(mesh.shape[table_axis])
    cshape = tuple(cache_rows.shape)
    if len(cshape) != 4 or cshape[0] != ndp or cshape[1] != ntp:
        raise ValueError(f"cache rows {cshape} do not match the mesh "
                         f"({ndp}, {ntp})")
    c_local = cshape[2] - 1
    if c_local < 1 or c_local & (c_local - 1):
        raise ValueError(f"cache rows per shard must be a power of two: "
                         f"{c_local}")
    return cshape, c_local, cshape[3] // vm.CACHE_WORDS


def _placed_cache(cache_in, sharding, cshape) -> PlacedArray:
    if isinstance(cache_in, PlacedArray):
        if cache_in.mesh != sharding.mesh:
            raise ValueError("cache rows placed on another mesh")
        got = tuple(cache_in.shape)
    else:
        got = tuple(np.shape(cache_in))
    if got != cshape:
        raise ValueError(f"memo evaluator was built for cache geometry "
                         f"{cshape} but called with {got}; rebuild it")
    if isinstance(cache_in, PlacedArray):
        return cache_in
    return place_array(np.asarray(cache_in, np.uint32), sharding)


def make_partitioned_cache(mesh, n_rows_local: int = 1 << 10,
                           entries: int = 8, batch_axis: str = "batch",
                           table_axis: str = "table"):
    """memo.VerdictCache laid out for the memo evaluators on a mesh: rows
    [dp, tp, n_rows_local + 1, 5 * entries + 1] placed P(batch, table),
    each coordinate its batch row's slice of the bucket rows plus its
    scratch row; the trailing hit-rank word stays 0 (rotation
    eviction)."""
    if n_rows_local & (n_rows_local - 1):
        raise ValueError(f"cache rows per shard must be a power of two: "
                         f"{n_rows_local}")
    dp, tp = int(mesh.shape[batch_axis]), int(mesh.shape[table_axis])

    def factory():
        rows = np.full((dp, tp, n_rows_local + 1,
                        vm.CACHE_WORDS * entries + 1), vm.EMPTY, np.uint32)
        rows[..., -1] = 0
        return rows

    return vm.VerdictCache(rows_factory=factory, sharding=NamedSharding(
        mesh, P(batch_axis, table_axis)))


def make_partitioned_memo_evaluator(mesh, tables, cache_rows, rep_cap: int,
                                    miss_cap: Optional[int] = None,
                                    batch_axis: str = "batch",
                                    table_axis: str = "table",
                                    collect_telemetry: bool = False):
    """sharded.make_partitioned_evaluator with the memo in front: each
    batch row dedups its tuples, the representatives probe the cache
    slice that owns their bucket, only the missed ones run the routed
    lattice, and the inserts land on the owner.  `cache_rows` fixes the
    cache geometry ([dp, tp, R_local + 1, 5e + 1]: a
    make_partitioned_cache's rows), `rep_cap` and `miss_cap` the
    per-row compaction capacities.  Returns fn(tables, batch,
    cache_rows) -> (Verdicts, l4_counts, l3_counts, cache_rows', hit
    bool [B], stats int32 [STATS][, per-chip telemetry]); on
    stats[STAT_OVERFLOW] != 0 only cache_rows' is specified (an
    overflowing row's slices come back unchanged) and the caller
    re-dispatches uncached."""
    if tables.l4_hash_rows is None:
        raise ValueError("partitioned memo evaluator requires the hashed L4 "
                         "entry tables")
    ntp = int(mesh.shape[table_axis])
    specs, rg = sh._routed_geom(tables, ntp, table_axis, failover=False)
    shardings = shardings_of(mesh, specs)
    cshape, c_local, entries = _cache_geom(mesh, cache_rows, batch_axis,
                                           table_axis)
    mg = MemoGeom(c_local=c_local, ntp=ntp, entries=entries,
                  width=cshape[3], rep_cap=int(rep_cap),
                  miss_cap=int(rep_cap if miss_cap is None else miss_cap),
                  failover=False)
    cache_sh = NamedSharding(mesh, P(batch_axis, table_axis))
    built = (tuple(tables.l4_hash_rows.shape),
             tuple(tables.l3_allow_bits.shape))

    def run(tables_in, batch, cache_in):
        got = (sh._shape(tables_in, "l4_hash_rows"),
               sh._shape(tables_in, "l3_allow_bits"))
        if got != built:
            raise ValueError(
                f"partitioned memo evaluator was built for geometry "
                f"{built + (cshape,)} but called with {got}; rebuild with "
                f"make_partitioned_memo_evaluator")
        cache = _placed_cache(cache_in, cache_sh, cshape)
        mt = sh.placed(tables_in, shardings)
        sb = sh.shard_batch(mesh, batch, batch_axis=batch_axis)
        v, l4, l3, _, cache2, hit, stats, trows = _memo_run(
            mesh, mt, sb, rg, mg, cache, None, collect_telemetry)
        out = (v, l4, l3, cache2, hit, stats)
        return out + ((trows,) if collect_telemetry else ())

    run.geom, run.memo_geom = rg, mg
    return run


def make_failover_memo_evaluator(mesh, tables, cache_rows, rep_cap: int,
                                 miss_cap: Optional[int] = None,
                                 batch_axis: str = "batch",
                                 table_axis: str = "table",
                                 collect_telemetry: bool = False):
    """sharded.make_failover_evaluator with the memo in front (the
    router's memo path): the `alive` mask folds into cache ownership (a
    dead chip's slice serves no hit and takes no insert; its keys miss)
    and the missed representatives run the replica-aware routed lattice.
    Returns run(tables_aug, batch, alive [dp, tp], valid [B], cache_rows)
    -> (Verdicts, l4_counts, l3_counts [E, 2, N] global, replica_hits
    (backup gathers of the missed representatives), cache_rows', hit
    bool [B], stats int32 [STATS][, per-chip telemetry]); the overflow
    contract of make_partitioned_memo_evaluator."""
    if tables.l4_hash_rows is None:
        raise ValueError("failover memo evaluator requires the hashed L4 "
                         "entry tables")
    ntp = int(mesh.shape[table_axis])
    dp = int(mesh.shape[batch_axis])
    specs, rg = sh._routed_geom(tables, ntp, table_axis, failover=True)
    shardings = shardings_of(mesh, specs)
    cshape, c_local, entries = _cache_geom(mesh, cache_rows, batch_axis,
                                           table_axis)
    mg = MemoGeom(c_local=c_local, ntp=ntp, entries=entries,
                  width=cshape[3], rep_cap=int(rep_cap),
                  miss_cap=int(rep_cap if miss_cap is None else miss_cap),
                  failover=True)
    cache_sh = NamedSharding(mesh, P(batch_axis, table_axis))
    n_rows, w = (int(tables.l4_hash_rows.shape[0]),
                 int(tables.l3_allow_bits.shape[-1]))
    aug = (n_rows * 2 if rg.rows_sharded else n_rows,
           w * 2 if rg.l3_sharded else w)

    def run(tables_aug, batch, alive, valid, cache_in):
        got = (sh._shape(tables_aug, "l4_hash_rows")[0],
               sh._shape(tables_aug, "l3_allow_bits")[-1])
        if got != aug:
            raise ValueError("failover memo evaluator geometry mismatch; "
                             "rebuild with make_failover_memo_evaluator")
        cache = _placed_cache(cache_in, cache_sh, cshape)
        alive_t = sh._as_tensor(alive, torch.bool, torch.device("cpu"))
        if tuple(alive_t.shape) != (dp, ntp):
            raise ValueError(f"alive must be [{dp}, {ntp}]")
        mt = sh.placed(tables_aug, shardings)
        sb = sh.shard_batch(mesh, batch, valid=valid, batch_axis=batch_axis)
        if not sb.has_valid:
            sb = sh.shard_batch(mesh, sb, valid=torch.ones(
                sb.size, dtype=torch.bool), batch_axis=batch_axis)
        v, l4, l3, replica, cache2, hit, stats, trows = _memo_run(
            mesh, mt, sb, rg, mg, cache, alive_t, collect_telemetry)
        if rg.l3_sharded:
            l3 = sh.fold_l3_aug(l3, ntp)
        out = (v, l4, l3, replica, cache2, hit, stats)
        return out + ((trows,) if collect_telemetry else ())

    run.geom, run.memo_geom = rg, mg
    return run

