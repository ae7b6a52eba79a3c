"""Declarative per-leaf partition rules for the policy and datapath
tables (the reference's compiler/partition.py).

A REGEX RULE TABLE matched over the leaf names (`match_partition_rules`)
decides which leaves shard along the mesh's `table` axis, with
`replicated` as the explicit fallback:

  * `l4_hash_rows`  — the hashed L4 entry plane, along the bucket-row
                      axis (each shard owns a contiguous row slice);
  * `l3_allow_bits` — the L3-only rows, along the identity WORD axis;
  * `l4_allow_bits` — the dense allow bitmap, same word axis;
  * ipcache `buckets` and `range_rows` — the bucket-row axis.

Everything else (id tables, port_slot, stashes, wildcard rows,
scalars) replicates.  The rule table is DATA: `partition_digest` hashes
it into a stamp the device store folds into its epoch layout, so a
delta recorded under one partitioning never scatters into an epoch
laid out under another.

The N+1 replica placement: each sharded leaf of REPLICA_LEAVES also
lives on a BACKUP owner, the next shard over (slice i's copy sits on
shard (i + 1) % ntp), so a dead chip takes down one copy of its rows,
not the rows.  `replicate_table_leaves` lays the device form out,
`replica_delta` rewrites a delta into it.

The fused datapath's families follow the same pattern
(`datapath_partition_specs`): the CT bucket rows, the inline LB rows
and the ipcache's bucket and range-class rows shard along the table
axis and join the N+1 placement (DATAPATH_REPLICA_LEAVES,
`replicate_datapath_leaves`); stashes, the [B, P] scan's ranges, the
classic LB, the prefilter and the tunnel map replicate.  A family of
specs is the family's dataclass with a PartitionSpec in each array
field.

The byte models (`shard_bytes_model`, `replica_bytes_model`,
`universe_max_identities`, `alltoall_bytes_per_tuple` and their
`datapath_*` forms) account each leaf as the rule layer places it.
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.engine.mesh import (
    TABLE_AXIS,
    Mesh,
    PartitionSpec as P,
    shardings_of,
)


def tree_path_to_string(path, sep: str = "/") -> str:
    """A key path (a sequence of keys: dict keys, sequence indices or
    attribute names) -> 'a/b/c'."""
    return sep.join(str(k) for k in path)


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if isinstance(tree, list):
        return list(values)
    if isinstance(tree, tuple):
        return type(tree)(values) if not hasattr(tree, "_fields") else (
            type(tree)(*values))
    return dataclasses.replace(tree, **{
        f.name: v for f, v in zip(dataclasses.fields(tree), values)})


def named_tree_map(f, tree, *rest, is_leaf=None, sep: str = "/"):
    """Map `f(path-string, leaf, *rest-leaves)` over the leaves of a
    tree of dicts, lists, tuples and dataclasses; None is a leaf (as the
    reference's key paths name it), and so is anything `is_leaf` picks."""

    def go(path, node, others):
        kids = None if (is_leaf is not None and is_leaf(node)) else (
            _children(node))
        if kids is None:
            return f(tree_path_to_string(path, sep=sep), node, *others)
        other_kids = [_children(o) for o in others]
        vals = [go(path + (k,), v, [ok[i][1] for ok in other_kids])
                for i, (k, v) in enumerate(kids)]
        return _rebuild(node, vals)

    return go((), tree, list(rest))


# Child order of the table dataclasses (their field order, as the
# reference's pytrees flatten), beside the rules that consume them.
POLICY_LEAF_NAMES = (
    "id_table", "id_direct", "id_lo_len", "port_slot", "l4_meta",
    "l4_allow_bits", "l3_allow_bits", "generation", "l4_hash_rows",
    "l4_hash_stash", "l4_wild_rows", "l4_wild_stash",
)
IPCACHE_LEAF_NAMES = (
    "buckets", "stash", "range_base", "range_mask", "range_plen",
    "range_value", "range_l3_in", "range_l3_out", "range_rows",
)
# the other fused-datapath families
CT_LEAF_NAMES = ("buckets", "stash")
LB_INLINE_LEAF_NAMES = ("rows", "stash")
LB_CLASSIC_LEAF_NAMES = ("buckets", "stash", "backend_rows")


# -- the rule tables ---------------------------------------------------------
# (regex, PartitionSpec) pairs, first match wins; the final catch-all IS
# the replicated fallback, so a new leaf replicates by default.


def default_table_rules(table_axis: str = TABLE_AXIS) -> List[tuple]:
    """The PolicyTables rule table (identity-major leaves sharded)."""
    return [
        # dense allow bitmap [E, 2, Kg, W]: identity WORD axis
        (r"^l4_allow_bits$", P(None, None, None, table_axis)),
        # L3-only rows [E, 2, W]: identity WORD axis
        (r"^l3_allow_bits$", P(None, None, table_axis)),
        # hashed L4 entry plane [R, lanes]: bucket-row axis
        (r"^l4_hash_rows$", P(table_axis)),
        # wild rows, stashes: identity-free and small, replicated
        (r"^l4_(wild_rows|hash_stash|wild_stash)$", P()),
        # replicated fallback: id tables, port_slot, generation, ...
        (r".*", P()),
    ]


def default_ipcache_rules(table_axis: str = TABLE_AXIS) -> List[tuple]:
    """The IPCacheDevice rule table: the /32 bucket rows and the hashed
    range-class rows shard along their row axis; the rest replicates."""
    return [
        (r"^(buckets|range_rows)$", P(table_axis)),
        (r".*", P()),
    ]


def default_ct_rules(table_axis: str = TABLE_AXIS) -> List[tuple]:
    """The CTSnapshot rule table: the bucket rows shard along their row
    axis; the overflow stash replicates (every probe compares it)."""
    return [
        (r"^buckets$", P(table_axis)),
        (r".*", P()),
    ]


def default_lb_rules(table_axis: str = TABLE_AXIS) -> List[tuple]:
    """The LB rule table: the inline layout's service rows shard along
    their row axis.  The classic layout replicates whole (its backend
    rows are indexed by the entry's stored row, not by a hash); the
    stash replicates."""
    return [
        (r"^rows$", P(table_axis)),
        (r".*", P()),
    ]


def match_partition_rules(rules: Sequence[tuple], names: Sequence[str],
                          leaves: Sequence) -> list:
    """The PartitionSpec of each leaf: `names[i]` matched against
    `rules` in order; None, scalar and one-element leaves never
    partition.  An unmatched leaf raises."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out = []
    for name, leaf in zip(names, leaves):
        if leaf is None:
            out.append(P())
            continue
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            out.append(P())
            continue
        for rx, spec in compiled:
            if rx.search(name) is not None:
                out.append(spec)
                break
        else:
            raise ValueError(f"partition rule not found for leaf: {name}")
    return out


def _leaves(tables, names):
    return [getattr(tables, n) for n in names]


def _specs_like(tables, names, specs):
    return dataclasses.replace(tables, **dict(zip(names, specs)))


def policy_partition_specs(tables, table_axis: str = TABLE_AXIS):
    """The PartitionSpec of each PolicyTables leaf under the default
    rule table, as a PolicyTables of specs."""
    specs = match_partition_rules(default_table_rules(table_axis),
                                  POLICY_LEAF_NAMES,
                                  _leaves(tables, POLICY_LEAF_NAMES))
    return _specs_like(tables, POLICY_LEAF_NAMES, specs)


def ipcache_partition_specs(dev, table_axis: str = TABLE_AXIS):
    """The PartitionSpecs of an IPCacheDevice's array leaves (every
    field of another ipcache form replicates), as a dict by name."""
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

    fields = [f.name for f in dataclasses.fields(dev)]
    if not isinstance(dev, IPCacheDevice):
        return {n: P() for n in fields}
    names = [n for n in IPCACHE_LEAF_NAMES if n in fields]
    specs = match_partition_rules(default_ipcache_rules(table_axis), names,
                                  _leaves(dev, names))
    out = {n: P() for n in fields}
    out.update(zip(names, specs))
    return out


def partition_digest(rules: Sequence[tuple]) -> int:
    """Stable 32-bit digest of a rule table, folded into the device
    store's epoch layout stamp."""
    text = ";".join(f"{pat}->{tuple(spec)}" for pat, spec in rules).encode()
    return zlib.crc32(text) & 0xFFFFFFFF


def _divisible(spec, shape, ntp: int, table_axis: str) -> bool:
    for axis, name in enumerate(spec):
        if name == table_axis and (axis >= len(shape)
                                   or shape[axis] % ntp != 0):
            return False
    return True


def divisible_partition_specs(tables, ntp: int,
                              table_axis: str = TABLE_AXIS):
    """policy_partition_specs with the divisibility check applied: a
    leaf whose sharded axis does not split evenly over `ntp` shards
    replicates (the evaluators and the store agree on this here)."""
    specs = policy_partition_specs(tables, table_axis)
    out = []
    for name in POLICY_LEAF_NAMES:
        spec, leaf = getattr(specs, name), getattr(tables, name)
        if leaf is None or not _divisible(
                spec, tuple(getattr(leaf, "shape", ())), ntp, table_axis):
            spec = P()
        out.append(spec)
    return _specs_like(tables, POLICY_LEAF_NAMES, out)


def table_shardings(mesh: Mesh, tables, table_axis: str = TABLE_AXIS):
    """The PolicyTables of NamedSharding (the port's per-coordinate
    placement, engine/mesh.py) of the default rule table resolved
    against `mesh`, indivisible leaves replicated."""
    return shardings_of(mesh, divisible_partition_specs(
        tables, int(mesh.shape[table_axis]), table_axis))


# -- N+1 shard replicas ------------------------------------------------------
# The routed evaluators gather the hashed L4 rows and the L3 words: those
# leaves get backup copies.  The dense l4_allow_bits stays single-sharded.

REPLICA_LEAVES = ("l4_hash_rows", "l3_allow_bits")
# slice i's backup owner is shard (i + REPLICA_BACKUP_OFFSET) % ntp
REPLICA_BACKUP_OFFSET = 1


def replica_axes(tables, ntp: int, table_axis: str = TABLE_AXIS
                 ) -> Dict[str, int]:
    """{leaf name: sharded-axis position} of the REPLICA_LEAVES the
    divisibility-checked rule layer shards at `ntp`."""
    specs = divisible_partition_specs(tables, ntp, table_axis)
    out = {}
    for name in REPLICA_LEAVES:
        for axis, ax_name in enumerate(getattr(specs, name)):
            if ax_name == table_axis:
                out[name] = axis
                break
    return out


def replicate_shard_axis(arr, ntp: int, axis: int) -> np.ndarray:
    """One sharded leaf with its backup copies: the sharded axis [S]
    becomes [2S], laid out per shard q as [slice q ; copy of slice
    (q - 1) % ntp], so shard q holds its own rows and its left
    neighbour's (the backup gather is `n + (i mod n)` on shard
    (owner + 1) % ntp)."""
    arr = np.asarray(arr)
    n = arr.shape[axis] // ntp
    slices = [np.take(arr, np.arange(q * n, (q + 1) * n), axis=axis)
              for q in range(ntp)]
    parts = []
    for q in range(ntp):
        parts.append(slices[q])
        parts.append(slices[(q - REPLICA_BACKUP_OFFSET) % ntp])
    return np.concatenate(parts, axis=axis)


def replicate_table_leaves(tables, ntp: int, table_axis: str = TABLE_AXIS):
    """PolicyTables with every replica-rule leaf augmented (the device
    layout of the replica store); other leaves pass through."""
    axes = replica_axes(tables, ntp, table_axis)
    return dataclasses.replace(tables, **{
        name: replicate_shard_axis(getattr(tables, name), ntp, axis)
        for name, axis in axes.items()})


def replica_positions(idx, n: int, ntp: int):
    """Global sharded-axis indices -> their (primary, backup) positions
    in the augmented layout."""
    idx = np.asarray(idx)
    shard = idx // n
    within = idx % n
    primary = shard * (2 * n) + within
    backup = (((shard + REPLICA_BACKUP_OFFSET) % ntp) * (2 * n) + n
              + within)
    return primary, backup


def replica_delta(delta, tables, ntp: int, table_axis: str = TABLE_AXIS):
    """A TableDelta recorded against the un-augmented layout, rewritten
    into augmented coordinates so one publish keeps both copies equal:
    a scatter that indexes the sharded axis (l4_hash_rows' bucket row)
    lands every row at its primary and its backup position; one whose
    values span the sharded axis (l3_allow_bits' [2, W] slabs) has its
    values augmented as the leaf was.  Whole-leaf replacements of
    replica leaves ship augmented."""
    from cilium_tpu_torch.compiler.delta import LeafUpdate, TableDelta

    axes = replica_axes(tables, ntp, table_axis)
    updates = {}
    for name, up in delta.updates.items():
        axis = axes.get(name)
        if axis is None:
            updates[name] = up
            continue
        n = getattr(tables, name).shape[axis] // ntp
        if axis < len(up.idx):
            primary, backup = replica_positions(up.idx[axis], n, ntp)
            idx = tuple(
                np.concatenate([primary, backup]) if i == axis
                else np.concatenate([comp, comp])
                for i, comp in enumerate(up.idx))
            values = np.concatenate([up.values, up.values], axis=0)
        else:
            # leaf axis `axis` lies inside the values: idx takes the
            # first len(idx) leaf axes, values' axis 0 is the row
            idx = up.idx
            values = replicate_shard_axis(up.values, ntp,
                                          axis - len(up.idx) + 1)
        updates[name] = LeafUpdate(idx=idx, values=values)
    replace = {
        name: (replicate_shard_axis(arr, ntp, axes[name])
               if name in axes else arr)
        for name, arr in delta.replace.items()}
    return TableDelta(base_stamp=delta.base_stamp,
                      new_stamp=delta.new_stamp, updates=updates,
                      replace=replace, layout=delta.layout)


def replica_partition_digest(table_axis: str = TABLE_AXIS,
                             ntp: Optional[int] = None) -> int:
    """Digest of the replica placement (rule table, replica set, backup
    offset and, with `ntp`, the shard count): a replica epoch never
    takes a delta recorded under plain sharding or another shard
    count, and the other way round."""
    text = ";".join(f"{pat}->{tuple(spec)}"
                    for pat, spec in default_table_rules(table_axis))
    text += (f";replicas={','.join(REPLICA_LEAVES)}"
             f";backup_offset={REPLICA_BACKUP_OFFSET}")
    if ntp is not None:
        text += f";ntp={int(ntp)}"
    return zlib.crc32(text.encode()) & 0xFFFFFFFF


def replica_bytes_model(tables, num_shards: int,
                        table_axis: str = TABLE_AXIS):
    """shard_bytes_model under the replica layout: a replica leaf costs
    2 / num_shards per chip.  Returns (rows, per_chip_total,
    replica_overhead_per_chip)."""
    axes = replica_axes(tables, num_shards, table_axis)
    rows, per_chip, _ = shard_bytes_model(tables, num_shards, table_axis)
    overhead = 0
    for r in rows:
        if r["leaf"] in axes and r["sharded"]:
            r["replicated_n_plus_1"] = True
            overhead += r["bytes_per_chip"]
            r["bytes_per_chip"] *= 2
        else:
            r["replicated_n_plus_1"] = False
    return rows, per_chip + overhead, overhead


# -- bytes / headroom models -------------------------------------------------


def _nbytes(leaf) -> int:
    nb = getattr(leaf, "nbytes", None)
    if nb is None and hasattr(leaf, "element_size"):
        nb = leaf.numel() * leaf.element_size()
    return int(nb if nb is not None else np.asarray(leaf).nbytes)


def shard_bytes_model(tables, num_shards: int, table_axis: str = TABLE_AXIS):
    """Per-leaf per-chip bytes as the store places the leaves (the
    divisibility fallback applied).  Returns (rows, per_chip_total,
    replicated_total); rows are dicts leaf/sharded/bytes_total/
    bytes_per_chip."""
    specs = divisible_partition_specs(tables, num_shards, table_axis)
    rows = []
    per_chip = replicated = 0
    for name in POLICY_LEAF_NAMES:
        leaf = getattr(tables, name)
        if leaf is None:
            continue
        nbytes = _nbytes(leaf)
        sharded = any(ax == table_axis for ax in getattr(specs, name))
        chip = (nbytes + num_shards - 1) // num_shards if sharded else nbytes
        if not sharded:
            replicated += nbytes
        per_chip += chip
        rows.append({"leaf": name, "sharded": sharded,
                     "bytes_total": nbytes, "bytes_per_chip": chip})
    return rows, per_chip, replicated


def universe_max_identities(tables, num_shards: int,
                            hbm_bytes: int = 16 << 30,
                            table_axis: str = TABLE_AXIS) -> int:
    """The identity-universe size one mesh can hold: replicated bytes
    plus the identity-major bytes per identity times N / num_shards
    within `hbm_bytes`, leaves classified by rule intent (the padded
    universe divides)."""
    leaves = _leaves(tables, POLICY_LEAF_NAMES)
    specs = match_partition_rules(default_table_rules(table_axis),
                                  POLICY_LEAF_NAMES, leaves)
    n = int(tables.id_table.shape[0])
    id_bytes = replicated = 0
    for leaf, spec in zip(leaves, specs):
        if leaf is None:
            continue
        if any(ax == table_axis for ax in spec):
            id_bytes += _nbytes(leaf)
        else:
            replicated += _nbytes(leaf)
    per_id = id_bytes / max(n, 1)
    budget = hbm_bytes - replicated
    if per_id <= 0 or budget <= 0:
        return 0
    return int(budget * num_shards / per_id)


def alltoall_bytes_per_tuple(num_shards: int) -> float:
    """Collective bytes the routed evaluator moves per tuple along the
    table axis: exact-probe found and value (8 B) plus the L3 bit (4 B);
    none on a one-shard mesh."""
    if num_shards <= 1:
        return 0.0
    return 12.0


# -- the fused datapath's families (CT, LB, ipcache) --------------------------
# Every hashed bucket-row plane the fused datapath gathers shards along the
# table axis as l4_hash_rows does, and the ones below join the N+1 replica
# placement.  Stashes, the [B, P] scan's range arrays, the classic LB,
# the prefilter and the tunnel map replicate.

# (family, leaf) pairs the N+1 layout augments; a family without the
# leaf (lb.rows on the classic layout) is skipped
DATAPATH_REPLICA_LEAVES = (
    ("ct", "buckets"),
    ("ipcache", "buckets"),
    ("ipcache", "range_rows"),
    ("lb", "rows"),
)


def _family_spec_children(children, names, rules, ntp, table_axis):
    """The PartitionSpec of each child of one family, indivisible
    sharded axes replicated; None children keep None."""
    specs = match_partition_rules(rules, names, children)
    out = []
    for leaf, spec in zip(children, specs):
        if leaf is None:
            out.append(None)
            continue
        if not _divisible(spec, tuple(np.shape(leaf)), ntp, table_axis):
            spec = P()
        out.append(spec)
    return tuple(out)


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _replicated_specs(obj):
    """The family dataclass with every array field replicated (P())."""
    return dataclasses.replace(obj, **{
        f.name: P() for f in dataclasses.fields(obj)
        if _is_array(getattr(obj, f.name))})


def _family_specs(obj, names, rules, ntp, table_axis):
    children = [getattr(obj, n) for n in names]
    specs = _family_spec_children(children, names, rules, ntp, table_axis)
    return dataclasses.replace(obj, **dict(zip(names, specs)))


def ct_family_specs(ct, ntp: int, table_axis: str = TABLE_AXIS):
    """The CTSnapshot of PartitionSpecs under default_ct_rules."""
    return _family_specs(ct, CT_LEAF_NAMES, default_ct_rules(table_axis),
                         ntp, table_axis)


def _lb_leaf_names(lb) -> tuple:
    from cilium_tpu_torch.lb.device import LBInline

    return (LB_INLINE_LEAF_NAMES if isinstance(lb, LBInline)
            else LB_CLASSIC_LEAF_NAMES)


def lb_family_specs(lb, ntp: int, table_axis: str = TABLE_AXIS):
    """The LBInline or LBTables of PartitionSpecs under
    default_lb_rules."""
    return _family_specs(lb, _lb_leaf_names(lb), default_lb_rules(table_axis),
                         ntp, table_axis)


def ipcache_family_specs(dev, ntp: int, table_axis: str = TABLE_AXIS):
    """The IPCacheDevice of PartitionSpecs under default_ipcache_rules
    (divisibility checked); a DIR-24-8 ipcache replicates."""
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

    if not isinstance(dev, IPCacheDevice):
        return _replicated_specs(dev)
    return _family_specs(dev, IPCACHE_LEAF_NAMES,
                         default_ipcache_rules(table_axis), ntp, table_axis)


def datapath_partition_specs(dtables, ntp: int, table_axis: str = TABLE_AXIS):
    """The PartitionSpecs of a whole DatapathTables: each family under
    its own rule table, the policy under the divisible policy rules,
    the prefilter and the tunnel map replicated.  A family dataclass of
    specs keeps its scalar fields."""
    return dataclasses.replace(
        dtables,
        prefilter=_replicated_specs(dtables.prefilter),
        ipcache=ipcache_family_specs(dtables.ipcache, ntp, table_axis),
        ct=ct_family_specs(dtables.ct, ntp, table_axis),
        lb=lb_family_specs(dtables.lb, ntp, table_axis),
        policy=divisible_partition_specs(dtables.policy, ntp, table_axis),
        tunnel=(None if dtables.tunnel is None
                else _replicated_specs(dtables.tunnel)),
    )


def _map_family_specs(fn, specs):
    """`fn(family, leaf, spec)` over every PartitionSpec leaf of a
    DatapathTables of specs, the same tree shape back."""
    fams = {}
    for f in dataclasses.fields(specs):
        obj = getattr(specs, f.name)
        if obj is None:
            continue
        fams[f.name] = dataclasses.replace(obj, **{
            g.name: fn(f.name, g.name, getattr(obj, g.name))
            for g in dataclasses.fields(obj)
            if isinstance(getattr(obj, g.name), P)})
    return dataclasses.replace(specs, **fams)


def datapath_table_shardings(mesh: Mesh, dtables,
                             table_axis: str = TABLE_AXIS):
    """The DatapathTables of NamedSharding of the family rules resolved
    against `mesh` (the datapath store's placement)."""
    from cilium_tpu_torch.engine.mesh import NamedSharding

    specs = datapath_partition_specs(dtables, int(mesh.shape[table_axis]),
                                     table_axis)
    return _map_family_specs(lambda f, n, s: NamedSharding(mesh, s), specs)


def datapath_replica_axes(dtables, ntp: int, table_axis: str = TABLE_AXIS):
    """{(family, leaf): sharded-axis position} of the
    DATAPATH_REPLICA_LEAVES the divisibility-checked rules shard at
    `ntp`."""
    specs = datapath_partition_specs(dtables, ntp, table_axis)
    out = {}
    for fam, leaf in DATAPATH_REPLICA_LEAVES:
        fobj = getattr(dtables, fam)
        if fobj is None or getattr(fobj, leaf, None) is None:
            continue
        spec = getattr(getattr(specs, fam), leaf, None)
        if not isinstance(spec, P):
            continue
        for axis, ax in enumerate(spec):
            if ax == table_axis:
                out[(fam, leaf)] = axis
                break
    return out


def datapath_all_replica_axes(dtables, ntp: int,
                              table_axis: str = TABLE_AXIS):
    """{(family, leaf): sharded axis} over the whole datapath tree: the
    datapath families' replica leaves and the policy's, keyed
    ("policy", name).  The one enumeration the delta publish, the chip
    repair and the residency checks share."""
    out = dict(datapath_replica_axes(dtables, ntp, table_axis))
    out.update({("policy", name): axis for name, axis in replica_axes(
        dtables.policy, ntp, table_axis).items()})
    return out


def replicate_datapath_leaves(dtables, ntp: int,
                              table_axis: str = TABLE_AXIS):
    """DatapathTables with every datapath replica leaf augmented along
    its sharded axis (replicate_shard_axis) and the policy augmented by
    replicate_table_leaves: the layout the fused failover evaluator
    reads."""
    axes = datapath_replica_axes(dtables, ntp, table_axis)
    ups: Dict[str, dict] = {}
    for (fam, leaf), axis in axes.items():
        ups.setdefault(fam, {})[leaf] = replicate_shard_axis(
            getattr(getattr(dtables, fam), leaf), ntp, axis)
    fams = {fam: dataclasses.replace(getattr(dtables, fam), **u)
            for fam, u in ups.items()}
    return dataclasses.replace(
        dtables, policy=replicate_table_leaves(dtables.policy, ntp,
                                               table_axis), **fams)


def datapath_partition_digest(table_axis: str = TABLE_AXIS,
                              ntp: Optional[int] = None) -> int:
    """Digest of the whole fused-datapath placement: every family's rule
    table, both replica sets, the backup offset and, with `ntp`, the
    shard count (the augmented shapes do not depend on it)."""
    parts = []
    for fam, rules in (("policy", default_table_rules(table_axis)),
                       ("ipcache", default_ipcache_rules(table_axis)),
                       ("ct", default_ct_rules(table_axis)),
                       ("lb", default_lb_rules(table_axis))):
        parts.append(fam + ":" + ";".join(f"{pat}->{tuple(spec)}"
                                          for pat, spec in rules))
    parts.append("replicas=" + ",".join(REPLICA_LEAVES))
    parts.append("dp_replicas=" + ",".join(
        f"{f}.{leaf}" for f, leaf in DATAPATH_REPLICA_LEAVES))
    parts.append(f"backup_offset={REPLICA_BACKUP_OFFSET}")
    if ntp is not None:
        parts.append(f"ntp={int(ntp)}")
    return zlib.crc32("|".join(parts).encode()) & 0xFFFFFFFF


def _family_byte_rows(fam, obj, names, rules, ntp, table_axis, rep_axes):
    children = [getattr(obj, n) for n in names]
    specs = _family_spec_children(children, names, rules, ntp, table_axis)
    rows = []
    for name, leaf, spec in zip(names, children, specs):
        if leaf is None:
            continue
        nbytes = _nbytes(leaf)
        sharded = spec is not None and any(ax == table_axis for ax in spec)
        chip = (nbytes + ntp - 1) // ntp if sharded else nbytes
        rep = (fam, name) in rep_axes
        if rep:
            chip *= 2
        rows.append({"leaf": f"{fam}.{name}", "sharded": sharded,
                     "replicated_n_plus_1": rep, "bytes_total": nbytes,
                     "bytes_per_chip": chip})
    return rows


def _array_bytes(obj) -> int:
    return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj)
               if _is_array(getattr(obj, f.name)))


def datapath_bytes_model(dtables, num_shards: int,
                         table_axis: str = TABLE_AXIS):
    """Per-leaf per-chip bytes of the whole fused datapath under the
    family rules and the N+1 placement.  Returns (rows, per_chip_total,
    replicated_total, overhead): `replicated_total` the per-chip bytes
    of the replicated leaves, `overhead` the backup copies' bytes."""
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

    rep_axes = datapath_replica_axes(dtables, num_shards, table_axis)
    pol_rows, per_chip, overhead = replica_bytes_model(
        dtables.policy, num_shards, table_axis)
    rows = [{**r, "leaf": f"policy.{r['leaf']}"} for r in pol_rows]
    replicated = sum(r["bytes_per_chip"] for r in rows if not r["sharded"])
    fam_args = [("ct", dtables.ct, CT_LEAF_NAMES,
                 default_ct_rules(table_axis)),
                ("lb", dtables.lb, _lb_leaf_names(dtables.lb),
                 default_lb_rules(table_axis))]
    if isinstance(dtables.ipcache, IPCacheDevice):
        fam_args.append(("ipcache", dtables.ipcache, IPCACHE_LEAF_NAMES,
                         default_ipcache_rules(table_axis)))
    for fam, obj, names, rules in fam_args:
        frows = _family_byte_rows(fam, obj, names, rules, num_shards,
                                  table_axis, rep_axes)
        rows.extend(frows)
        for r in frows:
            per_chip += r["bytes_per_chip"]
            if not r["sharded"]:
                replicated += r["bytes_per_chip"]
            elif r["replicated_n_plus_1"]:
                overhead += r["bytes_per_chip"] // 2
    extra = [dtables.prefilter, dtables.tunnel]
    if not isinstance(dtables.ipcache, IPCacheDevice):
        extra.append(dtables.ipcache)
    for obj in extra:
        if obj is None:
            continue
        nbytes = _array_bytes(obj)
        per_chip += nbytes
        replicated += nbytes
    return rows, per_chip, replicated, overhead


def datapath_universe_max_identities(dtables, num_shards: int,
                                     hbm_bytes: int = 16 << 30,
                                     table_axis: str = TABLE_AXIS) -> int:
    """universe_max_identities over the whole datapath: the policy's
    identity-major leaves (replica leaves twice) and the ipcache /32
    bucket plane scale with the identities; the CT and LB planes (which
    scale with flows and services) and the replicated leaves join the
    per-chip constant."""
    pol = dtables.policy
    leaves = _leaves(pol, POLICY_LEAF_NAMES)
    specs = match_partition_rules(default_table_rules(table_axis),
                                  POLICY_LEAF_NAMES, leaves)
    n = int(pol.id_table.shape[0])
    id_bytes = 0.0
    constant = 0.0
    for name, leaf, spec in zip(POLICY_LEAF_NAMES, leaves, specs):
        if leaf is None:
            continue
        if any(ax == table_axis for ax in spec):
            id_bytes += _nbytes(leaf) * (2 if name in REPLICA_LEAVES else 1)
        else:
            constant += _nbytes(leaf)
    rows, per_chip, _, _ = datapath_bytes_model(dtables, num_shards,
                                                table_axis)
    for r in rows:
        if r["leaf"].startswith("policy."):
            continue
        if r["leaf"] == "ipcache.buckets" and r["sharded"]:
            id_bytes += r["bytes_total"] * (
                2 if r["replicated_n_plus_1"] else 1)
        else:
            constant += r["bytes_per_chip"]
    constant += max(per_chip - sum(r["bytes_per_chip"] for r in rows), 0)
    per_id = id_bytes / max(n, 1)
    budget = hbm_bytes - constant
    if per_id <= 0 or budget <= 0:
        return 0
    return int(budget * num_shards / per_id)


def datapath_alltoall_bytes_per_tuple(num_shards: int,
                                      range_classes: int = 2) -> float:
    """Collective bytes the fused routed pipeline moves per tuple along
    the table axis: the lattice's 12 B, the CT service probe (8 B), the
    CT flow probe (16 B), the LB resolution (20 B), the ipcache exact
    probe (8 B) and 8 B per hashed range class; none on one shard."""
    if num_shards <= 1:
        return 0.0
    return 12.0 + 8.0 + 16.0 + 20.0 + 8.0 + 8.0 * range_classes


# -- live resharding: the owned-row delta between two shard counts ---------------
#
# The augmented replica layout keeps its total shape under any shard
# count (a sharded axis [S] is [2S] whatever ntp), so moving a leaf from
# ntp_src to ntp_dst shards is an index permutation of the augmented
# axis.  A target augmented row j, holding un-augmented row u owned by
# target column c, is RETAINED (already on its chip, no bytes) iff c also
# exists in the source layout (c < ntp_src) and the source chip of column
# c already held u in its primary or backup region; every other row is
# MOVED (streamed host to device by engine/reshard.py and counted in
# reshard_bytes_h2d).  A grow 2 -> 4 moves exactly the new columns'
# contents.


def reshard_row_map(n_rows: int, ntp_src: int, ntp_dst: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """For one sharded leaf axis of un-augmented length `n_rows`:
    (src_unaug, moved) over the target augmented axis [2 * n_rows]:
    src_unaug[j] the un-augmented row position j holds under ntp_dst
    (a column block's primary region [0, n) its own slice, its backup
    region [n, 2n) its left neighbour's), moved[j] whether position j
    must be streamed.  Both shard counts must divide `n_rows`."""
    s = int(n_rows)
    if s % ntp_src or s % ntp_dst:
        raise ValueError(f"shard counts {ntp_src}->{ntp_dst} must divide "
                         f"the sharded axis ({s} rows)")
    n_t = s // ntp_dst
    n_s = s // ntp_src
    j = np.arange(2 * s)
    col = j // (2 * n_t)
    within = j - col * 2 * n_t
    primary = within < n_t
    src_unaug = np.where(
        primary, col * n_t + within,
        ((col - REPLICA_BACKUP_OFFSET) % ntp_dst) * n_t + (within - n_t))
    src_shard = src_unaug // n_s
    resident = (col < ntp_src) & (
        (src_shard == col)
        | (src_shard == (col - REPLICA_BACKUP_OFFSET) % ntp_src))
    return src_unaug, ~resident


def reshard_moved_rows(tables, ntp_src: int, ntp_dst: int,
                       table_axis: str = TABLE_AXIS
                       ) -> Dict[str, Tuple[int, np.ndarray]]:
    """{leaf: (axis, moved target-augmented indices)} of the policy
    replica leaves: the rows a ReshardPlan streams.  A leaf sharded at
    one count and replicated at the other is a geometry change, not a
    permutation: ValueError."""
    src_axes = replica_axes(tables, ntp_src, table_axis)
    dst_axes = replica_axes(tables, ntp_dst, table_axis)
    if set(src_axes) != set(dst_axes):
        raise ValueError(
            f"replica leaf sets differ between shard counts {ntp_src} "
            f"({sorted(src_axes)}) and {ntp_dst} ({sorted(dst_axes)}): not "
            f"a permutation reshard")
    out: Dict[str, Tuple[int, np.ndarray]] = {}
    for name, axis in dst_axes.items():
        n = int(np.shape(getattr(tables, name))[axis])
        _, moved = reshard_row_map(n, ntp_src, ntp_dst)
        out[name] = (axis, np.flatnonzero(moved))
    return out


def datapath_reshard_moved_rows(dtables, ntp_src: int, ntp_dst: int,
                                table_axis: str = TABLE_AXIS
                                ) -> Dict[Tuple[str, str],
                                          Tuple[int, np.ndarray]]:
    """reshard_moved_rows over the whole fused datapath: {(family, leaf):
    (axis, moved target-augmented indices)} of every N+1 leaf (policy,
    CT, ipcache, LB: datapath_all_replica_axes)."""
    src_axes = datapath_all_replica_axes(dtables, ntp_src, table_axis)
    dst_axes = datapath_all_replica_axes(dtables, ntp_dst, table_axis)
    if set(src_axes) != set(dst_axes):
        raise ValueError(
            f"datapath replica leaf sets differ between shard counts "
            f"{ntp_src} and {ntp_dst}: not a permutation reshard")
    out: Dict[Tuple[str, str], Tuple[int, np.ndarray]] = {}
    for (fam, leaf), axis in dst_axes.items():
        n = int(np.shape(getattr(getattr(dtables, fam), leaf))[axis])
        _, moved = reshard_row_map(n, ntp_src, ntp_dst)
        out[(fam, leaf)] = (axis, np.flatnonzero(moved))
    return out
