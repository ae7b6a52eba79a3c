"""Declarative per-leaf partition rules for the policy tables (the
reference's compiler/partition.py, its policy, ipcache and replica
parts).

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

The byte models (`shard_bytes_model`, `replica_bytes_model`,
`universe_max_identities`, `alltoall_bytes_per_tuple`) account each
leaf as the rule layer places it.
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

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
