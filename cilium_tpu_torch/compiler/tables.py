"""Lowering per-endpoint policy map states to the datapath's tables.

Host-side numpy, leaf for leaf the layout the fused datapath reads:

  * identity universe `id_table` (sorted, padded) and the direct
    id -> index table `id_direct` (cluster-scope ids dense from 0,
    local CIDR ids dense from `id_lo_len`);
  * `l4_meta[e, d, j] = proxy_port << 1 | wildcard` per endpoint,
    direction and global L4 slot j;
  * the dense bitmaps `l4_allow_bits` / `l3_allow_bits` and the
    (proto, dport) -> slot table `port_slot` (the cold plane);
  * the hashed L4 entry tables: exact entries and wildcard (identity
    0) entries, each a power-of-two count of bucket rows plus a small
    overflow stash.  A probe is one row read and a lane compare.

Two hashed layouts exist.  The 3-word planar entry
(key0 = idx | dir << 22 | (ep & 0x1FF) << 23,
 key1 = dport << 16 | proto << 8 | ep >> 9,
 value = j << 16 | proxy) is what `lower_map_state` builds; the
compact 2-word entry (`repack_l4_subword`) keeps only the 12-bit slot
j beside the key and rebuilds the proxy port from `l4_meta`:

  cw0 = idx18 | (dport & 0x3FFF) << 18
  cw1 = dport >> 14 | proto << 2 | ep << 10 | dir << 18 | j << 19
  (empty lanes hold cw1 = 1 << 31)

The stash width (3 or 2 columns) is the layout marker.

`FleetCompiler` is the daemon's incremental lowering: it caches the
identity universe (arrival order), the slot space (first-seen order)
and each endpoint's rows by state token, stamps every compile with a
generation, and records what each compile changed so that `delta_for`
can describe the change between two publishes (compiler/delta.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cilium_tpu_torch.engine.hashtable import (
    FNV_OFFSET,
    FNV_PRIME,
    trim_pow2_prefix,
)
from cilium_tpu_torch.maps.policymap import (
    MapStateArrays,
    PolicyMapState,
    unpack_keys,
)

# Sentinel for padded slots of the sorted identity table.
PAD_ID = np.uint32(0xFFFFFFFF)
# Absent-entry marker in the direct identity index table.
NO_INDEX = np.uint32(0xFFFFFFFF)
# Absent-slot marker in the (proto, dport) -> L4 slot table.
NO_SLOT = np.uint16(0xFFFF)
# Cap on direct-table sizes (2^22 u32 = 16 MB).
MAX_DIRECT = 1 << 22

# Local (CIDR) identities live in a dedicated high id range
# (the reference's IdentityAllocator.LOCAL_IDENTITY_BASE).
LOCAL_ID_BASE = 1 << 24
# The reserved WORLD identity (pkg/identity numericidentity.go).
RESERVED_WORLD = 2

# -- hashed L4 entry table (3-word layout) -----------------------------------
L4H_LANES = 64
L4H_WILD_IDX = np.uint32((1 << 22) - 1)
L4H_STASH = 64

# -- compact (2-word) layout ---------------------------------------------------
L4C_LANES = 32
L4C_WILD_IDX18 = np.uint32((1 << 18) - 1)
L4C_KEY_MASK = np.uint32((1 << 19) - 1)
L4C_EMPTY_W1 = np.uint32(1 << 31)
L4C_CMP_MASK = np.uint32(L4C_KEY_MASK | L4C_EMPTY_W1)

# FleetCompiler instance nonces: a generation stamp is nonce << 32 |
# publish counter, so stamps of two compilers never compare.
_COMPILER_NONCE = itertools.count(1)

# the dense-bitmap fallback leaves the hashed probes never read
COLD_LEAVES = ("port_slot", "l4_allow_bits")


def l4h_entries(lanes: int) -> int:
    """Entries per bucket row at a given lane width (3 words each)."""
    return lanes // 3


def l4h_load(lanes: int) -> int:
    """Target average entries per bucket when sizing the row count."""
    return max(lanes // 8, 2)


def trim_stash(stash: np.ndarray) -> np.ndarray:
    """Trim a [L4H_STASH, 3 or 2] stash to the pow2 prefix holding its
    occupied rows (front-filled)."""
    if stash.shape[-1] == 2:
        used = int((stash[:, 1] != L4C_EMPTY_W1).sum())
    else:
        used = int((stash[:, 1] != np.uint32(0xFFFFFFFF)).sum())
    return trim_pow2_prefix(stash, used)


def l4_entry_words(tables_or_stash) -> int:
    """Entry word count of the hashed L4 layout (3 wide, 2 compact),
    read from the stash width."""
    stash = getattr(tables_or_stash, "l4_hash_stash", tables_or_stash)
    if stash is None:
        return 3
    return 2 if int(stash.shape[-1]) == 2 else 3


# Key packers over numpy u32 arrays.  The device probe computes the
# same words (engine/verdict.py on int64 tensors, csrc/verdict.cuh).
def l4c_key0(idx, dport):
    return (idx.astype(np.uint32) & np.uint32(0x3FFFF)) | (
        (dport.astype(np.uint32) & np.uint32(0x3FFF)) << np.uint32(18)
    )


def l4c_key1(dport, proto, ep, d):
    """Compact key word 1, key bits only (j is ORed in at build)."""
    return (
        (dport.astype(np.uint32) >> np.uint32(14))
        | ((proto.astype(np.uint32) & np.uint32(0xFF)) << np.uint32(2))
        | ((ep.astype(np.uint32) & np.uint32(0xFF)) << np.uint32(10))
        | ((d.astype(np.uint32) & np.uint32(1)) << np.uint32(18))
    )


def l4h_key0(idx, d, ep):
    return (
        idx.astype(np.uint32)
        | (d.astype(np.uint32) << np.uint32(22))
        | ((ep.astype(np.uint32) & np.uint32(0x1FF)) << np.uint32(23))
    )


def l4h_key1(dport, proto, ep):
    return (
        (dport.astype(np.uint32) << np.uint32(16))
        | (proto.astype(np.uint32) << np.uint32(8))
        | (ep.astype(np.uint32) >> np.uint32(9))
    )


def _fnv1a_host_2(w0: np.ndarray, w1: np.ndarray) -> np.ndarray:
    """FNV-1a over two u32 word columns."""
    h = np.full(len(w0), FNV_OFFSET, dtype=np.uint64)
    prime = np.uint64(int(FNV_PRIME))
    for col in (w0, w1):
        c = col.astype(np.uint64)
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((c >> shift) & 0xFF)) * prime) & 0xFFFFFFFF
    return h.astype(np.uint32)


def _round_up(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _pow2_at_least(n: int, floor: int) -> int:
    size = floor
    while size < n:
        size <<= 1
    return size


def _bucket_ranks(h: np.ndarray, n_rows: int, entries: int):
    """Rows double until the overflow fits the stash.  Returns
    (n_rows, order, sorted buckets, rank, main)."""
    t = len(h)
    while True:
        b = (h & np.uint32(n_rows - 1)).astype(np.int64)
        order = np.argsort(b, kind="stable")
        sb = b[order]
        first = np.searchsorted(sb, sb)
        rank = np.arange(t, dtype=np.int64) - first
        main = rank < entries
        if int((~main).sum()) <= L4H_STASH:
            return n_rows, order, sb, rank, main
        n_rows <<= 1


def place_l4_hash(w0, w1, value, h, min_rows: int, lanes: int = L4H_LANES):
    """Bucket placement of 3-word entries: (rows, stash untrimmed,
    overflow positions, buckets).  The one layout implementation,
    shared by build_l4_hash and the incremental tables of
    compiler/delta.py (which keep the last two as their per-bucket
    overflow state)."""
    t = len(w0)
    entries = l4h_entries(lanes)
    n_rows = _pow2_at_least(max(t // l4h_load(lanes), 1), min_rows)
    n_rows, order, sb, rank, main = _bucket_ranks(h, n_rows, entries)
    rows = np.zeros((n_rows, lanes), dtype=np.uint32)
    rows[:, entries : 2 * entries] = np.uint32(0xFFFFFFFF)
    flat = rows.reshape(-1)
    mo = order[main]
    base = sb[main] * lanes + rank[main]
    flat[base] = w0[mo]
    flat[base + entries] = w1[mo]
    flat[base + 2 * entries] = value[mo]
    stash = np.zeros((L4H_STASH, 3), dtype=np.uint32)
    stash[:, 1] = np.uint32(0xFFFFFFFF)
    so = order[~main]
    stash[: len(so), 0] = w0[so]
    stash[: len(so), 1] = w1[so]
    stash[: len(so), 2] = value[so]
    return rows, stash, so, (h & np.uint32(n_rows - 1)).astype(np.int64)


def build_l4_hash(ep, d, idx, dport, proto, value, min_rows: int = 64,
                  lanes: int = L4H_LANES):
    """Vectorized placement of T entries -> (rows u32 [R, lanes],
    stash u32 [pow2 used, 3])."""
    t = len(ep)
    if np.any((idx >= L4H_WILD_IDX) & (idx != L4H_WILD_IDX)):
        raise ValueError("identity index exceeds 22-bit hash key space")
    if t and int(ep.max()) >= 65536:
        raise ValueError("endpoint axis exceeds the 16-bit key space")
    w0 = l4h_key0(idx, d, ep)
    w1 = l4h_key1(dport, proto, ep)
    h = _fnv1a_host_2(w0, w1)
    rows, stash, _, _ = place_l4_hash(w0, w1, value, h, min_rows,
                                      lanes=lanes)
    return rows, trim_stash(stash)


def build_l4_hash_pair(ep, d, idx, dport, proto, value,
                       lanes: int = L4H_LANES):
    """Partition entries into the exact and wildcard tables:
    (rows, stash, wild_rows, wild_stash)."""
    wild = idx == L4H_WILD_IDX
    keep = ~wild
    rows, stash = build_l4_hash(
        ep[keep], d[keep], idx[keep], dport[keep], proto[keep],
        value[keep], lanes=lanes,
    )
    wrows, wstash = build_l4_hash(
        ep[wild], d[wild], idx[wild], dport[wild], proto[wild],
        value[wild], min_rows=16, lanes=lanes,
    )
    return rows, stash, wrows, wstash


@dataclass
class PolicyTables:
    """Stacked verdict tables for E endpoints.  Leaves are numpy
    arrays as built, or int32/u16 tensors once moved to a device
    (convert.tables_to).

      id_table       u32 [N]            sorted identity universe
      id_direct      u32 [LO+LL]        id -> index (two dense regions)
      id_lo_len      i32 scalar         split point of id_direct
      port_slot      u16 [256, 65536]   (proto, dport) -> L4 slot (cold)
      l4_meta        u32 [E, 2, Kg]     proxy_port << 1 | wildcard
      l4_allow_bits  u32 [E, 2, Kg, W]  per-identity allow (cold)
      l3_allow_bits  u32 [E, 2, W]      L3-only allow
      generation     u64 scalar         publish stamp (0 = unstamped)
      l4_hash_rows / l4_hash_stash      exact hashed entries
      l4_wild_rows / l4_wild_stash      wildcard hashed entries
    """

    id_table: object
    id_direct: object
    id_lo_len: object
    port_slot: object
    l4_meta: object
    l4_allow_bits: object
    l3_allow_bits: object
    # publish-generation stamp (FleetCompiler): nonce << 32 | publish
    # counter, a numpy u64 scalar on the host and a Python int on a
    # device; 0 = unstamped (one-shot compiles)
    generation: object = np.uint64(0)
    l4_hash_rows: object = None
    l4_hash_stash: object = None
    l4_wild_rows: object = None
    l4_wild_stash: object = None


def split_hot(tables: PolicyTables) -> PolicyTables:
    """The hot plane: cold leaves dropped (None).  Only valid for
    tables carrying the hashed entry pair."""
    if tables.l4_hash_rows is None:
        raise ValueError(
            "hot/cold split requires the hashed L4 entry tables "
            "(dense-fallback tables gather the cold plane)"
        )
    return dataclasses.replace(tables, **{leaf: None for leaf in COLD_LEAVES})


def tables_layout_version(tables) -> int:
    """Layout stamp of a PolicyTables: the hashed tables' pack widths,
    the dropped cold leaves and the compact-entry bit (the reference's
    compiler/tables.py tables_layout_version).  Tables with different
    stamps differ in their leaf set or lane widths; the verdict cache's
    epoch stamp carries it."""
    if tables is None:
        return 0
    rows = getattr(tables, "l4_hash_rows", None)
    wrows = getattr(tables, "l4_wild_rows", None)
    lanes = 0 if rows is None else int(rows.shape[1])
    wlanes = 0 if wrows is None else int(wrows.shape[1])
    cold_bits = 0
    for i, leaf in enumerate(COLD_LEAVES):
        if getattr(tables, leaf, None) is None:
            cold_bits |= 1 << i
    compact_bit = (
        1 if l4_entry_words(tables) == 2 else 0
    ) if getattr(tables, "l4_hash_stash", None) is not None else 0
    return lanes | (wlanes << 11) | (cold_bits << 22) | (compact_bit << 24)


def place_l4_hash_compact(cw0, cw1_key, j, h, min_rows: int,
                          lanes: int = L4C_LANES):
    """Compact sibling of place_l4_hash: 2-word planar entries (cw0
    plane then cw1 plane, the slot index ORed into cw1's value bits).
    Returns (rows, stash untrimmed)."""
    t = len(cw0)
    entries = lanes // 2
    cw1 = cw1_key | (j.astype(np.uint32) << np.uint32(19))
    n_rows = _pow2_at_least(max(t // l4h_load(lanes), 1), min_rows)
    n_rows, order, sb, rank, main = _bucket_ranks(h, n_rows, entries)
    rows = np.zeros((n_rows, lanes), dtype=np.uint32)
    rows[:, entries : 2 * entries] = L4C_EMPTY_W1
    flat = rows.reshape(-1)
    mo = order[main]
    base = sb[main] * lanes + rank[main]
    flat[base] = cw0[mo]
    flat[base + entries] = cw1[mo]
    stash = np.zeros((L4H_STASH, 2), dtype=np.uint32)
    stash[:, 1] = L4C_EMPTY_W1
    so = order[~main]
    stash[: len(so), 0] = cw0[so]
    stash[: len(so), 1] = cw1[so]
    return rows, stash


def l4_entry_records(tables: PolicyTables) -> Dict[str, dict]:
    """Decode every hashed entry, either layout, back to its fields:
    {"exact"/"wild": {ep, d, idx, dport, proto, j, proxy}}."""
    if tables.l4_hash_rows is None:
        raise ValueError("no hashed entry tables to decode")
    ew = l4_entry_words(tables)
    meta = np.asarray(tables.l4_meta)
    out = {}
    for key, rows_leaf, stash_leaf in (
        ("exact", "l4_hash_rows", "l4_hash_stash"),
        ("wild", "l4_wild_rows", "l4_wild_stash"),
    ):
        rows = np.asarray(getattr(tables, rows_leaf))
        stash = np.asarray(getattr(tables, stash_leaf))
        e = rows.shape[1] // ew
        w0 = np.concatenate([rows[:, :e].reshape(-1), stash[:, 0]])
        w1 = np.concatenate([rows[:, e : 2 * e].reshape(-1), stash[:, 1]])
        if ew == 3:
            val = np.concatenate(
                [rows[:, 2 * e : 3 * e].reshape(-1), stash[:, 2]]
            )
            keep = w1 != np.uint32(0xFFFFFFFF)
            w0, w1, val = w0[keep], w1[keep], val[keep]
            ep = ((w0 >> 23) & 0x1FF) | ((w1 & 0xFF) << 9)
            rec = {
                "ep": ep.astype(np.uint32),
                "d": ((w0 >> 22) & 1).astype(np.uint32),
                "idx": (w0 & np.uint32(0x3FFFFF)).astype(np.uint32),
                "dport": (w1 >> 16).astype(np.uint32),
                "proto": ((w1 >> 8) & 0xFF).astype(np.uint32),
                "j": (val >> 16).astype(np.uint32),
                "proxy": (val & 0xFFFF).astype(np.uint32),
            }
        else:
            keep = (w1 & L4C_EMPTY_W1) == 0
            cw0, cw1 = w0[keep], w1[keep]
            idx18 = cw0 & np.uint32(0x3FFFF)
            idx = np.where(
                idx18 == L4C_WILD_IDX18, L4H_WILD_IDX, idx18
            ).astype(np.uint32)
            ep = ((cw1 >> 10) & 0xFF).astype(np.uint32)
            d = ((cw1 >> 18) & 1).astype(np.uint32)
            j = ((cw1 >> 19) & 0xFFF).astype(np.uint32)
            rec = {
                "ep": ep,
                "d": d,
                "idx": idx,
                "dport": ((cw0 >> 18) | ((cw1 & 3) << 14)).astype(np.uint32),
                "proto": ((cw1 >> 2) & 0xFF).astype(np.uint32),
                "j": j,
                "proxy": (
                    meta[ep.astype(np.int64), d.astype(np.int64),
                         j.astype(np.int64)] >> 1
                ).astype(np.uint32),
            }
        out[key] = rec
    return out


def repack_l4_subword(tables: PolicyTables,
                      lanes: int = L4C_LANES) -> PolicyTables:
    """Re-place both hashed entry tables in the compact 2-word layout.
    Raises ValueError when the world's ranges do not fit the compact
    fields (> 2^18-2 padded identities, > 256 endpoints, > 4096 L4
    slots) or an entry's proxy differs from the l4_meta plane."""
    n = int(tables.id_table.shape[0])
    e_count, _, kg = tables.l4_meta.shape
    if n > (1 << 18) - 2:
        raise ValueError(
            f"identity axis {n} exceeds the compact 18-bit idx field"
        )
    if e_count > 256:
        raise ValueError(
            f"endpoint axis {e_count} exceeds the compact 8-bit field"
        )
    if kg > (1 << 12):
        raise ValueError(f"L4 slot axis {kg} exceeds the compact 12-bit field")
    recs = l4_entry_records(tables)
    meta = np.asarray(tables.l4_meta)
    out = {}
    for key, rows_leaf, stash_leaf, min_rows in (
        ("exact", "l4_hash_rows", "l4_hash_stash", 64),
        ("wild", "l4_wild_rows", "l4_wild_stash", 16),
    ):
        r = recs[key]
        meta_proxy = meta[
            r["ep"].astype(np.int64), r["d"].astype(np.int64),
            r["j"].astype(np.int64),
        ] >> 1
        if not np.array_equal(meta_proxy, r["proxy"]):
            raise ValueError(
                "entry proxy diverges from the l4_meta plane — "
                "compact layout would change verdicts"
            )
        idx18 = np.where(
            r["idx"] == L4H_WILD_IDX, L4C_WILD_IDX18, r["idx"]
        ).astype(np.uint32)
        cw0 = l4c_key0(idx18, r["dport"])
        cw1k = l4c_key1(r["dport"], r["proto"], r["ep"], r["d"])
        h = _fnv1a_host_2(cw0, cw1k)
        rows, stash = place_l4_hash_compact(
            cw0, cw1k, r["j"], h, min_rows, lanes=lanes
        )
        out[rows_leaf] = rows
        out[stash_leaf] = trim_stash(stash)
    return dataclasses.replace(tables, **out)


def build_id_table(identity_ids: Sequence[int],
                   identity_pad: int = 1024) -> np.ndarray:
    """Sorted, padded identity universe (a multiple of 32 long)."""
    ids = sorted(set(int(i) for i in identity_ids))
    n = _round_up(len(ids), identity_pad)
    n = _round_up(n, 32)
    table = np.full((n,), PAD_ID, dtype=np.uint32)
    table[: len(ids)] = np.asarray(ids, dtype=np.uint32)
    return table


def _build_direct_index(id_table: np.ndarray) -> Tuple[np.ndarray, int]:
    """One direct id -> index table: [0, lo_len) maps cluster-scope
    ids, [lo_len, end) maps local CIDR ids offset by LOCAL_ID_BASE.
    Returns (id_direct, lo_len)."""
    ids = id_table[id_table != PAD_ID].astype(np.int64)
    index = np.arange(len(ids), dtype=np.uint32)
    local_mask = ids >= LOCAL_ID_BASE
    lo_ids, lo_idx = ids[~local_mask], index[~local_mask]
    local_ids = ids[local_mask] - LOCAL_ID_BASE
    local_idx = index[local_mask]
    lo_max = int(lo_ids.max()) + 1 if len(lo_ids) else 1
    ll_max = int(local_ids.max()) + 1 if len(local_ids) else 1
    if lo_max > MAX_DIRECT or ll_max > MAX_DIRECT:
        raise ValueError(
            f"identity id range too large for direct indexing "
            f"(lo={lo_max}, local={ll_max}, cap={MAX_DIRECT})"
        )
    lo_len = _pow2_at_least(lo_max, 1024)
    ll_len = _pow2_at_least(ll_max, 32)
    id_direct = np.full(lo_len + ll_len, NO_INDEX, dtype=np.uint32)
    id_direct[lo_ids] = lo_idx
    id_direct[lo_len + local_ids] = local_idx
    return id_direct, lo_len


def _state_columns(states: Sequence[PolicyMapState]):
    """Every map entry as numpy columns, in (endpoint, dict) order:
    (ep, identity, dport, proto, direction, proxy)."""
    cols = [[], [], [], [], [], []]
    for e, state in enumerate(states):
        n = len(state)
        cols[0].append(np.full(n, e, np.int64))
        cols[1].append(np.fromiter((k.identity for k in state), np.int64, n))
        cols[2].append(np.fromiter((k.dest_port for k in state), np.int64, n))
        cols[3].append(np.fromiter((k.nexthdr for k in state), np.int64, n))
        cols[4].append(
            np.fromiter((k.traffic_direction for k in state), np.int64, n)
        )
        cols[5].append(
            np.fromiter((v.proxy_port for v in state.values()), np.int64, n)
        )
    return [
        np.concatenate(c) if c else np.zeros(0, np.int64) for c in cols
    ]


def _identity_index(id_table: np.ndarray, ident: np.ndarray) -> np.ndarray:
    """identity -> position in id_table (the last occurrence before
    the first pad slot); raises on an identity outside the universe."""
    pad = np.nonzero(id_table == PAD_ID)[0]
    live = id_table[: int(pad[0]) if len(pad) else len(id_table)]
    live = live.astype(np.int64)
    order = np.argsort(live, kind="stable")
    srt = live[order]
    pos = np.searchsorted(srt, ident, side="right") - 1
    ok = (pos >= 0) & (srt[np.maximum(pos, 0)] == ident) if len(srt) else (
        np.zeros(len(ident), bool)
    )
    if not np.all(ok):
        bad = int(ident[~ok][0])
        raise ValueError(
            f"identity {bad} in map state but not in the identity "
            f"universe (universe/table skew)"
        )
    return order[pos] if len(srt) else pos


def lower_map_state(states: Sequence[PolicyMapState], id_table: np.ndarray,
                    filter_pad: int = 64,
                    hash_lanes: int = L4H_LANES) -> PolicyTables:
    """Lower E map states onto a shared identity universe.  An entry
    whose identity is absent from `id_table` raises; two entries of
    one (endpoint, direction, port, proto) slot with different proxy
    ports raise."""
    n = id_table.shape[0]
    if n >= int(L4H_WILD_IDX):
        raise ValueError(
            "identity axis too large for the hashed L4 probe "
            f"(n={n}, cap={int(L4H_WILD_IDX)})"
        )
    w = n // 32
    id_direct, id_lo_len = _build_direct_index(id_table)
    e_count = len(states)
    ep, ident, dport, proto, dirn, proxy = _state_columns(states)

    l3 = (dport == 0) & (proto == 0)
    l4 = ~l3
    # global slot space: distinct (dport, proto) over all endpoints
    slot_key = (dport[l4] << 32) | proto[l4]
    all_keys = np.unique(slot_key)
    kg = _round_up(max(len(all_keys), 1), filter_pad)
    port_slot = np.full((256, 65536), NO_SLOT, dtype=np.uint16)
    port_slot[all_keys & 0xFF, all_keys >> 32] = np.arange(
        len(all_keys), dtype=np.uint16
    )

    l4_meta = np.zeros((e_count, 2, kg), dtype=np.uint32)
    l4_allow_bits = np.zeros((e_count, 2, kg, w), dtype=np.uint32)
    l3_allow_bits = np.zeros((e_count, 2, w), dtype=np.uint32)

    # L3-only entries
    idx3 = _identity_index(id_table, ident[l3])
    np.bitwise_or.at(
        l3_allow_bits,
        (ep[l3], dirn[l3], idx3 >> 5),
        (np.uint32(1) << (idx3 & 31).astype(np.uint32)),
    )

    # L4 entries, in (endpoint, dict) order
    e4, d4, p4 = ep[l4], dirn[l4], proxy[l4]
    j4 = np.searchsorted(all_keys, slot_key)
    wild4 = ident[l4] == 0
    # one proxy port per (endpoint, direction, slot)
    cell = (e4 * 2 + d4) * kg + j4
    order = np.argsort(cell, kind="stable")
    sc, sp = cell[order], p4[order]
    first = np.searchsorted(sc, sc)
    clash = sp != sp[first]
    if np.any(clash):
        k = order[int(np.nonzero(clash)[0][0])]
        raise ValueError(
            f"conflicting proxy ports for endpoint {int(e4[k])} slot "
            f"{(int(dport[l4][k]), int(proto[l4][k]), int(d4[k]))}: "
            f"{int(sp[first][np.nonzero(clash)[0][0]])} vs {int(p4[k])}"
        )
    np.bitwise_or.at(
        l4_meta, (e4, d4, j4), (p4.astype(np.uint32) << np.uint32(1))
    )
    np.bitwise_or.at(
        l4_meta, (e4[wild4], d4[wild4], j4[wild4]), np.uint32(1)
    )
    idx4 = np.full(len(e4), int(L4H_WILD_IDX), np.int64)
    idx4[~wild4] = _identity_index(id_table, ident[l4][~wild4])
    nw = ~wild4
    np.bitwise_or.at(
        l4_allow_bits,
        (e4[nw], d4[nw], j4[nw], idx4[nw] >> 5),
        (np.uint32(1) << (idx4[nw] & 31).astype(np.uint32)),
    )
    value = (j4 << 16) | p4
    rows, stash, wrows, wstash = build_l4_hash_pair(
        e4.astype(np.uint32), d4.astype(np.uint32), idx4.astype(np.uint32),
        dport[l4].astype(np.uint32), proto[l4].astype(np.uint32),
        value.astype(np.uint32), lanes=hash_lanes,
    )
    return PolicyTables(
        id_table=id_table,
        id_direct=id_direct,
        id_lo_len=np.int32(id_lo_len),
        port_slot=port_slot,
        l4_meta=l4_meta,
        l4_allow_bits=l4_allow_bits,
        l3_allow_bits=l3_allow_bits,
        l4_hash_rows=rows,
        l4_hash_stash=stash,
        l4_wild_rows=wrows,
        l4_wild_stash=wstash,
    )


def compile_map_states(states: Sequence[PolicyMapState],
                       identity_ids: Sequence[int],
                       identity_pad: int = 1024, filter_pad: int = 64,
                       hash_lanes: int = L4H_LANES) -> PolicyTables:
    """One-shot: build the shared identity table and lower E states."""
    return lower_map_state(
        states,
        build_id_table(identity_ids, identity_pad),
        filter_pad,
        hash_lanes=hash_lanes,
    )


class FleetCompiler:
    """Incremental fleet lowering, the daemon's compiler.

    The one-shot path rebuilds everything per policy event.  This
    compiler caches each piece keyed on what invalidates it:

      * identity universe: arrival-ordered and append-only, so adding
        an identity appends an index and existing bit rows stay valid;
        removing one forces a full reset;
      * L4 slot space: new (dport, proto) keys append slots in
        first-seen order; `port_slot` cells are written once;
      * per-endpoint rows: relowered only when the endpoint's state
        token changes, padded lazily when the buckets grow.

    Its tables equal compile_map_states' in verdicts, not byte for byte
    (slot and identity order differ).  Every compile is stamped with a
    generation (`nonce << 32 | counter`) and recorded, so that
    `delta_for` can describe the change since an earlier publish.

    The stacked rows and `port_slot` ping-pong between two host
    buffers: tables one compile old stay intact, older ones are
    overwritten in place (`check_tables_current`).  A caller that keeps
    host tables across two compiles copies them.
    """

    def __init__(self, identity_pad: int = 1024, filter_pad: int = 64
                 ) -> None:
        self.identity_pad = identity_pad
        self.filter_pad = filter_pad
        # publish generation; survives _reset() (it counts publishes)
        self._generation = 0
        self._instance_nonce = next(_COMPILER_NONCE)
        self._compile_lock = threading.Lock()
        self._reset()

    def _reset(self) -> None:
        from cilium_tpu_torch.compiler.delta import IncrementalHashPair

        # a reset mid-compile invalidates every delta precondition
        # captured before it
        self._reset_count = getattr(self, "_reset_count", 0) + 1
        self._id_list: List[int] = []
        self._id_index: Dict[int, int] = {}
        self._slot_of: Dict[Tuple[int, int], int] = {}
        self._slot_list: List[Tuple[int, int]] = []  # arrival order
        self._hash_pair = IncrementalHashPair()
        # the last compile's shape class, the change records delta_for
        # merges, and the caller's universe version
        self._shape_state: Optional[dict] = None
        self._pub_records = deque(maxlen=8)
        self._universe_token = None
        self._slot_lut_cache = None
        # double-buffered port_slot: each buffer knows how many slots it
        # holds; catching up writes only the new cells
        self._port_slot_bufs = [
            {"arr": np.full((256, 65536), NO_SLOT, dtype=np.uint16),
             "applied": 0}
            for _ in range(2)
        ]
        self._port_slot_flip = 0
        # ep_id -> dict(token, kg, w, meta, l4, l3, ent)
        self._rows: Dict[int, dict] = {}
        # double-buffered stacked tensors: each records the token its
        # copy of every endpoint's rows reflects
        self._stack_bufs: List[Optional[dict]] = [None, None]
        self._stack_flip = 0
        self._id_table: np.ndarray = None
        self._id_direct: np.ndarray = None
        self._id_lo_len: int = 0
        self._id_tables_dirty = True

    # -- identity universe ---------------------------------------------------

    def _sync_universe(self, identity_ids: Sequence[int]) -> None:
        want = set(int(i) for i in identity_ids)
        if not want >= self._id_index.keys():
            # removal: indices would shift, so reset
            self._reset()
        new = want - self._id_index.keys()
        if new:
            for num_id in sorted(new):
                self._id_index[num_id] = len(self._id_list)
                self._id_list.append(num_id)
            self._id_tables_dirty = True

    def _padded_n(self) -> int:
        n = _round_up(max(len(self._id_list), 1), self.identity_pad)
        return _round_up(n, 32)

    def identity_index(self) -> Tuple[Dict[int, int], int]:
        """(identity id -> dense index, padded identity count) of the
        current universe: the index space of the tables' id_direct."""
        return dict(self._id_index), self._padded_n()

    def _ensure_id_tables(self) -> None:
        if not self._id_tables_dirty and self._id_table is not None:
            return
        n = self._padded_n()
        if n >= int(L4H_WILD_IDX):
            raise ValueError(
                "identity axis too large for the hashed L4 probe "
                f"(n={n}, cap={int(L4H_WILD_IDX)})"
            )
        table = np.full((n,), PAD_ID, dtype=np.uint32)
        table[: len(self._id_list)] = np.asarray(self._id_list,
                                                 dtype=np.uint32)
        # arrival order, never sorted: the direct index maps each id to
        # its position in this table
        self._id_direct, self._id_lo_len = _build_direct_index(table)
        self._id_table = table
        self._id_tables_dirty = False

    # -- slot space ----------------------------------------------------------

    def _ensure_slots(self, state) -> bool:
        """Append slots for unseen (dport, proto) keys; True if the slot
        space grew."""
        grew = False
        if isinstance(state, MapStateArrays):
            _, dport, proto, _ = unpack_keys(state.keys_packed)
            nonl3 = (dport != 0) | (proto != 0)
            pairs = np.unique(
                (dport[nonl3].astype(np.int64) << 8) | proto[nonl3]
            )
            keys = [(p >> 8, p & 0xFF) for p in pairs.tolist()]
        else:
            keys = [(k.dest_port, k.nexthdr) for k in state
                    if not k.is_l3_only()]
        for key in keys:
            if key not in self._slot_of:
                self._slot_of[key] = len(self._slot_list)
                self._slot_list.append(key)
                grew = True
        return grew

    def _current_port_slot(self) -> np.ndarray:
        """Flip to the standby port_slot buffer and catch it up with the
        slots appended since it was last handed out."""
        buf = self._port_slot_bufs[self._port_slot_flip]
        if buf["applied"] == len(self._slot_list):
            return buf["arr"]
        self._port_slot_flip ^= 1
        buf = self._port_slot_bufs[self._port_slot_flip]
        for j in range(buf["applied"], len(self._slot_list)):
            dport, proto = self._slot_list[j]
            buf["arr"][proto & 0xFF, dport] = j
        buf["applied"] = len(self._slot_list)
        return buf["arr"]

    def _padded_kg(self) -> int:
        return _round_up(max(len(self._slot_of), 1), self.filter_pad)

    def _slot_pair_lut(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted packed dport << 8 | proto pairs, slot of each sorted
        position), rebuilt only when the slot list grows."""
        cached = self._slot_lut_cache
        if cached is not None and cached[0] == len(self._slot_list):
            return cached[1], cached[2]
        pairs = np.asarray(
            [(dp << 8) | pr for dp, pr in self._slot_list], np.int64
        )
        order = np.argsort(pairs, kind="stable")
        self._slot_lut_cache = (len(self._slot_list), pairs[order], order)
        return self._slot_lut_cache[1], self._slot_lut_cache[2]

    # -- per-endpoint rows ---------------------------------------------------

    @staticmethod
    def _empty_ent() -> dict:
        return {k: np.zeros(0, np.uint32)
                for k in ("d", "idx", "dport", "proto", "val")}

    def _lower_rows_arrays(self, state: MapStateArrays) -> dict:
        """The row lowering as array scatters (np.bitwise_or.at): rows
        bit-identical to the dict path's."""
        n = self._padded_n()
        w = n // 32
        kg = self._padded_kg()
        meta = np.zeros((2, kg), dtype=np.uint32)
        l4 = np.zeros((2, kg, w), dtype=np.uint32)
        l3 = np.zeros((2, w), dtype=np.uint32)
        m = len(state.keys_packed)
        out = {"kg": kg, "w": w, "meta": meta, "l4": l4, "l3": l3,
               "ent": self._empty_ent()}
        if m == 0:
            return out

        ident, dport, proto, d = unpack_keys(state.keys_packed)
        l3_mask = (dport == 0) & (proto == 0)
        wild_mask = (ident == 0) & ~l3_mask

        # identity -> dense index through the arrival-ordered direct table
        ident64 = ident.astype(np.int64)
        is_local = ident64 >= LOCAL_ID_BASE
        pos = np.where(is_local, self._id_lo_len + ident64 - LOCAL_ID_BASE,
                       ident64)
        idx = np.full(m, NO_INDEX, dtype=np.uint32)
        in_range = (pos >= 0) & (pos < len(self._id_direct))
        idx[in_range] = self._id_direct[pos[in_range]]
        bad = ~wild_mask & (idx == NO_INDEX)
        if bad.any():
            missing = int(ident[np.argmax(bad)])
            raise ValueError(
                f"identity {missing} in map state but not in the "
                f"identity universe (universe/table skew)"
            )
        word = (idx >> 5).astype(np.int64)
        bit = (np.uint32(1) << (idx & np.uint32(31))).astype(np.uint32)

        np.bitwise_or.at(
            l3.reshape(-1),
            d[l3_mask].astype(np.int64) * w + word[l3_mask],
            bit[l3_mask],
        )

        sel4 = ~l3_mask
        if not sel4.any():
            return out
        sorted_pairs, order = self._slot_pair_lut()
        pair = (dport[sel4].astype(np.int64) << 8) | proto[sel4]
        j = order[np.searchsorted(sorted_pairs, pair)].astype(np.int64)
        dj = d[sel4].astype(np.int64) * kg + j
        proxy4 = state.proxy[sel4].astype(np.int64)
        # one proxy port per (direction, slot)
        uniq_pairs = np.unique(np.stack([dj, proxy4], axis=1), axis=0)
        if len(np.unique(uniq_pairs[:, 0])) != len(uniq_pairs):
            dup = uniq_pairs[:, 0][
                np.nonzero(np.diff(uniq_pairs[:, 0]) == 0)[0][0]
            ]
            dpp, prr = self._slot_list[int(dup) % kg]
            raise ValueError(
                f"conflicting proxy ports for slot "
                f"{(dpp, prr, int(dup) // kg)}"
            )
        np.bitwise_or.at(
            meta.reshape(-1), dj,
            (proxy4.astype(np.uint32) << np.uint32(1))
            | wild_mask[sel4].astype(np.uint32),
        )
        setbits = sel4 & ~wild_mask
        if setbits.any():
            dj_all = np.full(m, -1, np.int64)
            dj_all[sel4] = dj
            np.bitwise_or.at(
                l4.reshape(-1), dj_all[setbits] * w + word[setbits],
                bit[setbits],
            )
        # the hashed probe's entry columns (the endpoint bits are added
        # at stack time)
        ent_idx = idx[sel4].copy()
        ent_idx[wild_mask[sel4]] = L4H_WILD_IDX
        out["ent"] = {
            "d": d[sel4].astype(np.uint32),
            "idx": ent_idx.astype(np.uint32),
            "dport": dport[sel4].astype(np.uint32),
            "proto": proto[sel4].astype(np.uint32),
            "val": ((j.astype(np.uint32) << np.uint32(16))
                    | proxy4.astype(np.uint32)),
        }
        return out

    def _lower_rows(self, state) -> dict:
        if isinstance(state, MapStateArrays):
            return self._lower_rows_arrays(state)
        n = self._padded_n()
        w = n // 32
        kg = self._padded_kg()
        meta = np.zeros((2, kg), dtype=np.uint32)
        l4 = np.zeros((2, kg, w), dtype=np.uint32)
        l3 = np.zeros((2, w), dtype=np.uint32)
        proxy_seen: Dict[Tuple[int, int], int] = {}
        cols = {k: [] for k in ("d", "idx", "dport", "proto", "val")}

        def index_of(num_id: int) -> int:
            idx = self._id_index.get(num_id)
            if idx is None:
                raise ValueError(
                    f"identity {num_id} in map state but not in the "
                    f"identity universe (universe/table skew)"
                )
            return idx

        for key, entry in state.items():
            d = key.traffic_direction
            if key.is_l3_only():
                idx = index_of(key.identity)
                l3[d, idx >> 5] |= np.uint32(1 << (idx & 31))
                continue
            j = self._slot_of[(key.dest_port, key.nexthdr)]
            prev = proxy_seen.setdefault((d, j), entry.proxy_port)
            if prev != entry.proxy_port:
                raise ValueError(
                    f"conflicting proxy ports for slot "
                    f"{(key.dest_port, key.nexthdr, d)}: "
                    f"{prev} vs {entry.proxy_port}"
                )
            meta[d, j] |= np.uint32(entry.proxy_port << 1)
            if key.identity == 0:
                meta[d, j] |= np.uint32(1)
                idx = int(L4H_WILD_IDX)
            else:
                idx = index_of(key.identity)
                l4[d, j, idx >> 5] |= np.uint32(1 << (idx & 31))
            cols["d"].append(d)
            cols["idx"].append(idx)
            cols["dport"].append(key.dest_port)
            cols["proto"].append(key.nexthdr)
            cols["val"].append((j << 16) | entry.proxy_port)
        ent = {k: np.asarray(v, np.uint32) for k, v in cols.items()}
        return {"kg": kg, "w": w, "meta": meta, "l4": l4, "l3": l3,
                "ent": ent}

    @staticmethod
    def _pad_rows(rows: dict, kg: int, w: int) -> dict:
        """Grow cached rows to the current buckets (zero columns for new
        slots and identity words keep the old bits valid)."""
        if rows["kg"] == kg and rows["w"] == w:
            return rows
        dk, dw = kg - rows["kg"], w - rows["w"]
        return dict(
            rows, kg=kg, w=w,
            meta=np.pad(rows["meta"], ((0, 0), (0, dk))),
            l4=np.pad(rows["l4"], ((0, 0), (0, dk), (0, dw))),
            l3=np.pad(rows["l3"], ((0, 0), (0, dw))),
        )

    # -- compile -------------------------------------------------------------

    def compile(self, endpoints, identity_ids: Sequence[int],
                universe_token=None) -> Tuple[PolicyTables, Dict[int, int]]:
        """Lower the fleet incrementally.  `endpoints` is
        [(ep_id, map state (dict or MapStateArrays), state token)]; an
        endpoint's rows are relowered only when its token differs from
        the cached one.  A `universe_token` equal to the previous
        compile's skips the identity-set diff (the caller warrants the
        ids are unchanged).  Returns (tables, ep_id -> endpoint-axis
        index).  Runs under a `compiler.compile` span."""
        from cilium_tpu_torch import tracing

        with self._compile_lock, tracing.tracer.span(
            "compiler.compile", site="compiler",
            attrs={"endpoints": len(endpoints)},
        ) as sp:
            tables, index = self._compile_locked(endpoints, identity_ids,
                                                 universe_token)
            sp.attrs["identities"] = len(self._id_list)
            sp.attrs["slots"] = len(self._slot_list)
            return tables, index

    def _compile_locked(self, endpoints, identity_ids, universe_token=None):
        prev_id_len = len(self._id_list)
        prev_slots = len(self._slot_list)
        shape_prev = self._shape_state
        reset_before = self._reset_count
        if (universe_token is None or self._universe_token is None
                or universe_token != self._universe_token):
            self._sync_universe(identity_ids)
            if self._reset_count != reset_before:  # _reset() ran
                prev_id_len = 0
                prev_slots = 0
                shape_prev = None
            self._universe_token = universe_token

        live = {ep_id for ep_id, _, _ in endpoints}
        for gone in set(self._rows) - live:
            del self._rows[gone]

        dirty = []
        for ep_id, state, token in endpoints:
            cached = self._rows.get(ep_id)
            if cached is None or cached["token"] != token:
                dirty.append((ep_id, state, token))
                self._ensure_slots(state)

        self._ensure_id_tables()
        n = self._padded_n()
        w = n // 32
        kg = self._padded_kg()

        for ep_id, state, token in dirty:
            rows = self._lower_rows(state)
            rows["token"] = token
            self._rows[ep_id] = rows

        order = sorted(live)
        index = {ep_id: i for i, ep_id in enumerate(order)}
        if order:
            for ep_id in order:
                self._rows[ep_id] = self._pad_rows(self._rows[ep_id], kg, w)
            l4_meta, l4_bits, l3_bits = self._stacked(order, kg, w)
        else:
            l4_meta = np.zeros((1, 2, kg), dtype=np.uint32)
            l4_bits = np.zeros((1, 2, kg, w), dtype=np.uint32)
            l3_bits = np.zeros((1, 2, w), dtype=np.uint32)

        (hash_rows, hash_stash, wild_rows, wild_stash), hash_info = (
            self._hash_pair.build(order, self._rows,
                                  [ep_id for ep_id, _, _ in dirty])
        )
        self._generation += 1
        tables = PolicyTables(
            id_table=self._id_table,
            id_direct=self._id_direct,
            id_lo_len=np.int32(self._id_lo_len),
            port_slot=self._current_port_slot(),
            l4_meta=l4_meta,
            l4_allow_bits=l4_bits,
            l3_allow_bits=l3_bits,
            generation=np.uint64(
                (self._instance_nonce << 32) | self._generation),
            l4_hash_rows=hash_rows,
            l4_hash_stash=hash_stash,
            l4_wild_rows=wild_rows,
            l4_wild_stash=wild_stash,
        )
        self._record_publish(shape_prev, order, index, dirty, n, w, kg,
                             prev_id_len, prev_slots, hash_info)
        return tables, index

    # -- delta publication records -------------------------------------------

    def _record_publish(self, shape_prev, order, index, dirty, n, w, kg,
                        prev_id_len, prev_slots, hash_info) -> None:
        """Append the change record delta_for merges: per leaf, the
        indices changed since the previous compile, or None when the
        leaf's shape class moved and it must ship whole."""
        order_t = tuple(order)
        direct_len = (len(self._id_direct)
                      if self._id_direct is not None else 0)
        shape_now = {"order": order_t, "kg": kg, "w": w, "n": n,
                     "direct_len": direct_len, "lo_len": self._id_lo_len}
        stack_full = (
            shape_prev is None
            or shape_prev["order"] != order_t
            or shape_prev["kg"] != kg
            or shape_prev["w"] != w
        )
        id_full = shape_prev is None or shape_prev["n"] != n
        direct_full = (
            shape_prev is None
            or shape_prev["direct_len"] != direct_len
            or shape_prev["lo_len"] != self._id_lo_len
        )
        direct_pos = None
        if not direct_full:
            direct_pos = np.asarray(
                [i if i < LOCAL_ID_BASE
                 else self._id_lo_len + i - LOCAL_ID_BASE
                 for i in self._id_list[prev_id_len:]],
                np.int64,
            )
        self._pub_records.append({
            "gen": self._generation,
            "stack": (None if stack_full
                      else sorted({index[ep_id] for ep_id, _, _ in dirty})),
            "id_table": (None if id_full
                         else (prev_id_len, len(self._id_list))),
            "id_direct": direct_pos,
            "slots": (prev_slots, len(self._slot_list)),
            "hash_exact": hash_info.get("exact"),
            "hash_exact_stash": hash_info.get("exact_stash", True),
            "hash_wild": hash_info.get("wild"),
            "hash_wild_stash": hash_info.get("wild_stash", True),
        })
        self._shape_state = shape_now

    def delta_for(self, base_stamp: Optional[int], tables: PolicyTables):
        """TableDelta of every change from the publish stamped
        `base_stamp` to `tables` (this compiler's latest compile), or
        None when none can be derived (unknown base, a record gap, another
        compiler) and the caller must upload in full.  Scatter values
        are fresh copies taken from `tables`.  Runs under a
        `compiler.delta_for` span."""
        from cilium_tpu_torch import tracing
        from cilium_tpu_torch.compiler.delta import LeafUpdate, TableDelta

        with self._compile_lock, tracing.tracer.span(
            "compiler.delta_for", site="compiler"
        ):
            if not base_stamp:
                return None
            if (base_stamp >> 32) != self._instance_nonce:
                return None
            cur_stamp = int(np.asarray(tables.generation))
            if cur_stamp != (self._instance_nonce << 32) | self._generation:
                return None
            layout = tables_layout_version(tables)
            base_gen = base_stamp & 0xFFFFFFFF
            if base_gen == self._generation:
                return TableDelta(base_stamp, cur_stamp, layout=layout)
            recs = [r for r in self._pub_records
                    if base_gen < r["gen"] <= self._generation]
            if len(recs) != self._generation - base_gen:
                return None  # record gap (reset or deque overflow)
            delta = TableDelta(base_stamp, cur_stamp, layout=layout)
            delta.replace["generation"] = np.uint64(cur_stamp)

            def scatter1(name, arr, idx_list):
                idx = np.asarray(sorted(idx_list), np.int64)
                if len(idx):
                    delta.updates[name] = LeafUpdate((idx,), arr[idx])

            # stacked per-endpoint rows
            if any(r["stack"] is None for r in recs):
                delta.replace["l4_meta"] = tables.l4_meta
                delta.replace["l4_allow_bits"] = tables.l4_allow_bits
                delta.replace["l3_allow_bits"] = tables.l3_allow_bits
            else:
                rows = set()
                for r in recs:
                    rows.update(r["stack"])
                scatter1("l4_meta", tables.l4_meta, rows)
                scatter1("l4_allow_bits", tables.l4_allow_bits, rows)
                scatter1("l3_allow_bits", tables.l3_allow_bits, rows)

            # identity universe
            if any(r["id_table"] is None for r in recs):
                delta.replace["id_table"] = tables.id_table
            else:
                lo = min(r["id_table"][0] for r in recs)
                hi = max(r["id_table"][1] for r in recs)
                if hi > lo:
                    delta.updates["id_table"] = LeafUpdate(
                        (np.arange(lo, hi, dtype=np.int64),),
                        tables.id_table[lo:hi].copy(),
                    )
            if any(r["id_direct"] is None for r in recs):
                delta.replace["id_direct"] = tables.id_direct
                delta.replace["id_lo_len"] = np.int32(self._id_lo_len)
            else:
                pos = np.unique(np.concatenate(
                    [r["id_direct"] for r in recs] + [np.zeros(0, np.int64)]
                ))
                if len(pos):
                    delta.updates["id_direct"] = LeafUpdate(
                        (pos,), tables.id_direct[pos])

            # (proto, dport) -> slot cells: append-only, written once
            slot_lo = min(r["slots"][0] for r in recs)
            slot_hi = max(r["slots"][1] for r in recs)
            if slot_hi > slot_lo:
                cells = self._slot_list[slot_lo:slot_hi]
                delta.updates["port_slot"] = LeafUpdate(
                    (np.asarray([pr & 0xFF for _, pr in cells], np.int64),
                     np.asarray([dp for dp, _ in cells], np.int64)),
                    np.arange(slot_lo, slot_hi, dtype=np.uint16),
                )

            # hashed entry tables
            for leaf, stash_leaf, key, table in (
                ("l4_hash_rows", "l4_hash_stash", "hash_exact",
                 self._hash_pair.exact),
                ("l4_wild_rows", "l4_wild_stash", "hash_wild",
                 self._hash_pair.wild),
            ):
                arr = getattr(tables, leaf)
                if (any(r[key] is None for r in recs)
                        or arr.shape[0] != table.n_rows):
                    delta.replace[leaf] = arr
                    delta.replace[stash_leaf] = getattr(tables, stash_leaf)
                    continue
                rows = set()
                for r in recs:
                    rows.update(r[key])
                scatter1(leaf, arr, rows)
                if any(r[key + "_stash"] for r in recs):
                    delta.replace[stash_leaf] = getattr(tables, stash_leaf)
            return delta

    def check_tables_current(self, tables) -> None:
        """Raise ValueError for tables of this compiler two or more
        compiles old: their stacked buffers have been rewritten in
        place, so verdicts from them would be silently wrong.  Unstamped
        tables and another compiler's are accepted."""
        raw = getattr(tables, "generation", None)
        stamp = int(np.asarray(raw)) if raw is not None else 0
        if stamp == 0 or (stamp >> 32) != self._instance_nonce:
            return
        gen = stamp & 0xFFFFFFFF
        if self._generation - gen > 1:
            raise ValueError(
                f"stale PolicyTables: generation {gen} is "
                f"{self._generation - gen} publishes old (max 1 — "
                f"double-buffered rows have been overwritten)"
            )

    def _stacked(self, order: List[int], kg: int, w: int):
        """Write rows into the standby stacked buffer, copying only the
        endpoints whose token differs from what that buffer holds; a
        full stack only when the endpoint set or the shapes change."""
        self._stack_flip ^= 1
        buf = self._stack_bufs[self._stack_flip]
        shape_key = (tuple(order), kg, w)
        if buf is None or buf["shape_key"] != shape_key:
            e = len(order)
            buf = {
                "shape_key": shape_key,
                "meta": np.empty((e, 2, kg), dtype=np.uint32),
                "l4": np.empty((e, 2, kg, w), dtype=np.uint32),
                "l3": np.empty((e, 2, w), dtype=np.uint32),
                "tokens": {},
            }
            self._stack_bufs[self._stack_flip] = buf
        tokens = buf["tokens"]
        for i, ep_id in enumerate(order):
            rows = self._rows[ep_id]
            if tokens.get(ep_id) == rows["token"]:
                continue
            buf["meta"][i] = rows["meta"]
            buf["l4"][i] = rows["l4"]
            buf["l3"][i] = rows["l3"]
            tokens[ep_id] = rows["token"]
        # pre-warm the other buffer now, so the next compile copies
        # only the endpoints dirtied in between
        other_i = self._stack_flip ^ 1
        other = self._stack_bufs[other_i]
        if other is None or other["shape_key"] != shape_key:
            self._stack_bufs[other_i] = {
                "shape_key": shape_key,
                "meta": buf["meta"].copy(),
                "l4": buf["l4"].copy(),
                "l3": buf["l3"].copy(),
                "tokens": dict(tokens),
            }
        return buf["meta"], buf["l4"], buf["l3"]
