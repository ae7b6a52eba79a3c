"""FNV-1a over u32 words, and the generic device hash table (the
reference's engine/hashtable.py).

The hash decides the bucket of every hashed table of the datapath: the
L4 entry tables, conntrack, the LB service rows, the ipcache buckets
and its range classes.  The build side hashes on the host with
`_fnv1a_host`; the probe side hashes the same words on the device.
Both run byte-wise FNV-1a with a wrapping u32 multiply.  On the card
the kernels inline it (csrc/common.cuh); `fnv1a` here is the plain
version the CPU path and the comparisons use.

`HashTable` is the device analog of BPF_MAP_TYPE_HASH for multi-word
keys: `build_hash_table` places unique u32 keys [N, KW] on the host by
open addressing within a fixed window of PROBE_WINDOW slots, the keys
that find no free slot in their window going to a STASH_SIZE-row stash
appended to the table; `lookup_batch` probes a batch of keys (on the
card HASH_LOOKUP, csrc/lookup.cu; on the CPU `lookup_batch_plain`).
The probe never stops at an empty slot, so lookups do not depend on
insertion order.  Key layout: u32 [C + S, KW], main region then stash,
empty slots hold the all-ones key (never inserted).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cilium_tpu_torch.device import (
    MASK32,
    require_on,
    resolve_device,
    tensor_on,
    widen,
)

EMPTY = np.uint32(0xFFFFFFFF)

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)


def trim_pow2_prefix(arr: np.ndarray, used: int) -> np.ndarray:
    """Slice a front-filled overflow stash to the smallest pow2 prefix
    holding its `used` occupied rows (never below 1 row).  Probes
    compare every stash row against every flow, so capacity rows with
    never-matching sentinels are wasted work; trimming cannot change
    a result."""
    size = 1
    while size < max(used, 1):
        size <<= 1
    return arr[:size]


def _fnv1a_host(words: np.ndarray) -> np.ndarray:
    """FNV-1a over u32 words, vectorized: words [N, KW] -> u32 [N]."""
    h = np.full(words.shape[0], FNV_OFFSET, dtype=np.uint64)
    for w in range(words.shape[1]):
        for shift in (0, 8, 16, 24):
            byte = (words[:, w].astype(np.uint64) >> shift) & 0xFF
            h = ((h ^ byte) * np.uint64(int(FNV_PRIME))) & 0xFFFFFFFF
    return h.astype(np.uint32)


def fnv1a(words: torch.Tensor) -> torch.Tensor:
    """Plain version: words [B, KW] (u32 bits, any integer dtype) ->
    int64 [B] holding the u32 hash."""
    w = widen(words)
    h = torch.full(
        (w.shape[0],), int(FNV_OFFSET), dtype=torch.int64, device=w.device
    )
    prime = int(FNV_PRIME)
    for k in range(w.shape[1]):
        col = w[:, k]
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((col >> shift) & 0xFF)) * prime) & MASK32
    return h


@dataclass
class HashTable:
    """keys u32 [C + S, KW] (numpy, or int32 tensors holding the bits),
    value_index int32 [C + S]; `capacity` main-region slots (rows
    [capacity:] are the stash) and the probe window `max_probes` are
    static."""

    keys: object
    value_index: object
    max_probes: int
    capacity: int


PROBE_WINDOW = 8
STASH_SIZE = 128
# capacity >= LOAD_FACTOR_INV x entries keeps the window leftovers well
# under STASH_SIZE
LOAD_FACTOR_INV = 4
_MAX_GROWTH_DOUBLINGS = 2


def _place_vectorized(hashes: np.ndarray, capacity: int, window: int
                      ) -> "tuple[np.ndarray, np.ndarray]":
    """Round-based placement: each round every unplaced key claims slot
    (h + disp) & mask, and the first claimant of a free slot (stable
    sort order) wins.  Returns (slot per key, -1 where unplaced; the
    indices of the unplaced keys)."""
    mask = capacity - 1
    n = len(hashes)
    slot_of = np.full(n, -1, np.int64)
    occupied = np.zeros(capacity, bool)
    remaining = np.arange(n)
    h = hashes.astype(np.int64)
    for disp in range(window):
        if not len(remaining):
            break
        cand = (h[remaining] + disp) & mask
        order = np.argsort(cand, kind="stable")
        cs = cand[order]
        first = np.ones(len(cs), bool)
        first[1:] = cs[1:] != cs[:-1]
        ok = first & ~occupied[cs]
        winner_rows = order[ok]
        slot_of[remaining[winner_rows]] = cs[ok]
        occupied[cs[ok]] = True
        keep = np.ones(len(remaining), bool)
        keep[winner_rows] = False
        remaining = remaining[keep]
    return slot_of, remaining


def build_hash_table(keys: np.ndarray, min_capacity: int = 16) -> HashTable:
    """keys u32 [N, KW] (unique) -> the windowed table with its stash,
    on the host.  The capacity starts at the smallest power of two from
    `min_capacity` up that is at least LOAD_FACTOR_INV x N, and doubles
    while more than STASH_SIZE keys find no slot, at most
    _MAX_GROWTH_DOUBLINGS times: then ValueError (an adversarial
    collision set fails loudly instead of doubling without end)."""
    n, kw = keys.shape
    capacity = min_capacity
    while capacity < LOAD_FACTOR_INV * max(n, 1):
        capacity *= 2
    hashes = _fnv1a_host(keys.astype(np.uint32))
    for _ in range(_MAX_GROWTH_DOUBLINGS + 1):
        slots, leftovers = _place_vectorized(hashes, capacity, PROBE_WINDOW)
        if len(leftovers) <= STASH_SIZE:
            break
        capacity *= 2
    else:
        raise ValueError(
            f"hash table build failed: {len(leftovers)} keys unplaced "
            f"after growing to capacity {capacity} (adversarial "
            f"collisions?)")
    table_keys = np.full((capacity + STASH_SIZE, kw), EMPTY, dtype=np.uint32)
    value_index = np.full(capacity + STASH_SIZE, -1, dtype=np.int32)
    placed = slots >= 0
    table_keys[slots[placed]] = keys[placed]
    value_index[slots[placed]] = np.flatnonzero(placed).astype(np.int32)
    table_keys[capacity:capacity + len(leftovers)] = keys[leftovers]
    value_index[capacity:capacity + len(leftovers)] = leftovers.astype(
        np.int32)
    return HashTable(keys=table_keys, value_index=value_index,
                     max_probes=PROBE_WINDOW, capacity=capacity)


# queries per chunk of the plain version: its [B, S, KW] stash compare
# stays near 130 MB at KW = 4
_PLAIN_CHUNK = 1 << 16


def lookup_batch_plain(table: HashTable, query: torch.Tensor):
    """Plain version of the reference's `lookup_batch`: query [B, KW]
    (u32 bits) -> (found bool [B], index int32 [B]).  The window's first
    hit in window order wins; a window hit beats a stash hit, and the
    stash takes its first hit; a miss gives index 0; a query equal to
    the all-ones sentinel in every word is masked to (False, 0)."""
    capacity = int(table.capacity)
    mask = capacity - 1
    keys = widen(table.keys)
    value_index = table.value_index.to(torch.int64)
    stash = keys[capacity:]
    arange = torch.arange(int(table.max_probes), device=keys.device)
    found_out, index_out = [], []
    for q in widen(query).split(_PLAIN_CHUNK):
        h = fnv1a(q) & mask
        slots = (h[:, None] + arange[None, :]) & mask
        hits = (keys[slots] == q[:, None, :]).all(dim=2)  # [b, P]
        found = hits.any(dim=1)
        pos = hits.to(torch.int8).argmax(dim=1)
        index = torch.where(found, value_index[(h + pos) & mask], 0)
        s_hits = (stash[None, :, :] == q[:, None, :]).all(dim=2)  # [b, S]
        s_found = s_hits.any(dim=1)
        s_index = value_index[capacity:][s_hits.to(torch.int8).argmax(dim=1)]
        index = torch.where(s_found & ~found, s_index, index)
        found = found | s_found
        sentinel = (q == int(EMPTY)).all(dim=1)
        found_out.append(found & ~sentinel)
        index_out.append(torch.where(sentinel, 0, index).to(torch.int32))
    if not found_out:
        return (torch.zeros(0, dtype=torch.bool, device=keys.device),
                torch.zeros(0, dtype=torch.int32, device=keys.device))
    return torch.cat(found_out), torch.cat(index_out)


def lookup_batch(table: HashTable, query, device=None):
    """query u32 [B, KW] -> (found bool [B], index int32 [B]) on `device`
    (None = the card): `index` is the row passed to build_hash_table
    (0 where not found).  `table` lies on that device
    (convert.hashtable_to); `query` is a tensor there or a numpy array,
    uploaded.  A CUDA device launches HASH_LOOKUP; the CPU runs the
    plain version."""
    dev = resolve_device(device)
    query = tensor_on(query, dev, "query")
    require_on(table.keys, dev, "the hash table (convert.hashtable_to)")
    if query.dim() != 2 or query.shape[1] != table.keys.shape[1]:
        raise ValueError(f"query must be [B, {int(table.keys.shape[1])}], "
                         f"got {tuple(query.shape)}")
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.HASH_LOOKUP(table, query)
    return lookup_batch_plain(table, query)
