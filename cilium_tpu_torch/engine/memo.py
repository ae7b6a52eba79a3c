"""Verdict memoization: intra-batch tuple dedup and a device-resident
policy-verdict cache with epoch-stamped invalidation.

The counterpart of the reference's engine/memo.py (K14).  Two levels
in front of the policy lattice:

  * **Level A, intra-batch dedup** (`dedup_groups`): the post-ipcache
    policy keys (identity index, known flag, L3 bit, endpoint,
    direction, dport, proto, packed into three u32 words by
    `memo_key_words`) are sorted in ascending key order, duplicates
    collapse into groups, and the lattice runs only on each group's
    representative (its first member in the stable sort order, so the
    smallest original row).  A static `rep_cap` bounds the
    representatives.
  * **Level B, the cache** (`cache_probe`, `bucket_insert_lanes`,
    `apply_rank_updates`, `cache_insert`): a hashed bucket-row table
    maps a key to its packed lattice outputs (`v0 = j << 16 | proxy`,
    `v1` = the three probe bits).  A probe compares all three key
    words, so a collision can only miss.  Missed representatives
    (compacted in representative order) run the
    lattice and are inserted: each into a distinct (bucket, lane),
    the bucket's first empty lane or, with the per-row rank word, its
    least-recently-hit lane, shifted by the key's rank among the
    batch's same-bucket representatives.

A batch whose groups exceed `rep_cap` overflows: the
stats row reports it, the cache comes back as it was, and the per-tuple
outputs are unspecified (the caller re-dispatches through the uncached
program).

Row layouts ([n_rows + 1, W] u32 words, row n_rows the scratch row):
legacy W = 5E (3 key words + 2 value words per lane), rank W = 5E + 1
(one trailing hit-rank word of 4-bit nibbles), sub-word W = 4E + E/8 + 1
(the probe bits in a nibble plane).  The port never writes the scratch
row: an entry that is not inserted is dropped, where the reference
routes it there through a scatter whose duplicate-index order XLA
leaves implementation-defined; no probe reads that row.

Every plain function here works on int64 tensors holding u32 values
(cache rows are int32 tensors holding the u32 bits) on any device.  The
entry points `memo_evaluate` (the daemon's serving shape) and
`memo_pair_packed4` (the headline pair) run the plain versions on CPU
tensors and, on CUDA tensors, launch the hand-written kernels of
csrc/memo.cu (MEMO_KEYS_LATTICE, MEMO_DEDUP, MEMO_CACHE) and the memo
mode of DATAPATH_PAIR (csrc/datapath.cu).  `VerdictCache` is the host
owner of the rows.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from cilium_tpu_torch.device import MASK32, narrow, resolve_device, widen

# k0 holds the dense identity index, bounded below 2^22 by the
# compilers, so the all-ones word never is a real key: it marks an
# empty lane
EMPTY = np.uint32(0xFFFFFFFF)

# words per cache entry: 3 key words + 2 value words
CACHE_KEY_WORDS = 3
CACHE_WORDS = 5

# the per-row hit-rank word: a 4-bit recency nibble per lane (at most 8
# lanes); a hit bumps its lane's nibble (saturating at 15), an insert
# into a full bucket takes the lowest nibble and resets it
RANK_NIBBLE_BITS = 4
RANK_NIBBLE_MAX = 15
RANK_MAX_LANES = 8

# the stats vector (u32 [5]) every memo program returns
STAT_UNIQUE = 0  # distinct policy keys in the batch
STAT_HIT = 1  # tuples whose representative hit the cache
STAT_INSERT = 2  # cache entries inserted (missed representatives)
STAT_OVERFLOW = 3  # groups and misses beyond the static capacities
STAT_TUPLES = 4  # batch tuples the row covers
STATS = 5


# -- layout --------------------------------------------------------------------


def cache_layout(rows):
    """(entries, has_rank, subword) of a cache-row array, from its
    width alone: legacy 5E, rank 5E + 1, sub-word 4E + E/8 + 1."""
    w = int(rows.shape[-1])
    for e in (8, 16, 32):
        if w == 4 * e + e // 8 + 1:
            return e, True, True
    if w % CACHE_WORDS == 0:
        return w // CACHE_WORDS, False, False
    return (w - 1) // CACHE_WORDS, True, False


def cache_entries(rows) -> int:
    """Entries per bucket row."""
    return cache_layout(rows)[0]


def has_rank_word(rows) -> bool:
    """True when the rows carry the trailing hit-rank word."""
    return cache_layout(rows)[1]


def rank_column(rows) -> int:
    """The column of the rank word (sub-word: after the nibble plane)."""
    e, _, subw = cache_layout(rows)
    return 4 * e + e // 8 if subw else CACHE_WORDS * e


def make_cache_rows(n_rows: int = 1 << 12, entries: int = 8,
                    subword: bool = False) -> np.ndarray:
    """Host-side empty cache: [n_rows + 1, W] u32, key and value lanes
    EMPTY, the rank word (and the sub-word nibble plane) zero.  Row
    n_rows is the scratch row."""
    if n_rows & (n_rows - 1):
        raise ValueError(f"cache rows must be a power of two: {n_rows}")
    if subword:
        if entries % 8:
            raise ValueError("sub-word cache rows need entries % 8 == 0")
        rows = np.full((n_rows + 1, 4 * entries + entries // 8 + 1), EMPTY,
                       np.uint32)
        rows[:, 4 * entries:] = 0
        return rows
    rows = np.full((n_rows + 1, CACHE_WORDS * entries + 1), EMPTY, np.uint32)
    rows[:, -1] = 0
    return rows


# -- the word packing ----------------------------------------------------------


def memo_key_words(idx, known, l3_bit, ep, dirn, dport, proto):
    """The three u32 policy-key words (int64 tensors).  `dport` and
    `proto` are already clipped to their ranges; `l3_bit` may be None
    (no L3 plane word on this path).  As in the reference, `ep << 1`
    drops bit 31 of the endpoint word and `| dirn` overlaps bit 0 (and
    more) for a direction word other than 0 or 1: such keys collapse,
    and their tuples share one representative's verdict."""
    k0 = idx & MASK32
    k1 = (((dport & MASK32) << 16) | ((proto & MASK32) << 8)
          | (known.to(torch.int64) << 1)) & MASK32
    if l3_bit is not None:
        k1 = k1 | l3_bit.to(torch.int64)
    k2 = (((ep & MASK32) << 1) | (dirn & MASK32)) & MASK32
    return k0, k1, k2


def pack_value_words(probe1, probe2, probe3, proxy, j):
    """Lattice outputs -> (v0, v1): v0 = j << 16 | proxy (16 bits each),
    v1 = the three probe bits."""
    v0 = (((j & MASK32) << 16) & MASK32) | (proxy & 0xFFFF)
    v1 = (probe1.to(torch.int64) | (probe2.to(torch.int64) << 1)
          | (probe3.to(torch.int64) << 2))
    return v0, v1


def unpack_value_words(v0, v1):
    """(v0, v1) -> (probe1, probe2, probe3, proxy, j); proxy and j
    int64."""
    return ((v1 & 1).bool(), ((v1 >> 1) & 1).bool(), ((v1 >> 2) & 1).bool(),
            v0 & 0xFFFF, v0 >> 16)


# -- level A -------------------------------------------------------------------


def _nonzero_padded(mask, size: int, fill: int):
    """Positions of True in order, cut or padded with `fill` to
    `size` (jnp.nonzero with size and fill_value)."""
    pos = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    out[:pos.numel()] = pos
    return out


def dedup_groups(k0, k1, k2, rep_cap: int) -> dict:
    """Level A, plain: a stable lexicographic sort of the key words (k0
    first, unsigned), then the groups of equal keys.

      srow       int64 [B]  original row of each sorted position
      gid        int64 [B]  group id per sorted position
      rgid       int64 [B]  group id per original row (rgid[srow] = gid)
      n_unique   int        distinct keys
      rep_orig   int64 [rep_cap + 1]  each group's first row in sort
                 order; slots past n_unique hold srow[0], slot rep_cap 0
      rep_valid  bool [rep_cap]
      overflow   int        groups beyond rep_cap
    """
    b = k0.shape[0]
    dev = k0.device
    srow = torch.arange(b, dtype=torch.int64, device=dev)
    for k in (k2, k1, k0):  # least significant word first, stable
        srow = srow[torch.sort(k[srow], stable=True).indices]
    sk = [k[srow] for k in (k0, k1, k2)]
    new = torch.ones(b, dtype=torch.bool, device=dev)
    if b > 1:
        new[1:] = ((sk[0][1:] != sk[0][:-1]) | (sk[1][1:] != sk[1][:-1])
                   | (sk[2][1:] != sk[2][:-1]))
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    n_unique = int(gid[-1].item()) + 1
    rep_pos = _nonzero_padded(new, rep_cap, 0)
    rep_orig = torch.cat([srow[rep_pos],
                          torch.zeros(1, dtype=torch.int64, device=dev)])
    rep_valid = torch.arange(rep_cap, device=dev) < n_unique
    rgid = torch.empty_like(gid)
    rgid[srow] = gid
    return dict(srow=srow, gid=gid, rgid=rgid, n_unique=n_unique,
                rep_orig=rep_orig, rep_valid=rep_valid,
                overflow=max(n_unique - rep_cap, 0))


# -- level B -------------------------------------------------------------------


def rank_nibbles(rank_word, entries: int):
    """[U] rank words -> [U, entries] recency nibbles (lanes past 8
    share nibbles modulo 8)."""
    shifts = RANK_NIBBLE_BITS * (
        torch.arange(entries, device=rank_word.device) % RANK_MAX_LANES)
    return (rank_word[:, None] >> shifts[None, :]) & RANK_NIBBLE_MAX


def bucket_insert_lanes(empty, bucket, entries: int, rank_word=None):
    """Per-key insert lane and validity for same-batch inserts: the
    key's rank among the batch's keys of its bucket (in key order: the
    stable sort the reference's XLA sort gives), then the k-th coldest
    lane (empty lanes first, then by rank nibble; with a `rank_word` and
    at most 8 lanes) or the bucket's first empty lane (else a bucket
    rotation) shifted by the rank.  Keys ranked past the lane count get
    ok False.  `empty` [U, entries] bool, `bucket` [U] int64."""
    u = bucket.shape[0]
    dev = bucket.device
    pos = torch.arange(u, dtype=torch.int64, device=dev)
    sb, sidx = torch.sort(bucket, stable=True)
    newb = torch.ones(u, dtype=torch.bool, device=dev)
    if u > 1:
        newb[1:] = sb[1:] != sb[:-1]
    seg_start = torch.cummax(torch.where(newb, pos, 0), 0).values
    rank = torch.zeros(u, dtype=torch.int64, device=dev)
    rank[sidx] = pos - seg_start
    if rank_word is not None and entries <= RANK_MAX_LANES:
        score = torch.where(empty, -1, rank_nibbles(rank_word, entries))
        order = torch.argsort(score, dim=1, stable=True)
        lane = order.gather(1, rank.clamp(0, entries - 1)[:, None])[:, 0]
    else:
        first_empty = torch.argmax(empty.to(torch.int32), dim=1)
        full_rot = bucket % entries
        base = torch.where(empty.any(dim=1), first_empty, full_rot)
        lane = (base + rank) % entries
    return lane, rank < entries


def cache_probe(cache_rows, k0, k1, k2, valid):
    """Level B probe: one bucket row per key, lane compares over all
    three key words.  Returns (hit, v0, v1, bucket, ins_lane, ins_ok,
    hit_lane, rank_word), as the reference's cache_probe."""
    from cilium_tpu_torch.engine.hashtable import fnv1a
    from cilium_tpu_torch.engine.subword import unpack_lanes

    e, ranked, subw = cache_layout(cache_rows)
    n_rows = int(cache_rows.shape[0]) - 1  # the last row is scratch
    bucket = fnv1a(torch.stack([k0, k1, k2], dim=1)) & (n_rows - 1)
    rowv = widen(cache_rows[bucket])
    lane_hit = ((rowv[:, :e] == k0[:, None])
                & (rowv[:, e:2 * e] == k1[:, None])
                & (rowv[:, 2 * e:3 * e] == k2[:, None]))
    hit = lane_hit.any(dim=1) & valid
    v0 = torch.where(lane_hit, rowv[:, 3 * e:4 * e], 0).sum(dim=1) & MASK32
    if subw:
        v1_lanes = unpack_lanes(rowv[:, 4 * e:4 * e + e // 8], 4, e)
    else:
        v1_lanes = rowv[:, 4 * e:5 * e]
    v1 = torch.where(lane_hit, v1_lanes, 0).sum(dim=1) & MASK32
    hit_lane = torch.argmax(lane_hit.to(torch.int32), dim=1)
    if ranked:
        rank_word = rowv[:, rank_column(cache_rows)]
    else:
        rank_word = torch.zeros_like(bucket)
    ins_lane, ins_ok = bucket_insert_lanes(
        rowv[:, :e] == int(EMPTY), bucket, e,
        rank_word=rank_word if ranked else None)
    return hit, v0, v1, bucket, ins_lane, ins_ok, hit_lane, rank_word


def _column_add(rows64, row_idx, col: int, delta):
    """rows64[row_idx, col] += delta (u32 wraparound), in place."""
    c = rows64[:, col].clone()
    c.index_add_(0, row_idx, delta)
    rows64[:, col] = c & MASK32


def apply_rank_updates(cache_rows, bucket, hit, hit_lane, rank_word, ins_row,
                       ins_lane, ins_rank_word, do_insert):
    """The hit-rank word's two commuting adds: each hit bumps its
    lane's nibble (saturating at 15), each insert subtracts its target
    lane's current nibble.  Returns new rows (int32); a no-op on the
    rank-less layout or past 8 lanes.  `ins_row` entries that do not
    insert carry a zero delta and are dropped."""
    e, ranked, _ = cache_layout(cache_rows)
    if not ranked or e > RANK_MAX_LANES:
        return cache_rows
    col = rank_column(cache_rows)
    nb = RANK_NIBBLE_BITS
    h_shift = nb * (hit_lane % RANK_MAX_LANES)
    h_nib = (rank_word >> h_shift) & RANK_NIBBLE_MAX
    h_delta = torch.where(hit & (h_nib < RANK_NIBBLE_MAX),
                          torch.ones_like(h_shift) << h_shift, 0)
    i_shift = nb * (ins_lane % RANK_MAX_LANES)
    i_nib = (ins_rank_word >> i_shift) & RANK_NIBBLE_MAX
    i_delta = (0 - (i_nib << i_shift)) & MASK32
    rows = widen(cache_rows)
    _column_add(rows, bucket, col, h_delta)
    _column_add(rows, ins_row[do_insert], col, i_delta[do_insert])
    return narrow(rows)


def cache_insert(cache_rows, bucket, lane, k0, k1, k2, v0, v1, do_insert):
    """Write the inserted entries into their (bucket, lane) slots,
    which bucket_insert_lanes keeps distinct; entries with `do_insert`
    False are dropped.  Sub-word rows take v1 in its nibble through an
    add of the difference (lanes of one nibble word never coincide).
    Returns new rows (int32)."""
    e, _, subw = cache_layout(cache_rows)
    rows = widen(cache_rows)
    b, ln = bucket[do_insert], lane[do_insert]
    words = [k0, k1, k2, v0] + ([] if subw else [v1])
    for c, w in enumerate(words):
        rows[b, ln + c * e] = w[do_insert] & MASK32
    if subw:
        word_col = 4 * e + ln // 8
        shift = 4 * (ln % 8)
        old = (widen(cache_rows[b, word_col]) >> shift) & 0xF
        delta = (((v1[do_insert] & 0xF) - old) << shift) & MASK32
        flat = rows.view(-1)
        acc = flat.clone()
        acc.index_add_(0, b * rows.shape[1] + word_col, delta)
        rows = (acc & MASK32).view(rows.shape)
    return narrow(rows)


def pad_rep(x, mp):
    """Per-representative values gathered at padded miss positions:
    one zero slot appended, then indexed by `mp` (the padding points at
    that slot)."""
    return torch.cat([x, torch.zeros(1, dtype=x.dtype, device=x.device)])[mp]


def scatter_back(g, rep_cap: int, hit, cv0, cv1, miss_pos, mv0, mv1):
    """Representative value words -> per-tuple columns: hits keep the
    cached words, misses take the fresh lattice words, then every tuple
    takes its group's (the group index clipped to rep_cap - 1).
    Returns (v0, v1, tuple_hit), [B] each."""
    dev = hit.device
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    rv0 = torch.cat([torch.where(hit, cv0, 0), zero])
    rv1 = torch.cat([torch.where(hit, cv1, 0), zero])
    real = miss_pos < rep_cap  # the padding lands on the scratch slot
    rv0[miss_pos[real]] = mv0[real]
    rv1[miss_pos[real]] = mv1[real]
    gg = g["gid"].clamp(max=rep_cap - 1)
    srow = g["srow"]
    b = srow.shape[0]
    v0 = torch.zeros(b, dtype=torch.int64, device=dev)
    v1 = torch.zeros(b, dtype=torch.int64, device=dev)
    tuple_hit = torch.zeros(b, dtype=torch.bool, device=dev)
    v0[srow] = rv0[gg]
    v1[srow] = rv1[gg]
    tuple_hit[srow] = hit[gg]
    return v0, v1, tuple_hit


def memo_cache_plain(pol, cache_rows, keys, g, idx, known, l3_bit, ep, dirn,
                     dport, proto, rep_cap: int):
    """Level B of the memoized lattice, plain (MEMO_CACHE's scope): the
    cache probe of dedup_groups' representatives `g`, the miss
    compaction, the lattice on the missed representatives, the insert
    (only when nothing overflowed) and the scatter-back.  `keys` are the
    (k0, k1, k2) words, the other inputs the tuples' lattice inputs.
    Returns (v0, v1, hit [B], cache_rows', stats int64 [5])."""
    from cilium_tpu_torch.engine.verdict import _probes

    k0, k1, k2 = keys
    b = k0.shape[0]
    dev = k0.device
    rep_orig = g["rep_orig"]
    r = rep_orig[:rep_cap]
    rk0, rk1, rk2 = k0[r], k1[r], k2[r]
    (hit, cv0, cv1, bucket, ins_lane, ins_ok, hit_lane,
     rank_word) = cache_probe(cache_rows, rk0, rk1, rk2, g["rep_valid"])

    # -- miss compaction: the lattice runs on the missed representatives
    miss = g["rep_valid"] & ~hit
    n_miss = int(miss.sum().item())
    miss_pos = _nonzero_padded(miss, rep_cap, rep_cap)
    m_orig = rep_orig[miss_pos.clamp(max=rep_cap)]
    m_known = (idx[m_orig], known[m_orig]) + (
        (l3_bit[m_orig],) if l3_bit is not None else ())
    p1m, p2m, p3m, proxym, jm, _ = _probes(
        pol, ep[m_orig], dirn[m_orig], dport[m_orig], proto[m_orig],
        idx_known=m_known)
    mv0, mv1 = pack_value_words(p1m, p2m, p3m, proxym, jm)
    v0, v1, tuple_hit = scatter_back(g, rep_cap, hit, cv0, cv1, miss_pos,
                                     mv0, mv1)

    # -- insert the missed representatives, only when nothing overflowed
    overflow = g["overflow"]  # n_miss <= n_valid <= rep_cap
    mp = miss_pos.clamp(max=rep_cap)
    do_ins = ((torch.arange(rep_cap, device=dev) < n_miss)
              & pad_rep(ins_ok, mp))
    n_insert = int(do_ins.sum().item())
    cache_out = cache_rows
    if overflow == 0:
        ranked = apply_rank_updates(
            cache_rows, bucket, hit, hit_lane, rank_word,
            pad_rep(bucket, mp), pad_rep(ins_lane, mp),
            pad_rep(rank_word, mp), do_ins)
        cache_out = cache_insert(
            ranked, pad_rep(bucket, mp), pad_rep(ins_lane, mp),
            pad_rep(rk0, mp), pad_rep(rk1, mp), pad_rep(rk2, mp),
            mv0, mv1, do_ins)
    stats = torch.tensor(
        [g["n_unique"], int(tuple_hit.sum().item()), n_insert, overflow, b],
        dtype=torch.int64, device=dev)
    return v0, v1, tuple_hit, cache_out, stats


def memo_lattice(pol, cache_rows, idx, known, l3_bit, ep, dirn, dport, proto,
                 rep_cap: int):
    """The two-level memoized lattice, plain: the key words, dedup
    (level A), then memo_cache_plain (level B).  Inputs int64 [B]
    (`dport`/`proto` clipped, `l3_bit` None without an L3 plane word).
    Returns (probe1, probe2, probe3, proxy, j, hit, cache_rows', stats
    int64 [5]); with stats[STAT_OVERFLOW] != 0 the cache comes back
    unchanged and the per-tuple outputs are unspecified."""
    keys = memo_key_words(idx, known, l3_bit, ep, dirn, dport, proto)
    g = dedup_groups(*keys, rep_cap)
    v0, v1, hit, cache_out, stats = memo_cache_plain(
        pol, cache_rows, keys, g, idx, known, l3_bit, ep, dirn, dport, proto,
        rep_cap)
    probe1, probe2, probe3, proxy, j = unpack_value_words(v0, v1)
    return probe1, probe2, probe3, proxy, j, hit, cache_out, stats


def make_lattice_memo_fn(rep_cap: int, cell: dict):
    """A `lattice_fn` for engine.datapath._datapath_core (the signature
    of verdict._probes): the memoized lattice in place of the probe
    chain.  The updated cache, the summed stats and the per-tuple hit
    flags land in `cell`, whose cache the next call probes."""
    from cilium_tpu_torch.engine.verdict import _index_identity

    def fn(pol, ep, dirn, dport, proto, identity=None, idx_known=None):
        l3_bit = None
        if idx_known is not None:
            idx, known = idx_known[0], idx_known[1]
            if len(idx_known) > 2:
                l3_bit = idx_known[2]
        else:
            idx, known = _index_identity(pol, identity)
        (probe1, probe2, probe3, proxy, j, hit, cache_out,
         stats) = memo_lattice(
            pol, cell["cache"], idx, known, l3_bit, ep, dirn,
            dport.clamp(0, 65535), proto.clamp(0, 255),
            rep_cap=rep_cap)
        cell["cache"] = cache_out
        cell["stats"] = stats if "stats" not in cell else cell["stats"] + stats
        cell.setdefault("hits", []).append(hit)
        return probe1, probe2, probe3, proxy, j, idx

    return fn


# -- the memo programs -----------------------------------------------------------


def memo_evaluate_plain(tables, batch, cache_rows, rep_cap: int):
    """Plain version of the reference's memo_evaluate_kernel: the
    identity index, the memoized lattice, the combine.  Returns
    (Verdicts, cache_rows', hit bool [B], stats int32 [5])."""
    from cilium_tpu_torch.engine.verdict import (
        Verdicts,
        _combine,
        _index_identity,
    )

    idx, known = _index_identity(tables, widen(batch.identity))
    (probe1, probe2, probe3, proxy, j, hit, cache_out,
     stats) = memo_lattice(
        tables, cache_rows, idx, known, None,
        batch.ep_index.to(torch.int64), batch.direction.to(torch.int64),
        batch.dport.to(torch.int64).clamp(0, 65535),
        batch.proto.to(torch.int64).clamp(0, 255),
        rep_cap=rep_cap)
    allowed, proxy_out, kind = _combine(probe1, probe2, probe3, proxy,
                                        batch.is_fragment.bool())
    v = Verdicts(allowed=allowed.to(torch.uint8),
                 proxy_port=proxy_out.to(torch.int32), match_kind=kind)
    return v, cache_out, hit, narrow(stats)


def memo_pair_plain(tables, pair, cache_rows, acc, telem, rep_cap: int):
    """Plain version of the reference's memo_pair_packed4_kernel: both
    packed4 halves through the fused pipeline with the memoized lattice
    (the ingress half's updated cache feeds the egress half's probe).
    The counters, telemetry and cache commit only when the summed
    stats show no overflow: `acc` and `telem` are then updated in place.
    Returns (out_in, out_eg, acc, telem, cache_rows', hit_in, hit_eg,
    stats int32 [5]); cache_rows itself is left as it was."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine.verdict import _accumulate_counters

    cell = {"cache": cache_rows}
    fn = make_lattice_memo_fn(rep_cap, cell)
    out_i, cols_i, t_i = dp._datapath_half(
        tables, dp.flow_batch_from_packed4(pair[0]), True, lattice_fn=fn)
    out_e, cols_e, t_e = dp._datapath_half(
        tables, dp.flow_batch_from_packed4(pair[1]), False, lattice_fn=fn)
    stats = cell["stats"]
    hit_i, hit_e = cell["hits"]
    if int(stats[STAT_OVERFLOW].item()) == 0:
        _accumulate_counters(
            acc, *(torch.cat([a, b]) for a, b in zip(cols_i, cols_e)))
        telem.copy_(narrow(widen(telem) + torch.stack([t_i, t_e])))
        cache_out = cell["cache"]
    else:
        cache_out = cache_rows
    return out_i, out_e, acc, telem, cache_out, hit_i, hit_e, narrow(stats)


def memo_evaluate(tables, batch, cache_rows, rep_cap: int, device=None):
    """The memoized tuple lattice (the daemon's serving shape) on
    `device` (None = the card), where the policy tables, the batch and
    the cache rows must lie.  A CUDA device launches MEMO_KEYS_LATTICE,
    MEMO_DEDUP and MEMO_CACHE; the CPU runs the plain version.  Returns
    (Verdicts, cache_rows', hit bool [B], stats int32 [5]); the input
    rows are left as they were."""
    from cilium_tpu_torch.device import require_on
    from cilium_tpu_torch.engine.verdict import _lattice_device

    dev = _lattice_device(tables, batch, device)
    require_on(cache_rows, dev, "the cache rows (VerdictCache on the device)")
    if dev.type == "cuda":
        return _memo_evaluate_cuda(tables, batch, cache_rows, rep_cap)
    return memo_evaluate_plain(tables, batch, cache_rows, rep_cap)


def memo_pair_packed4(tables, pair, cache_rows, acc, telem, rep_cap: int):
    """The memoized headline pair: a CUDA `pair` launches DATAPATH_PAIR's
    memo mode around MEMO_DEDUP and MEMO_CACHE (per half); a CPU pair
    runs the plain version.  Returns (out_in, out_eg, acc, telem,
    cache_rows', hit_in, hit_eg, stats int32 [5]) as memo_pair_plain."""
    if pair.device.type == "cuda":
        return _memo_pair_cuda(tables, pair, cache_rows, acc, telem, rep_cap)
    if pair.device.type == "cpu":
        return memo_pair_plain(tables, pair, cache_rows, acc, telem, rep_cap)
    raise ValueError(f"unsupported device {pair.device}")


def memo_evaluate_kernel(rep_cap: int):
    """fn(tables, batch, cache_rows, device=None) -> memo_evaluate's
    outputs, at this capacity (the reference's factory)."""
    return functools.partial(memo_evaluate, rep_cap=rep_cap)


def memo_pair_packed4_kernel(rep_cap: int):
    """fn(tables, pair, cache_rows, acc, telem) -> memo_pair_packed4's
    outputs, at this capacity (the reference's factory)."""
    return functools.partial(memo_pair_packed4, rep_cap=rep_cap)


# -- the card ------------------------------------------------------------------


def _memo_evaluate_cuda(tables, batch, cache_rows, rep_cap):
    from cilium_tpu_torch import kernels

    packed = batch.pack()
    keys = kernels.MEMO_KEYS_LATTICE.keys(tables, packed)
    g = kernels.MEMO_DEDUP(keys, rep_cap)
    stats = torch.empty(STATS, dtype=torch.int32, device=packed.device)
    out = torch.empty_like(cache_rows)
    v0, v1, hit = kernels.MEMO_CACHE(
        tables, keys, g, cache_rows, out, stats, rep_cap=rep_cap,
        has_l3=False, ep_dir=(packed[0], packed[4]))
    v = kernels.MEMO_KEYS_LATTICE.combine(v0, v1, packed)
    return v, out, hit, stats


def _memo_pair_cuda(tables, pair, cache_rows, acc, telem, rep_cap):
    from cilium_tpu_torch import kernels

    dev = pair.device
    b = int(pair.shape[2])
    front = kernels.DATAPATH_PAIR_MEMO.front(tables, pair)
    stats = torch.empty(STATS, dtype=torch.int32, device=dev)
    out_rows = torch.empty_like(cache_rows)
    vals = torch.empty((2, 2, b), dtype=torch.int32, device=dev)
    hits = torch.empty((2, b), dtype=torch.bool, device=dev)
    for half in (0, 1):
        keys = front.keys[half]
        g = kernels.MEMO_DEDUP(keys, rep_cap)
        # the ingress half copies the rows and commits into the copy; the
        # egress half probes and commits there; an overflow of either
        # restores the copy from the input
        kernels.MEMO_CACHE(
            tables.policy, keys, g, cache_rows if half == 0 else out_rows,
            out_rows, stats, rep_cap=rep_cap,
            has_l3=front.has_l3, accumulate=half == 1,
            restore=cache_rows if half == 1 else None,
            out=(vals[half, 0], vals[half, 1], hits[half]))
    out_i, out_e = kernels.DATAPATH_PAIR_MEMO.back(tables, pair, front, vals,
                                                   acc, telem, stats)
    return out_i, out_e, acc, telem, out_rows, hits[0], hits[1], stats


# -- the host owner of the rows --------------------------------------------------


class VerdictCache:
    """Host-side owner of the cache rows: epoch-stamped invalidation,
    flush / hit / miss / insert accounting into the metrics registry.

    `stamp` is any hashable naming the table world the cached verdicts
    were computed under (the publish generation and the layout
    version); any change flushes.  The rows live on `device` (None =
    the card) as an int32 tensor of u32 words.  `rows_factory` (host
    rows) and `sharding` (an engine.mesh.NamedSharding) give another
    layout: the mesh cache's [dp, tp, R + 1, W] rows placed per
    coordinate (engine/memo_mesh.py make_partitioned_cache) as an
    engine.mesh.PlacedArray."""

    def __init__(self, n_rows: int = 1 << 12, entries: int = 8,
                 subword: bool = False, device=None, rows_factory=None,
                 sharding=None) -> None:
        self._lock = threading.Lock()
        self._sharding = sharding
        self._device = None if sharding is not None else resolve_device(
            device)
        self._factory = rows_factory or functools.partial(
            make_cache_rows, n_rows, entries, subword=subword)
        self._stamp = None
        # a just-allocated buffer is as empty as a flushed one: the first
        # ensure() adopts its stamp without a flush
        self._fresh = True
        self._rows = self._put(self._factory())
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.flushes = 0
        self.overflows = 0
        self.tuples = 0
        self.unique = 0

    def _put(self, rows):
        if self._sharding is not None:
            from cilium_tpu_torch.engine.mesh import place_array

            return place_array(rows, self._sharding)
        from cilium_tpu_torch.convert import cache_rows_to

        return cache_rows_to(rows, self._device)

    @property
    def stamp(self):
        return self._stamp

    @property
    def rows(self):
        return self._rows

    @rows.setter
    def rows(self, value):
        # a direct write means the buffer carries real entries again
        self._rows = value
        self._fresh = False

    def nbytes(self) -> int:
        return int(np.prod(self._rows.shape)) * 4

    def acquire(self):
        """(stamp, rows) read together for one dispatch."""
        with self._lock:
            return self._stamp, self._rows

    def commit(self, stamp, rows) -> bool:
        """Keep kernel-updated rows only if the cache still holds
        `stamp`: rows derived from a cache that a publish flushed
        meanwhile are dropped."""
        with self._lock:
            if stamp != self._stamp:
                return False
            self._rows = rows
            self._fresh = False
            return True

    def ensure(self, stamp) -> bool:
        """Make the cache valid for `stamp`, flushing when it changed.
        Returns True when the cache was invalidated (or adopted by a
        fresh buffer)."""
        with self._lock:
            if stamp == self._stamp:
                return False
            if self._fresh:
                self._stamp = stamp
                return True
            self._flush_locked(reason="epoch-stamp", old=self._stamp,
                               new=stamp)
            self._stamp = stamp
            return True

    def flush(self, reason: str = "explicit") -> None:
        with self._lock:
            self._flush_locked(reason=reason)
            self._stamp = None

    def _flush_locked(self, reason: str, old=None, new=None) -> None:
        """A fresh buffer; the flush counts in the metrics and lands as
        a `cache.flush` event on the active span."""
        from cilium_tpu_torch import tracing
        from cilium_tpu_torch.metrics import registry as metrics

        self._rows = self._put(self._factory())
        self._fresh = True
        self.flushes += 1
        metrics.verdict_cache_flushes_total.inc()
        tracing.add_event("cache.flush", reason=reason, old_stamp=str(old),
                          new_stamp=str(new))

    def account(self, stats) -> dict:
        """Fold one batch's stats row into the counters and the metrics
        registry.  A batch that overflowed adds only its overflow."""
        from cilium_tpu_torch.metrics import registry as metrics

        s = np.asarray(torch.as_tensor(stats).cpu()).astype(np.int64)
        s &= 0xFFFFFFFF
        row = {
            "unique": int(s[STAT_UNIQUE]),
            "hits": int(s[STAT_HIT]),
            "insertions": int(s[STAT_INSERT]),
            "overflow": int(s[STAT_OVERFLOW]),
            "tuples": int(s[STAT_TUPLES]),
        }
        with self._lock:
            if row["overflow"]:
                self.overflows += row["overflow"]
                return row
            misses = row["tuples"] - row["hits"]
            self.hits += row["hits"]
            self.misses += misses
            self.insertions += row["insertions"]
            self.tuples += row["tuples"]
            self.unique += row["unique"]
        if row["hits"]:
            metrics.verdict_cache_hits_total.inc(value=row["hits"])
        if misses:
            metrics.verdict_cache_misses_total.inc(value=misses)
        if row["insertions"]:
            metrics.verdict_cache_insertions_total.inc(
                value=row["insertions"])
        return row

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def dedup_factor(self) -> float:
        with self._lock:
            return self.tuples / self.unique if self.unique else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "insertions": self.insertions,
                "flushes": self.flushes,
                "overflows": self.overflows,
                "hit_rate": self.hits / total if total else 0.0,
                "dedup_factor": (self.tuples / self.unique
                                 if self.unique else 1.0),
                "bytes": self.nbytes(),
                "stamp": str(self._stamp),
            }
