"""Conntrack snapshot for the device, and the plain probe.

The host CTMap stays authoritative; a batch is evaluated against a
compiled snapshot.  The snapshot is bucketized: the bucket hash runs
over the direction-normalized tuple (sorted (addr, port) pairs), so a
flow's forward key and reverse key land in the same bucket and one
row read answers ct_lookup4's reverse-then-forward probe order.
Entries that overflow their bucket go to a small stash that every
probe compares.

Entry words, planar within the row (word k of entry i at lane
k * E + i):
  w0  normalized lo address
  w1  normalized hi address
  w2  lo port << 16 | hi port
  w3  proto << 8 | swapped << 7 | key flags
  w4  rev_nat_index << 16 | slave
The compact form (`compact_ct_snapshot`, 4 words, 64-lane rows of 16
entries) packs w3 and the low bytes of rev_nat and slave into one
word: w3c = w3 << 16 | rev_nat8 << 8 | slave8.  The stash keeps the
5-word layout in both forms.

DNATed flow entries are placed twice: in the bucket of their own
(post-DNAT) tuple and in the bucket of the original pre-DNAT tuple,
which is the row the egress path fetches once for both its
service-scope probe and its flow probe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.ct.table import (
    CT_ESTABLISHED,
    CT_INGRESS,
    CT_EGRESS,
    CT_NEW,
    CT_RELATED,
    CT_REPLY,
    CTMap,
    CTTuple,
    TUPLE_F_IN,
    TUPLE_F_OUT,
    TUPLE_F_RELATED,
    TUPLE_F_SERVICE,
)
from cilium_tpu_torch.device import array_tensor, u32_tensor, widen
from cilium_tpu_torch.engine.hashtable import (
    _fnv1a_host,
    fnv1a,
    trim_pow2_prefix,
)

ENTRY_WORDS = 5
BUCKET_LANES = 128
ENTRIES_PER_BUCKET = BUCKET_LANES // ENTRY_WORDS  # 25
STASH_ENTRIES = 128
BUCKET_LOAD = 4
_SWAPPED_BIT = 1 << 7
_EMPTY_W3 = np.uint32(0xFFFFFFFF)
_EMPTY_W3C = np.uint32(0xFFFF0000)
CT_COMPACT_LANES = 64


def _normalize_host(daddr: int, saddr: int, dport: int,
                    sport: int) -> Tuple[int, int, int, int, int]:
    """(lo_addr, hi_addr, lo_port, hi_port, swapped)."""
    if (daddr, dport) > (saddr, sport):
        return saddr, daddr, sport, dport, 1
    return daddr, saddr, dport, sport, 0


def _bucket_hash_words(lo_addr, hi_addr, lo_port, hi_port,
                       proto) -> np.ndarray:
    return np.stack(
        [
            np.asarray(lo_addr, np.uint32),
            np.asarray(hi_addr, np.uint32),
            (np.asarray(lo_port, np.uint32) << 16)
            | np.asarray(hi_port, np.uint32),
            np.asarray(proto, np.uint32),
        ],
        axis=-1,
    )


def _pack_entry(key: CTTuple, entry) -> Tuple[int, int, int, int, int]:
    lo_a, hi_a, lo_p, hi_p, swapped = _normalize_host(
        key.daddr, key.saddr, key.dport, key.sport
    )
    w3 = ((key.nexthdr & 0xFF) << 8) | (swapped * _SWAPPED_BIT) | (
        key.flags & 0x7F
    )
    w4 = ((entry.rev_nat_index & 0xFFFF) << 16) | (entry.slave & 0xFFFF)
    return (
        lo_a & 0xFFFFFFFF,
        hi_a & 0xFFFFFFFF,
        ((lo_p & 0xFFFF) << 16) | (hi_p & 0xFFFF),
        w3,
        w4,
    )


@dataclass
class CTSnapshot:
    """Compiled CT: bucket rows + overflow stash.  `entry_words` 5 is
    the 128-lane layout, 4 the compact one."""

    buckets: object  # u32 [Cb, 128 | lanes]
    stash: object  # u32 [S, 5]
    n_buckets: int
    entry_words: int = ENTRY_WORDS


def _envelope_buckets(max_entries: int) -> int:
    nb = 16
    while nb * BUCKET_LOAD < max(max_entries, 1):
        nb *= 2
    return nb


class CTBucketIndex:
    """Host mirror of the device bucket layout: which bucket each key
    lives in, DNATed entries in two."""

    def __init__(self, ct: CTMap) -> None:
        self.n_buckets = _envelope_buckets(ct.max_entries)
        self.bucket_keys: List[List[CTTuple]] = [
            [] for _ in range(self.n_buckets)
        ]
        self.stash_keys: List[CTTuple] = []
        self.key_home: Dict[CTTuple, List[int]] = {}
        self.ct = ct
        for key in ct.entries:
            self._place(key)

    def _bucket_of_tuple(self, daddr: int, saddr: int, dport: int,
                         sport: int, proto: int) -> int:
        lo_a, hi_a, lo_p, hi_p, _ = _normalize_host(
            daddr, saddr, dport, sport
        )
        words = _bucket_hash_words(lo_a, hi_a, lo_p, hi_p, proto)
        return int(_fnv1a_host(words[None, :])[0]) & (self.n_buckets - 1)

    def _homes_of(self, key: CTTuple) -> List[int]:
        homes = [
            self._bucket_of_tuple(
                key.daddr, key.saddr, key.dport, key.sport, key.nexthdr
            )
        ]
        entry = self.ct.entries.get(key)
        orig_daddr = entry.orig_daddr if entry else 0
        if orig_daddr:
            pre = self._bucket_of_tuple(
                orig_daddr, key.saddr, entry.orig_dport, key.sport,
                key.nexthdr,
            )
            if pre != homes[0]:
                homes.append(pre)
        return homes

    def _place(self, key: CTTuple) -> List[int]:
        """A key lives either in its home rows or exactly once in the
        stash, never both (the masked value sums would double)."""
        want = self._homes_of(key)
        if all(len(self.bucket_keys[b]) < ENTRIES_PER_BUCKET for b in want):
            for b in want:
                self.bucket_keys[b].append(key)
            homes = list(want)
        else:
            if len(self.stash_keys) >= STASH_ENTRIES:
                raise ValueError(
                    "CT bucket and stash overflow — raise max_entries "
                    "(bucket envelope) or stash size"
                )
            self.stash_keys.append(key)
            homes = [-1]
        self.key_home[key] = homes
        return homes

    def _row(self, b: int) -> np.ndarray:
        row = np.zeros(BUCKET_LANES, dtype=np.uint32)
        row[3 * ENTRIES_PER_BUCKET : 4 * ENTRIES_PER_BUCKET] = _EMPTY_W3
        for i, key in enumerate(self.bucket_keys[b]):
            packed = _pack_entry(key, self.ct.entries[key])
            for k in range(ENTRY_WORDS):
                row[k * ENTRIES_PER_BUCKET + i] = packed[k]
        return row

    def _stash_rows(self) -> np.ndarray:
        stash = np.zeros((STASH_ENTRIES, ENTRY_WORDS), dtype=np.uint32)
        stash[:, 3] = _EMPTY_W3
        for i, key in enumerate(self.stash_keys):
            stash[i] = _pack_entry(key, self.ct.entries[key])
        return trim_ct_stash(stash)

    def apply(self, created: List[CTTuple], deleted: List[CTTuple]
              ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Fold create/delete key sets into the mirror; returns
        (changed bucket indices i32 [M], their rows u32 [M, 128], the
        new stash or None) for `apply_bucket_delta`.  M is padded to a
        power of two (at least 8) by repeating the first changed
        bucket: the repeated writes carry the same row."""
        dirty = set()
        stash_dirty = False
        for key in deleted:
            homes = self.key_home.pop(key, None)
            if homes is None:
                continue
            for home in homes:
                if home < 0:
                    self.stash_keys.remove(key)
                    stash_dirty = True
                else:
                    self.bucket_keys[home].remove(key)
                    dirty.add(home)
        for key in created:
            homes = self.key_home.get(key)
            if homes is None:
                homes = self._place(key)
            for home in homes:  # the value may have changed: re-pack
                if home < 0:
                    stash_dirty = True
                else:
                    dirty.add(home)
        idx = np.array(sorted(dirty), dtype=np.int32)
        rows = (
            np.stack([self._row(b) for b in idx]) if len(idx)
            else np.zeros((0, BUCKET_LANES), dtype=np.uint32)
        )
        if len(idx):
            m = 8
            while m < len(idx):
                m *= 2
            pad = m - len(idx)
            if pad:
                idx = np.concatenate([idx, np.full(pad, idx[0], np.int32)])
                rows = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
        return idx, rows, self._stash_rows() if stash_dirty else None

    def full_snapshot(self) -> CTSnapshot:
        buckets = np.zeros((self.n_buckets, BUCKET_LANES), dtype=np.uint32)
        buckets[:, 3 * ENTRIES_PER_BUCKET : 4 * ENTRIES_PER_BUCKET] = (
            _EMPTY_W3
        )
        for b in range(self.n_buckets):
            if self.bucket_keys[b]:
                buckets[b] = self._row(b)
        return CTSnapshot(
            buckets=buckets, stash=self._stash_rows(),
            n_buckets=self.n_buckets,
        )


def apply_bucket_delta_plain(snapshot: CTSnapshot, idx: torch.Tensor,
                             rows: torch.Tensor) -> None:
    """Plain version of the CT delta: rows [M, lanes] written into
    `snapshot.buckets` at idx [M] by an index write, in place, with
    jax's scatter rules: an index below 0 gets the bucket count added
    once, and a row whose index is still outside the table is dropped.
    Duplicate indices carry identical rows, so the order of the writes
    does not matter."""
    n = int(snapshot.buckets.shape[0])
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    keep = (i >= 0) & (i < n)
    snapshot.buckets[i[keep]] = rows[keep]


def apply_bucket_delta(snapshot: CTSnapshot, idx: np.ndarray,
                       rows: np.ndarray,
                       stash: Optional[np.ndarray] = None) -> CTSnapshot:
    """Write changed bucket rows (and, when given, a new stash) into a
    device-resident snapshot, in place, and return it.  The JAX
    reference donates the snapshot to its jitted scatter, so its update
    is in place too.  `idx` i32 [M], `rows` u32 [M, lanes] and `stash`
    u32 [S, 5] are CTBucketIndex.apply's numpy output; the new stash
    replaces `snapshot.stash`.  On a CUDA snapshot the rows go through
    the CT_DELTA kernel (kernels.py); on a CPU snapshot through
    `apply_bucket_delta_plain`."""
    dev = snapshot.buckets.device
    if len(idx):
        idx_t = array_tensor(np.asarray(idx, np.int32), dev)
        rows_t = u32_tensor(rows, dev)
        if dev.type == "cuda":
            from cilium_tpu_torch import kernels

            kernels.CT_DELTA(snapshot, idx_t, rows_t)
        elif dev.type == "cpu":
            apply_bucket_delta_plain(snapshot, idx_t, rows_t)
        else:
            raise ValueError(f"unsupported device {dev}")
    if stash is not None:
        snapshot.stash = u32_tensor(stash, dev)
    return snapshot


def trim_ct_stash(stash: np.ndarray) -> np.ndarray:
    """Trim the stash to the pow2 prefix holding its occupied rows."""
    used = int((stash[:, 3] != _EMPTY_W3).sum())
    return trim_pow2_prefix(stash, used)


def compile_ct(ct: CTMap) -> CTSnapshot:
    """Snapshot the host CT into device bucket tables; the bucket
    count is pinned by ct.max_entries."""
    return CTBucketIndex(ct).full_snapshot()


def _decode_per_bucket(snapshot: CTSnapshot):
    """(per-bucket entry lists, stash entry list), every entry as its
    5 words; bucket membership is kept as it is (the pre-DNAT copy of
    a DNATed entry does not sit in the bucket its words hash to)."""
    ew = snapshot.entry_words
    rows = np.asarray(snapshot.buckets)
    n_e = rows.shape[1] // ew
    per_bucket = []
    for b in range(snapshot.n_buckets):
        row = rows[b]
        entries = []
        for k in range(n_e):
            w3p = row[3 * n_e + k]
            if ew == ENTRY_WORDS:
                if w3p == _EMPTY_W3:
                    continue
                entries.append(tuple(int(row[p * n_e + k]) for p in range(5)))
            else:
                if (w3p & np.uint32(0xFFFF0000)) == _EMPTY_W3C:
                    continue
                w3 = int(w3p) >> 16
                w4 = ((int(w3p) >> 8) & 0xFF) << 16 | (int(w3p) & 0xFF)
                entries.append(
                    (int(row[k]), int(row[n_e + k]), int(row[2 * n_e + k]),
                     w3, w4)
                )
        per_bucket.append(entries)
    stash = np.asarray(snapshot.stash)
    stash_entries = [
        tuple(int(v) for v in stash[i])
        for i in range(stash.shape[0])
        if stash[i, 3] != _EMPTY_W3
    ]
    return per_bucket, stash_entries


def _place_ct_layout(per_bucket, stash_entries, nb: int, lanes: int,
                     entry_words: int) -> CTSnapshot:
    """Bucket-preserving placement into either layout.  An entry whose
    bucket copy would overflow moves to the stash, and so do its other
    bucket copies; the stash holds exactly one copy."""
    n_e = lanes // entry_words
    overflowed = set()
    for entries in per_bucket:
        if len(entries) > n_e:
            overflowed.update(entries[n_e:])
    buckets = np.zeros((nb, lanes), dtype=np.uint32)
    empty3 = _EMPTY_W3 if entry_words == ENTRY_WORDS else _EMPTY_W3C
    buckets[:, 3 * n_e : 4 * n_e] = empty3
    stash = np.zeros((STASH_ENTRIES, ENTRY_WORDS), dtype=np.uint32)
    stash[:, 3] = _EMPTY_W3
    sfill = 0
    stashed = set()
    for b, entries in enumerate(per_bucket):
        k = 0
        for ent in entries:
            if ent in overflowed:
                if ent not in stashed:
                    if sfill >= STASH_ENTRIES:
                        raise ValueError(
                            "CT bucket and stash overflow — keep the "
                            "wider layout"
                        )
                    stash[sfill] = ent
                    sfill += 1
                    stashed.add(ent)
                continue
            w0, w1, w2, w3, w4 = ent
            if entry_words == ENTRY_WORDS:
                for p, w in enumerate(ent):
                    buckets[b, p * n_e + k] = w
            else:
                buckets[b, k] = w0
                buckets[b, n_e + k] = w1
                buckets[b, 2 * n_e + k] = w2
                buckets[b, 3 * n_e + k] = (
                    (w3 << 16) | (((w4 >> 16) & 0xFF) << 8) | (w4 & 0xFF)
                )
            k += 1
    for ent in stash_entries:
        if ent in stashed:
            continue
        if sfill >= STASH_ENTRIES:
            raise ValueError(
                "CT bucket and stash overflow — keep the wider layout"
            )
        stash[sfill] = ent
        sfill += 1
    return CTSnapshot(
        buckets=buckets, stash=trim_ct_stash(stash), n_buckets=nb,
        entry_words=entry_words,
    )


def compact_ct_snapshot(snapshot: CTSnapshot,
                        lanes: int = CT_COMPACT_LANES) -> CTSnapshot:
    """Re-place a snapshot in the compact 4-word layout, same bucket
    count and membership.  rev_nat and slave must fit a byte and no
    state halfword may equal the empty marker: ValueError otherwise
    (the caller keeps the 5-word layout)."""
    per_bucket, stash_entries = _decode_per_bucket(snapshot)
    for ent in (e for entries in per_bucket for e in entries):
        w3, w4 = ent[3], ent[4]
        if ((w4 >> 16) & 0xFFFF) > 0xFF or (w4 & 0xFFFF) > 0xFF:
            raise ValueError(
                "rev_nat/slave exceed the compact byte fields — "
                "keeping the 5-word CT layout"
            )
        if w3 >= 0xFFFF:
            raise ValueError(
                "CT state halfword collides with the compact empty "
                "marker — keeping the 5-word CT layout"
            )
    return _place_ct_layout(
        per_bucket, stash_entries, snapshot.n_buckets, lanes, 4
    )


# -- plain device probe (int64 tensors holding u32 values) -------------------


def _normalize(daddr, saddr, dport, sport):
    daddr, saddr = widen(daddr), widen(saddr)
    dport, sport = widen(dport) & 0xFFFF, widen(sport) & 0xFFFF
    swapped = (daddr > saddr) | ((daddr == saddr) & (dport > sport))
    lo_a = torch.where(swapped, saddr, daddr)
    hi_a = torch.where(swapped, daddr, saddr)
    lo_p = torch.where(swapped, sport, dport)
    hi_p = torch.where(swapped, dport, sport)
    return lo_a, hi_a, lo_p, hi_p, swapped


def ct_fetch_rows(snapshot: CTSnapshot, daddr, saddr, dport, sport, proto):
    """The bucket row read: each flow's row by the normalized-tuple
    hash.  Returns int32 rows [B, lanes]."""
    lo_a, hi_a, lo_p, hi_p, _ = _normalize(daddr, saddr, dport, sport)
    h = fnv1a(
        torch.stack(
            [lo_a, hi_a, (lo_p << 16) | hi_p, widen(proto) & 0xFF], dim=1
        )
    )
    return snapshot.buckets[h & (snapshot.n_buckets - 1)]


def ct_probe_keys(daddr, saddr, dport, sport, proto, direction,
                  related_icmp=None):
    """Normalized compare words and the forward/reverse w3 words:
    (lo_a, hi_a, ports_w, w3_fwd, w3_rev, probed_related)."""
    direction = widen(direction)
    base_flags = torch.where(
        direction == CT_INGRESS,
        TUPLE_F_OUT,
        torch.where(direction == CT_EGRESS, TUPLE_F_IN, TUPLE_F_SERVICE),
    )
    if related_icmp is not None:
        base_flags = base_flags | torch.where(
            related_icmp, TUPLE_F_RELATED, 0
        )
    rev_flags = base_flags ^ TUPLE_F_IN
    lo_a, hi_a, lo_p, hi_p, swapped = _normalize(daddr, saddr, dport, sport)
    proto_u = widen(proto) & 0xFF
    pairs_equal = (widen(daddr) == widen(saddr)) & (
        (widen(dport) & 0xFFFF) == (widen(sport) & 0xFFFF)
    )
    fwd_sw = (swapped & ~pairs_equal).to(torch.int64)
    rev_sw = (~swapped & ~pairs_equal).to(torch.int64)
    w3_fwd = (proto_u << 8) | (fwd_sw * _SWAPPED_BIT) | base_flags
    w3_rev = (proto_u << 8) | (rev_sw * _SWAPPED_BIT) | rev_flags
    probed_related = (base_flags & TUPLE_F_RELATED) != 0
    return lo_a, hi_a, (lo_p << 16) | hi_p, w3_fwd, w3_rev, probed_related


def _masked_sum(hit, vals):
    return (torch.where(hit, vals, 0).sum(dim=1)) & 0xFFFFFFFF


def ct_probe_row_parts(rows, lo_a, hi_a, ports_w, w3_fwd, w3_rev,
                       owns=None, entry_words: int = ENTRY_WORDS):
    """Lane compares against fetched rows, either layout, with an
    optional ownership mask `owns` bool [B] (the routed mesh probe
    reads each row on its owning shard only: a shard that does not own
    a flow's row contributes exactly zero, so a sum over the table axis
    equals the single-device result).  Returns (fwd_found, rev_found,
    fwd_val, rev_val)."""
    n_e = rows.shape[1] // entry_words
    ew = [
        widen(rows[:, k * n_e : (k + 1) * n_e]) for k in range(entry_words)
    ]
    key_eq = (
        (ew[0] == lo_a[:, None])
        & (ew[1] == hi_a[:, None])
        & (ew[2] == ports_w[:, None])
    )
    if owns is not None:
        key_eq = key_eq & owns[:, None]
    if entry_words == ENTRY_WORDS:
        w3_plane, val_plane = ew[3], ew[4]
    else:
        w3_plane = ew[3] >> 16
        val_plane = (((ew[3] >> 8) & 0xFF) << 16) | (ew[3] & 0xFF)
    fwd_hit = key_eq & (w3_plane == w3_fwd[:, None])
    rev_hit = key_eq & (w3_plane == w3_rev[:, None])
    return (
        fwd_hit.any(dim=1), rev_hit.any(dim=1),
        _masked_sum(fwd_hit, val_plane), _masked_sum(rev_hit, val_plane),
    )


def ct_probe_stash_parts(snapshot, lo_a, hi_a, ports_w, w3_fwd, w3_rev):
    """Stash half of the CT probe; same contract as the row parts."""
    stash = widen(snapshot.stash)  # [S, 5]
    s_key_eq = (
        (stash[None, :, 0] == lo_a[:, None])
        & (stash[None, :, 1] == hi_a[:, None])
        & (stash[None, :, 2] == ports_w[:, None])
    )
    s_fwd = s_key_eq & (stash[None, :, 3] == w3_fwd[:, None])
    s_rev = s_key_eq & (stash[None, :, 3] == w3_rev[:, None])
    vals = stash[None, :, 4]
    return (
        s_fwd.any(dim=1), s_rev.any(dim=1),
        _masked_sum(s_fwd, vals), _masked_sum(s_rev, vals),
    )


def ct_probe_combine(fwd_found, rev_found, fwd_val, rev_val,
                     probed_related):
    """(result u8, rev_nat i32, slave i32): the reverse key first
    (REPLY/RELATED), then the forward key (ESTABLISHED), else NEW."""
    result = torch.where(
        rev_found,
        torch.where(probed_related, CT_RELATED, CT_REPLY),
        torch.where(
            fwd_found,
            torch.where(probed_related, CT_RELATED, CT_ESTABLISHED),
            CT_NEW,
        ),
    ).to(torch.uint8)
    val = torch.where(rev_found, rev_val, fwd_val)
    hit = rev_found | fwd_found
    rev_nat = torch.where(hit, val >> 16, 0).to(torch.int32)
    slave = torch.where(hit, val & 0xFFFF, 0).to(torch.int32)
    return result, rev_nat, slave


def ct_probe_rows(snapshot: CTSnapshot, rows, daddr, saddr, dport, sport,
                  proto, direction, related_icmp=None):
    """Probe fetched rows for a tuple and direction.  The rows need
    not come from this tuple's hash: the egress path probes the
    pre-DNAT row for the post-DNAT key."""
    lo_a, hi_a, ports_w, w3_fwd, w3_rev, probed_related = ct_probe_keys(
        daddr, saddr, dport, sport, proto, direction, related_icmp
    )
    rf, rr, rfv, rrv = ct_probe_row_parts(
        rows, lo_a, hi_a, ports_w, w3_fwd, w3_rev,
        entry_words=snapshot.entry_words,
    )
    sf, sr, sfv, srv = ct_probe_stash_parts(
        snapshot, lo_a, hi_a, ports_w, w3_fwd, w3_rev
    )
    return ct_probe_combine(
        rf | sf, rr | sr, (rfv + sfv) & 0xFFFFFFFF,
        (rrv + srv) & 0xFFFFFFFF, probed_related,
    )
