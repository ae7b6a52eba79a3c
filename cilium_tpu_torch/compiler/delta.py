"""Delta table publication: host-side diffing of compiled tables.

FleetCompiler re-lowers only the endpoints whose map state moved.  This
module closes the remaining whole-world costs, so that one rule added
to a 50,000-rule fleet costs about what it changes:

  * IncrementalHashPair keeps the hashed L4 entry tables across
    compiles.  A dirty endpoint's entry section is diffed against its
    previous lowering, and only the hash buckets whose ordered content
    changed are placed again.  The result equals a from-scratch
    build_l4_hash_pair over the same concatenated entries: lane order
    inside a bucket is the global concatenation order, and a bucket
    left alone keeps its subsequence.
  * PendingBuffer is the double-buffered publish pair of a mutable
    master array: each publish flips to the standby buffer and copies
    only the rows dirtied since that buffer was last handed out, so a
    consumer may hold the previous array for one flip.
  * TableDelta describes, per leaf, a scatter (indices and fresh
    values) or a whole-leaf replacement (its shape class moved); the
    device store (engine/publish.py) writes it into a resident epoch
    instead of uploading every table, as Cilium updates single
    policymap entries in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from cilium_tpu_torch.compiler.tables import (
    L4H_LANES,
    L4H_STASH,
    L4H_WILD_IDX,
    _fnv1a_host_2,
    _pow2_at_least,
    l4h_entries,
    l4h_key0,
    l4h_key1,
    l4h_load,
    place_l4_hash,
    trim_stash,
)

# -- per-leaf scatter update -------------------------------------------------


@dataclass
class LeafUpdate:
    """Scatter payload of one PolicyTables leaf: write `values` at
    `idx`, a tuple of index arrays, one per indexed leading axis."""

    idx: Tuple[np.ndarray, ...]
    values: np.ndarray

    @property
    def nbytes(self) -> int:
        return sum(i.nbytes for i in self.idx) + self.values.nbytes


@dataclass
class TableDelta:
    """Everything that changed between two publish generations.

    `updates` leaves scatter in place; `replace` leaves ship whole
    (their shape class moved, or they are scalars).  Leaves in neither
    are identical between the generations.  `layout` is the
    tables_layout_version the delta was recorded against: the device
    store refuses it for an epoch of another layout and uploads in
    full."""

    base_stamp: int
    new_stamp: int
    updates: Dict[str, LeafUpdate] = field(default_factory=dict)
    replace: Dict[str, np.ndarray] = field(default_factory=dict)
    layout: int = 0

    @property
    def bytes_h2d(self) -> int:
        """Bytes this delta ships host to device (a full upload ships
        tables_nbytes)."""
        n = sum(u.nbytes for u in self.updates.values())
        n += sum(np.asarray(a).nbytes for a in self.replace.values())
        return n


def tables_nbytes(tables) -> int:
    """Total payload of a full PolicyTables upload."""
    total = 0
    for f in dataclasses.fields(tables):
        leaf = getattr(tables, f.name)
        if leaf is not None:
            total += np.asarray(leaf).nbytes
    return total


# -- double-buffered publish pair over a mutable master ----------------------


class PendingBuffer:
    """Two publish buffers ping-ponging over a master array that is
    mutated in place between publishes.  `publish()` flips to the
    standby buffer and copies only the rows dirtied since that buffer
    was last returned."""

    def __init__(self) -> None:
        self._bufs = [{"arr": None, "pending": set()} for _ in range(2)]
        self._flip = 0

    def mark(self, rows) -> None:
        """Record master rows (axis 0) changed since the last publish."""
        for buf in self._bufs:
            buf["pending"].update(rows)

    def mark_all(self) -> None:
        for buf in self._bufs:
            buf["arr"] = None
            buf["pending"].clear()

    def publish(self, master: np.ndarray) -> np.ndarray:
        self._flip ^= 1
        buf = self._bufs[self._flip]
        arr = buf["arr"]
        if arr is None or arr.shape != master.shape:
            buf["arr"] = master.copy()
        elif buf["pending"]:
            idx = np.fromiter(buf["pending"], dtype=np.int64,
                              count=len(buf["pending"]))
            buf["arr"][idx] = master[idx]
        buf["pending"].clear()
        # pre-warm the standby now, so the first incremental publish
        # copies only what it changed
        other = self._bufs[self._flip ^ 1]
        if other["arr"] is None or other["arr"].shape != master.shape:
            other["arr"] = master.copy()
            other["pending"].clear()
        return buf["arr"]


# -- incremental hashed L4 entry tables --------------------------------------


def _hash_cols(ep_idx: int, ent: dict):
    """One endpoint's key/value columns of the hashed probe, split into
    the exact and wildcard partitions (concatenation order kept)."""
    d = ent["d"]
    idx = ent["idx"]
    if len(idx) and int(idx.max()) > int(L4H_WILD_IDX):
        raise ValueError("identity index exceeds 22-bit hash key space")
    ep = np.full(len(d), ep_idx, np.uint32)
    w0 = l4h_key0(idx, d, ep)
    w1 = l4h_key1(ent["dport"], ent["proto"], ep)
    h = _fnv1a_host_2(w0, w1)
    wild = idx == L4H_WILD_IDX
    out = {}
    for name, sel in (("exact", ~wild), ("wild", wild)):
        out[name] = {"w0": w0[sel], "w1": w1[sel], "val": ent["val"][sel],
                     "h": h[sel]}
    return out


def _key64(sec: dict) -> np.ndarray:
    return ((sec["w0"].astype(np.uint64) << np.uint64(32))
            | sec["w1"].astype(np.uint64))


def _window_buckets(old: dict, new: dict, mask: int) -> np.ndarray:
    """Conservative fallback: the buckets touched by the difference
    window (common prefix and suffix stripped).  Right for any
    reordering of a section: entries outside the window are identical
    in content and relative order."""
    lo, ln = len(old["w0"]), len(new["w0"])
    m = min(lo, ln)
    if m:
        eq = ((old["w0"][:m] == new["w0"][:m])
              & (old["w1"][:m] == new["w1"][:m])
              & (old["val"][:m] == new["val"][:m]))
        prefix = int(m) if eq.all() else int(np.argmin(eq))
    else:
        prefix = 0
    rm = min(lo, ln) - prefix  # the suffix must not overlap the prefix
    if rm:
        eq = ((old["w0"][lo - rm:] == new["w0"][ln - rm:])
              & (old["w1"][lo - rm:] == new["w1"][ln - rm:])
              & (old["val"][lo - rm:] == new["val"][ln - rm:]))
        rev = eq[::-1]
        suffix = int(rm) if rev.all() else int(np.argmin(rev))
    else:
        suffix = 0
    win = np.concatenate([old["h"][prefix:lo - suffix],
                          new["h"][prefix:ln - suffix]])
    return np.unique(win & np.uint32(mask))


def _section_changed_buckets(old: dict, new: dict,
                             mask: int) -> Optional[np.ndarray]:
    """The buckets whose ordered subsequence of this section's entries
    differs between `old` and `new`, or None when nothing changed.

    Fast path: entries are keyed by their unique (w0, w1) words and
    diffed as sets.  That is sound only when the common entries keep
    their relative order, which sections lowered from sorted
    MapStateArrays always do; otherwise (dict-ordered states) the
    window diff takes over."""
    lo, ln = len(old["w0"]), len(new["w0"])
    if lo == ln and (np.array_equal(old["w0"], new["w0"])
                     and np.array_equal(old["w1"], new["w1"])
                     and np.array_equal(old["val"], new["val"])):
        return None
    ko, kn = _key64(old), _key64(new)
    sn = np.sort(kn)
    pos_c = np.minimum(np.searchsorted(sn, ko), max(len(sn) - 1, 0))
    old_in_new = sn[pos_c] == ko if len(sn) else np.zeros(lo, bool)
    so = np.sort(ko)
    pos_c = np.minimum(np.searchsorted(so, kn), max(len(so) - 1, 0))
    new_in_old = so[pos_c] == kn if len(so) else np.zeros(ln, bool)
    if not np.array_equal(ko[old_in_new], kn[new_in_old]):
        # common entries reordered: the key diff is unsound
        return _window_buckets(old, new, mask)
    # values of the matched pairs (aligned by the order check above)
    val_changed = old["val"][old_in_new] != new["val"][new_in_old]
    win = np.concatenate([old["h"][~old_in_new], new["h"][~new_in_old],
                          old["h"][old_in_new][val_changed]])
    if not len(win):
        return None
    return np.unique(win & np.uint32(mask))


def _stack_of(w0: int, w1: int) -> int:
    """An entry's endpoint (stack) index from its two key words."""
    return ((w0 >> 23) & 0x1FF) | ((w1 & 0x7F) << 9)


class _IncrementalTable:
    """One hashed entry table (exact or wild) kept across compiles.  The
    master `rows` mutate in place; publishes go through a PendingBuffer
    pair.  `stash` is rebuilt per publish (64 x 3 words)."""

    def __init__(self, min_rows: int) -> None:
        self.min_rows = min_rows
        self.lanes = L4H_LANES
        self.rows: Optional[np.ndarray] = None
        self.stash: Optional[np.ndarray] = None
        self.n_rows = 0
        # bucket -> [k, 3] u32 overflow triples in global order
        self.overflow: Dict[int, np.ndarray] = {}
        self.pub = PendingBuffer()
        self.stash_dirty = True

    @property
    def entries(self) -> int:
        return l4h_entries(self.lanes)

    def _sized_rows(self, t: int) -> int:
        return _pow2_at_least(max(t // l4h_load(self.lanes), 1),
                              self.min_rows)

    def full_build(self, cols: dict) -> Set[int]:
        """From-scratch placement through tables.place_l4_hash, keeping
        its overflow positions as the per-bucket state the delta path
        maintains.  Returns every row."""
        rows, stash, so, b = place_l4_hash(
            cols["w0"], cols["w1"], cols["val"], cols["h"], self.min_rows,
            lanes=self.lanes,
        )
        self.overflow = {}
        for pos in so.tolist():  # already in (bucket, order) order
            bb = int(b[pos])
            triple = np.asarray(
                [cols["w0"][pos], cols["w1"][pos], cols["val"][pos]],
                np.uint32)[None]
            prev = self.overflow.get(bb)
            self.overflow[bb] = (triple if prev is None
                                 else np.concatenate([prev, triple]))
        self.rows = rows
        self.n_rows = rows.shape[0]
        self.stash = stash
        self.stash_dirty = True
        self.pub.mark_all()
        return set(range(self.n_rows))

    def _rebuild_stash(self) -> None:
        stash = np.zeros((L4H_STASH, 3), dtype=np.uint32)
        stash[:, 1] = np.uint32(0xFFFFFFFF)
        k = 0
        for bb in sorted(self.overflow):
            tri = self.overflow[bb]
            stash[k:k + len(tri)] = tri
            k += len(tri)
        self.stash = stash
        self.stash_dirty = True

    def delta_build(self, t_new: int, affected: np.ndarray,
                    dirty_stack: Set[int],
                    new_by_bucket: Dict[int, list]) -> Optional[Set[int]]:
        """Place only the `affected` buckets again.  A bucket's current
        ordered content is read back from the master rows (lanes in
        global order, then its overflow triples), the dirty endpoints'
        entries are dropped and replaced by `new_by_bucket[b]` (each
        tagged with its stack index), and a stable merge by stack index
        gives the order a full rebuild would place.  Returns the changed
        rows, or None when the size class moved or the stash would
        overflow (the caller then builds in full)."""
        if self.rows is None or self._sized_rows(t_new) != self.n_rows:
            return None
        if len(affected) == 0:
            return set()
        e = self.entries
        placed: Dict[int, list] = {}
        over_total = sum(len(v) for v in self.overflow.values())
        for bb in affected.tolist():
            bb = int(bb)
            row = self.rows[bb]
            w1s = row[e:2 * e]
            kept = []
            for lane in range(e):
                w1 = int(w1s[lane])
                if w1 == 0xFFFFFFFF:
                    break  # lanes fill front to back
                w0 = int(row[lane])
                stack = _stack_of(w0, w1)
                if stack not in dirty_stack:
                    kept.append((stack, (w0, w1, int(row[2 * e + lane]))))
            for tri in self.overflow.get(bb, ()):
                w0, w1 = int(tri[0]), int(tri[1])
                stack = _stack_of(w0, w1)
                if stack not in dirty_stack:
                    kept.append((stack, (w0, w1, int(tri[2]))))
            fresh = new_by_bucket.get(bb, ())
            # stable by stack index: kept and fresh are each ordered, and
            # a stack index never appears in both
            merged = sorted(kept + list(fresh), key=lambda x: x[0])
            placed[bb] = [tri for _, tri in merged]
        # the stash's capacity, before anything is mutated
        removed = sum(len(self.overflow.get(int(bb), ()))
                      for bb in affected.tolist())
        added = sum(max(len(v) - e, 0) for v in placed.values())
        if over_total - removed + added > L4H_STASH:
            return None
        stash_changed = removed > 0 or added > 0
        for bb, content in placed.items():
            row = self.rows[bb]
            row[:] = 0
            row[e:2 * e] = 0xFFFFFFFF
            lanes = content[:e]
            if lanes:
                arr = np.asarray(lanes, np.uint32)
                k = len(lanes)
                row[:k] = arr[:, 0]
                row[e:e + k] = arr[:, 1]
                row[2 * e:2 * e + k] = arr[:, 2]
            spill = content[e:]
            self.overflow.pop(bb, None)
            if spill:
                self.overflow[bb] = np.asarray(spill, np.uint32)
        changed = set(placed)
        self.pub.mark(changed)
        if stash_changed:
            self._rebuild_stash()
        else:
            self.stash_dirty = False
        return changed

    def published(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, stash) safe to hand out: rows through the publish
        pair, the stash owned by this generation and trimmed to its
        occupied pow2 prefix."""
        return self.pub.publish(self.rows), trim_stash(self.stash)


class IncrementalHashPair:
    """The (exact, wild) hashed L4 table pair kept across compiles (see
    the module docstring): FleetCompiler's replacement for a
    from-scratch build_l4_hash_pair."""

    def __init__(self) -> None:
        self._sections: Dict[int, dict] = {}  # ep_id -> cols per table
        self._order: Optional[Tuple[int, ...]] = None
        self.exact = _IncrementalTable(min_rows=64)
        self.wild = _IncrementalTable(min_rows=16)

    def reset(self) -> None:
        self.__init__()

    def _concat(self, order: Sequence[int], table: str) -> dict:
        secs = [self._sections[ep][table] for ep in order]
        keys = ("w0", "w1", "val", "h")
        if not secs:
            return {k: np.zeros(0, np.uint32) for k in keys}
        return {k: np.concatenate([s[k] for s in secs]) for k in keys}

    def build(self, order: Sequence[int], rows_by_ep: Dict[int, dict],
              dirty_ep_ids: Sequence[int]) -> Tuple[tuple, dict]:
        """Update the pair for this compile.  `rows_by_ep[ep]["ent"]`
        holds each endpoint's entry columns; only `dirty_ep_ids`
        changed since the previous call.  Returns ((rows, stash,
        wild_rows, wild_stash), info), where info maps each table name
        to its changed rows (None: rebuilt in full) and name + "_stash"
        to whether its stash changed."""
        order_t = tuple(order)
        if len(order_t) > 65536:
            # the empty-lane marker relies on ep >> 9 < 128
            raise ValueError("endpoint axis exceeds the 16-bit key space")
        ep_index = {ep: i for i, ep in enumerate(order_t)}
        full = self._order != order_t or self.exact.rows is None
        if full:
            self._sections = {
                ep: _hash_cols(ep_index[ep], rows_by_ep[ep]["ent"])
                for ep in order_t
            }
        else:
            dirty = [ep for ep in dirty_ep_ids if ep in ep_index]
            new_secs = {
                ep: _hash_cols(ep_index[ep], rows_by_ep[ep]["ent"])
                for ep in dirty
            }
        self._order = order_t

        info = {}
        for name, table in (("exact", self.exact), ("wild", self.wild)):
            if full:
                table.full_build(self._concat(order_t, name))
                info[name] = None
                info[name + "_stash"] = True
                continue
            mask = table.n_rows - 1
            parts = []
            for ep in dirty:
                got = _section_changed_buckets(
                    self._sections[ep][name], new_secs[ep][name], mask)
                if got is not None:
                    parts.append(got)
            if not parts:
                info[name] = set()
                info[name + "_stash"] = False
                table.stash_dirty = False
                continue
            affected = np.unique(np.concatenate(parts))
            # splice the fresh sections in before placing again
            for ep in dirty:
                self._sections[ep][name] = new_secs[ep][name]
            # the dirty endpoints' entries in the affected buckets, tagged
            # with their stack index, in (stack, section) order
            dirty_set = set(dirty)
            dirty_stack = {ep_index[ep] for ep in dirty}
            new_by_bucket: Dict[int, list] = {}
            for ep in order_t:
                if ep not in dirty_set:
                    continue
                sec = self._sections[ep][name]
                b = (sec["h"] & np.uint32(mask)).astype(np.int64)
                stack = ep_index[ep]
                for pos in np.nonzero(np.isin(b, affected))[0].tolist():
                    new_by_bucket.setdefault(int(b[pos]), []).append(
                        (stack, (int(sec["w0"][pos]), int(sec["w1"][pos]),
                                 int(sec["val"][pos]))))
            t_new = sum(len(self._sections[ep][name]["w0"])
                        for ep in order_t)
            changed = table.delta_build(t_new, affected, dirty_stack,
                                        new_by_bucket)
            if changed is None:
                table.full_build(self._concat(order_t, name))
                info[name] = None
                info[name + "_stash"] = True
            else:
                info[name] = changed
                info[name + "_stash"] = table.stash_dirty
        if not full and dirty:
            for ep in dirty:
                self._sections[ep] = new_secs[ep]
        rows, stash = self.exact.published()
        wrows, wstash = self.wild.published()
        return (rows, stash, wrows, wstash), info
