"""Replay: flow records through the fused datapath, the conntrack churn
loop over a flow pool, and the record replay through the bare policy
lattice.

`replay` is the reference's `replay()`, the workload the repo was built
for: flow records are decoded, cut into padded batches and uploaded as
one [8, B] word pack each (`read_flow_batches`), and each batch runs the
fused single-batch step (DATAPATH_STEP on the card) with its counter
hits scattered into a carried u32 buffer, folded into host u64 sums
every `max(1, 2^31 // batch_size)` batches and at the end, so that no
cell can wrap.  With `collect_telemetry` a full batch also sums its
[2, 20] telemetry on the device; a partial tail batch (whose padding
the device sums would count) and the no-counter path fold it on the
host over the valid rows.  The folded histogram lands in
`stats.telemetry` and in the metrics registry.  Up to four batches are
in flight.  With `ct_map` it runs in churn mode: each batch runs the
counter-carrying step, then the intent compaction over its pack, and
the rounds of the churn loop below write the CT back before the next
batch, so a flow that batch i creates is ESTABLISHED from batch i + 1
on; convergence reruns take the plain step.

`replay_lattice` is the post-hoc Hubble audit path: flow records (the
identity already resolved in each record) are decoded, cut into padded
batches, uploaded as one [6, B] pack each and judged by the tuple
lattice with per-batch counters (the LATTICE kernel on the card), up to
four batches in flight; each drained batch adds its verdict tallies to
the stats and its counters to u64 host totals.

The churn loop is the counterpart of the reference's `replay_pool`
(its config-5 `ct_churn_tuples_per_sec`).  The flow pool (unique flows,
as real traffic repeats flows) is packed once into [8, P] words on the
device; each batch is a vector of picks into it, explicit or drawn on
the device with the reference's threefry draw (prng.py, PICK_DRAW).
One round of a batch runs:

  1. the churn step on the device: the single-batch datapath step
     over pool[:, picks] (DATAPATH_STEP), then the intent compaction
     (CHURN_COMPACT): a claim table keeps the first flagged row per
     flow-hash slot, and the first `cap` winners, in row order, are
     written as [12, cap] intent columns beside a 4-word header;
  2. the 16-byte header copied to the host: the round's one blocking
     synchronisation;
  3. the intents fetched in the smallest slice bucket that holds them;
  4. the host CT fold (apply_ct_writeback_host, then
     CTBucketIndex.apply, in np.unique's sorted order);
  5. the changed bucket rows written into the resident snapshot in
     place (CT_DELTA).

The round repeats (a rerun) while the header's `remaining` says that
intents lost their slot or were cut by the cap.  On CUDA tensors the
kernels run, or the call raises; on CPU tensors their plain versions
run.  `replay`'s and `replay_lattice`'s `manager=` runs the endpoint
manager's stale-table check first.  `replay`'s `flow_store=` (a
flow.FlowStore) folds every drained batch into the flow ring on the
host (`_FlowCapture`): every drop and the allows that the
MonitorAggregationLevel's head sample keeps, tagged with `chip`, the
peer identity on its side of the pair and the record's endpoint id
(through `ep_map`'s inverse); the columns it reads are copied to the
host once per batch.  Flow capture is not offered in churn mode, as in
the reference.
`sync_counters_to_endpoints` folds the counter totals back into the
endpoints' realized map states.  Every step launch of `replay` and
`replay_lattice` goes through resilience.guarded_dispatch: the
`engine.dispatch` fault seam fires before the launch and a fired fault
is retried, at most twice; the steps that carry the counter buffers
(`donated=True`) retry only that pre-launch fault.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.ct.device import CTBucketIndex, apply_bucket_delta
from cilium_tpu_torch.device import (
    narrow,
    on_device,
    require_on,
    resolve_device,
    u32_tensor,
    widen,
)
from cilium_tpu_torch.engine.datapath import (
    FLOW_COLUMNS,
    DatapathTables,
    DatapathVerdicts,
    FlowBatch,
    apply_ct_writeback_host,
    datapath_step,
    datapath_step_accum,
    datapath_step_accum_telem,
    datapath_step_pool,
    flow_batch_from_packed,
    pack_flow_batch,
    pool_flows,
    pool_rows_of,
)
from cilium_tpu_torch.engine.hashtable import fnv1a
from cilium_tpu_torch.engine.verdict import (
    TELEM_COLS,
    TupleBatch,
    evaluate_batch,
    evaluate_batch_with_counters,
    make_counter_buffers,
    make_telemetry_buffers,
)
from cilium_tpu_torch.maps.policymap import (
    MapStateArrays,
    PolicyKey,
    _EntryView,
)
from cilium_tpu_torch.native.loader import decode_flow_records
from cilium_tpu_torch.prng import fold_in, prng_key, randint_u32
from cilium_tpu_torch.resilience import guarded_dispatch

# fold the carried u32 counter buffer into host u64 sums before any cell
# could gain 2^31 increments (a batch adds at most batch_size to a cell)
_COUNTER_FOLD_MAX_INCR = 1 << 31
# create/delete intents that one round may carry to the host
_CT_INTENT_CAP = 1 << 16
# claim-table slots of the on-device intent dedup
_CT_CLAIM_SLOTS = 1 << 19
# the intent fetch moves the smallest of these column slices that
# holds the round's intents
_CT_FETCH_BUCKETS = (1 << 10, 1 << 13, _CT_INTENT_CAP)

# rows of the [12, cap] intent buffer
INTENT_COLUMNS = (
    "ct_create", "ct_delete", "final_daddr", "final_dport", "saddr",
    "sport", "proto", "direction", "rev_nat", "lb_slave", "daddr", "dport",
)

_POOL_PACK_KEY = "__device_pack__"
_POOL_ROWS_KEY = "__device_rows__"


def churn_hash(out: DatapathVerdicts, flows: FlowBatch) -> torch.Tensor:
    """FNV-1a of each row's post-DNAT flow words (final_daddr, saddr,
    final_dport << 16 | sport, proto << 8 | direction): int64 [B]
    holding the u32 hash."""
    u = widen
    return fnv1a(torch.stack([
        u(out.final_daddr),
        u(flows.saddr),
        ((u(out.final_dport) << 16) | (u(flows.sport) & 0xFFFF)) & 0xFFFFFFFF,
        ((u(flows.proto) << 8) | u(flows.direction)) & 0xFFFFFFFF,
    ], dim=1))


def _intent_columns(out: DatapathVerdicts, flows: FlowBatch):
    src = dict(
        ct_create=out.ct_create, ct_delete=out.ct_delete,
        final_daddr=out.final_daddr, final_dport=out.final_dport,
        saddr=flows.saddr, sport=flows.sport, proto=flows.proto,
        direction=flows.direction, rev_nat=out.rev_nat,
        lb_slave=out.lb_slave, daddr=flows.daddr, dport=flows.dport,
    )
    return torch.stack([widen(src[c]) for c in INTENT_COLUMNS])


def _churn_compact(out: DatapathVerdicts, flows: FlowBatch, valid: int,
                   cap: int = _CT_INTENT_CAP,
                   claim_slots: int = _CT_CLAIM_SLOTS):
    """Plain version of the intent compaction.  Rows below `valid`
    that create or delete are flagged; each claims slot
    `hash & (claim_slots - 1)` with its row id, and the smallest id
    wins.  A flagged loser whose hash differs from its winner's is a
    distinct flow (a "true loser") and needs a rerun; one with the same
    hash is a later packet of the winner's flow.  The first `cap`
    winners in row order become the intents.  Returns (header int32 [4]
    = n_tx, allowed, redirected, remaining, intents int32 [12, cap]),
    u32 bits in int32."""
    b = int(out.ct_create.shape[0])
    dev = out.ct_create.device
    row_id = torch.arange(b, dtype=torch.int64, device=dev)
    in_valid = row_id < valid
    flag = (out.ct_create.bool() | out.ct_delete.bool()) & in_valid
    h = churn_hash(out, flows)
    slot = h & (claim_slots - 1)
    claim = torch.full((claim_slots,), b, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(0, slot, torch.where(flag, row_id, b), "amin")
    winner_row = claim[slot]
    winner = flag & (winner_row == row_id)
    true_loser = flag & ~winner & (h[winner_row.clamp(0, b - 1)] != h)
    take = min(cap, b)
    order = torch.nonzero(winner).reshape(-1)[:take]
    intents = torch.zeros((len(INTENT_COLUMNS), cap), dtype=torch.int32,
                          device=dev)
    intents[:, : order.numel()] = narrow(_intent_columns(out, flows)[:, order])
    n_win = winner.sum()
    n_tx = n_win.clamp(max=take)
    allowed = (widen(out.allowed) * in_valid).sum()
    redirected = ((out.proxy_port > 0) & in_valid).sum()
    remaining = true_loser.sum() + (n_win - n_tx)
    header = narrow(torch.stack([n_tx, allowed, redirected, remaining]))
    return header, intents


def churn_compact(out: DatapathVerdicts, pool: torch.Tensor,
                  picks: torch.Tensor, valid: int):
    """The intent compaction of a step over pool[:, picks], at the
    module's `_CT_INTENT_CAP` and `_CT_CLAIM_SLOTS` as they stand when
    it is called.  CUDA tensors launch CHURN_COMPACT (which reads the
    flow words from the pool itself); CPU tensors run `_churn_compact`."""
    cap, claim_slots = _CT_INTENT_CAP, _CT_CLAIM_SLOTS
    if pool.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.CHURN_COMPACT(out, pool, picks, valid, cap,
                                     claim_slots)
    if pool.device.type == "cpu":
        return _churn_compact(out, pool_flows(pool, picks), valid, cap,
                              claim_slots)
    raise ValueError(f"unsupported device {pool.device}")


def churn_step(tables: DatapathTables, pool: torch.Tensor,
               picks: torch.Tensor, valid: int,
               pool_rows: Optional[torch.Tensor] = None):
    """Pool gather, single-batch datapath step and intent compaction:
    (header, intents) as `_churn_compact` returns them; `pool_rows` is
    the pool's row-major copy for the step's gather (datapath_step_pool)."""
    out = datapath_step_pool(tables, pool, picks, pool_rows)
    return churn_compact(out, pool, picks, valid)


def pack_flow_pool(pool: Dict[str, np.ndarray]) -> np.ndarray:
    """Flow-pool columns -> the [8, P] u32 pack, rows in FLOW_COLUMNS
    order."""
    p = len(pool["saddr"])
    packed = np.empty((len(FLOW_COLUMNS), p), dtype=np.uint32)
    for j, name in enumerate(FLOW_COLUMNS):
        packed[j] = np.asarray(pool[name]).astype(np.uint32, copy=False)
    return packed


def _fetch_buckets(cap: int):
    return tuple(b for b in _CT_FETCH_BUCKETS if b < cap) + (cap,)


def _fetch_intents(intents: torch.Tensor, k: int) -> np.ndarray:
    """The first k intent columns as u32 numpy, copied to the host in
    the smallest slice bucket that holds them."""
    cap = int(intents.shape[1])
    bucket = next(b for b in _fetch_buckets(cap) if k <= b)
    return intents[:, :bucket].cpu().numpy().view(np.uint32)[:, :k]


@dataclass
class ReplayStats:
    total: int = 0
    allowed: int = 0
    denied: int = 0
    redirected: int = 0
    batches: int = 0
    seconds: float = 0.0
    ct_created: int = 0
    ct_deleted: int = 0
    # churn rounds (batches plus reruns), each round's intent count, and
    # the host seconds of the rounds' folds (intent fetch, CT write-back,
    # bucket index, delta launch)
    rounds: int = 0
    intents: List[int] = field(default_factory=list)
    fold_seconds: float = 0.0
    # host seconds by span.  replay_lattice: a dict of decode (the
    # record columns), pack (a batch's pack and its upload), dispatch
    # (the lattice launch), drain (tallies and counters fetched and
    # summed).  replay: a SpanStats of host_pack (decode, then each
    # batch's pack and upload), dispatch (the step's launch; in churn
    # mode with the compaction) and drain (tallies and telemetry folds;
    # in churn mode the rounds' CT folds)
    spans: object = field(default_factory=dict)
    # replay(collect_telemetry=True): the [2, 20] u64 histogram of the
    # replayed flows
    telemetry: object = None

    @property
    def verdicts_per_sec(self) -> float:
        return self.total / self.seconds if self.seconds else 0.0

    @property
    def reruns(self) -> int:
        return self.rounds - self.batches


class _ChurnDriver:
    """The churn loop's state: the bucket index (host mirror of the
    device snapshot) and the resident snapshot, cached on the CTMap
    across calls.  The cache holds while the map's `mutations` counter
    and its key set are those it was stored with; code that changes a
    CTEntry's fields behind the map's back must
    `del ct_map._device_churn_cache`.  Within the loop every change
    goes through `drain`, which keeps the map, the index and the
    snapshot in step."""

    def __init__(self, ct_map, device: torch.device) -> None:
        from cilium_tpu_torch.convert import ct_snapshot_to

        self.ct_map = ct_map
        cached = getattr(ct_map, "_device_churn_cache", None)
        if (
            cached is not None
            and cached[2] == ct_map.mutations
            and cached[0].key_home.keys() == ct_map.entries.keys()
            and on_device(cached[1].buckets, device)
        ):
            self.ct_index, self.dev_snap = cached[:2]
        else:
            self.ct_index = CTBucketIndex(ct_map)
            self.dev_snap = ct_snapshot_to(
                self.ct_index.full_snapshot(), device
            )

    def drain(self, header_d: torch.Tensor, intents_d: torch.Tensor,
              stats: ReplayStats, valid: int, first_pass: bool) -> int:
        """One round's host side: read the header (the sync), fold the
        intents into the map, the index and the snapshot, and count
        the batch on its first pass.  Returns `remaining` (> 0: the
        caller reruns the batch)."""
        header = header_d.cpu().numpy().view(np.uint32)
        k, allowed, redirected, remaining = (int(v) for v in header)
        stats.rounds += 1
        stats.intents.append(k)
        if first_pass:
            stats.total += valid
            stats.allowed += allowed
            stats.denied += valid - allowed
            stats.redirected += redirected
            stats.batches += 1
        if k:
            t0 = time.perf_counter()
            packed = _fetch_intents(intents_d, k)
            created, deleted = apply_ct_writeback_host(
                self.ct_map,
                packed[0].astype(bool),
                packed[1].astype(bool),
                *(packed[j] for j in range(2, 10)),
                orig_daddr=packed[10],
                orig_dport=packed[11],
                now=self.ct_map.now(),
            )
            stats.ct_created += len(created)
            stats.ct_deleted += len(deleted)
            if created or deleted:
                idx, rows, new_stash = self.ct_index.apply(created, deleted)
                if len(idx) or new_stash is not None:
                    apply_bucket_delta(self.dev_snap, idx, rows, new_stash)
            stats.fold_seconds += time.perf_counter() - t0
        return remaining

    def run_batch(self, tables: DatapathTables, pool: torch.Tensor,
                  picks: torch.Tensor, valid: int, stats: ReplayStats,
                  pool_rows: Optional[torch.Tensor] = None) -> None:
        first_pass = True
        while True:
            t = dataclasses.replace(tables, ct=self.dev_snap)
            header, intents = churn_step(t, pool, picks, valid, pool_rows)
            remaining = self.drain(header, intents, stats, valid, first_pass)
            first_pass = False
            if remaining == 0:
                return

    def stash(self) -> None:
        self.ct_map._device_churn_cache = (
            self.ct_index, self.dev_snap, self.ct_map.mutations,
        )


def _pool_on(pool: Dict[str, np.ndarray], dev: torch.device) -> torch.Tensor:
    """The pool's [8, P] device pack, cached on the pool dict itself
    (helpers that take the pool should read FLOW_COLUMNS, not
    items()); the columns are treated as immutable once replayed."""
    from cilium_tpu_torch.convert import flow_pool_to

    packed = pool.get(_POOL_PACK_KEY)
    if packed is None or not on_device(packed, dev):
        packed = flow_pool_to(pool, dev)
        pool[_POOL_PACK_KEY] = packed
        pool.pop(_POOL_ROWS_KEY, None)
    return packed


def _pool_rows_on(pool: Dict[str, np.ndarray],
                  dev: torch.device) -> Optional[torch.Tensor]:
    """The card's row-major copy of the pool's pack (pool_rows_of),
    cached beside it; None off the card (the plain step gathers the
    pack's columns)."""
    packed = _pool_on(pool, dev)
    if packed.device.type != "cuda":
        return None
    rows = pool.get(_POOL_ROWS_KEY)
    if rows is None:
        rows = pool_rows_of(packed)
        pool[_POOL_ROWS_KEY] = rows
    return rows


def replay_pool(tables: DatapathTables, pool: Dict[str, np.ndarray],
                picks, batch_size: int = 1 << 21, *, ct_map,
                device=None) -> ReplayStats:
    """Sustained-churn replay over a flow pool (see the module
    docstring) with `tables` already on `device` (None = the card);
    their CT plane is replaced by the loop's own snapshot.

    `picks` is an explicit index array (uploaded as u32 per batch) or
    an int n: n uniform picks drawn on the device, the reference's
    numbers: batch i draws `randint(fold_in(PRNGKey(len(ct) ^ n), i),
    (batch_size,), 0, P, uint32)` under threefry2x32 (prng.py; PICK_DRAW
    on the card).  Each batch has `batch_size` rows; the last one's rows
    past `valid` are padding that is computed but never counted.
    `stats.seconds` starts after the per-call set-up (tables, pool
    pack, snapshot cache)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    require_on(tables.policy.id_table, dev, "the tables (convert.tables_to)")
    pool_dev = _pool_on(pool, dev)
    pool_rows = _pool_rows_on(pool, dev)
    churn = _ChurnDriver(ct_map, dev)
    stats = ReplayStats()

    def run(picks_dev, valid):
        churn.run_batch(tables, pool_dev, picks_dev, valid, stats, pool_rows)

    if isinstance(picks, (int, np.integer)):
        n = int(picks)
        base_key = prng_key(len(ct_map.entries) ^ n)
        n_pool = int(pool_dev.shape[1])
        t0 = time.perf_counter()
        for batch_idx, start in enumerate(range(0, n, batch_size)):
            picks_dev = randint_u32(fold_in(base_key, batch_idx), batch_size,
                                    n_pool, dev)
            run(picks_dev, min(batch_size, n - start))
    else:
        picks = np.asarray(picks).astype(np.uint32, copy=False)
        t0 = time.perf_counter()
        for start in range(0, len(picks), batch_size):
            chunk = picks[start : start + batch_size]
            valid = len(chunk)
            if valid < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros(batch_size - valid, np.uint32)]
                )
            run(u32_tensor(chunk, dev), valid)
    churn.stash()
    stats.seconds = time.perf_counter() - t0
    return stats


# -- record replay through the bare lattice --------------------------------------


def _ep_index_of(rec, ep_map: Optional[Dict[int, int]]) -> np.ndarray:
    """Record endpoint ids -> endpoint-axis indices (int32): through
    `ep_map`'s LUT, unknown ids going to 0; without it the id itself,
    so an id of 2^31 or more wraps negative."""
    ep_index = rec["ep_id"].astype(np.int64)  # no wrap before the LUT
    if ep_map is not None:
        lut = np.zeros(max(ep_map.keys(), default=0) + 1, dtype=np.int32)
        for ep_id, idx in ep_map.items():
            lut[ep_id] = idx
        in_range = ep_index < len(lut)
        ep_index = np.where(
            in_range, lut[np.minimum(ep_index, len(lut) - 1)], 0
        )
    return ep_index.astype(np.int32)


def _batch_slices(n: int, batch_size: int):
    for start in range(0, n, batch_size):
        yield start, min(start + batch_size, n)


def _padded(a: np.ndarray, start: int, end: int, size: int, fill=0):
    chunk = a[start:end]
    pad = size - (end - start)
    if pad:
        chunk = np.concatenate([chunk, np.full(pad, fill, dtype=a.dtype)])
    return chunk


def read_batches(buf: bytes, batch_size: int,
                 ep_map: Optional[Dict[int, int]] = None,
                 device=None) -> Iterator[Tuple[TupleBatch, int]]:
    """Decode flow records and yield (TupleBatch on `device`, valid):
    batches of `batch_size` rows, the last padded with zeros (fragment
    flag False) past its `valid` rows."""
    return read_batches_from_rec(
        decode_flow_records(buf), batch_size, ep_map, device=device
    )


def read_batches_from_rec(rec: Dict[str, np.ndarray], batch_size: int,
                          ep_map: Optional[Dict[int, int]] = None,
                          ep_index: Optional[np.ndarray] = None,
                          device=None) -> Iterator[Tuple[TupleBatch, int]]:
    """read_batches over already-decoded record columns; `ep_index`
    supplies an endpoint-axis translation already computed."""
    n = len(rec["ep_id"])
    if ep_index is None:
        ep_index = _ep_index_of(rec, ep_map)
    # each column cast once, not once per batch
    cols = dict(
        ep_index=ep_index,
        identity=rec["identity"],
        dport=rec["dport"].astype(np.int32),
        proto=rec["proto"].astype(np.int32),
        direction=rec["direction"].astype(np.int32),
        is_fragment=rec["is_fragment"].astype(bool),
    )
    for start, end in _batch_slices(n, batch_size):
        yield (
            TupleBatch.from_numpy(
                **{k: _padded(a, start, end, batch_size) for k, a in
                   cols.items()},
                device=device,
            ),
            end - start,
        )


class _CounterAccumulator:
    """u64 host totals of the per-batch u32 counters."""

    l4: Optional[np.ndarray] = None
    l3: Optional[np.ndarray] = None

    def add(self, l4_counts: torch.Tensor, l3_counts: torch.Tensor) -> None:
        l4 = l4_counts.cpu().numpy().view(np.uint32).astype(np.uint64)
        l3 = l3_counts.cpu().numpy().view(np.uint32).astype(np.uint64)
        if self.l4 is None:
            self.l4, self.l3 = l4, l3
        else:
            self.l4 += l4
            self.l3 += l3


def _tally(verdicts, valid: int, stats: ReplayStats) -> None:
    """Count a batch's first `valid` rows (padding never counts)."""
    allowed = int(verdicts.allowed[:valid].sum())
    stats.total += int(valid)
    stats.allowed += allowed
    stats.denied += int(valid) - allowed
    stats.redirected += int((verdicts.proxy_port[:valid] > 0).sum())


def _drain(item, stats: ReplayStats,
           acc: Optional[_CounterAccumulator]) -> None:
    """A finished batch: tally its rows; add its counters, padding rows'
    hits included, as the reference does."""
    (verdicts, l4_counts, l3_counts), valid = item
    _tally(verdicts, valid, stats)
    if acc is not None:
        acc.add(l4_counts, l3_counts)


def replay_lattice(tables, buf: bytes, batch_size: int = 1 << 20,
                   accumulate_counters: bool = True,
                   ep_map: Optional[Dict[int, int]] = None, manager=None,
                   *, device=None) -> tuple:
    """Replay flow records through the bare policy lattice on `device`
    (None = the card), where the PolicyTables must already lie
    (convert.policy_tables_to, or an EndpointManager's
    `published_device()` epoch).  Returns (stats, l4, l3): the u64 hit
    totals [E, 2, Kg] and [E, 2, N] over every batch, or None, None
    without `accumulate_counters` (which then runs the lattice without
    its counters).  With `manager` the tables must still be current
    (EndpointManager.check_tables_current raises otherwise).
    `stats.seconds` covers decode, upload, the lattice and the drains;
    `stats.spans` splits it."""
    if manager is not None:
        manager.check_tables_current(tables)
    dev = resolve_device(device)
    require_on(tables.l3_allow_bits, dev,
               "the policy tables (convert.policy_tables_to)")
    stats = ReplayStats()
    acc = _CounterAccumulator() if accumulate_counters else None

    def step(batch):
        if acc is None:
            return evaluate_batch(tables, batch, dev), None, None
        return evaluate_batch_with_counters(tables, batch, dev)

    spans = stats.spans = dict.fromkeys(
        ("decode", "pack", "dispatch", "drain"), 0.0)

    def timed(span, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        spans[span] += time.perf_counter() - t
        return out

    pending = []  # pipelined dispatch, at most 4 batches in flight
    t0 = time.perf_counter()
    batches = timed("decode", read_batches, buf, batch_size, ep_map, dev)
    while (item := timed("pack", next, batches, None)) is not None:
        batch, valid = item
        pending.append((timed("dispatch", guarded_dispatch, step, batch),
                        valid))
        stats.batches += 1
        if len(pending) >= 4:
            timed("drain", _drain, pending.pop(0), stats, acc)
    while pending:
        timed("drain", _drain, pending.pop(0), stats, acc)
    stats.seconds = time.perf_counter() - t0
    if acc is None:
        return stats, None, None
    return stats, acc.l4, acc.l3


# -- record replay through the fused datapath ------------------------------------


def read_flow_batches(buf: bytes, batch_size: int,
                      ep_map: Optional[Dict[int, int]] = None,
                      device=None) -> Iterator[Tuple[FlowBatch, int]]:
    """Decode flow records and yield (FlowBatch on `device`, valid):
    batches of `batch_size` raw 5-tuples (identity is derived on the
    device, by the ipcache stage of the fused step), the last padded
    with zero rows past its `valid` ones.  Each batch moves as one
    [8, B] u32 pack (FLOW_COLUMNS order), the words the reference's
    int32 casts give; the columns are cast once, not per batch."""
    dev = resolve_device(device)
    rec = decode_flow_records(buf)
    n = len(rec["ep_id"])
    cols = dict(
        ep_index=_ep_index_of(rec, ep_map),
        saddr=rec["saddr"],
        daddr=rec["daddr"],
        sport=rec["sport"].astype(np.int32),
        dport=rec["dport"].astype(np.int32),
        proto=rec["proto"].astype(np.int32),
        direction=rec["direction"].astype(np.int32),
        is_fragment=rec["is_fragment"].astype(bool),
    )
    words = np.empty((len(FLOW_COLUMNS), n), dtype=np.uint32)
    for j, name in enumerate(FLOW_COLUMNS):
        words[j] = cols[name].astype(np.uint32)
    for start, end in _batch_slices(n, batch_size):
        if end - start == batch_size:
            chunk = words[:, start:end]
        else:
            chunk = np.zeros((len(FLOW_COLUMNS), batch_size), np.uint32)
            chunk[:, : end - start] = words[:, start:end]
        yield flow_batch_from_packed(u32_tensor(chunk, dev)), end - start


def _drain_fused(item, stats: ReplayStats) -> None:
    """A finished fused batch: its counters live in the carried buffer,
    so only the tallies of its first `valid` rows are taken."""
    verdicts, valid = item
    _tally(verdicts, valid, stats)


def replay(tables: DatapathTables, buf: bytes, batch_size: int = 1 << 20,
           accumulate_counters: bool = True,
           ep_map: Optional[Dict[int, int]] = None, manager=None,
           ct_map=None, collect_telemetry: bool = False, flow_store=None,
           chip: int = 0, *, device=None) -> tuple:
    """Replay flow records through the fused datapath step on `device`
    (None = the card), where the DatapathTables must already lie
    (convert.tables_to); see the module docstring.  Returns (stats, l4,
    l3): the u64 hit totals [E, 2, Kg] and [E, 2, N] over every batch,
    padding rows' hits included as in the reference, or (stats, None,
    None) without `accumulate_counters`.  `collect_telemetry` and
    `flow_store` are not offered in churn mode (`ct_map`), as in the
    reference.  `stats.spans`
    is a SpanStats; `stats.seconds` covers decode, upload, the steps and
    the drains."""
    from cilium_tpu_torch.metrics import registry as metrics
    from cilium_tpu_torch.spanstat import SpanStats
    from cilium_tpu_torch.telemetry import (
        fold_telemetry,
        telemetry_from_outputs,
    )

    if manager is not None:
        # the stale-table guard at the layer that reads the stacked
        # per-endpoint rows: tables two or more publishes old have had
        # those rows rewritten in place and would answer wrongly
        manager.check_tables_current(tables.policy)
    if flow_store is not None and ct_map is not None:
        raise ValueError(
            "flow capture is not offered in churn mode (the churn "
            "programs fuse intent compaction instead of returning "
            "per-tuple verdict columns)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    require_on(tables.policy.id_table, dev, "the tables (convert.tables_to)")
    stats = ReplayStats()
    spans = stats.spans = SpanStats()
    fold_every = max(1, _COUNTER_FOLD_MAX_INCR // max(batch_size, 1))
    acc = make_counter_buffers(tables.policy) if accumulate_counters else None
    acc_total = None
    since_fold = 0
    telem_dev = telem_total = None
    if collect_telemetry and ct_map is None:
        telem_total = np.zeros((2, TELEM_COLS), np.uint64)
        if accumulate_counters:
            telem_dev = make_telemetry_buffers(dev)

    def host_u64(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().view(np.uint32).astype(np.uint64)

    def fold_counters() -> None:
        # the telemetry buffer wraps at the same u32 horizon: same cadence
        nonlocal acc_total, since_fold, telem_total
        host = host_u64(acc)
        acc_total = host if acc_total is None else acc_total + host
        acc.zero_()
        if telem_dev is not None:
            telem_total = telem_total + host_u64(telem_dev)
            telem_dev.zero_()
        since_fold = 0

    def counted() -> None:
        nonlocal since_fold
        since_fold += 1
        if since_fold >= fold_every:
            fold_counters()

    capture = None
    if flow_store is not None:
        capture = _FlowCapture(flow_store, tables, ep_map, chip)

    def drain_item(item) -> None:
        nonlocal telem_total
        out, valid, fold_direction, flows, sec_is_idx = item
        spans.span("drain").start()
        _drain_fused((out, valid), stats)
        if fold_direction is not None:
            telem_total = telem_total + telemetry_from_outputs(
                out, fold_direction, valid=valid)
        if capture is not None:
            capture(out, flows, valid, sec_is_idx)
        spans.span("drain").end()

    churn = picks = None
    if ct_map is not None:
        churn = _ChurnDriver(ct_map, dev)
        picks = torch.arange(batch_size, dtype=torch.int32, device=dev)

    pending = []  # pipelined dispatch, at most 4 batches in flight
    t0 = time.perf_counter()
    # a generator: the decode runs in the first host_pack span
    batches = read_flow_batches(buf, batch_size, ep_map, dev)
    while True:
        spans.span("host_pack").start()
        item = next(batches, None)
        spans.span("host_pack").end(success=item is not None)
        if item is None:
            break
        flows, valid = item
        iter_t0 = time.perf_counter()
        if churn is not None:
            # the counter-carrying step on the first pass, the plain
            # step on convergence reruns; the compaction reads the pack
            pack = pack_flow_batch(flows)
            first_pass = True
            while True:
                t = dataclasses.replace(tables, ct=churn.dev_snap)
                spans.span("dispatch").start()
                if first_pass and acc is not None:
                    out, _ = guarded_dispatch(datapath_step_accum, t,
                                              flows, acc, donated=True)
                    header, intents = churn_compact(out, pack, picks, valid)
                    counted()
                else:
                    header, intents = guarded_dispatch(
                        churn_step, t, pack, picks, valid)
                spans.span("dispatch").end()
                spans.span("drain").start()
                remaining = churn.drain(header, intents, stats, valid,
                                        first_pass)
                spans.span("drain").end()
                first_pass = False
                if remaining == 0:
                    break
            metrics.batch_duration.observe(time.perf_counter() - iter_t0)
            continue
        fold_direction = None
        # the accumulate forms write the raw lattice index as sec_id,
        # which the capture translates through id_table (idx form only)
        sec_is_idx = acc is not None
        spans.span("dispatch").start()
        if acc is not None:
            if telem_dev is not None and valid == batch_size:
                out, _, _ = guarded_dispatch(
                    datapath_step_accum_telem, tables, flows, acc, telem_dev,
                    donated=True)
            else:
                out, _ = guarded_dispatch(datapath_step_accum, tables,
                                          flows, acc, donated=True)
                if telem_total is not None:
                    # a partial tail: the device sums would count its
                    # padding rows, so it folds on the host
                    fold_direction = flows.direction
            counted()
        else:
            out = guarded_dispatch(datapath_step, tables, flows)
            if telem_total is not None:
                fold_direction = flows.direction
        spans.span("dispatch").end()
        pending.append((out, valid, fold_direction,
                        flows if capture is not None else None, sec_is_idx))
        stats.batches += 1
        if len(pending) >= 4:
            drain_item(pending.pop(0))
        metrics.batch_duration.observe(time.perf_counter() - iter_t0)
    while pending:
        drain_item(pending.pop(0))
    if churn is not None:
        churn.stash()
    if telem_total is not None:
        if telem_dev is not None:
            telem_total = telem_total + host_u64(telem_dev)
            telem_dev = None  # the closing counter fold must not add it again
        stats.telemetry = telem_total
        fold_telemetry(telem_total)
    stats.seconds = time.perf_counter() - t0
    if acc is None:
        return stats, None, None
    fold_counters()
    kg = int(tables.policy.l4_meta.shape[2])
    return stats, acc_total[:, :, :kg], acc_total[:, :, kg:]


class _FlowCapture:
    """The replay's Hubble feed (the reference's `_capture_replay_flows`):
    one drained batch's DatapathVerdicts folded into the flow ring.  The
    derived peer identity (sec_id: the source of an ingress flow, the
    destination of an egress one) rides its side of the pair, the other
    side is 0 (replay knows no endpoint identities); record endpoint ids
    go back through `ep_map`'s inverse."""

    def __init__(self, store, tables: DatapathTables,
                 ep_map: Optional[Dict[int, int]], chip: int) -> None:
        from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

        self.store = store
        self.chip = chip
        self.id_table = tables.policy.id_table.cpu().numpy().view(np.uint32)
        # sec_id is an index only from the accumulate forms over an
        # idx-form ipcache (the generic form emits the identity)
        self.idx_form = bool(isinstance(tables.ipcache, IPCacheDevice)
                             and tables.ipcache.values_are_idx)
        self.ep_rev_lut = None
        if ep_map:
            self.ep_rev_lut = np.zeros(max(ep_map.values()) + 1, np.int64)
            for ep_id, idx in ep_map.items():
                self.ep_rev_lut[idx] = ep_id

    def __call__(self, out: DatapathVerdicts, flows: FlowBatch, valid: int,
                 sec_is_idx: bool) -> None:
        from cilium_tpu_torch import option
        from cilium_tpu_torch.flow import allow_sample_for_level, capture_batch

        def host(t: torch.Tensor) -> np.ndarray:
            return t[:valid].cpu().numpy()

        sec = host(out.sec_id).view(np.uint32).astype(np.int64)
        if sec_is_idx and self.idx_form:
            sec = self.id_table[np.minimum(sec, len(self.id_table) - 1)]
            sec = sec.astype(np.int64)
        dirs = host(flows.direction)
        zeros = np.zeros(valid, np.int64)
        ep_ids = host(flows.ep_index)
        if self.ep_rev_lut is not None:
            ep_ids = self.ep_rev_lut[np.minimum(ep_ids,
                                                len(self.ep_rev_lut) - 1)]
        capture_batch(
            self.store,
            ep_ids=ep_ids,
            src_identities=np.where(dirs == 0, sec, zeros),
            dst_identities=np.where(dirs == 0, zeros, sec),
            dports=host(out.final_dport),
            protos=host(flows.proto),
            directions=dirs,
            allowed=host(out.allowed),
            match_kind=host(out.match_kind),
            proxy_port=host(out.proxy_port),
            pre_dropped=host(out.pre_dropped),
            ct_result=host(out.ct_result),
            ct_delete=host(out.ct_delete),
            lb_slave=host(out.lb_slave),
            ipcache_miss=host(out.ipcache_miss),
            chip=self.chip,
            allow_sample=allow_sample_for_level(
                option.Config.opts.level(option.MONITOR_AGGREGATION)),
        )


def slot_keys_from_tables(tables) -> Dict[int, Tuple[int, int]]:
    """Global L4 slot -> (dport, proto), read back from the compiled
    port_slot table (numpy or a tensor): the inverse of the slot
    assignment in compiler.tables.lower_map_state."""
    from cilium_tpu_torch.compiler.tables import NO_SLOT

    port_slot = tables.port_slot
    if isinstance(port_slot, torch.Tensor):
        port_slot = port_slot.cpu().numpy()
    port_slot = np.asarray(port_slot)
    protos, dports = np.nonzero(port_slot != int(NO_SLOT))
    slots = port_slot[protos, dports]
    return {
        int(j): (int(dport), int(proto))
        for j, dport, proto in zip(slots, dports, protos)
    }


def _first_l4_entry(state, dport: int, proto: int, direction: int):
    """The first entry of `state`, in its items() order, on (dport,
    proto, direction): the first by packed key for MapStateArrays, found
    with one array compare instead of a walk over every entry."""
    if isinstance(state, MapStateArrays):
        want = (dport << 16) | (proto << 8) | direction
        pos = np.flatnonzero(
            (state.keys_packed & np.uint64(0xFFFFFFFF)) == np.uint64(want))
        return _EntryView(state, int(pos[0])) if len(pos) else None
    for key, cand in state.items():
        if (key.dest_port == dport and key.nexthdr == proto
                and key.traffic_direction == direction):
            return cand
    return None


def sync_counters_to_endpoints(
    l4_counts: Optional[np.ndarray],
    l3_counts: Optional[np.ndarray],
    manager,
    tables=None,
    index: Optional[Dict[int, int]] = None,
) -> int:
    """Fold accumulated counters back into the endpoints' realized map
    states (the packets field of policy_entry the agent reads back from
    the datapath, pkg/maps/policymap PolicyEntry).

    Pass the `tables`/`index` the counters were computed against (host
    arrays or a device epoch); a republish between the replay and the
    sync would otherwise shift the identity/slot indexing and
    misattribute counts.  Falls back to the currently published version
    when not given.  Returns entries updated."""
    if tables is None or index is None:
        _, tables, index = manager.published()
    if tables is None:
        return 0
    # no staleness guard: only id_table (fresh per rebuild) and
    # port_slot (write-once cells) are read, both valid in arbitrarily
    # old snapshots
    updated = 0
    rev_index = {v: k for k, v in index.items()}
    id_table = tables.id_table
    if isinstance(id_table, torch.Tensor):
        id_table = id_table.cpu().numpy()
    id_table = np.asarray(id_table).view(np.uint32)
    if l3_counts is not None:
        # L3 counters are indexed by identity index.  The realized
        # state is re-read under the endpoint lock per update: a
        # concurrent sync_policy_map publishes a NEW state, and an
        # increment through a pre-sync view would land in the old one.
        for e, d, idx in zip(*np.nonzero(l3_counts)):
            ep = manager.lookup(rev_index.get(int(e), -1))
            if ep is None:
                continue
            key = PolicyKey(int(id_table[idx]), 0, 0, int(d))
            with ep.lock:
                entry = ep.realized_map_state.get(key)
                if entry is not None:
                    entry.packets += int(l3_counts[e, d, idx])
                    updated += 1
    if l4_counts is not None:
        # L4 counters are indexed by global slot; a slot hit covers
        # every (identity, dport, proto) entry of that filter, so the
        # slot's wildcard entry, or else its first entry, takes the
        # count (totals preserved, as in the reference)
        slot_keys = slot_keys_from_tables(tables)
        for e, d, j in zip(*np.nonzero(l4_counts)):
            ep = manager.lookup(rev_index.get(int(e), -1))
            if ep is None or int(j) not in slot_keys:
                continue
            dport, proto = slot_keys[int(j)]
            count = int(l4_counts[e, d, j])
            wild = PolicyKey(0, dport, proto, int(d))
            with ep.lock:
                state = ep.realized_map_state
                entry = state.get(wild)
                if entry is None:
                    entry = _first_l4_entry(state, dport, proto, int(d))
                if entry is not None:
                    entry.packets += count
                    updated += 1
    return updated
