"""Verdict batches → FlowRecords (the perf-ring→Hubble fold).

``capture_batch`` folds one evaluated batch's per-tuple columns into
the FlowStore: EVERY drop becomes a record (a dropped flow is the
thing an operator greps for) and allows are head-sampled under the
same knob the monitor fold uses (MonitorAggregationLevel — the
aggregate counters stay exact in the telemetry plane; only the
per-record fan-out is sampled).

Drop classification goes through ``engine.verdict.telemetry_masks``
— the ONE definition set the device [2, TELEM_COLS] histogram and
the host telemetry fold already share — so a record's ``drop_reason``
is by construction the TELEM_DROP_* column that counted it in the
device histogram: the FlowStore's per-reason counts and
``cilium_drop_count_total`` can never disagree.  Paths without the
full DatapathVerdicts columns (the lattice-only audit path of
Daemon.process_flows) pass zeros for the missing stages, which is
exactly what those stages contributed to their histogram.

The port's copy of the JAX package's module: the capture is host numpy,
and the masks come from the port's telemetry_masks on CPU tensors that
share the columns' memory.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import torch

from cilium_tpu_torch.engine.verdict import (
    TELEM_DROP_FRAG,
    TELEM_DROP_POLICY,
    TELEM_DROP_PREFILTER,
    telemetry_masks,
)
from cilium_tpu_torch.flow.store import (
    VERDICT_DROPPED,
    VERDICT_FORWARDED,
    FlowRecord,
    FlowStore,
)
from cilium_tpu_torch.option import (
    MONITOR_AGG_NONE,
)
from cilium_tpu_torch.telemetry import DROP_COLUMN_REASONS

# drop column → canonical reason, in classification order (the masks
# are disjoint and partition the denials — telemetry_consistent)
_DROP_COLUMNS = (
    TELEM_DROP_PREFILTER,
    TELEM_DROP_POLICY,
    TELEM_DROP_FRAG,
)

# MonitorAggregationLevel → per-batch allow-record budget: `none`
# captures every allow (per-packet visibility, the level that also
# enables per-flow TraceNotify); each higher level cuts the head
# sample — drops are NEVER sampled
_ALLOW_SAMPLE_BY_LEVEL = {0: None, 1: 1024, 2: 256, 3: 64}


def allow_sample_for_level(level: int) -> Optional[int]:
    """Allowed-flow head-sample budget for a MonitorAggregationLevel
    (None = capture every allow)."""
    if level == MONITOR_AGG_NONE:
        return None
    return _ALLOW_SAMPLE_BY_LEVEL.get(
        int(level), _ALLOW_SAMPLE_BY_LEVEL[3]
    )


def chip_of_rows(n_rows: int, n_chips: int) -> np.ndarray:
    """Chip ordinal per batch row under even batch sharding (the
    mesh evaluator splits the batch axis into n_chips contiguous
    shards) — the tag flow records carry on a mesh."""
    if n_chips <= 1:
        return np.zeros(n_rows, np.int32)
    shard = n_rows // n_chips
    return np.minimum(
        np.arange(n_rows, dtype=np.int32) // max(shard, 1),
        n_chips - 1,
    )


def capture_batch(
    store: FlowStore,
    *,
    ep_ids,
    src_identities,
    dst_identities,
    dports,
    protos,
    directions,
    allowed,
    match_kind,
    proxy_port=None,
    pre_dropped=None,
    ct_result=None,
    ct_delete=None,
    lb_slave=None,
    ipcache_miss=None,
    chip=0,
    allow_sample: Optional[int] = None,
    now: Optional[float] = None,
    metrics_registry=None,
    trace_id: str = "",
    cache_hit=None,
    tenant="",
    diff_status=None,
) -> int:
    """Fold one batch's per-tuple columns into the store.  All
    columns are host arrays of one length (the batch's VALID prefix —
    callers slice padding off first).  ``chip`` is a scalar ordinal
    or a per-tuple array; ``allow_sample`` caps allowed-flow records
    for this batch (None = all; 0 = drops only).
    ``metrics_registry`` additionally feeds
    flow_records_captured_total / flow_store_evicted (None = no
    metrics — tools and benches that must not touch the process
    registry).  ``trace_id`` stamps the span-plane join key on every
    record of a traced batch (GET /flows?trace-id=...).
    ``cache_hit`` is the per-tuple verdict-cache hit column of a
    memoized dispatch (None = uncached path, records carry False) —
    `cilium-tpu observe --cache-hit` filters on it.  ``tenant`` is
    the submitting tenant/namespace — a scalar string (the one-shot
    REST path) or a per-tuple object array (the serving plane's
    coalesced multi-tenant batches); `observe --tenant` filters on
    it.  ``diff_status`` is the per-tuple shadow verdict-diff
    transition code column (shadow.py TRANS_* u8; None =
    unsampled batch, records carry "") — `observe --diff-status`
    joins flow records to the armed diff window.  Returns the
    number of records captured."""
    allowed = np.asarray(allowed).astype(bool)
    kind = np.asarray(match_kind)
    b = len(allowed)
    zeros = np.zeros(b, np.int32)

    def _col(a):
        return zeros if a is None else np.asarray(a)

    proxy = _col(proxy_port)
    ct_res = _col(ct_result)
    masks = [
        m.numpy()
        for m in telemetry_masks(*(
            torch.from_numpy(np.ascontiguousarray(a)) for a in (
                _col(pre_dropped), ct_res, kind, allowed, _col(ct_delete),
                proxy, _col(lb_slave), _col(ipcache_miss),
            )
        ))
    ]
    # per-tuple reason attribution straight from the histogram's own
    # drop columns (disjoint; partition the denials)
    reason = np.full(b, "", dtype=object)
    for col in _DROP_COLUMNS:
        reason[masks[col]] = DROP_COLUMN_REASONS[col]

    drop_idx = np.nonzero(~allowed)[0]
    allow_idx = np.nonzero(allowed)[0]
    if allow_sample is not None:
        allow_idx = allow_idx[: max(0, int(allow_sample))]
    # a batch with more drops than the ring holds: building records
    # the bounded deque would evict before anyone could read them
    # only amplifies the drop storm — keep the NEWEST capacity's
    # worth and charge the rest as evictions (visible loss, same
    # counter ring overflow uses).  Metrics below still count every
    # drop, so the counter plane stays exact.
    n_drops = len(drop_idx)
    truncated = max(0, n_drops - store.capacity)
    if truncated:
        drop_idx = drop_idx[-store.capacity:]
        allow_idx = allow_idx[:0]
    idx = np.concatenate([drop_idx, allow_idx])

    ep_ids = np.asarray(ep_ids)
    src_identities = np.asarray(src_identities)
    dst_identities = np.asarray(dst_identities)
    dports = np.asarray(dports)
    protos = np.asarray(protos)
    directions = np.asarray(directions)
    chips = (
        np.asarray(chip)
        if not np.isscalar(chip)
        else np.full(b, int(chip), np.int32)
    )
    hits = (
        np.zeros(b, bool)
        if cache_hit is None
        else np.asarray(cache_hit).astype(bool)
    )
    tenants = (
        np.asarray(tenant, dtype=object)
        if not isinstance(tenant, str)
        else np.full(b, tenant, dtype=object)
    )
    if diff_status is None:
        diff_names = None
    else:
        from cilium_tpu_torch.shadow import TRANS_NAMES

        codes = np.asarray(diff_status)
        diff_names = np.full(b, "", dtype=object)
        for code, name in TRANS_NAMES.items():
            if name:
                diff_names[codes == code] = name
    ts = time.time() if now is None else now
    records = [
        FlowRecord(
            ts=ts,
            chip=int(chips[i]),
            ep_id=int(ep_ids[i]),
            src_identity=int(src_identities[i]),
            dst_identity=int(dst_identities[i]),
            dport=int(dports[i]),
            proto=int(protos[i]),
            direction=int(directions[i]),
            verdict=(
                VERDICT_FORWARDED if allowed[i] else VERDICT_DROPPED
            ),
            match_kind=int(kind[i]),
            drop_reason=str(reason[i]),
            proxy_port=int(proxy[i]),
            ct_state=int(ct_res[i]),
            trace_id=trace_id,
            cache_hit=bool(hits[i]),
            tenant=str(tenants[i]),
            diff_status=(
                "" if diff_names is None else str(diff_names[i])
            ),
        )
        for i in idx
    ]
    n = store.extend(records)
    store.charge_evicted(truncated)
    if metrics_registry is not None:
        if n_drops:
            metrics_registry.flow_records_captured_total.inc(
                VERDICT_DROPPED, value=n_drops
            )
        if len(allow_idx):
            metrics_registry.flow_records_captured_total.inc(
                VERDICT_FORWARDED, value=len(allow_idx)
            )
        metrics_registry.flow_store_evicted.set(value=store.evicted)
    return n
