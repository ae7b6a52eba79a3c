"""The flow-record ring: Hubble's container/ring over this datapath.

Behavioral analog of hubble/pkg/container/ring + the observe filters
(hubble/pkg/filters): a bounded ring of FlowRecords with a monotonic
sequence number, guarded by one lock; follow-mode readers block on a
condition variable exactly like MonitorBus.wait_for_events (no spin —
the writer notifies).  Eviction is the ring's contract: the OLDEST
record falls off when full, and ``evicted`` counts what a late reader
can no longer see (the analog of hubble's lost-events accounting for
readers that fell behind the ring).  The port's copy of the JAX
package's module.
"""

from __future__ import annotations

import threading
from collections import Counter as _Counter
from collections import deque
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional

DIRECTION_INGRESS = 0
DIRECTION_EGRESS = 1

VERDICT_FORWARDED = "FORWARDED"
VERDICT_DROPPED = "DROPPED"

_DIRECTION_NAMES = {
    DIRECTION_INGRESS: "ingress",
    DIRECTION_EGRESS: "egress",
}
_PROTO_ALIASES = {"icmp": 1, "tcp": 6, "udp": 17, "icmpv6": 58}


@dataclass
class FlowRecord:
    """One captured flow (the flow.Flow proto of Hubble, reduced to
    this datapath's tuple space).  ``src_identity``/``dst_identity``
    orient the tuple as a src→dst pair regardless of direction: the
    local endpoint is the destination of an ingress flow and the
    source of an egress one."""

    ts: float  # capture wall-clock (time.time())
    chip: int  # device ordinal that evaluated the flow
    ep_id: int  # local endpoint id
    src_identity: int
    dst_identity: int
    dport: int
    proto: int
    direction: int  # 0=ingress 1=egress
    verdict: str  # FORWARDED | DROPPED
    match_kind: int  # MATCH_* lattice code
    drop_reason: str = ""  # canonical reason name ("" when forwarded)
    proxy_port: int = 0
    ct_state: int = 0  # CT_* result (0 = stateless/audit path)
    seq: int = 0  # store-assigned monotonic sequence
    trace_id: str = ""  # span-plane join key ("" when untraced)
    # verdict served from the device verdict cache (engine/memo.py);
    # False on uncached paths and degraded host-fold batches
    cache_hit: bool = False
    # submitting tenant/namespace (the serving plane's fairness
    # unit; "" on paths without tenant attribution) — fairness
    # decisions are debuggable end to end: a shed flow's Overload
    # record names WHO was shed
    tenant: str = ""
    # shadow verdict-diff status (shadow.py): "" when the
    # flow was not sampled into an armed shadow window or its two
    # worlds agree; else the transition the shadow world would apply
    # ("allow_to_deny" | "deny_to_allow" | "changed")
    diff_status: str = ""

    def to_dict(self) -> dict:
        d = asdict(self)
        d["direction"] = _DIRECTION_NAMES.get(
            self.direction, str(self.direction)
        )
        return d


def parse_direction(value) -> int:
    """'ingress'/'egress'/0/1 → direction code."""
    if isinstance(value, int):
        if value in (0, 1):
            return value
        raise ValueError(f"direction must be 0 or 1, got {value!r}")
    low = str(value).strip().lower()
    if low in ("ingress", "0"):
        return DIRECTION_INGRESS
    if low in ("egress", "1"):
        return DIRECTION_EGRESS
    raise ValueError(
        f"direction must be ingress or egress, got {value!r}"
    )


def parse_proto(value) -> int:
    """'tcp'/'udp'/number → IP protocol number."""
    low = str(value).strip().lower()
    if low in _PROTO_ALIASES:
        return _PROTO_ALIASES[low]
    try:
        return int(low)
    except ValueError:
        raise ValueError(f"unknown protocol {value!r}")


def _parse_since(value) -> float:
    """`since` filter: absolute unix seconds, or a relative
    '<n>s'/'<n>m'/'<n>h' window back from now."""
    import time as _time

    s = str(value).strip().lower()
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0}.get(s[-1:] or "")
    if mult is not None:
        try:
            return _time.time() - float(s[:-1]) * mult
        except ValueError:
            raise ValueError(f"bad since window {value!r}")
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"bad since value {value!r}")


@dataclass
class FlowFilter:
    """Hubble-like observe filters over FlowRecords.  Every field is
    conjunctive; None = wildcard.  ``identity`` matches EITHER side
    of the pair (hubble's --identity semantics)."""

    verdict: Optional[str] = None
    drop_reason: Optional[str] = None
    identity: Optional[int] = None
    ep: Optional[int] = None
    port: Optional[int] = None
    proto: Optional[int] = None
    direction: Optional[int] = None
    since: Optional[float] = None
    chip: Optional[int] = None
    trace_id: Optional[str] = None
    cache_hit: Optional[bool] = None
    tenant: Optional[str] = None
    # "any" matches every re-verdicted flow; a specific transition
    # name matches exactly
    diff_status: Optional[str] = None

    # GET /flows query-param name → field + parser
    PARAM_FIELDS = {
        "verdict": ("verdict", lambda v: str(v).upper()),
        "drop-reason": ("drop_reason", str),
        "identity": ("identity", int),
        "ep": ("ep", int),
        "port": ("port", int),
        "proto": ("proto", parse_proto),
        "direction": ("direction", parse_direction),
        "since": ("since", _parse_since),
        "chip": ("chip", int),
        "trace-id": ("trace_id", lambda v: str(v).lower()),
        "cache-hit": (
            "cache_hit",
            lambda v: str(v).strip().lower()
            in ("1", "true", "yes", "on"),
        ),
        "tenant": ("tenant", str),
        "diff-status": (
            "diff_status",
            lambda v: str(v).strip().lower().replace("-", "_"),
        ),
    }

    @classmethod
    def from_params(cls, params: Dict[str, str]) -> "FlowFilter":
        """Build from (string-valued) query params; unknown keys are
        the caller's concern (the route strips its own pagination
        params first).  Raises ValueError on malformed values."""
        kwargs = {}
        for key, raw in params.items():
            spec = cls.PARAM_FIELDS.get(key)
            if spec is None:
                raise ValueError(f"unknown flow filter {key!r}")
            fld, parse = spec
            kwargs[fld] = parse(raw)
        flt = cls(**kwargs)
        if flt.verdict is not None and flt.verdict not in (
            VERDICT_FORWARDED, VERDICT_DROPPED,
        ):
            raise ValueError(
                f"verdict must be {VERDICT_FORWARDED} or "
                f"{VERDICT_DROPPED}, got {flt.verdict!r}"
            )
        return flt

    def matches(self, r: FlowRecord) -> bool:
        if self.verdict is not None and r.verdict != self.verdict:
            return False
        if (
            self.drop_reason is not None
            and r.drop_reason != self.drop_reason
        ):
            return False
        if self.identity is not None and self.identity not in (
            r.src_identity, r.dst_identity,
        ):
            return False
        if self.ep is not None and r.ep_id != self.ep:
            return False
        if self.port is not None and r.dport != self.port:
            return False
        if self.proto is not None and r.proto != self.proto:
            return False
        if self.direction is not None and r.direction != self.direction:
            return False
        if self.since is not None and r.ts < self.since:
            return False
        if self.chip is not None and r.chip != self.chip:
            return False
        if self.trace_id is not None and r.trace_id != self.trace_id:
            return False
        if (
            self.cache_hit is not None
            and bool(r.cache_hit) != self.cache_hit
        ):
            return False
        if self.tenant is not None and r.tenant != self.tenant:
            return False
        if self.diff_status is not None:
            if self.diff_status == "any":
                if not r.diff_status:
                    return False
            elif r.diff_status != self.diff_status:
                return False
        return True


class FlowStore:
    """Bounded ring of FlowRecords (hubble's ring buffer): appends
    assign a monotonic ``seq``, overflow evicts the OLDEST record,
    and follow-mode readers block on the condition variable until a
    record newer than their cursor lands."""

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._ring: deque = deque(maxlen=capacity)
        self._next_seq = 1
        self.captured_total = 0
        self.evicted = 0

    def extend(self, records: Iterable[FlowRecord]) -> int:
        """Append records (stamping seq), waking follow-mode readers
        once per batch.  Returns the number appended."""
        n = 0
        with self._cond:
            for r in records:
                r.seq = self._next_seq
                self._next_seq += 1
                if len(self._ring) == self.capacity:
                    self.evicted += 1
                self._ring.append(r)
                n += 1
            self.captured_total += n
            if n:
                self._cond.notify_all()
        return n

    def append(self, record: FlowRecord) -> None:
        self.extend((record,))

    def charge_evicted(self, n: int) -> None:
        """Account records a producer declined to build because this
        bounded ring could never retain them (capture_batch's
        drop-storm truncation): they are losses a reader should see,
        charged to the same counter as ring eviction."""
        if n > 0:
            with self._lock:
                self.evicted += n

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[FlowRecord]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def query(
        self,
        flt: Optional[FlowFilter] = None,
        last: Optional[int] = None,
        after_seq: Optional[int] = None,
    ) -> List[FlowRecord]:
        """Filtered read in ring (oldest→newest) order.  ``last``
        keeps only the newest N matches (hubble's --last);
        ``after_seq`` restricts to records newer than a follow
        cursor."""
        import itertools

        with self._lock:
            ring = self._ring
            if after_seq is not None and ring:
                # seqs are contiguous in the ring, so the cursor's
                # position is arithmetic — a follow wakeup copies
                # only the NEW records
                start = after_seq - ring[0].seq + 1
                if start >= len(ring):
                    src = []
                elif start > 0:
                    src = list(itertools.islice(ring, start, None))
                else:
                    src = list(ring)
            else:
                src = list(ring)
        # the Python-level filter pass runs OUTSIDE the lock: a
        # one-shot full-ring query must not stall the capture hot
        # path for the duration of per-record matches() calls (the
        # C-speed list copy above is the only time the lock is held)
        out = [r for r in src if flt is None or flt.matches(r)]
        if last is not None and last >= 0:
            out = out[-last:] if last else []
        return out

    def wait_for_flows(
        self,
        after_seq: int,
        timeout: float,
        flt: Optional[FlowFilter] = None,
    ) -> List[FlowRecord]:
        """Follow-mode long-poll: block until a MATCHING record with
        seq > after_seq lands or the timeout lapses (the
        MonitorBus.wait_for_events condvar pattern).  Returns the
        matching records (empty on timeout)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            # snapshot the write cursor BEFORE querying: any record
            # appended after this point re-triggers the query, so a
            # match landing between query() and wait() can't be
            # missed
            with self._lock:
                seen = self._next_seq - 1
            got = self.query(flt, after_seq=after_seq)
            if got:
                return got
            with self._cond:
                while self._next_seq - 1 == seen:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return []
                    self._cond.wait(timeout=remaining)

    def summary(self, top: int = 10) -> dict:
        """Aggregations over the ring (the `hubble observe
        --output=summary` / Grafana-panel shapes): top drop reasons,
        top denied (src identity, dst identity) pairs, per-chip flow
        counts with an imbalance ratio, verdict totals."""
        snap = self.snapshot()
        reasons: _Counter = _Counter()
        pairs: _Counter = _Counter()
        chips: _Counter = _Counter()
        verdicts: _Counter = _Counter()
        tenants: _Counter = _Counter()
        tenant_sheds: _Counter = _Counter()
        for r in snap:
            verdicts[r.verdict] += 1
            chips[r.chip] += 1
            if r.tenant:
                tenants[r.tenant] += 1
            if r.verdict == VERDICT_DROPPED:
                reasons[r.drop_reason] += 1
                pairs[(r.src_identity, r.dst_identity)] += 1
                if r.tenant and r.drop_reason == "Overload":
                    tenant_sheds[r.tenant] += 1
        chip_counts = {str(c): n for c, n in sorted(chips.items())}
        imbalance = (
            max(chips.values()) / max(1, min(chips.values()))
            if chips
            else 0.0
        )
        return {
            "records": len(snap),
            "captured_total": self.captured_total,
            "evicted": self.evicted,
            "verdicts": dict(verdicts),
            "top_drop_reasons": [
                {"reason": reason, "count": n}
                for reason, n in reasons.most_common(top)
            ],
            "top_denied_pairs": [
                {
                    "src_identity": src,
                    "dst_identity": dst,
                    "count": n,
                }
                for (src, dst), n in pairs.most_common(top)
            ],
            "per_chip": chip_counts,
            "chip_imbalance": round(imbalance, 3),
            "per_tenant": dict(tenants),
            "per_tenant_overload": dict(tenant_sheds),
        }
