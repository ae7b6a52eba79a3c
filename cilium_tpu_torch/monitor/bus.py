"""The monitor event bus + verdict-batch folding.

Fan-out mirrors monitor/monitor.go: the node monitor reads the perf
ring and multiplexes to subscribed listeners; slow listeners in the
reference get disconnected — here `lost_events` counts what a bounded
subscriber queue dropped (the perf ring's lost-samples counter,
pkg/bpf/perf.go).

`verdicts_to_events` folds a batched engine output into DropNotify /
PolicyVerdictNotify events host-side.  The datapath stays batched; the
event bus is a control-plane consumer, so the per-event Python cost
only applies to the (sampled or denied) slice that gets folded.  The
port's copy of the JAX package's module: `verdicts_to_events` takes the
verdict columns as numpy arrays or tensors on any device (drained to
the host once).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

from cilium_tpu_torch.engine.oracle import (
    MATCH_FRAG_DROP,
    MATCH_L3,
    MATCH_L4,
    MATCH_L4_WILD,
    MATCH_NONE,
)
from cilium_tpu_torch.monitor.events import (
    DropNotify,
    PolicyVerdictNotify,
)

DROP_POLICY_CODE = 133  # magnitude of DROP_POLICY (common.h:240)
DROP_FRAG_CODE = 157  # magnitude of DROP_FRAG_NOSUPPORT (common.h:264)


def _host(a) -> np.ndarray:
    """A column as a host array (a tensor is copied off its device)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


class MonitorBus:
    def __init__(self, queue_size: int = 65536) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._subscribers: List[Deque] = []
        self._callbacks: List[Callable] = []
        self.queue_size = queue_size
        self.lost_events = 0  # bus-global (all subscribers)
        self._drops: dict = {}  # id(queue) → that subscriber's drops

    def subscribe_queue(self) -> Deque:
        """Bounded queue subscriber; overflow counts lost events."""
        q: Deque = deque(maxlen=self.queue_size)
        with self._lock:
            self._subscribers.append(q)
        return q

    def subscribe(self, fn: Callable) -> None:
        with self._lock:
            self._callbacks.append(fn)

    def unsubscribe_queue(self, q: Deque) -> bool:
        """Detach a queue subscriber (monitor listener hang-up,
        monitor.go listener cleanup)."""
        with self._lock:
            self._drops.pop(id(q), None)
            try:
                self._subscribers.remove(q)
                return True
            except ValueError:
                return False

    def wait_for_events(self, q: Deque, timeout: float) -> bool:
        """Block until `q` has events or the timeout lapses — the
        long-poll wakeup (no 50 ms spin; publish() notifies)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cond:
            while not q:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def queue_drops(self, q: Deque, reset: bool = False) -> int:
        """Overflow drops charged to ONE subscriber's queue.  With
        `reset` the counter reads as a delta (long-poll replies report
        drops SINCE the last poll, not a forever-cumulative number)."""
        with self._lock:
            if reset:
                return self._drops.pop(id(q), 0)
            return self._drops.get(id(q), 0)

    def publish(self, event) -> None:
        with self._lock:
            for q in self._subscribers:
                if len(q) == q.maxlen:
                    # full ring: drop the NEWEST event, like a full
                    # perf ring rejecting the producer's write.  The
                    # old deque-maxlen append silently evicted the
                    # OLDEST instead, so the lost-event counter
                    # disagreed with which event was actually gone.
                    self.lost_events += 1
                    self._drops[id(q)] = (
                        self._drops.get(id(q), 0) + 1
                    )
                    continue
                q.append(event)
            callbacks = list(self._callbacks)
            self._cond.notify_all()
        for fn in callbacks:
            fn(event)


def verdicts_to_events(
    bus: MonitorBus,
    verdicts,
    ep_ids: np.ndarray,
    identities: np.ndarray,
    dports: np.ndarray,
    protos: np.ndarray,
    directions: np.ndarray,
    emit_allowed: bool = False,
    verdict_eps: "Optional[set]" = None,
    emit_drops: bool = True,
    emit_trace: bool = False,
    sample: Optional[int] = None,
    metrics_registry=None,
) -> int:
    """Fold a batch: denied tuples → DropNotify (+ verdict events when
    PolicyVerdictNotification is on / emit_allowed).  `verdict_eps`
    scopes allowed-verdict emission to specific endpoint ids — the
    per-endpoint PolicyVerdictNotification option (`cilium endpoint
    config`), which the reference compiles into that endpoint's
    datapath alone.  `emit_drops` is the DropNotification option
    (DROP_NOTIFY #define); `emit_trace` emits a per-flow TraceNotify
    for allowed tuples — the TraceNotification option at
    MonitorAggregationLevel none (TRACE_NOTIFY; higher aggregation
    levels suppress per-packet traces, monitor.go).  `sample` caps
    the number of per-tuple events PUBLISHED this call (the
    MonitorAggregation analog for batch folds: the aggregate
    counters below stay exact over the whole batch; only the
    per-event fan-out is head-sampled) — None publishes everything.
    `metrics_registry` redirects the counter feed away from the
    process-global registry — callers whose traffic was ALREADY
    folded there (e.g. from the device telemetry accumulator) pass a
    private Registry so the same tuples aren't counted twice.
    Returns the number of events published."""
    allowed = _host(verdicts.allowed)
    kind = _host(verdicts.match_kind)
    proxy = _host(verdicts.proxy_port)
    # datapath traffic counters (metrics.go drop_count_total /
    # forward_count_total / policy_verdict_total), batched — one inc
    # per label set, canonical bpf/lib/common.h reason names
    if metrics_registry is None:
        from cilium_tpu_torch.metrics import registry as _metrics
    else:
        _metrics = metrics_registry
    from cilium_tpu_torch.monitor.events import drop_reason_name

    for dirv, dname in ((0, "INGRESS"), (1, "EGRESS")):
        in_dir = np.asarray(directions) == dirv
        fwd = int((allowed.astype(bool) & in_dir).sum())
        if fwd:
            _metrics.forward_count.inc(dname, value=fwd)
        denied = (~allowed.astype(bool)) & in_dir
        frag = denied & (kind == MATCH_FRAG_DROP)
        pol = denied & ~frag
        if int(pol.sum()):
            _metrics.drop_count.inc(
                drop_reason_name(-DROP_POLICY_CODE), dname,
                value=int(pol.sum()),
            )
        if int(frag.sum()):
            _metrics.drop_count.inc(
                drop_reason_name(-DROP_FRAG_CODE), dname,
                value=int(frag.sum()),
            )
        # the lattice verdict histogram (match kind implies action)
        for code, match, action in (
            (MATCH_L4, "l4", "allowed"),
            (MATCH_L3, "l3", "allowed"),
            (MATCH_L4_WILD, "l4_wild", "allowed"),
            (MATCH_NONE, "none", "denied"),
            (MATCH_FRAG_DROP, "frag", "denied"),
        ):
            n_kind = int(((kind == code) & in_dir).sum())
            if n_kind:
                _metrics.policy_verdict_total.inc(
                    dname, match, action, value=n_kind
                )
    import time as _time

    _metrics.event_ts.set("api", value=_time.time())
    n = 0
    per_ep = None
    if emit_allowed:
        idx = np.arange(len(allowed))
    elif verdict_eps:
        ep_arr = np.asarray(ep_ids)
        per_ep = np.isin(ep_arr, np.asarray(sorted(verdict_eps)))
        idx = np.nonzero((allowed == 0) | per_ep)[0]
    else:
        idx = np.nonzero(allowed == 0)[0]

    def _verdict_event(i, is_allowed: bool) -> PolicyVerdictNotify:
        return PolicyVerdictNotify(
            source=int(ep_ids[i]),
            src_label=int(identities[i]),
            dst_label=0,
            dport=int(dports[i]),
            proto=int(protos[i]),
            ingress=int(directions[i]) == 0,
            allowed=is_allowed,
            proxy_port=int(proxy[i]),
            match_kind=int(kind[i]),
        )

    if emit_trace:
        from cilium_tpu_torch.monitor.events import TraceNotify

        for i in np.nonzero(allowed)[0]:
            if sample is not None and n >= sample:
                break
            # the local endpoint is the DESTINATION of an ingress
            # flow and the SOURCE of an egress one (send_trace_notify
            # carries distinct src/dst; 0 = remote/unknown)
            ingress_i = int(directions[i]) == 0
            bus.publish(
                TraceNotify(
                    source=0 if ingress_i else int(ep_ids[i]),
                    src_label=int(identities[i]),
                    dst_id=int(ep_ids[i]) if ingress_i else 0,
                )
            )
            n += 1
    for i in idx:
        if sample is not None and n >= sample:
            break
        if allowed[i]:
            bus.publish(_verdict_event(i, True))
        else:
            if emit_allowed or (
                per_ep is not None and per_ep[i]
            ):
                # PolicyVerdictNotification covers BOTH outcomes in
                # the reference (monitor/datapath_policy.go): opted-in
                # endpoints see the deny verdict alongside the drop
                bus.publish(_verdict_event(i, False))
                n += 1
            if not emit_drops:
                continue
            reason = (
                DROP_FRAG_CODE
                if kind[i] == MATCH_FRAG_DROP
                else DROP_POLICY_CODE
            )
            bus.publish(
                DropNotify(
                    source=int(ep_ids[i]),
                    src_label=int(identities[i]),
                    reason=reason,
                )
            )
        n += 1
    return n
