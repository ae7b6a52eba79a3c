"""In-process distributed tracing: the span plane.

The port's copy of the JAX package's tracing module; only its imports
and what `track_jit` counts differ.

A Dapper-style tracer for the verdict serving stack: every span
carries (trace_id, span_id, parent_id), a monotonic-clock duration,
attributes and a status, and lands in a bounded ring the API serves
(`GET /debug/traces`) and bugtool archives.  Context propagates two
ways:

  * in-process via a contextvar — a span opened anywhere under an
    active span becomes its child, so the REST handler's root span
    automatically parents `Daemon.process_flows`, which parents each
    batch's dispatch, which parents the per-chip children;
  * across processes via a W3C `traceparent`-style HTTP header
    (`00-<trace_id>-<span_id>-<flags>`) accepted and emitted by
    api/server — a client that stamps its own header sees its ids on
    every span, flow record and reply.

Determinism and cost are first-class: ids come from a seedable RNG
(tests pin exact ids), sampling is HEAD-based (the decision is made
once at the root — an unsampled request creates no spans at all, the
same shape as the flow plane's head-sampled allows), and the tracer
accounts its own bookkeeping time in `overhead_s` so bench.py's
`tracing_overhead_pct` gate and tools/trace_smoke.py measure the real
hot-path cost instead of an A/B of noisy wall clocks.

Join keys: the trace id is stamped into FlowRecords captured during a
traced batch (GET /flows?trace-id=...) and the jit/table metrics are
sampled by the same instrumented sites, so one id connects
`/debug/traces`, `/flows` and `/metrics/prometheus`.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

TRACEPARENT_HEADER = "traceparent"
TRACE_ID_HEADER = "X-Trace-Id"

# head-sampling default: record everything (the per-request span count
# is bounded — one span per phase/batch, never per flow — so the
# default mirrors the flow plane's "drops always" posture; operators
# turn the knob down under load, --trace-sample-rate)
DEFAULT_SAMPLE_RATE = 1.0


@dataclass
class SpanContext:
    """Propagated identity of a remote parent (parsed traceparent)."""

    trace_id: str
    span_id: str
    sampled: bool = True


@dataclass
class Span:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: str  # 16 hex chars, "" for a root
    name: str
    site: str  # instrumentation point, e.g. "engine.dispatch"
    ts: float  # wall-clock start (time.time()) — for rendering
    start: float  # perf_counter at start
    duration: float = 0.0  # seconds (0 while running)
    status: str = "ok"  # ok | error
    attrs: Dict[str, object] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)

    @property
    def duration_ms(self) -> float:
        return self.duration * 1000.0

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "site": self.site,
            "ts": self.ts,
            "duration_ms": round(self.duration_ms, 4),
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _NoopSpan:
    """The unsampled stand-in: absorbs attribute writes and renders
    falsy ids, so instrumented code never branches on sampling."""

    trace_id = ""
    span_id = ""
    parent_id = ""
    duration = 0.0
    status = "ok"

    def __init__(self) -> None:
        self.attrs: Dict[str, object] = {}
        self.events: List[dict] = []


_NOOP = _NoopSpan()

# the active span of THIS execution context (contextvars: each API
# handler thread/task sees its own chain)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "cilium_tpu_torch_span", default=None
)


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """`00-<32 hex>-<16 hex>-<2 hex flags>` → SpanContext; anything
    malformed is ignored (None): a bad header must start a fresh
    trace, never 500 the request."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(
        trace_id=trace_id.lower(),
        span_id=span_id.lower(),
        sampled=bool(int(flags, 16) & 1),
    )


def format_traceparent(span) -> str:
    flags = "01"
    return f"00-{span.trace_id}-{span.span_id}-{flags}"


class Tracer:
    """Bounded-ring tracer with contextvar propagation.

    `capacity` bounds the exporter ring (oldest spans fall off,
    counted in `dropped` — the FlowStore eviction contract);
    `sample_rate` is the head-sampling probability applied at ROOT
    span creation (children inherit the decision); `seed` pins the
    RNG so ids and sampling decisions reproduce in tests."""

    def __init__(
        self,
        capacity: int = 8192,
        sample_rate: float = DEFAULT_SAMPLE_RATE,
        seed: Optional[int] = None,
    ) -> None:
        self.capacity = capacity
        self.sample_rate = sample_rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.started_total = 0
        self.finished_total = 0
        # the tracer's own bookkeeping seconds (begin/finish, ring
        # append) — what tracing actually charges the instrumented
        # path; bench.py's tracing_overhead_pct reads this
        self.overhead_s = 0.0

    # -- id generation --------------------------------------------------------

    def _gen_ids(self, bits: int) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(bits):0{bits // 4}x}"

    def _sampled(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample_rate

    def reset(
        self,
        seed: Optional[int] = None,
        sample_rate: Optional[float] = None,
    ) -> None:
        """Clear the ring and (optionally) reseed/re-rate — tests and
        bench runs start from a known state."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.started_total = 0
            self.finished_total = 0
            self.overhead_s = 0.0
            if seed is not None:
                self._rng = random.Random(seed)
        if sample_rate is not None:
            self.sample_rate = sample_rate

    # -- span lifecycle -------------------------------------------------------

    def begin(
        self,
        name: str,
        site: str = "",
        parent: Optional[SpanContext] = None,
        attrs: Optional[dict] = None,
    ):
        """Open a span and install it as the current context.  Returns
        (span, token); pair with finish().  `parent` overrides the
        contextvar chain (the HTTP header case).  An unsampled root
        yields the noop span — children of a noop stay noop."""
        t0 = time.perf_counter()
        cur = _current.get()
        if parent is not None:
            if not parent.sampled:
                token = _current.set(_NOOP)
                return _NOOP, token
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif cur is not None:
            if cur is _NOOP:
                token = _current.set(_NOOP)
                return _NOOP, token
            trace_id, parent_id = cur.trace_id, cur.span_id
        else:
            if not self._sampled():
                token = _current.set(_NOOP)
                return _NOOP, token
            trace_id, parent_id = self._gen_ids(128), ""
        span = Span(
            trace_id=trace_id,
            span_id=self._gen_ids(64),
            parent_id=parent_id,
            name=name,
            site=site,
            ts=time.time(),
            start=t0,
            attrs=dict(attrs) if attrs else {},
        )
        self.started_total += 1
        token = _current.set(span)
        self.overhead_s += time.perf_counter() - t0
        return span, token

    def finish(self, span, token, status: Optional[str] = None) -> None:
        """Close a span, restore the outer context, export to the
        ring.  Noop spans only restore the context."""
        t0 = time.perf_counter()
        try:
            _current.reset(token)
        except ValueError:
            # token from another context (exotic caller); best-effort
            _current.set(None)
        if span is _NOOP:
            return
        span.duration = t0 - span.start
        if status is not None:
            span.status = status
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)
            self.finished_total += 1
        self.overhead_s += time.perf_counter() - t0

    def span(
        self,
        name: str,
        site: str = "",
        parent: Optional[SpanContext] = None,
        attrs: Optional[dict] = None,
    ):
        """Context-manager form: exceptions mark the span error and
        re-raise."""
        return _SpanCtx(self, name, site, parent, attrs)

    def record(
        self,
        name: str,
        site: str,
        duration: float,
        parent=None,
        attrs: Optional[dict] = None,
        status: str = "ok",
        ts: Optional[float] = None,
    ):
        """Export an already-measured span (jit compiles, synthesized
        per-chip children): no contextvar involvement.  `parent` is a
        Span (defaults to the current one).  Recording under an
        UNSAMPLED context is skipped — the head decision made at the
        root covers everything beneath it, so a sampled-out request
        exports nothing at all; with no context (background work
        outside any request) the span becomes its own root."""
        t0 = time.perf_counter()
        if parent is None:
            parent = _current.get()
        if parent is _NOOP or (
            parent is not None and not parent.trace_id
        ):
            return None
        if parent is None:
            trace_id, parent_id = self._gen_ids(128), ""
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(
            trace_id=trace_id,
            span_id=self._gen_ids(64),
            parent_id=parent_id,
            name=name,
            site=site,
            ts=(time.time() - duration) if ts is None else ts,
            start=t0 - duration,
            duration=duration,
            status=status,
            attrs=dict(attrs) if attrs else {},
        )
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)
            self.started_total += 1
            self.finished_total += 1
        self.overhead_s += time.perf_counter() - t0
        return span

    # -- queries --------------------------------------------------------------

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def get_trace(self, trace_id: str) -> List[Span]:
        """Every exported span of one trace, oldest first."""
        trace_id = str(trace_id).lower()
        return sorted(
            (s for s in self.snapshot() if s.trace_id == trace_id),
            key=lambda s: s.start,
        )

    def query(
        self,
        trace_id: Optional[str] = None,
        min_duration_ms: Optional[float] = None,
        site: Optional[str] = None,
        last: Optional[int] = None,
    ) -> List[Span]:
        out = self.snapshot()
        if trace_id is not None:
            tid = str(trace_id).lower()
            out = [s for s in out if s.trace_id == tid]
        if site is not None:
            out = [s for s in out if s.site == site]
        if min_duration_ms is not None:
            out = [
                s for s in out if s.duration_ms >= min_duration_ms
            ]
        out.sort(key=lambda s: s.start)
        if last is not None and last >= 0:
            out = out[-last:] if last else []
        return out

    def slowest_traces(self, n: int = 10) -> List[dict]:
        """Traces ranked by ROOT span duration (the request-level
        latency), with per-trace span counts — `cilium-tpu trace
        --slowest N`."""
        spans = self.snapshot()
        by_trace: Dict[str, List[Span]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        rows = []
        for tid, group in by_trace.items():
            ids = {s.span_id for s in group}
            roots = [
                s for s in group
                if not s.parent_id or s.parent_id not in ids
            ]
            root = max(roots, key=lambda s: s.duration, default=None)
            if root is None:
                continue
            rows.append(
                {
                    "trace_id": tid,
                    "root": root.name,
                    "site": root.site,
                    "ts": root.ts,
                    "duration_ms": round(root.duration_ms, 4),
                    "status": root.status,
                    "spans": len(group),
                }
            )
        rows.sort(key=lambda r: r["duration_ms"], reverse=True)
        return rows[: max(0, n)]


class _SpanCtx:
    def __init__(self, tracer, name, site, parent, attrs) -> None:
        self._tracer = tracer
        self._args = (name, site, parent, attrs)
        self.span = None
        self._token = None

    def __enter__(self):
        name, site, parent, attrs = self._args
        self.span, self._token = self._tracer.begin(
            name, site=site, parent=parent, attrs=attrs
        )
        return self.span

    def __exit__(self, exc_type, exc, tb):
        status = None
        if exc_type is not None:
            status = "error"
            if self.span is not _NOOP:
                self.span.attrs.setdefault("error", repr(exc))
        self._tracer.finish(self.span, self._token, status=status)
        return False


# -- module-global tracer (the metrics-registry shape) ----------------------

tracer = Tracer()


def current_span():
    """The active span of this execution context (None/noop outside a
    trace)."""
    return _current.get()


def current_trace_id() -> str:
    """Trace id of the active context ("" when untraced/unsampled) —
    the join key stamped into FlowRecords."""
    cur = _current.get()
    return cur.trace_id if cur is not None else ""


def add_event(name: str, **attrs) -> None:
    """Attach a point-in-time event to the active span (breaker
    decisions, admission shedding, retries).  No-op outside a sampled
    span — the cheap path costs one contextvar read."""
    cur = _current.get()
    if cur is None or cur is _NOOP:
        return
    cur.events.append(
        {
            "name": name,
            "offset_ms": round(
                (time.perf_counter() - cur.start) * 1000.0, 4
            ),
            **attrs,
        }
    )


def record_chip_spans(
    trc: Tracer, parent, n_chips: int, rows: int, site: str
) -> None:
    """Synthesize per-chip dispatch children under a finished parent
    span: the device step is SPMD — every chip executes the same
    program over its batch shard in lockstep — so the parent's window
    partitions evenly across chips (the children sum to the parent,
    the smoke's tree-integrity invariant)."""
    if parent is None or parent is _NOOP or not parent.trace_id:
        return
    n_chips = max(1, int(n_chips))
    share = parent.duration / n_chips
    per_chip = rows // n_chips if n_chips else rows
    for chip in range(n_chips):
        trc.record(
            "chip.dispatch",
            site=site,
            duration=share,
            parent=parent,
            attrs={"chip": chip, "rows": per_chip},
            status=parent.status,
            ts=parent.ts,
        )


class StatSpan:
    """One clock window feeding BOTH accounting planes: a tracer span
    and a SpanStat phase accumulator.  Because the start/end
    timestamps are shared, `/debug/profile`'s phase totals and the
    span durations served by `/debug/traces` agree exactly (the old
    arrangement timed them separately).

    start()/end(success=) mirror SpanStat's verbs so call sites keep
    their shape; also usable as a context manager."""

    def __init__(
        self,
        trc: Tracer,
        stats,
        name: str,
        site: str = "",
        attrs: Optional[dict] = None,
    ) -> None:
        self._tracer = trc
        self._stat = stats.span(name)
        self._name = name
        self._site = site
        self._attrs = attrs
        self.span = None
        self._token = None
        self._t0 = 0.0

    def start(self) -> "StatSpan":
        self.span, self._token = self._tracer.begin(
            self._name, site=self._site, attrs=self._attrs
        )
        # the stat's own running state is NEVER engaged: end() feeds
        # it a measured duration (the span's, or this private clock
        # when unsampled), so a window abandoned by an exception can
        # never fold a bogus inter-request gap into the accumulator
        # on the next start()
        if self.span is _NOOP:
            self._t0 = time.perf_counter()
        return self

    def end(self, success: bool = True) -> "StatSpan":
        self._tracer.finish(
            self.span, self._token,
            status="ok" if success else "error",
        )
        d = (
            self.span.duration
            if self.span is not _NOOP
            else time.perf_counter() - self._t0
        )
        # the SAME duration lands in both planes (SpanStat.observe is
        # the one shared fold implementation)
        self._stat.observe(d, success=success)
        return self

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end(success=exc_type is None)
        return False


def stat_span(stats, name, site="", attrs=None, trc=None) -> StatSpan:
    """StatSpan over the module tracer (or an injected one)."""
    return StatSpan(
        trc or tracer, stats, name, site=site, attrs=attrs
    )


def track_jit(fn, site: str, trc: Optional[Tracer] = None):
    """Wrap a launch callable with executable-cache observability:
    a callable with `_cache_size()` (the count of launch classes it
    has run: a jit cache in the reference, the persistent pair
    program's layout, K and B classes here) counts a miss at `site`
    for each call that GROWS it (a new class) and charges the call's
    wall seconds to `cilium_jit_cache_compile_seconds{site}` plus a
    `jit.compile` span; calls of a known class count hits.  Compile
    seconds include the first execution (and a kernel library's build
    at first use) — that is what the caller actually waits for.  A
    callable without `_cache_size` passes through uncounted."""

    def wrapped(*args, **kwargs):
        size_fn = getattr(fn, "_cache_size", None)
        if size_fn is None:  # no launch classes to observe
            return fn(*args, **kwargs)
        from cilium_tpu_torch.metrics import registry as metrics

        before = size_fn()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        if size_fn() > before:
            metrics.jit_cache_misses.inc(site)
            metrics.jit_compile_seconds.inc(site, value=dt)
            (trc or tracer).record(
                "jit.compile", site=site, duration=dt,
                attrs={"cache_size": size_fn()},
            )
        else:
            metrics.jit_cache_hits.inc(site)
        return out

    wrapped.__wrapped__ = fn
    return wrapped


# -- rendering (CLI tree view) ----------------------------------------------


def render_span_tree(spans: List[dict]) -> str:
    """Text tree of one trace's spans (dict form, as served by
    GET /debug/traces) with per-span ms — `cilium-tpu trace <id>`.
    Orphans (parent outside the ring) render as extra roots so a
    partially-evicted trace still shows."""
    if not spans:
        return "(no spans)\n"
    spans = sorted(spans, key=lambda s: s.get("ts", 0.0))
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent_id", "")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    lines: List[str] = []

    def walk(span: dict, depth: int) -> None:
        pad = "  " * depth
        attrs = span.get("attrs") or {}
        extra = (
            " " + " ".join(f"{k}={v}" for k, v in attrs.items())
            if attrs
            else ""
        )
        status = span.get("status", "ok")
        mark = "" if status == "ok" else f" [{status}]"
        lines.append(
            f"{pad}{span['name']} ({span.get('site', '')}) "
            f"{span.get('duration_ms', 0.0):.3f}ms{mark}{extra}"
        )
        for ev in span.get("events") or []:
            ev = dict(ev)
            nm = ev.pop("name", "event")
            off = ev.pop("offset_ms", 0.0)
            kv = " ".join(f"{k}={v}" for k, v in ev.items())
            lines.append(f"{pad}  @{off:.3f}ms {nm} {kv}".rstrip())
        for child in children.get(span["span_id"], ()):
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines) + "\n"
