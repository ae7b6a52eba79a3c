"""Resilience primitives for the verdict serving plane (the port's own
copy of the JAX package's resilience.py).

The survivability layer the reference spreads across pkg/controller
(exponential error backoff), pkg/health (degraded-mode reporting) and
the agent's restart story, distilled into three host-side primitives
the hot path composes:

  * retry_call — bounded retries with exponential backoff + jitter
    and a hard deadline (controller.go:175's backoff, per-call);
  * CircuitBreaker — closed/open/half-open over any dependency (the
    device dispatch, here): trip after consecutive failures, shed load
    while open, probe with limited half-open trials, close on
    success.  Transitions invoke a listener so the daemon can flip
    /healthz to degraded, publish AgentNotify monitor events and
    set the breaker_state gauge;
  * DispatchWatchdog — run a callable under a wall-clock deadline on
    a worker thread (a wedged kernel launch cannot be cancelled; the
    watchdog abandons it and fails the call so the breaker can open
    instead of the flow stream hanging forever);
  * AdmissionGate — bounded in-flight admission for overload
    shedding (the perf ring's finite depth: past the watermark the
    datapath drops with a reason instead of queueing unboundedly).

Everything is deterministic under a seed (jittered backoff included)
so chaos-storm runs reproduce.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from cilium_tpu_torch import tracing
from cilium_tpu_torch.logging import get_logger

log = get_logger("resilience")


class DeadlineExceeded(TimeoutError):
    """A watchdogged call outlived its deadline."""


class BreakerOpen(RuntimeError):
    """Fast-fail: the circuit is open; the dependency is shed."""


def retry_call(
    fn: Callable,
    *args,
    retries: int = 2,
    base_delay: float = 0.005,
    max_delay: float = 0.5,
    deadline: Optional[float] = None,
    jitter: float = 0.5,
    seed: Optional[int] = None,
    retry_on: Tuple[type, ...] = (Exception,),
    on_retry: Optional[Callable] = None,
    **kwargs,
):
    """Call `fn` with up to `retries` retries: exponential backoff
    (base * 2^attempt, capped at max_delay) with multiplicative
    jitter in [1-jitter, 1+jitter] — seeded when `seed` is given, so
    schedules are reproducible.  `deadline` bounds the WHOLE call in
    seconds: no retry starts past it, and the last failure re-raises
    (controller.go's backoff loop with pkg/endpoint's generation
    timeout semantics).  `on_retry(attempt, exc)` observes each
    retry — the daemon counts dispatch_retries_total through it."""
    rng = random.Random(seed) if seed is not None else random
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            attempt += 1
            if attempt > retries:
                raise
            if (
                deadline is not None
                and time.monotonic() - t0 >= deadline
            ):
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            delay = min(base_delay * (2 ** (attempt - 1)), max_delay)
            if jitter:
                delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
            if deadline is not None:
                delay = min(
                    delay,
                    max(0.0, deadline - (time.monotonic() - t0)),
                )
            if delay > 0:
                time.sleep(delay)


# breaker states (numeric codes are the breaker_state gauge values)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"
STATE_CODES: Dict[str, int] = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Closed → (failure_threshold consecutive failures) → open →
    (recovery_timeout) → half-open → (success_threshold probe
    successes) → closed; a half-open probe failure re-opens.

    allow() is the admission question ("may I try the dependency?");
    callers pair it with record_success()/record_failure(), or use
    call() which wraps all three and raises BreakerOpen when shed.
    While half-open at most `half_open_max` probes are in flight at
    once — the rest are shed as if open (xDS's probe-one semantics).

    `on_transition(name, old, new, reason)` runs OUTSIDE the lock on
    every state change.

    `probe_ttl` bounds how long a half-open probe slot stays
    reserved: a probe whose owner never reports back (a dispatch
    abandoned past its watchdog deadline whose caller thread then
    died, a chip probe lost with its runtime) would otherwise pin
    `_half_open_inflight` at the limit and wedge the breaker in
    half-open forever — no probe can ever run again, so the breaker
    can neither close nor re-open.  With a TTL, allow() reclaims
    expired slots before answering the admission question.
    """

    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        recovery_timeout: float = 1.0,
        success_threshold: int = 1,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable] = None,
        probe_ttl: Optional[float] = None,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_timeout = recovery_timeout
        self.success_threshold = max(1, success_threshold)
        self.half_open_max = max(1, half_open_max)
        self.probe_ttl = probe_ttl
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._half_open_successes = 0
        # one issue-timestamp per in-flight half-open probe slot
        # (oldest first) — per-slot so a TTL reclaim of an abandoned
        # probe can never discard a LIVE probe's reservation when
        # half_open_max > 1
        self._probe_issued: list = []
        self._opened_at = 0.0
        self.opened_total = 0

    # -- state machine --------------------------------------------------------

    def _transition(self, new: str, reason: str):
        """Caller holds the lock; returns the listener thunk to run
        outside it (a listener that logs/publishes must never hold
        the breaker lock)."""
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = self._clock()
            self.opened_total += 1
        if new == HALF_OPEN:
            self._half_open_successes = 0
            self._probe_issued.clear()
        if new == CLOSED:
            self._consecutive_failures = 0
        listener = self.on_transition
        if listener is None or old == new:
            return None
        return lambda: listener(self.name, old, new, reason)

    def allow(self) -> bool:
        notify = None
        with self._lock:
            if self._state == OPEN:
                if (
                    self._clock() - self._opened_at
                    >= self.recovery_timeout
                ):
                    notify = self._transition(
                        HALF_OPEN, "recovery timeout elapsed"
                    )
                else:
                    ok = False
            if self._state == HALF_OPEN:
                now = self._clock()
                if self.probe_ttl is not None and self._probe_issued:
                    # probes whose owner vanished without recording:
                    # reclaim exactly the expired slots so half-open
                    # can't wedge (see the class docstring) — live
                    # probes keep their reservation
                    fresh = [
                        t for t in self._probe_issued
                        if now - t < self.probe_ttl
                    ]
                    if len(fresh) < len(self._probe_issued):
                        log.warning(
                            "reclaiming expired half-open probe "
                            "slot(s)",
                            extra={"fields": {
                                "breaker": self.name,
                                "reclaimed": len(self._probe_issued)
                                - len(fresh),
                                "inflight": len(fresh),
                                "probe_ttl_s": self.probe_ttl,
                            }},
                        )
                        self._probe_issued = fresh
                ok = len(self._probe_issued) < self.half_open_max
                if ok:
                    self._probe_issued.append(now)
            elif self._state == CLOSED:
                ok = True
        if notify is not None:
            notify()
        # span-plane attribution: the admission question's answer
        # lands on the active span (the per-batch dispatch span), so
        # a trace shows WHY a batch failed over without cross-
        # referencing the breaker gauge's scrape timeline
        tracing.add_event(
            "breaker.decision", breaker=self.name,
            state=self._state, allowed=ok,
        )
        return ok

    def record_success(self) -> None:
        notify = None
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                if self._probe_issued:
                    self._probe_issued.pop(0)
                self._half_open_successes += 1
                if (
                    self._half_open_successes
                    >= self.success_threshold
                ):
                    notify = self._transition(
                        CLOSED, "half-open probes succeeded"
                    )
        if notify is not None:
            notify()

    def record_failure(self, reason: str = "") -> None:
        tracing.add_event(
            "breaker.failure", breaker=self.name, reason=reason
        )
        notify = None
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                if self._probe_issued:
                    self._probe_issued.pop(0)
                notify = self._transition(
                    OPEN, reason or "half-open probe failed"
                )
            elif (
                self._state == CLOSED
                and self._consecutive_failures
                >= self.failure_threshold
            ):
                notify = self._transition(
                    OPEN,
                    reason
                    or f"{self._consecutive_failures} consecutive "
                    f"failures",
                )
        if notify is not None:
            notify()

    def release_probe(self) -> None:
        """Give back a half-open probe slot WITHOUT recording a
        verdict: the admitted dispatch never ran (e.g. the mesh
        routed the batch to the terminal host fold before launch),
        so the chip earned neither a success nor a failure — but
        the reservation must not pin the slot until the TTL."""
        with self._lock:
            if self._state == HALF_OPEN and self._probe_issued:
                self._probe_issued.pop()  # the newest reservation

    def call(self, fn: Callable, *args, **kwargs):
        if not self.allow():
            raise BreakerOpen(f"circuit {self.name!r} is open")
        try:
            got = fn(*args, **kwargs)
        except Exception as exc:
            self.record_failure(str(exc))
            raise
        self.record_success()
        return got

    # -- introspection --------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            # surface the would-be half-open state so status reads
            # don't lag behind the next allow()
            if (
                self._state == OPEN
                and self._clock() - self._opened_at
                >= self.recovery_timeout
            ):
                return HALF_OPEN
            return self._state

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "opened_total": self.opened_total,
                "failure_threshold": self.failure_threshold,
                "recovery_timeout": self.recovery_timeout,
                "half_open_inflight": len(self._probe_issued),
            }

    def reset(self) -> None:
        """Force-close (tests / operator action)."""
        notify = None
        with self._lock:
            if self._state != CLOSED:
                notify = self._transition(CLOSED, "reset")
            self._consecutive_failures = 0
        if notify is not None:
            notify()


class ChipBreakerBank:
    """Per-chip circuit breakers keyed by device ordinal — the mesh
    refinement of the process-wide dispatch breaker: a mesh should
    fail PER CHIP, losing 1/N of its capacity when one chip sickens
    instead of failing the whole fleet over to the host fold.

    One CircuitBreaker per ordinal, lazily created with shared
    parameters; `allow(ordinal)` is the per-chip admission question
    the shard router asks before each launch (a half-open chip's
    allow() IS its re-admission probe — the dispatch that includes
    it), and `record_success`/`record_failure` feed per-chip failure
    attribution back.  `on_transition(ordinal, old, new, reason)`
    observes every chip's state change (the daemon wires it to the
    cilium_chip_breaker_state{chip} gauge, monitor events, and the
    store's outage tracking).  Probes carry a `probe_ttl` so a chip
    that dies mid-probe cannot wedge its breaker in half-open."""

    def __init__(
        self,
        name: str = "engine.dispatch",
        failure_threshold: int = 1,
        recovery_timeout: float = 1.0,
        success_threshold: int = 1,
        probe_ttl: Optional[float] = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable] = None,
    ) -> None:
        self.name = name
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.success_threshold = success_threshold
        self.probe_ttl = probe_ttl
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._breakers: Dict[int, CircuitBreaker] = {}

    def breaker(self, ordinal: int) -> CircuitBreaker:
        ordinal = int(ordinal)
        with self._lock:
            b = self._breakers.get(ordinal)
            if b is None:
                # read self.on_transition at FIRE time, not breaker-
                # creation time: a breaker lazily created before the
                # failover router rewires the bank (e.g. by an early
                # states() call) must still reach the router's
                # ledger/gauge wiring
                def listener(_n, old, new, why, o=ordinal):
                    outer = self.on_transition
                    if outer is not None:
                        outer(o, old, new, why)

                b = CircuitBreaker(
                    name=f"{self.name}[chip={ordinal}]",
                    failure_threshold=self.failure_threshold,
                    recovery_timeout=self.recovery_timeout,
                    success_threshold=self.success_threshold,
                    probe_ttl=self.probe_ttl,
                    clock=self._clock,
                    on_transition=listener,
                )
                self._breakers[ordinal] = b
            return b

    def allow(self, ordinal: int) -> bool:
        return self.breaker(ordinal).allow()

    def record_success(self, ordinal: int) -> None:
        self.breaker(ordinal).record_success()

    def record_failure(self, ordinal: int, reason: str = "") -> None:
        self.breaker(ordinal).record_failure(reason)

    def release_probe(self, ordinal: int) -> None:
        self.breaker(ordinal).release_probe()

    def state(self, ordinal: int) -> str:
        return self.breaker(ordinal).state

    def states(self) -> Dict[int, str]:
        with self._lock:
            breakers = dict(self._breakers)
        return {o: b.state for o, b in sorted(breakers.items())}

    def open_chips(self) -> Tuple[int, ...]:
        return tuple(
            o for o, s in self.states().items() if s != CLOSED
        )

    def snapshot(self) -> Dict[int, Dict[str, object]]:
        with self._lock:
            breakers = dict(self._breakers)
        return {o: b.snapshot() for o, b in sorted(breakers.items())}

    def reset(self) -> None:
        with self._lock:
            breakers = list(self._breakers.values())
        for b in breakers:
            b.reset()


class DispatchWatchdog:
    """Per-batch dispatch deadline: run `fn` on a persistent worker
    thread and give up after `timeout` seconds.  The abandoned
    dispatch keeps running on its (daemon) worker — kernel launches
    cannot be cancelled — but the CALLER gets a DeadlineExceeded it
    can feed the breaker, instead of the whole flow stream wedging
    with the runtime.

    Workers are pooled and EXCLUSIVE: each run() takes (or spawns) an
    idle long-lived worker, so the deadline clocks only this call's
    execution — never queue-wait behind a concurrent caller — and an
    abandoned worker can hold nothing but its own wedged call.  A
    healthy worker returns to the pool (no thread-per-batch churn); a
    worker that blew its deadline drains its stuck call, sees the
    stop sentinel and exits, while the caller's retry gets a fresh
    one."""

    def __init__(self, timeout: float = 30.0) -> None:
        self.timeout = timeout
        self._lock = threading.Lock()
        self._idle: list = []  # stack of idle workers' queues

    @staticmethod
    def _work_loop(q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn, args, out, done, ctx = item
            try:
                # run under the CALLER's contextvars snapshot: spans
                # opened inside the watchdogged call (jit.compile,
                # nested dispatch children) parent to the caller's
                # active span instead of starting orphan traces on
                # this worker thread
                out.append(("ok", ctx.run(fn, *args)))
            except BaseException as exc:  # noqa: BLE001
                out.append(("err", exc))
            done.set()

    def run(self, fn: Callable, *args, timeout: Optional[float] = None):
        import queue as _queue

        timeout = self.timeout if timeout is None else timeout
        if timeout is None or timeout <= 0:
            return fn(*args)
        with self._lock:
            q = self._idle.pop() if self._idle else None
        if q is None:
            q = _queue.Queue()
            threading.Thread(
                target=self._work_loop,
                args=(q,),
                name="dispatch-watchdog",
                daemon=True,
            ).start()
        import contextvars

        out: list = []
        done = threading.Event()
        q.put((fn, args, out, done, contextvars.copy_context()))
        if not done.wait(timeout):
            # abandon THIS worker only; it exits once the wedged
            # call drains
            q.put(None)
            log.warning(
                "dispatch exceeded watchdog deadline; abandoning "
                "worker",
                extra={"fields": {"timeout_s": timeout}},
            )
            raise DeadlineExceeded(
                f"dispatch exceeded {timeout}s watchdog deadline"
            )
        with self._lock:
            self._idle.append(q)
        status, value = out[0]
        if status == "err":
            raise value
        return value


def wait_devices(out) -> None:
    """Wait for the CUDA devices that any tensor in `out` (a tensor, or
    tuples, lists, dicts and dataclasses of them) lies on."""
    import torch

    devs = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devs.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(out)
    for dev in devs:
        torch.cuda.synchronize(dev)


def guarded_dispatch(
    fn: Callable,
    *args,
    retries: int = 2,
    base_delay: float = 0.002,
    watchdog: Optional["DispatchWatchdog"] = None,
    site: str = "engine.dispatch",
    seed: int = 0,
    donated: bool = False,
):
    """THE device-dispatch guard of replay() and replay_lattice(): the
    fault seam fires BEFORE the launch (an injected failure never
    touches a carried buffer), the optional watchdog bounds the
    launch, and bounded seeded-backoff retry absorbs transients — each
    retry counted in dispatch_retries_total.  Anything persistent
    propagates for the caller's breaker/failover to handle.

    A CUDA launch returns before its kernels end, so under a watchdog
    the deadline covers the wait for the devices the result lies on
    (`wait_devices`): a wedged kernel blows the deadline instead of
    returning at once.

    `donated=True` marks call sites whose step updates carried buffers
    in place (the accumulator-carrying steps): a REAL mid-launch
    failure may have written part of them, so only the pre-launch
    injected fault is retryable there — anything else re-raises
    immediately instead of retrying over half-written state."""
    from cilium_tpu_torch import faultinject
    from cilium_tpu_torch.metrics import registry as metrics

    def _synced(*a):
        out = fn(*a)
        wait_devices(out)
        return out

    def _once():
        faultinject.fire(site)
        if watchdog is not None:
            return watchdog.run(_synced, *args)
        return fn(*args)

    return retry_call(
        _once,
        retries=retries,
        base_delay=base_delay,
        seed=seed,
        retry_on=(
            (faultinject.FaultInjected,) if donated else (Exception,)
        ),
        on_retry=lambda attempt, exc: (
            metrics.dispatch_retries_total.inc(),
            tracing.add_event(
                "dispatch.retry", attempt=attempt, error=repr(exc)
            ),
        ),
    )


class AdmissionGate:
    """Bounded in-flight admission (flows, not batches): reserve()
    admits `n` units when the outstanding total stays within the
    limit, else refuses — the caller sheds that batch under the
    canonical Overload drop reason.  Never blocks: backpressure on
    the datapath means dropping with attribution, not queueing
    (the perf ring overwrites, it does not wait)."""

    def __init__(self, limit: Optional[int] = None) -> None:
        self.limit = limit  # None = unbounded
        self._lock = threading.Lock()
        self._inflight = 0
        self.shed_total = 0

    def reserve(self, n: int, charge: bool = True) -> bool:
        """Admit `n` units, or refuse.  With `charge` (default) a
        refusal charges `n` straight to shed_total — the one-shot
        path's whole-batch shed.  `charge=False` is for callers that
        retry with a SUBSET after a refusal (the serving plane's
        shed-priority ordering): they charge exactly what they
        finally shed via charge_shed, so accounting stays
        exactly-once."""
        with self._lock:
            if (
                self.limit is not None
                and self._inflight + n > self.limit
            ):
                if charge:
                    self.shed_total += n
                tracing.add_event(
                    "admission.shed", flows=n,
                    inflight=self._inflight, limit=self.limit,
                )
                return False
            self._inflight += n
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - n)

    def charge_shed(self, n: int) -> None:
        """Account flows shed by a gate OTHER than this one (the
        serving plane's per-tenant backlog bound) so shed_total
        stays the one number health()/status() report — without
        double-counting a reserve() refusal, which already
        charged."""
        with self._lock:
            self.shed_total += n

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight
