"""Deterministic, seedable fault injection for the serving plane (the
port's own copy of the JAX package's faultinject.py).

The analog of the reference's chaos suites
(Cilium's test/runtime/chaos.go kills agents;
test/k8sT/Chaos.go restarts nodes) brought INSIDE the process: named
instrumentation sites in the hot path consult a process-global
registry, and an armed site fails its callers on a deterministic
schedule — so resilience machinery (retry, circuit breaker, host-path
failover, kvstore redial) can be *proven* instead of assumed.

Sites (dotted names; the instrumented seams):

  engine.dispatch   device verdict dispatch (replay.replay and
                    replay_lattice) — the kernel launch that a wedged
                    card or a dispatch failure takes down.  Accepts
                    the `chip=` selector (below): the mesh failover
                    router (engine/failover.py) probes this site once
                    per device ordinal before each launch, so a
                    chip-scoped schedule kills exactly one chip while
                    the unscoped daemon/replay seam never sees it
  native.decode     flow-record decode (native.decode_flow_records)
  kvstore.conn      socket transport send path (kvstore RemoteBackend)
                    — custom action: the call site severs its socket
  ct.insert         host CT map insertion (CTMap.create)
  proxy.upcall      proxy redirect realization (Proxy.
                    update_endpoint_redirects)
  publish.scatter   delta-publish device scatter (engine.publish
                    DeviceTableStore._publish_delta) — probed once
                    per resident device ordinal, so `chip=` scoped
                    schedules poison the scatter only when that
                    chip holds a slice of the spare epoch; the
                    publish falls back to a FULL upload (counted in
                    publish_fallback_total) instead of leaving a
                    half-patched epoch
  memo.insert       verdict-cache insert/commit path — the host
                    commit of kernel-inserted rows (engine.memo
                    VerdictCache.commit, unscoped) and the routed
                    memo plane's per-chip probes before commit
                    (engine.failover._memo_dispatch, `chip=`
                    honored); a fired fault drops the batch's cache
                    write-back and the batch re-dispatches uncached
                    — bit-identity is unconditional either way

Schedules are deterministic and composable:

  "raise"                    fail every call while armed
  "raise:next=3"             fail the next 3 calls, then pass
  "raise:every=5"            fail every 5th call
  "raise:prob=0.1;seed=7"    seeded Bernoulli (reproducible)
  "hang:delay=0.5"           sleep `delay` then pass (watchdog bait)
  "corrupt:next=1"           data-mode: corrupt_bytes() mangles the
                             payload (truncation) instead of raising
  "raise:chip=3"             chip-scoped: fires only for callers that
                             identify as device ordinal 3 (the mesh
                             router's per-chip attribution probes);
                             call sites that pass no ordinal are
                             never affected, and non-matching
                             ordinals do not consume the schedule

Arming surfaces: `registry.arm()` in-process, the
CILIUM_TPU_FAULTS env var at import ("site=spec,site=spec"),
`PATCH /config {"faults": {...}}` via the daemon, the REST
`/debug/faults` routes, and `cilium-tpu fault arm/disarm/list`.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from cilium_tpu_torch.logging import get_logger

log = get_logger("faultinject")

# the instrumented seams; arming anything else is a caller error
SITES = (
    "engine.dispatch",
    "native.decode",
    "kvstore.conn",
    "ct.insert",
    "proxy.upcall",
    "publish.scatter",
    "memo.insert",
    # the elastic-resharding migration scatter (engine/reshard.py):
    # probed once per target-column ordinal before each bounded-byte
    # migration step, so chip-scoped schedules can kill a migration
    # mid-stream (the plan then completes via the survivors' replica
    # copies or rolls back to the source layout)
    "reshard.migrate",
)

MODES = ("raise", "hang", "corrupt")


class FaultInjected(RuntimeError):
    """An armed site fired (mode=raise)."""

    def __init__(self, site: str, chip: Optional[int] = None) -> None:
        where = site if chip is None else f"{site} (chip {chip})"
        super().__init__(f"injected fault at {where}")
        self.site = site
        self.chip = chip


@dataclass
class FaultSpec:
    """One site's failure schedule."""

    mode: str = "raise"
    next_n: int = 0  # fail the next N calls (0 = no next-N window)
    every: int = 0  # fail every Kth call (0 = off)
    prob: float = 0.0  # seeded Bernoulli (0 = off)
    seed: int = 0
    delay: float = 0.05  # hang duration (mode=hang)
    chip: int = -1  # device-ordinal scope (-1 = unscoped)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r} "
                f"(one of {'/'.join(MODES)})"
            )
        if self.next_n < 0 or self.every < 0:
            raise ValueError("next/every must be >= 0")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError("prob must be in [0, 1]")

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        """Spec string → FaultSpec: "mode[:k=v[;k=v...]]"."""
        mode, _, params = str(text).strip().partition(":")
        kw: Dict[str, object] = {}
        if params:
            for pair in params.split(";"):
                if not pair:
                    continue
                key, sep, value = pair.partition("=")
                if not sep:
                    raise ValueError(
                        f"fault spec param {pair!r} is not k=v"
                    )
                key = key.strip()
                if key == "next":
                    kw["next_n"] = int(value)
                elif key in ("every", "seed", "chip"):
                    kw[key] = int(value)
                elif key in ("prob", "delay"):
                    kw[key] = float(value)
                else:
                    raise ValueError(
                        f"unknown fault spec param {key!r}"
                    )
        return FaultSpec(mode=mode or "raise", **kw)

    def describe(self) -> Dict[str, object]:
        return {
            "mode": self.mode,
            "next": self.next_n,
            "every": self.every,
            "prob": self.prob,
            "seed": self.seed,
            "delay": self.delay,
            "chip": self.chip,
        }


@dataclass
class _ArmedSite:
    spec: FaultSpec
    calls: int = 0
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.spec.seed)

    def decide(self) -> bool:
        """One call through the schedule (caller holds the lock)."""
        self.calls += 1
        spec = self.spec
        if spec.next_n:
            if self.fired < spec.next_n:
                self.fired += 1
                return True
            return False
        if spec.every:
            hit = self.calls % spec.every == 0
        elif spec.prob:
            hit = self.rng.random() < spec.prob
        else:
            hit = True
        if hit:
            self.fired += 1
        return hit


class FaultRegistry:
    """Process-global armed-site table; all decisions under one lock
    so schedules stay deterministic under concurrent callers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: Dict[str, _ArmedSite] = {}

    def arm(self, site: str, spec) -> FaultSpec:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} "
                f"(one of {', '.join(SITES)})"
            )
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        with self._lock:
            self._armed[site] = _ArmedSite(spec)
        log.warning(
            "fault site armed",
            extra={"fields": {"site": site, **spec.describe()}},
        )
        return spec

    def disarm(self, site: str) -> bool:
        with self._lock:
            return self._armed.pop(site, None) is not None

    def disarm_all(self) -> int:
        with self._lock:
            n = len(self._armed)
            self._armed.clear()
        return n

    def armed(self) -> Dict[str, Dict[str, object]]:
        """Snapshot for the REST/CLI surface."""
        with self._lock:
            return {
                site: {
                    **armed.spec.describe(),
                    "calls": armed.calls,
                    "fired": armed.fired,
                }
                for site, armed in self._armed.items()
            }

    # -- the instrumentation verbs ------------------------------------------

    # NOTE on the lock-free `if not self._armed` fast paths below:
    # the instrumentation verbs sit on per-flow/per-frame hot paths
    # (every CTMap.create, every kvstore frame, every dispatch), so
    # the nothing-armed case — production — must not take the global
    # lock.  Reading the dict's emptiness without the lock is a
    # benign race: arming is advisory (a fault armed concurrently
    # with a call may miss that one call), and dict reads are atomic
    # under the GIL.

    @staticmethod
    def _in_scope(spec: FaultSpec, chip: Optional[int]) -> bool:
        """Chip-scope gate: a chip-scoped spec only matches callers
        identifying as that exact ordinal (out-of-scope calls must
        not consume the schedule — "kill chip 3" means chip 3's next
        probe, not whichever chip happens to probe first); an
        unscoped spec matches every caller, ordinal-passing or not."""
        if spec.chip < 0:
            return True
        return chip is not None and chip == spec.chip

    def any_armed(self) -> bool:
        """Lock-free production guard: True when ANY site is armed.
        Call sites whose PROBE SETUP itself has a cost (e.g.
        enumerating device ordinals for per-chip attribution) gate
        the setup on this, the same benign-race emptiness read the
        verbs below use."""
        return bool(self._armed)

    def should_fire(self, site: str, chip: Optional[int] = None) -> bool:
        """Count one call; True when the schedule says fail.  For
        call sites with a CUSTOM fault action (kvstore.conn severs
        its socket) — fire() applies the generic raise/hang action."""
        if not self._armed:
            return False
        with self._lock:
            armed = self._armed.get(site)
            if armed is None or not self._in_scope(armed.spec, chip):
                return False
            hit = armed.decide()
        if hit:
            self._count(site, armed.spec.mode, chip)
        return hit

    def fire(self, site: str, chip: Optional[int] = None) -> None:
        """The generic instrumentation hook: no-op unless armed; an
        armed raise-site raises FaultInjected, a hang-site sleeps
        its delay (the dispatch watchdog's bait).  corrupt-mode
        sites never act here — corrupt_bytes() is their verb.  Pass
        `chip` (a device ordinal) from per-chip attribution probes:
        chip-scoped specs fire only for their ordinal."""
        if not self._armed:
            return
        with self._lock:
            armed = self._armed.get(site)
            if armed is None or armed.spec.mode == "corrupt":
                return
            if not self._in_scope(armed.spec, chip):
                return
            hit = armed.decide()
            mode = armed.spec.mode
            delay = armed.spec.delay
        if not hit:
            return
        self._count(site, mode, chip)
        if mode == "hang":
            time.sleep(delay)
            return
        raise FaultInjected(site, chip)

    def corrupt_bytes(self, site: str, buf: bytes) -> bytes:
        """Data-plane verb: an armed corrupt-site mangles the buffer
        (drops the trailing byte — a truncated record stream, the
        classic partial-read corruption) on its schedule."""
        if not self._armed:
            return buf
        with self._lock:
            armed = self._armed.get(site)
            if armed is None or armed.spec.mode != "corrupt":
                return buf
            hit = armed.decide()
        if not hit or not buf:
            return buf
        self._count(site, "corrupt")
        return buf[:-1]

    @staticmethod
    def _count(site: str, mode: str, chip: Optional[int] = None) -> None:
        # late import: metrics must stay importable without this
        # module and vice versa
        from cilium_tpu_torch.metrics import registry as metrics

        metrics.fault_injections_total.inc(site, mode)
        log.warning(
            "injected fault fired",
            extra={"fields": {"site": site, "mode": mode,
                              "chip": chip}},
        )


registry = FaultRegistry()

# module-level conveniences (the instrumented call sites use these)
arm = registry.arm
disarm = registry.disarm
disarm_all = registry.disarm_all
armed = registry.armed
any_armed = registry.any_armed
fire = registry.fire
should_fire = registry.should_fire
corrupt_bytes = registry.corrupt_bytes


class injected:
    """Context manager for tests: arm on enter, disarm on exit."""

    def __init__(self, site: str, spec="raise") -> None:
        self.site = site
        self.spec = spec

    def __enter__(self) -> FaultSpec:
        return arm(self.site, self.spec)

    def __exit__(self, *exc) -> None:
        disarm(self.site)


FAULTS_ENV = "CILIUM_TPU_FAULTS"


def _arm_from_env() -> None:
    """CILIUM_TPU_FAULTS="site=spec,site=spec" armed at import —
    chaos runs of unmodified entrypoints (agent, bench, tools)."""
    raw = os.environ.get(FAULTS_ENV, "")
    if not raw:
        return
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        site, sep, spec = item.partition("=")
        if not sep:
            raise ValueError(
                f"{FAULTS_ENV} entry {item!r} is not site=spec"
            )
        arm(site.strip(), spec)


_arm_from_env()
