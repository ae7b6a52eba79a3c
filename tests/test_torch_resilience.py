"""The PyTorch port's resilience primitives and fault-injection
framework (cilium_tpu_torch/resilience.py, faultinject.py), held to the
JAX package's unit tests (tests/test_resilience.py, mirrored here test
for test): retry backoff and deadline, the circuit-breaker state
machine, the dispatch watchdog, the admission gate, fault-schedule
determinism and arming from the environment.  Then what the port adds:
the chip-scoped specs of tests/test_chip_failover.py, each schedule's
fire sequence against the reference registry's, the seams of the
replay dispatch, the proxy upcall and the guarded dispatch's device
wait."""

import itertools
import threading
import time

import numpy as np

import pytest

from cilium_tpu_torch import faultinject
from cilium_tpu_torch.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    AdmissionGate,
    BreakerOpen,
    CircuitBreaker,
    DeadlineExceeded,
    DispatchWatchdog,
    retry_call,
)


@pytest.fixture(autouse=True)
def _disarm_all_faults():
    faultinject.disarm_all()
    yield
    faultinject.disarm_all()


# -- retry_call ---------------------------------------------------------------


def test_retry_call_succeeds_after_transients():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    seen = []
    got = retry_call(
        flaky,
        retries=3,
        base_delay=0.0001,
        seed=0,
        on_retry=lambda attempt, exc: seen.append(attempt),
    )
    assert got == "ok" and calls["n"] == 3
    assert seen == [1, 2]


def test_retry_call_exhausts_and_reraises():
    def always():
        raise ValueError("permanent")

    with pytest.raises(ValueError, match="permanent"):
        retry_call(always, retries=2, base_delay=0.0001, seed=0)


def test_retry_call_respects_deadline():
    calls = {"n": 0}

    def slow_fail():
        calls["n"] += 1
        time.sleep(0.05)
        raise RuntimeError("x")

    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        retry_call(
            slow_fail, retries=100, base_delay=0.01, deadline=0.1,
            seed=0,
        )
    # a 100-retry budget bounded by the deadline, not the count
    assert time.monotonic() - t0 < 2.0
    assert calls["n"] < 10


def test_retry_call_retry_on_filter():
    def raises_key():
        raise KeyError("nope")

    calls = {"n": 0}

    def count():
        calls["n"] += 1
        raise KeyError("nope")

    with pytest.raises(KeyError):
        retry_call(
            count, retries=5, base_delay=0.0001,
            retry_on=(ValueError,),
        )
    assert calls["n"] == 1  # non-matching exceptions never retry


# -- CircuitBreaker -----------------------------------------------------------


def _ticking_breaker(step=0.1, **kw):
    clock = itertools.count(0.0, step)
    return CircuitBreaker("t", clock=lambda: next(clock), **kw)


def test_breaker_full_cycle():
    events = []
    b = _ticking_breaker(
        failure_threshold=2,
        recovery_timeout=0.5,
        on_transition=lambda n, old, new, why: events.append(
            (old, new)
        ),
    )
    assert b.state == CLOSED and b.allow()
    b.record_failure()
    assert b.state == CLOSED  # below threshold
    b.record_failure()
    assert events == [(CLOSED, OPEN)]
    # open: shed until the recovery timeout elapses on the fake clock
    # (each clock read advances 0.1): a few allow() calls later the
    # breaker lets one probe through as half-open
    probed = False
    for _ in range(10):
        if b.allow():
            probed = True
            break
    assert probed
    assert (OPEN, HALF_OPEN) in events
    b.record_success()
    assert b.state == CLOSED
    assert events[-1] == (HALF_OPEN, CLOSED)
    assert b.opened_total == 1


def test_breaker_half_open_failure_reopens():
    b = _ticking_breaker(failure_threshold=1, recovery_timeout=0.05)
    b.record_failure()
    assert b.opened_total == 1
    while not b.allow():
        pass
    b.record_failure()  # the probe failed
    assert b.opened_total == 2
    assert b.snapshot()["state"] == OPEN


def test_breaker_half_open_limits_probes():
    b = _ticking_breaker(
        failure_threshold=1, recovery_timeout=0.05, half_open_max=1
    )
    b.record_failure()
    while not b.allow():  # first probe admitted
        pass
    assert not b.allow()  # second concurrent probe shed
    b.record_success()
    assert b.state == CLOSED


def test_breaker_call_wrapper():
    b = _ticking_breaker(
        failure_threshold=1, recovery_timeout=1e9
    )
    with pytest.raises(RuntimeError):
        b.call(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(BreakerOpen):
        b.call(lambda: "never")
    b.reset()
    assert b.call(lambda: "ok") == "ok"


def test_half_open_probe_watchdog_timeout_releases_slot():
    """Regression (ISSUE 8 satellite): a half-open probe timed out
    by the DispatchWatchdog must release its _half_open_inflight
    slot when the caller records the failure — a hung probe must not
    wedge the breaker in half-open forever."""
    b = _ticking_breaker(failure_threshold=1, recovery_timeout=0.05)
    b.record_failure()
    while not b.allow():  # the half-open probe slot is taken
        pass
    assert b.snapshot()["half_open_inflight"] == 1
    wd = DispatchWatchdog(timeout=0.05)
    with pytest.raises(DeadlineExceeded):
        wd.run(lambda: time.sleep(1.0))  # the probe hangs
    b.record_failure("probe exceeded watchdog deadline")
    snap = b.snapshot()
    assert snap["half_open_inflight"] == 0
    assert snap["state"] == OPEN
    # the breaker is NOT wedged: after the recovery timeout a fresh
    # probe is admitted again
    while not b.allow():
        pass
    b.record_success()
    assert b.state == CLOSED


def test_half_open_probe_ttl_reclaims_abandoned_slot():
    """The accounting fix: a probe whose OWNER vanishes without ever
    recording (caller thread died with its abandoned watchdog
    worker) would pin the slot forever; probe_ttl lets allow()
    reclaim it so half-open cannot wedge."""
    clock = itertools.count(0.0, 0.1)
    b = CircuitBreaker(
        "t",
        failure_threshold=1,
        recovery_timeout=0.3,
        probe_ttl=0.5,
        clock=lambda: next(clock),
    )
    b.record_failure()
    while not b.allow():
        pass
    # owner never reports back.  Without the TTL every further
    # allow() would return False forever; with it, the slot expires
    # on the fake clock and a new probe is admitted.
    admitted = False
    for _ in range(20):
        if b.allow():
            admitted = True
            break
    assert admitted, "breaker wedged in half-open"
    b.record_success()
    assert b.state == CLOSED


def test_no_ttl_probe_slot_stays_reserved():
    """Without probe_ttl the slot is only released by record_*"""
    clock = itertools.count(0.0, 0.1)
    b = CircuitBreaker(
        "t", failure_threshold=1, recovery_timeout=0.3,
        clock=lambda: next(clock),
    )
    b.record_failure()
    while not b.allow():
        pass
    assert not any(b.allow() for _ in range(20))


def test_probe_ttl_multi_slot_keeps_live_probe_reservation():
    """half_open_max > 1: the TTL reclaim must expire exactly the
    abandoned slot(s).  One shared issue-timestamp would let a newer
    probe refresh the window and keep an older abandoned slot alive
    forever; wholesale zeroing would discard a LIVE probe's
    reservation and over-admit."""
    t = [0.0]
    b = CircuitBreaker(
        "t", failure_threshold=1, recovery_timeout=1.0,
        half_open_max=2, success_threshold=2,
        probe_ttl=5.0, clock=lambda: t[0],
    )
    b.record_failure()
    t[0] = 1.0
    assert b.allow()  # probe A @1.0 — its owner will vanish
    t[0] = 4.5
    assert b.allow()  # probe B @4.5 — live
    assert b.snapshot()["half_open_inflight"] == 2
    assert not b.allow()  # both slots held
    t[0] = 6.5  # A expired (ttl 5), B still fresh
    assert b.allow()  # reclaims ONLY A's slot, admits probe C
    assert b.snapshot()["half_open_inflight"] == 2
    assert not b.allow()  # B's live reservation was kept
    b.record_success()  # B reports
    b.record_success()  # C reports
    assert b.state == CLOSED


# -- ChipBreakerBank ----------------------------------------------------------


def test_bank_listener_rebind_reaches_existing_breakers():
    """The bank reads on_transition at FIRE time: a breaker lazily
    created before the failover router rewires the bank (e.g. by an
    early states() read) must still reach the router's ledger/gauge
    wiring."""
    from cilium_tpu_torch.resilience import ChipBreakerBank

    bank = ChipBreakerBank(
        failure_threshold=1, recovery_timeout=1e9
    )
    assert bank.state(3) == CLOSED  # lazily creates chip 3's breaker
    events = []
    bank.on_transition = (
        lambda o, old, new, why: events.append((o, new))
    )
    bank.record_failure(3, "boom")
    assert events == [(3, OPEN)]


def test_chip_breaker_bank_independent_chips():
    from cilium_tpu_torch.resilience import ChipBreakerBank

    events = []
    bank = ChipBreakerBank(
        failure_threshold=1,
        recovery_timeout=1e9,
        on_transition=lambda o, old, new, why: events.append(
            (o, old, new)
        ),
    )
    assert bank.allow(0) and bank.allow(1)
    bank.record_failure(3, "boom")
    assert bank.state(3) == OPEN
    assert bank.states()[3] == OPEN
    assert bank.open_chips() == (3,)
    # other ordinals unaffected
    assert bank.allow(0) and not bank.allow(3)
    assert events == [(3, CLOSED, OPEN)]
    assert bank.breaker(3).name == "engine.dispatch[chip=3]"
    bank.reset()
    assert bank.open_chips() == ()


def test_chip_breaker_bank_half_open_recovery():
    from cilium_tpu_torch.resilience import ChipBreakerBank

    bank = ChipBreakerBank(
        failure_threshold=1, recovery_timeout=0.01
    )
    bank.record_failure(2, "boom")
    deadline = time.monotonic() + 2.0
    while not bank.allow(2) and time.monotonic() < deadline:
        time.sleep(0.005)
    bank.record_success(2)
    assert bank.state(2) == CLOSED


def test_breaker_success_threshold():
    b = _ticking_breaker(
        failure_threshold=1,
        recovery_timeout=0.05,
        success_threshold=2,
    )
    b.record_failure()
    while not b.allow():
        pass
    b.record_success()
    assert b.snapshot()["state"] == HALF_OPEN  # needs 2 successes
    assert b.allow()
    b.record_success()
    assert b.state == CLOSED


# -- DispatchWatchdog ---------------------------------------------------------


def test_watchdog_passes_results_and_errors():
    wd = DispatchWatchdog(timeout=5.0)
    assert wd.run(lambda: 42) == 42
    with pytest.raises(ValueError, match="inner"):
        wd.run(lambda: (_ for _ in ()).throw(ValueError("inner")))


def test_watchdog_deadline():
    wd = DispatchWatchdog(timeout=0.05)
    with pytest.raises(DeadlineExceeded):
        wd.run(lambda: time.sleep(1.0))


def test_watchdog_disabled():
    wd = DispatchWatchdog(timeout=0)
    assert wd.run(lambda: "direct") == "direct"


def test_watchdog_catches_injected_hang():
    """The hang fault mode + watchdog compose: a stalled dispatch
    surfaces as DeadlineExceeded the breaker can count."""
    wd = DispatchWatchdog(timeout=0.05)
    faultinject.arm("engine.dispatch", "hang:delay=1.0;next=1")

    def dispatch():
        faultinject.fire("engine.dispatch")
        return "served"

    with pytest.raises(DeadlineExceeded):
        wd.run(dispatch)
    assert wd.run(dispatch) == "served"  # schedule exhausted


# -- AdmissionGate ------------------------------------------------------------


def test_admission_gate_bounds_inflight():
    g = AdmissionGate(limit=10)
    assert g.reserve(6) and g.inflight == 6
    assert not g.reserve(5)  # would exceed
    assert g.shed_total == 5
    assert g.reserve(4) and g.inflight == 10
    g.release(10)
    assert g.inflight == 0
    unbounded = AdmissionGate(limit=None)
    assert unbounded.reserve(1 << 40)


def test_admission_gate_concurrent():
    g = AdmissionGate(limit=100)
    admitted = []

    def worker():
        if g.reserve(30):
            admitted.append(30)

    threads = [threading.Thread(target=worker) for _ in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(admitted) <= 100
    assert g.inflight == sum(admitted)


# -- fault schedules ----------------------------------------------------------


def test_fault_spec_parsing():
    s = faultinject.FaultSpec.parse("raise:next=3")
    assert s.mode == "raise" and s.next_n == 3
    s = faultinject.FaultSpec.parse("hang:delay=0.25;every=4")
    assert s.mode == "hang" and s.delay == 0.25 and s.every == 4
    s = faultinject.FaultSpec.parse("corrupt:prob=0.5;seed=9")
    assert s.mode == "corrupt" and s.prob == 0.5 and s.seed == 9
    with pytest.raises(ValueError):
        faultinject.FaultSpec.parse("explode")
    with pytest.raises(ValueError):
        faultinject.FaultSpec.parse("raise:bogus=1")
    with pytest.raises(ValueError):
        faultinject.FaultSpec.parse("raise:prob=2.0")


def test_fault_schedule_next_n():
    faultinject.arm("engine.dispatch", "raise:next=2")
    fired = 0
    for _ in range(5):
        try:
            faultinject.fire("engine.dispatch")
        except faultinject.FaultInjected:
            fired += 1
    assert fired == 2
    assert faultinject.armed()["engine.dispatch"]["fired"] == 2


def test_fault_schedule_every_kth():
    faultinject.arm("engine.dispatch", "raise:every=3")
    outcomes = []
    for _ in range(9):
        try:
            faultinject.fire("engine.dispatch")
            outcomes.append(False)
        except faultinject.FaultInjected:
            outcomes.append(True)
    assert outcomes == [False, False, True] * 3


def test_fault_schedule_seeded_prob_deterministic():
    def run():
        faultinject.arm(
            "engine.dispatch", "raise:prob=0.5;seed=42"
        )
        out = []
        for _ in range(32):
            try:
                faultinject.fire("engine.dispatch")
                out.append(0)
            except faultinject.FaultInjected:
                out.append(1)
        faultinject.disarm("engine.dispatch")
        return out

    first, second = run(), run()
    assert first == second  # same seed, same schedule
    assert 0 < sum(first) < 32


def test_unknown_site_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        faultinject.arm("no.such.site", "raise")


def test_env_arming(monkeypatch):
    monkeypatch.setenv(
        faultinject.FAULTS_ENV, "engine.dispatch=raise:next=1"
    )
    faultinject._arm_from_env()
    assert "engine.dispatch" in faultinject.armed()
    with pytest.raises(faultinject.FaultInjected):
        faultinject.fire("engine.dispatch")


def test_injected_context_manager():
    with faultinject.injected("ct.insert", "raise:next=1"):
        assert "ct.insert" in faultinject.armed()
        with pytest.raises(faultinject.FaultInjected):
            faultinject.fire("ct.insert")
    assert "ct.insert" not in faultinject.armed()


def test_corrupt_bytes_mode():
    faultinject.arm("native.decode", "corrupt:next=1")
    assert faultinject.corrupt_bytes("native.decode", b"abcd") == (
        b"abc"
    )
    # schedule exhausted: passthrough
    assert faultinject.corrupt_bytes("native.decode", b"abcd") == (
        b"abcd"
    )
    # fire() never acts on a corrupt-mode site
    faultinject.arm("native.decode", "corrupt")
    faultinject.fire("native.decode")


# -- chip-scoped specs (tests/test_chip_failover.py) ---------------------------


def test_chip_scoped_spec_parses_and_scopes():
    spec = faultinject.FaultSpec.parse("raise:chip=3;next=2")
    assert spec.chip == 3 and spec.next_n == 2
    faultinject.arm("engine.dispatch", spec)
    # unscoped call sites never see a chip-scoped schedule, and other
    # ordinals do not consume it
    faultinject.fire("engine.dispatch")
    faultinject.fire("engine.dispatch", chip=2)
    with pytest.raises(faultinject.FaultInjected) as err:
        faultinject.fire("engine.dispatch", chip=3)
    assert err.value.chip == 3
    with pytest.raises(faultinject.FaultInjected):
        faultinject.fire("engine.dispatch", chip=3)
    faultinject.fire("engine.dispatch", chip=3)  # next=2 spent
    armed = faultinject.armed()["engine.dispatch"]
    assert armed["chip"] == 3 and armed["fired"] == 2


def test_unscoped_spec_fires_for_any_ordinal():
    faultinject.arm("engine.dispatch", "raise:next=1")
    with pytest.raises(faultinject.FaultInjected):
        faultinject.fire("engine.dispatch", chip=5)


# -- the same schedules as the reference registry ------------------------------


@pytest.mark.parametrize("spec", [
    "raise", "raise:next=3", "raise:every=4", "raise:prob=0.3;seed=7",
    "raise:chip=2;next=2", "raise:chip=1;every=2", "hang:delay=0;next=2",
    "corrupt:next=2",
])
def test_schedule_matches_reference_registry(spec):
    """The same calls through both packages' registries fire at the same
    calls and leave the same armed listing."""
    try:
        from cilium_tpu import faultinject as jfi
    except ImportError:
        pytest.skip("the JAX package is not importable")

    def run(fi):
        fi.disarm_all()
        fi.arm("publish.scatter", spec)
        fired = []
        for k in range(24):
            chip = None if k % 5 == 4 else k % 4
            try:
                fi.fire("publish.scatter", chip=chip)
                fired.append(False)
            except fi.FaultInjected as exc:
                fired.append((exc.site, exc.chip))
            fired.append(fi.corrupt_bytes("publish.scatter", b"ab"))
        listing = fi.armed()
        fi.disarm_all()
        return fired, listing

    assert run(faultinject) == run(jfi)


# -- the seams -------------------------------------------------------------------


def _tiny_lattice():
    from cilium_tpu_torch import convert
    from cilium_tpu_torch.compiler import tables as ttab
    from cilium_tpu_torch.maps import policymap as tpm
    from cilium_tpu_torch.native import loader as tld

    states = [{tpm.PolicyKey(5, 80, 6, tpm.INGRESS): tpm.PolicyMapStateEntry(),
               tpm.PolicyKey(2, 0, 0, tpm.EGRESS): tpm.PolicyMapStateEntry()},
              {}]
    tables = convert.policy_tables_to(ttab.compile_map_states(
        states, [1, 2, 5], identity_pad=32, filter_pad=16), "cpu")
    n = 64
    k = np.arange(n)
    buf = tld.encode_flow_records(
        ep_id=k % 2, identity=np.array([1, 2, 5, 9])[k % 4],
        saddr=k, daddr=k, sport=k, dport=np.where(k % 3 == 0, 80, 443),
        proto=np.full(n, 6), direction=k % 2, is_fragment=np.zeros(n))
    return tables, buf


def test_replay_dispatch_retries_injected_faults():
    """replay_lattice's dispatches go through the guarded seam: a fault
    that fires twice is retried away (same stats, two retries counted);
    a persistent one propagates."""
    from cilium_tpu_torch import replay as trp
    from cilium_tpu_torch.metrics import registry as metrics

    tables, buf = _tiny_lattice()
    want, wl4, wl3 = trp.replay_lattice(tables, buf, 32, device="cpu")
    before = metrics.dispatch_retries_total.get()
    with faultinject.injected("engine.dispatch", "raise:next=2"):
        got, l4, l3 = trp.replay_lattice(tables, buf, 32, device="cpu")
    assert metrics.dispatch_retries_total.get() - before == 2
    for f in ("total", "allowed", "denied", "redirected", "batches"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(l4, wl4)
    np.testing.assert_array_equal(l3, wl3)
    with faultinject.injected("engine.dispatch", "raise"):
        with pytest.raises(faultinject.FaultInjected):
            trp.replay_lattice(tables, buf, 32, device="cpu")


def test_proxy_upcall_seam_fires_in_its_span():
    """An armed proxy.upcall site fails redirect realization at the start
    of the proxy.upcall span; disarmed, the same call realizes."""
    from types import SimpleNamespace

    from cilium_tpu_torch.proxy.proxy import Proxy

    proxy = Proxy(device="cpu")
    ep = SimpleNamespace(id=7, desired_l4_policy=None, realized_redirects={})
    with faultinject.injected("proxy.upcall", "raise:next=1"):
        with pytest.raises(faultinject.FaultInjected):
            proxy.update_endpoint_redirects(ep, None, {}, 0)
    assert proxy.update_endpoint_redirects(ep, None, {}, 0) == {}


def test_guarded_dispatch_deadline_covers_the_device_wait(monkeypatch):
    """Under a watchdog the guarded call waits for the result's devices
    inside the deadline (a CUDA launch returns before its kernels end);
    without one it returns the launch's result as it is."""
    from cilium_tpu_torch import resilience

    waited = []
    monkeypatch.setattr(resilience, "wait_devices", waited.append)
    out = resilience.guarded_dispatch(lambda x: x + 1, 1,
                                      watchdog=DispatchWatchdog(5.0))
    assert out == 2 and waited == [2]
    assert resilience.guarded_dispatch(lambda x: x * 3, 2) == 6
    assert waited == [2]


def test_wait_devices_walks_nested_results():
    """CPU tensors in tuples, dicts and dataclasses need no wait."""
    import dataclasses

    import torch

    from cilium_tpu_torch.resilience import wait_devices

    @dataclasses.dataclass
    class Box:
        a: object

    wait_devices((torch.zeros(2), {"k": [Box(torch.ones(1)), 3]}, None))
