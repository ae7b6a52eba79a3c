"""The PyTorch port's span plane (tracing.py) and the span seams of the
modules it already had, on the CPU against the JAX package's: the same
calls through both packages give the same spans, compared by name, site,
attributes, events, status and tree shape (and, under one seed, by id:
both tracers draw their ids from random.Random(seed) in the same order).
Durations and wall-clock stamps differ between any two runs and are left
out.

  * traceparent parse and format, on good and malformed headers;
  * span trees: nesting, an error span, an explicit remote parent, an
    unsampled parent, `record`, `record_chip_spans`, `add_event`, the
    ring bound, head sampling at a rate below 1 (the same seed, so the
    same decisions), and `render_span_tree` of the same spans;
  * `StatSpan` over each package's SpanStats: the shared clock and the
    success and failure counts;
  * `track_jit`: hits and misses at a site of the port's persistent pair
    program against a jitted JAX function over the same shape classes,
    and a callable without `_cache_size` passing through uncounted;
  * the seams: `compiler.compile`, `compiler.delta_for` and
    `publish.epoch` over two publishes, `proxy.upcall` of the proxy from
    rules, and the verdict cache's `cache.flush` event.
"""

import time
import types

import numpy as np
import pytest
import torch

from cilium_tpu_torch import spanstat as tspanstat
from cilium_tpu_torch import tracing as ttracing
from cilium_tpu_torch import world
from cilium_tpu_torch.metrics import registry as tmetrics

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu import spanstat as jspanstat
    from cilium_tpu import tracing as jtracing
    from cilium_tpu.metrics import registry as jmetrics
except ImportError:  # the card's machine has no JAX
    jax = None

PACKAGES = ("jax", "port")


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _mod(which):
    return jtracing if which == "jax" else ttracing


def _view(spans, ids=True):
    """Spans (objects or dicts) without their clocks; parents by name
    where ids are not compared."""
    dicts = [s if isinstance(s, dict) else s.to_dict() for s in spans]
    names = {d["span_id"]: d["name"] for d in dicts}
    out = []
    for d in dicts:
        v = {k: d[k] for k in ("name", "site", "status", "attrs")}
        v["events"] = [{k: x for k, x in e.items() if k != "offset_ms"}
                       for e in d["events"]]
        v["parent"] = names.get(d["parent_id"], d["parent_id"] and "?")
        if ids:
            v.update({k: d[k] for k in ("trace_id", "span_id", "parent_id")})
        out.append(v)
    return out


# -- traceparent ---------------------------------------------------------------------

HEADERS = (
    None, "", "junk", "00-abc-def-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-00",
    " 00-" + "1" * 32 + "-" + "2" * 16 + "-03 ",
    "00-" + "1" * 32 + "-" + "2" * 16,
)


def test_traceparent_parse_and_format_match_jax():
    _need_jax()
    for h in HEADERS:
        got, want = ttracing.parse_traceparent(h), jtracing.parse_traceparent(h)
        assert (got is None) == (want is None), h
        if got is not None:
            assert (got.trace_id, got.span_id, got.sampled) == (
                want.trace_id, want.span_id, want.sampled), h
    span = types.SimpleNamespace(trace_id="a" * 32, span_id="b" * 16)
    assert ttracing.format_traceparent(span) == jtracing.format_traceparent(
        span)


# -- span trees ----------------------------------------------------------------------


def _tree_scenario(mod):
    """One sequence of tracer calls; returns (spans, extra facts)."""
    t = mod.Tracer(seed=11, capacity=64)
    tok = mod._current.set(None)  # isolate from any ambient span
    try:
        with t.span("root", site="api", attrs={"batch": 3}) as root:
            with t.span("child", site="daemon") as child:
                mod.add_event("breaker.decision", allowed=False, n=2)
                t.record("jit.compile", "engine", 0.25,
                         attrs={"cache_size": 1})
            with t.span("child2", site="daemon", attrs={"k": "v"}):
                pass
            with pytest.raises(RuntimeError):
                with t.span("boom", site="engine"):
                    raise RuntimeError("x")
        mod.record_chip_spans(t, child, 4, 1024, "engine.sharded")
        ctx = mod.parse_traceparent(mod.format_traceparent(root))
        with t.span("served", site="api", parent=ctx):
            pass
        unsampled = mod.parse_traceparent(
            mod.format_traceparent(root)[:-2] + "00")
        with t.span("shed", parent=unsampled) as shed:
            mod.add_event("ignored")
        free = t.record("background", "engine", 0.5)
        facts = dict(
            shed_trace=shed.trace_id, free_root=free.parent_id == "",
            current_after=mod.current_span() is None,
            current_trace=mod.current_trace_id(),
        )
    finally:
        mod._current.reset(tok)
    return t.snapshot(), facts


def _ring_scenario(mod):
    t = mod.Tracer(seed=4, capacity=4)
    for i in range(7):
        with t.span(f"s{i}"):
            pass
    return ([s.name for s in t.snapshot()], t.dropped, t.started_total,
            t.finished_total)


def _sampling_scenario(mod):
    t = mod.Tracer(seed=5, sample_rate=0.5)
    kept = []
    for i in range(40):
        with t.span(f"r{i}") as r:
            with t.span("c"):
                pass
        kept.append(r.trace_id != "")
    t.reset(seed=6, sample_rate=0.0)
    with t.span("none"):
        pass
    return kept, _view(t.snapshot()), len(t.snapshot())


def test_span_trees_match_jax():
    _need_jax()
    j_spans, j_facts = _tree_scenario(jtracing)
    t_spans, t_facts = _tree_scenario(ttracing)
    assert _view(t_spans) == _view(j_spans)
    assert t_facts == j_facts
    names = [s.name for s in t_spans]
    assert names.count("chip.dispatch") == 4 and "shed" not in names
    assert _ring_scenario(ttracing) == _ring_scenario(jtracing)
    kept, _, _ = _sampling_scenario(ttracing)
    assert _sampling_scenario(ttracing) == _sampling_scenario(jtracing)
    assert 0 < sum(kept) < len(kept)


def test_render_span_tree_matches_jax():
    _need_jax()
    spans, _ = _tree_scenario(ttracing)
    dicts = [dict(s.to_dict(), duration_ms=1.5, ts=float(i))
             for i, s in enumerate(spans)]
    for d in dicts:
        d["events"] = [dict(e, offset_ms=0.25) for e in d["events"]]
    text = ttracing.render_span_tree(dicts)
    assert text == jtracing.render_span_tree(dicts)
    lines = text.splitlines()
    assert lines[0].startswith("root (api)") and "batch=3" in lines[0]
    assert any(line.strip().startswith("@") for line in lines)
    assert ttracing.render_span_tree([]) == jtracing.render_span_tree([])
    orphans = dicts[1:]
    assert (ttracing.render_span_tree(orphans)
            == jtracing.render_span_tree(orphans))


# -- StatSpan --------------------------------------------------------------------------


def _stat_scenario(mod, spanstat):
    t = mod.Tracer(seed=9)
    stats = spanstat.SpanStats()
    tok = mod._current.set(None)
    try:
        ss = mod.stat_span(stats, "dispatch", site="daemon", trc=t).start()
        time.sleep(0.001)
        ss.end()
        span = t.snapshot()[-1]
        shared = stats.span("dispatch").total() == span.duration
        mod.stat_span(stats, "dispatch", trc=t).start().end(success=False)
        with pytest.raises(ValueError):
            with mod.StatSpan(t, stats, "ctx", site="x"):
                raise ValueError("y")
        quiet = mod.Tracer(seed=9, sample_rate=0.0)
        mod.stat_span(stats, "other", trc=quiet).start().end()
    finally:
        mod._current.reset(tok)
    counts = {name: (s.num_success, s.num_failure)
              for name, s in stats.items()}
    return shared, counts, _view(t.snapshot()), quiet.snapshot()


def test_stat_span_matches_jax():
    _need_jax()
    got = _stat_scenario(ttracing, tspanstat)
    want = _stat_scenario(jtracing, jspanstat)
    assert got == want
    assert got[0] is True
    assert got[1] == {"dispatch": (1, 1), "ctx": (0, 1), "other": (1, 0)}


# -- track_jit -------------------------------------------------------------------------


def _calls(metrics, site):
    return (metrics.jit_cache_hits.get(site),
            metrics.jit_cache_misses.get(site),
            metrics.jit_compile_seconds.get(site))


def test_track_jit_counts_match_jax():
    """Three calls over two shape classes: 2 misses and 1 hit at the site
    in both packages, compile seconds charged, a `jit.compile` span per
    miss; a callable without _cache_size counts nothing."""
    _need_jax()
    from cilium_tpu_torch import convert
    from cilium_tpu_torch.engine import datapath as tdp
    from cilium_tpu_torch.engine import verdict as tv

    site = "test.torch.trackjit"
    w = world.make_world(seed=4, n_rules=100, n_endpoints=4,
                         n_identities=256, n_cidr_blocks=4, n_vips=2,
                         n_pool=500, ct_max_entries=1024, identity_pad=256,
                         filter_pad=16)
    tt = convert.tables_to(world.headline_tables(w), "cpu")
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cpu")
    port_fn = ttracing.track_jit(tdp.persistent_pair_program(2), site)
    jax_fn = jtracing.track_jit(jax.jit(lambda x: x * 2), site)
    before = (_calls(jmetrics, site), _calls(tmetrics, site))
    tok = ttracing._current.set(None)
    jtok = jtracing._current.set(None)
    t0, j0 = len(ttracing.tracer.snapshot()), len(jtracing.tracer.snapshot())
    try:
        for half in (32, 32, 48):
            pairs = np.stack(w.pairs(seed=half, half=half, k=2))
            port_fn(tt, torch.from_numpy(pairs.view(np.int32)), acc, tel)
            jax_fn(jnp.ones(half))
    finally:
        ttracing._current.reset(tok)
        jtracing._current.reset(jtok)
    after = (_calls(jmetrics, site), _calls(tmetrics, site))
    for (h0, m0, c0), (h1, m1, c1) in zip(before, after):
        assert (h1 - h0, m1 - m0) == (1, 2)
        assert c1 > c0
    for mod, n0 in ((ttracing, t0), (jtracing, j0)):
        compiles = [s for s in mod.tracer.snapshot()[n0:]
                    if s.name == "jit.compile" and s.site == site]
        assert len(compiles) == 2
    plain = ttracing.track_jit(lambda x: x + 1, site + ".plain")
    jplain = jtracing.track_jit(lambda x: x + 1, site + ".plain")
    assert plain(1) == jplain(1) == 2
    assert _calls(tmetrics, site + ".plain") == _calls(
        jmetrics, site + ".plain") == (0, 0, 0)


# -- the seams ---------------------------------------------------------------------------


def _global_spans(mod, run):
    """Run `run()` under a root span of the package's module tracer
    (reseeded, ring cleared) and return the spans it exported."""
    mod.tracer.reset(seed=21, sample_rate=1.0)
    tok = mod._current.set(None)
    try:
        with mod.tracer.span("step", site="test"):
            out = run()
    finally:
        mod._current.reset(tok)
    return mod.tracer.snapshot(), out


def _publish_run(tab, pub, pm, store):
    """Two compiles of a small fleet, each with delta_for and a publish,
    inside the same root span (the rule_update recipe's three seams)."""
    def state(ports):
        return {pm.PolicyKey(256 + i, p, 6, i % 2):
                pm.PolicyMapStateEntry(proxy_port=0)
                for i, p in enumerate(ports)}

    fc = tab.FleetCompiler(identity_pad=256, filter_pad=16)
    ids = [256 + i for i in range(24)]
    modes = []
    for step, ports in enumerate(([80, 443], [80, 443, 8080])):
        entries = [(100 + e, state(ports[: 1 + e % len(ports)]), step)
                   for e in range(3)]
        tables, _ = fc.compile(entries, ids)
        delta = fc.delta_for(store.spare_stamp(), tables)
        _, stats = store.publish(tables, delta)
        modes.append(stats.mode)
    return modes


def test_compile_delta_and_epoch_spans_match_jax():
    _need_jax()
    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.engine import publish as jpub
    from cilium_tpu.maps import policymap as jpm
    from cilium_tpu_torch.compiler import tables as ttab
    from cilium_tpu_torch.engine import publish as tpub
    from cilium_tpu_torch.maps import policymap as tpm

    j_spans, j_modes = _global_spans(jtracing, lambda: _publish_run(
        jtab, jpub, jpm, jpub.DeviceTableStore()))
    t_spans, t_modes = _global_spans(ttracing, lambda: _publish_run(
        ttab, tpub, tpm, tpub.DeviceTableStore(device="cpu")))
    assert t_modes == j_modes
    assert _view(t_spans, ids=False) == _view(j_spans, ids=False)
    names = [s.name for s in t_spans]
    for seam in ("compiler.compile", "compiler.delta_for", "publish.epoch"):
        assert names.count(seam) == 2, names


def test_proxy_upcall_span_matches_jax():
    """The proxy from rules: one `proxy.upcall` span per
    update_endpoint_redirects call, with the endpoint and the realized
    redirects."""
    _need_jax()
    from test_torch_proxy import _jax_setup

    pw = world.proxy_world(64, 16)
    j_spans, _ = _global_spans(jtracing, lambda: _jax_setup(pw))
    t_spans, _ = _global_spans(ttracing, lambda: world.proxy_setup(pw, "cpu"))
    assert _view(t_spans, ids=False) == _view(j_spans, ids=False)
    upcalls = [s for s in t_spans if s.name == "proxy.upcall"]
    assert len(upcalls) == 1
    assert upcalls[0].attrs == {"endpoint": world.PROXY_ENDPOINT_ID,
                                "redirects": 4}


def _flush_run(cache):
    cache.ensure(("gen", 1))  # a fresh buffer adopts its first stamp
    cache.rows = cache.rows  # now it carries entries
    cache.ensure(("gen", 1))
    cache.ensure(("gen", 2))
    cache.flush()
    return cache.flushes


def test_cache_flush_event_matches_jax():
    _need_jax()
    from cilium_tpu.engine import memo as jvm
    from cilium_tpu_torch.engine import memo as tm

    j_spans, j_n = _global_spans(jtracing,
                                 lambda: _flush_run(jvm.VerdictCache(64)))
    t_spans, t_n = _global_spans(
        ttracing, lambda: _flush_run(tm.VerdictCache(64, device="cpu")))
    assert t_n == j_n == 2
    assert _view(t_spans, ids=False) == _view(j_spans, ids=False)
    events = t_spans[0].events
    assert [e["reason"] for e in events] == ["epoch-stamp", "explicit"]
    assert events[0]["old_stamp"] == "('gen', 1)"
