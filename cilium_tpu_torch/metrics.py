"""Metrics registry.

Re-design of Cilium's pkg/metrics/metrics.go: the same metric names
and label sets, over a minimal in-process registry with Prometheus text
exposition (an HTTP exporter can serve `expose()` verbatim; no
prometheus client dependency in the image).  The port's copy of the
reference's registry, stdlib only: the port's record replay observes
`batch_duration` and its telemetry fold increments `forward_count`,
`drop_count`, `policy_verdict_total` and `datapath_stage_total`; the
other metrics are carried for the planes still to port.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Dict, List, Tuple

NAMESPACE = "cilium"


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped (exposition spec "Line format");
    raw interpolation corrupts the exposition for values like drop
    reasons containing quotes."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (not quotes)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_labels(
    label_names: Tuple[str, ...], label_values: Tuple[str, ...]
) -> str:
    """`{k="v",...}` selector with escaped values ('' when unlabeled)."""
    sel = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in zip(label_names, label_values)
    )
    return f"{{{sel}}}" if sel else ""


class Counter:
    def __init__(self, name: str, help_text: str, labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._values: Dict[Tuple[str, ...], float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, *label_values: str, value: float = 1.0) -> None:
        with self._lock:
            self._values[label_values] += value

    def get(self, *label_values: str) -> float:
        with self._lock:
            return self._values[label_values]

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} counter",
        ]
        with self._lock:
            for labels, value in sorted(self._values.items()):
                suffix = format_labels(self.label_names, labels)
                lines.append(f"{self.name}{suffix} {value}")
        return lines


class Gauge(Counter):
    def set(self, *label_values: str, value: float) -> None:
        """Labels-first, keyword-only value — the same shape as
        Counter.inc(*labels, value=), so the two verbs can't be
        confused at a call site (the old value-first positional form
        silently read a label as the value and vice versa)."""
        with self._lock:
            self._values[label_values] = float(value)

    def dec(self, *label_values: str) -> None:
        self.inc(*label_values, value=-1.0)

    def expose(self) -> List[str]:
        lines = super().expose()
        lines[1] = f"# TYPE {self.name} gauge"
        return lines


class Histogram:
    """Fixed-bucket histogram (regeneration seconds etc.)."""

    DEFAULT_BUCKETS = (
        0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
    )

    def __init__(self, name: str, help_text: str, buckets=None):
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._n += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (linear within the
        landing bucket, the same estimator promql's histogram_quantile
        applies to the exposition)."""
        with self._lock:
            n = self._n
            if n == 0:
                return 0.0
            rank = q * n
            cumulative = 0
            lo = 0.0
            for b, c in zip(self.buckets, self._counts):
                if cumulative + c >= rank:
                    frac = (rank - cumulative) / c if c else 0.0
                    return lo + (b - lo) * frac
                cumulative += c
                lo = b
            return self.buckets[-1]

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        cumulative = 0
        with self._lock:
            for b, c in zip(self.buckets, self._counts):
                cumulative += c
                lines.append(
                    f'{self.name}_bucket{{le="{b}"}} {cumulative}'
                )
            lines.append(
                f'{self.name}_bucket{{le="+Inf"}} {self._n}'
            )
            lines.append(f"{self.name}_sum {self._sum}")
            lines.append(f"{self.name}_count {self._n}")
        return lines


class WindowedHistogram(Histogram):
    """Histogram plus a bounded window of recent raw observations for
    EXACT short-horizon quantiles (the p50/p99 batch-latency lines the
    bench and `cilium status` surface): the cumulative buckets feed
    Prometheus; the window answers "what is p99 right now" without
    bucket-resolution error."""

    def __init__(self, name, help_text, buckets=None, window: int = 512):
        super().__init__(name, help_text, buckets)
        self._window = deque(maxlen=window)

    def observe(self, value: float) -> None:
        super().observe(value)
        with self._lock:
            self._window.append(value)

    def window_quantile(self, q: float) -> float:
        """Exact quantile over the last `window` observations
        (nearest-rank); 0.0 when nothing has been observed."""
        with self._lock:
            if not self._window:
                return 0.0
            ordered = sorted(self._window)
            rank = min(
                len(ordered) - 1, max(0, int(q * len(ordered)))
            )
            return ordered[rank]


class Registry:
    """pkg/metrics/metrics.go:120-278 metric set."""

    def __init__(self) -> None:
        ns = NAMESPACE
        self.endpoint_count_regenerating = Gauge(
            f"{ns}_endpoint_regenerating",
            "Number of endpoints currently regenerating",
        )
        self.endpoint_regenerations = Counter(
            f"{ns}_endpoint_regenerations",
            "Count of all endpoint regenerations that have completed",
            ("outcome",),
        )
        self.endpoint_regeneration_seconds = Histogram(
            f"{ns}_endpoint_regeneration_seconds",
            "Endpoint regeneration time",
        )
        self.endpoint_state_count = Gauge(
            f"{ns}_endpoint_state",
            "Count of all endpoints by state",
            ("endpoint_state",),
        )
        self.policy_count = Gauge(
            f"{ns}_policy_count", "Number of policies currently loaded"
        )
        self.policy_regeneration_count = Counter(
            f"{ns}_policy_regeneration_total",
            "Total number of policies regenerated successfully",
        )
        self.policy_revision = Gauge(
            f"{ns}_policy_max_revision",
            "Highest policy revision number in the agent",
        )
        self.policy_import_errors = Counter(
            f"{ns}_policy_import_errors",
            "Number of times a policy import has failed",
        )
        self.proxy_redirects = Gauge(
            f"{ns}_proxy_redirects",
            "Number of redirects installed for endpoints",
            ("protocol",),
        )
        self.policy_l7_total = Counter(
            f"{ns}_policy_l7_total",
            "Number of total L7 requests/responses",
            ("rule",),  # received|forwarded|denied|parse_errors
        )
        self.drop_count = Counter(
            f"{ns}_drop_count_total",
            "Total dropped packets by reason and direction",
            ("reason", "direction"),
        )
        self.forward_count = Counter(
            f"{ns}_forward_count_total",
            "Total forwarded packets by direction",
            ("direction",),
        )
        self.event_ts = Gauge(
            f"{ns}_event_ts",
            "Last timestamp when we received an event",
            ("source",),
        )
        self.verdict_throughput = Gauge(
            f"{ns}_verdicts_per_second",
            "Device verdict throughput (TPU-native metric)",
        )
        self.policy_verdict_total = Counter(
            f"{ns}_policy_verdict_total",
            "Policy verdicts by direction, match type and action",
            ("direction", "match", "action"),
        )
        self.datapath_stage_total = Counter(
            f"{ns}_datapath_stage_total",
            "Datapath stage outcomes by stage and direction "
            "(LB DNAT, CT states, ipcache world fallback, proxy "
            "redirects) folded from the on-device accumulator",
            ("stage", "direction"),
        )
        self.batch_duration = WindowedHistogram(
            f"{ns}_datapath_batch_duration_seconds",
            "Wall time of one datapath batch (dispatch to drained)",
            buckets=(
                0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5,
            ),
        )
        # -- resilience plane (circuit breaker / degraded mode /
        # overload shedding / fault injection) --------------------------
        self.breaker_state = Gauge(
            f"{ns}_circuit_breaker_state",
            "Circuit breaker state (0=closed, 1=open, 2=half-open)",
            ("breaker",),
        )
        self.dispatch_retries_total = Counter(
            f"{ns}_dispatch_retries_total",
            "Device dispatch attempts retried after a failure",
        )
        self.degraded_batches_total = Counter(
            f"{ns}_degraded_batches_total",
            "Batches served by the host-path fallback while the "
            "device dispatch breaker was open or failing",
        )
        self.shed_flows_total = Counter(
            f"{ns}_shed_flows_total",
            "Flows shed by bounded admission under overload",
        )
        self.ct_occupancy = Gauge(
            f"{ns}_ct_occupancy_ratio",
            "Conntrack map occupancy as a fraction of capacity",
        )
        self.ct_emergency_gc_total = Counter(
            f"{ns}_ct_emergency_gc_total",
            "Emergency CT garbage collections triggered by the "
            "occupancy high watermark",
        )
        self.fault_injections_total = Counter(
            f"{ns}_fault_injections_total",
            "Injected faults fired, by site and mode",
            ("site", "mode"),
        )
        self.publish_fallback_total = Counter(
            f"{ns}_publish_fallback_total",
            "Delta publishes that fell back to a full upload "
            "because an armed publish.scatter fault poisoned the "
            "device scatter (real scatter errors de-register the "
            "spare and propagate instead)",
        )
        self.memo_insert_faults_total = Counter(
            f"{ns}_memo_insert_faults_total",
            "Verdict-cache commits dropped by a memo.insert fault; "
            "each such batch re-dispatched through the uncached "
            "program (bit-identity unconditional)",
        )
        # -- per-chip failover plane (engine/failover.py) ----------------
        self.chip_breaker_state = Gauge(
            f"{ns}_chip_breaker_state",
            "Per-chip dispatch breaker state keyed by device ordinal "
            "(0=closed, 1=open, 2=half-open) — the mesh refinement "
            "of cilium_circuit_breaker_state",
            ("chip",),
        )
        self.rerouted_batches_total = Counter(
            f"{ns}_rerouted_batches_total",
            "Batches whose tuple stream was re-split across "
            "surviving chips because at least one chip's breaker "
            "was open",
        )
        self.replica_gather_total = Counter(
            f"{ns}_replica_gather_total",
            "Tuples whose routed table gather was served from a "
            "backup (N+1 replica) shard region because the primary "
            "owner's breaker was open",
        )
        self.rebalance_bytes_h2d_total = Counter(
            f"{ns}_rebalance_bytes_h2d_total",
            "Bytes scattered host->device by chip re-admission "
            "rebalances (replaying the rows a chip missed while its "
            "breaker was open, through the delta-scatter path)",
        )
        # -- verdict memoization plane (engine/memo.py) ------------------
        self.verdict_cache_hits_total = Counter(
            f"{ns}_verdict_cache_hits_total",
            "Tuples whose policy verdict was served from the "
            "device-resident verdict cache (lattice gathers skipped)",
        )
        self.verdict_cache_misses_total = Counter(
            f"{ns}_verdict_cache_misses_total",
            "Tuples whose policy key missed the verdict cache and "
            "was evaluated through the lattice",
        )
        self.verdict_cache_insertions_total = Counter(
            f"{ns}_verdict_cache_insertions_total",
            "Entries inserted into the verdict cache (missed "
            "representatives after intra-batch dedup)",
        )
        self.verdict_cache_flushes_total = Counter(
            f"{ns}_verdict_cache_flushes_total",
            "Verdict-cache flushes (epoch-stamp change on a delta "
            "publish / repack / partition change, or a chip "
            "kill/readmission)",
        )
        # -- continuous serving plane (serve.py) -----------------
        self.serve_queue_depth = Gauge(
            f"{ns}_serve_queue_depth",
            "Flows queued in the serving plane's ingest queue, per "
            "tenant (the dynamic-batching backlog)",
            ("tenant",),
        )
        self.serve_queue_delay_seconds = WindowedHistogram(
            f"{ns}_serve_queue_delay_seconds",
            "Per-flow time from submission to device dispatch in "
            "the serving plane (the batching wait the SLO bounds)",
            buckets=(
                0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5,
            ),
        )
        self.serve_latency_seconds = WindowedHistogram(
            f"{ns}_serve_latency_seconds",
            "Per-submission time from submission to completed reply "
            "in the serving plane (what serving_p99_ms summarizes)",
            buckets=(
                0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0,
            ),
        )
        self.serving_p99_ms = Gauge(
            f"{ns}_serving_p99_ms",
            "p99 submission-to-reply latency over the serving "
            "plane's rolling window, milliseconds",
        )
        self.serve_batch_fill_pct = Gauge(
            f"{ns}_serve_batch_fill_pct",
            "Valid-tuple fill of the most recent coalesced device "
            "batch (100 = the jit class dispatched full)",
        )
        self.serve_batches_total = Counter(
            f"{ns}_serve_batches_total",
            "Coalesced device batches dispatched by the serving "
            "plane",
        )
        self.serve_deadline_dispatch_total = Counter(
            f"{ns}_serve_deadline_dispatch_total",
            "Serving-plane batches dispatched EARLY (below the "
            "target fill) because the oldest queued flow's deadline "
            "no longer allowed waiting, by the SLO class of the "
            "flow that forced it (\"default\" = no named class)",
            ("slo_class",),
        )
        self.serve_admitted_flows_total = Counter(
            f"{ns}_serve_admitted_flows_total",
            "Flows admitted into the serving plane's ingest queue, "
            "per tenant",
            ("tenant",),
        )
        self.serve_shed_flows_total = Counter(
            f"{ns}_serve_shed_flows_total",
            "Flows shed by the serving plane under the canonical "
            "Overload drop reason, per tenant (backlog bound or "
            "admission gate)",
            ("tenant",),
        )
        # -- shadow policy rollout / verdict-diff canarying
        # (shadow.py) --------------------------------------------
        self.policy_diff_sampled_total = Counter(
            f"{ns}_policy_diff_sampled_total",
            "Flows sampled into the armed shadow window and "
            "dual-epoch evaluated (folded exactly once each; "
            "refused in-flight samples count in "
            "policy_diff_refused_total instead)",
        )
        self.policy_diff_changed_total = Counter(
            f"{ns}_policy_diff_changed_total",
            "Sampled flows whose verdict column differs between the "
            "live and shadow policy worlds, by column and direction",
            ("column", "direction"),
        )
        self.policy_diff_flows_allow_to_deny_total = Counter(
            f"{ns}_policy_diff_flows_allow_to_deny_total",
            "Sampled flows the live world allows that the shadow "
            "world would deny (the blast-radius line of a pending "
            "policy change)",
        )
        self.policy_diff_flows_deny_to_allow_total = Counter(
            f"{ns}_policy_diff_flows_deny_to_allow_total",
            "Sampled flows the live world denies that the shadow "
            "world would allow (the exposure line of a pending "
            "policy change)",
        )
        self.policy_diff_stale_total = Counter(
            f"{ns}_policy_diff_stale_total",
            "Shadow diff windows closed with an explicit stale "
            "status because a publish moved the live world past the "
            "pinned epoch stamp (a diff never silently spans a "
            "third world)",
        )
        self.policy_diff_refused_total = Counter(
            f"{ns}_policy_diff_refused_total",
            "Sampled shadow dispatches refused instead of folded "
            "(window closed while the sample was in flight, shadow "
            "evaluation failure, or a drain-side failover dropped "
            "the shadow columns) — exactly-once accounting's "
            "complement to policy_diff_sampled_total",
        )
        # -- flow observability plane (flow.py) ------------------
        self.flow_records_captured_total = Counter(
            f"{ns}_flow_records_captured_total",
            "Flow records accounted by the capture fold, by verdict "
            "(every drop counts here even when a drop storm exceeds "
            "ring capacity — the excess shows in flow_store_evicted)",
            ("verdict",),
        )
        self.flow_store_evicted = Gauge(
            f"{ns}_flow_store_evicted",
            "Flow records lost to the bounded FlowStore ring "
            "(overflow eviction + drop-storm truncation): what a "
            "late reader can no longer see",
        )
        # -- delta table publication (engine/publish.py) -----------------
        self.table_publish_total = Counter(
            f"{ns}_table_publish_total",
            "Device table-epoch publications by mode (delta = "
            "in-place scatter of the changed rows, full = whole "
            "upload)",
            ("mode",),
        )
        self.table_publish_bytes = Counter(
            f"{ns}_table_publish_bytes_total",
            "Bytes shipped host->device by table publications, "
            "by mode",
            ("mode",),
        )
        self.table_publish_seconds = Gauge(
            f"{ns}_table_publish_last_seconds",
            "Wall seconds of the most recent device table "
            "publication",
        )
        # -- device-resource accounting (publish layer + jitted entry
        # points): HBM growth and recompile storms in one scrape ---------
        self.device_table_bytes = Gauge(
            f"{ns}_device_table_bytes",
            "Device-resident policy-table bytes per epoch slot "
            "(live = the serving epoch, standby = the double-buffered "
            "spare awaiting the next delta scatter)",
            ("epoch",),
        )
        self.device_table_bytes_per_chip = Gauge(
            f"{ns}_device_table_bytes_per_chip",
            "Device-resident policy-table bytes per mesh chip "
            "(live + standby epochs), sampled at publish — the "
            "per-shard HBM line behind the universe_max_identities "
            "headroom model (identity-sharded tables divide across "
            "chips; replicated leaves repeat on every chip)",
            ("chip",),
        )
        self.device_table_retired_bytes = Counter(
            f"{ns}_device_table_donation_retired_bytes_total",
            "Bytes of standby-epoch buffers consumed (donated in "
            "place) by delta publications — HBM reused, not "
            "reallocated",
        )
        self.jit_cache_hits = Counter(
            f"{ns}_jit_cache_hits",
            "Calls into an instrumented jitted entry point served "
            "from the executable cache, by site",
            ("site",),
        )
        self.jit_cache_misses = Counter(
            f"{ns}_jit_cache_misses",
            "Calls into an instrumented jitted entry point that "
            "grew the executable cache (fresh XLA trace+compile), "
            "by site",
            ("site",),
        )
        self.jit_compile_seconds = Counter(
            f"{ns}_jit_cache_compile_seconds",
            "Wall seconds spent in cache-growing calls (compile + "
            "first execution), by site — the recompile-storm signal",
            ("site",),
        )
        # -- trace plane (tracing.py) -----------------------------
        self.trace_spans_total = Gauge(
            f"{ns}_trace_spans_total",
            "Spans exported to the trace ring since process start "
            "(sampled from the tracer at span-export points)",
        )
        self.trace_spans_dropped = Gauge(
            f"{ns}_trace_spans_dropped",
            "Spans lost to the bounded trace ring (oldest-first "
            "eviction): what a late /debug/traces reader can no "
            "longer see",
        )
        # -- phase spans + mesh telemetry --------------------------------
        self.spanstat_seconds = Gauge(
            f"{ns}_spanstat_seconds",
            "Accumulated wall seconds per SpanStat phase "
            "(success + failure), mirroring /debug/profile",
            ("scope", "phase"),
        )
        self.telemetry_per_chip = Counter(
            f"{ns}_datapath_telemetry_per_chip_total",
            "Per-chip datapath stage histogram on a sharded mesh "
            "(TELEM_* column names); summing a column over `chip` "
            "equals the mesh-total counters",
            ("chip", "column", "direction"),
        )
        # -- live performance plane (perfplane.py) ----------------
        self.serve_phase_seconds = Gauge(
            f"{ns}_serve_phase_seconds",
            "Decaying-window quantiles of per-batch serve-loop phase "
            "durations (pack = host staging, dispatch = jit enqueue, "
            "drain = blocked on device readback, device = enqueue + "
            "drain, fold = drain-side event/flow/metric fold, wall = "
            "plan-to-reply), stat in p50|p99|max",
            ("phase", "stat"),
        )
        self.serve_batch_fill_window_pct = Gauge(
            f"{ns}_serve_batch_fill_window_pct",
            "Decaying-window quantiles of coalesced-batch fill "
            "(serve_batch_fill_pct promoted from last-value to the "
            "perf plane's window), stat in p50|p99|max",
            ("stat",),
        )
        self.serve_queue_delay_window_seconds = Gauge(
            f"{ns}_serve_queue_delay_window_seconds",
            "Decaying-window quantiles of per-span queue delay "
            "(serve_queue_delay_seconds promoted to the perf "
            "plane's window), stat in p50|p99|max",
            ("stat",),
        )
        self.serve_ingest_stall_seconds = Counter(
            f"{ns}_serve_ingest_stall_seconds_total",
            "Wall seconds the serve loop spent waiting with a "
            "NONEMPTY ingest queue while nothing was in flight on "
            "the device (the ingest-starvation accumulator: the "
            "device idles because the host trickle-feeds it)",
        )
        self.serve_slo_deadline_total = Counter(
            f"{ns}_serve_slo_deadline_total",
            "Completed serving-plane submissions by deadline "
            "outcome (hit = replied within the submission's "
            "deadline, miss = reply landed late or flows shed), "
            "per tenant and SLO class",
            ("tenant", "slo_class", "outcome"),
        )
        self.serve_slo_error_budget_burn = Gauge(
            f"{ns}_serve_slo_error_budget_burn",
            "Per-tenant error-budget burn rate: windowed deadline "
            "miss fraction over the SLO class's allowed miss "
            "fraction (1 - objective); > 1 burns budget faster "
            "than the class allows",
            ("tenant",),
        )
        self.perf_model_bytes_per_tuple = Gauge(
            f"{ns}_perf_model_bytes_per_tuple",
            "The gatherprof byte model evaluated LIVE against the "
            "published layout stamp: hot = modeled hot-plane gather "
            "bytes, cold = dense-fallback bytes, effective = hot "
            "under the observed dedup/cache-hit factors",
            ("plane",),
        )
        self.perf_model_gbps = Gauge(
            f"{ns}_perf_model_gbps",
            "Modeled sustained gather bandwidth: effective "
            "bytes-per-tuple x the serving plane's measured "
            "verdicts/s EWMA (model x measurement, not a "
            "measurement)",
        )
        self.retune_total = Counter(
            f"{ns}_retune_total",
            "Online re-tune layout swaps applied by "
            "engine.autotune.online_retune, by drift trigger "
            "(p99_drift | fill_low | stall | forced)",
            ("trigger",),
        )
        self.datapath_persistent_launches = Counter(
            f"{ns}_datapath_persistent_launches_total",
            "Fused persistent-program launches (each covers K "
            "staged batch pairs in one device program)",
        )
        self.datapath_persistent_pairs = Counter(
            f"{ns}_datapath_persistent_pairs_total",
            "Batch pairs staged into the persistent fused program "
            "(pairs/launches = realized staging depth)",
        )
        self.reshard_total = Counter(
            f"{ns}_reshard_total",
            "Live elastic reshard migrations by outcome (cutover | "
            "rollback | restart_full)",
            ("outcome",),
        )
        self.reshard_bytes_h2d_total = Counter(
            f"{ns}_reshard_bytes_h2d_total",
            "Bytes streamed host->device by reshard migration "
            "steps (moved-owner rows only; the stop-the-world "
            "comparator would ship the whole world)",
        )
        self.reshard_steps_total = Counter(
            f"{ns}_reshard_steps_total",
            "Bounded-byte migration steps executed by reshard "
            "plans (each step scatters at most step_bytes into the "
            "staged target epoch)",
        )
        self.reshard_seconds = Histogram(
            f"{ns}_reshard_seconds",
            "End-to-end reshard migration duration, plan begin "
            "through cutover or rollback",
        )

    def expose(self) -> str:
        lines: List[str] = []
        for attr in vars(self).values():
            if isinstance(attr, (Counter, Gauge, Histogram)):
                lines.extend(attr.expose())
        return "\n".join(lines) + "\n"


# process-global registry, like pkg/metrics's default registry
registry = Registry()
