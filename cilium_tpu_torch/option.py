"""Runtime configuration system.

The port's own copy of the JAX package's option.py, with the
DaemonConfig fields the port reads (the compiler cache key and its
padding knobs, dry mode and the device batch wait for the daemon).
`Config` is one process-global per package: a test that sets one
package's fields sets the other's too, and restores both.

Re-design of pkg/option/{config.go,option.go,
runtime_options.go,monitor.go}: a global DaemonConfig plus an option
LIBRARY — per-option descriptors carrying a define symbol, a
description, dependency requirements, and optional parse/verify/format
hooks — over a mutable option map with dependency propagation
(option.go:419 enabling an option enables what it requires;
option.go:445 disabling one disables its dependents).

Each endpoint carries an OptionMap overlay (Endpoint.opts); the
daemon's runtime option patch that reads them waits for the daemon's
API.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# Policy enforcement modes (pkg/option/config.go)
DEFAULT_ENFORCEMENT = "default"
ALWAYS_ENFORCE = "always"
NEVER_ENFORCE = "never"

# AllowLocalhost modes
ALLOW_LOCALHOST_AUTO = "auto"
ALLOW_LOCALHOST_ALWAYS = "always"
ALLOW_LOCALHOST_POLICY = "policy"

# Mutable option names (pkg/option/runtime_options.go)
POLICY_TRACING = "PolicyTracing"
DEBUG = "Debug"
DEBUG_LB = "DebugLB"
DROP_NOTIFICATION = "DropNotification"
TRACE_NOTIFICATION = "TraceNotification"
POLICY_VERDICT_NOTIFICATION = "PolicyVerdictNotification"
CONNTRACK = "Conntrack"
CONNTRACK_ACCOUNTING = "ConntrackAccounting"
CONNTRACK_LOCAL = "ConntrackLocal"
MONITOR_AGGREGATION = "MonitorAggregationLevel"
NAT46 = "NAT46"

# MonitorAggregationLevel settings (pkg/option/monitor.go): 0 = every
# packet traced; higher = progressively aggregated
MONITOR_AGG_NONE = 0
MONITOR_AGG_LOWEST = 1
MONITOR_AGG_LOW = 2
MONITOR_AGG_MEDIUM = 3
MONITOR_AGG_MAX = MONITOR_AGG_MEDIUM

_MONITOR_AGG_NAMES = {
    "": MONITOR_AGG_NONE,
    "none": MONITOR_AGG_NONE,
    "disabled": MONITOR_AGG_NONE,
    "lowest": MONITOR_AGG_LOWEST,
    "low": MONITOR_AGG_LOW,
    "medium": MONITOR_AGG_MEDIUM,
    "max": MONITOR_AGG_MAX,
    "maximum": MONITOR_AGG_MAX,
}


def _parse_bool(value) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int) and value in (0, 1):
        return value
    if isinstance(value, str):
        low = value.strip().lower()
        if low in ("true", "on", "enable", "enabled", "1"):
            return 1
        if low in ("false", "off", "disable", "disabled", "0"):
            return 0
    raise ValueError(f"expected a boolean, got {value!r}")


def parse_monitor_aggregation(value) -> int:
    """ParseMonitorAggregationLevel (monitor.go): names or 0..3."""
    if isinstance(value, bool):
        return MONITOR_AGG_MAX if value else MONITOR_AGG_NONE
    if isinstance(value, int):
        if 0 <= value <= MONITOR_AGG_MAX:
            return value
        raise ValueError(
            f"invalid monitor aggregation level {value!r}"
        )
    if isinstance(value, str):
        low = value.strip().lower()
        if low in _MONITOR_AGG_NAMES:
            return _MONITOR_AGG_NAMES[low]
        if low.isdigit() and 0 <= int(low) <= MONITOR_AGG_MAX:
            return int(low)
    raise ValueError(f"invalid monitor aggregation level {value!r}")


def format_monitor_aggregation(value: int) -> str:
    for name, v in _MONITOR_AGG_NAMES.items():
        if v == value and name not in ("", "disabled", "maximum"):
            return name
    return str(value)


def _verify_nat46(key: str, value) -> None:
    if _parse_bool(value):
        # the reference gates NAT46 on IPv4 being enabled
        # (runtime_options.go ErrNAT46ReqIPv4); this datapath has no
        # NAT46 lowering yet, so enabling it must fail loudly rather
        # than silently do nothing
        raise ValueError(
            "NAT46 translation is not supported by this datapath"
        )


@dataclass(frozen=True)
class OptionSpec:
    """One library entry (option.go:41 Option)."""

    define: str  # the compile-key symbol (≙ the BPF #define)
    description: str
    requires: Tuple[str, ...] = ()
    parse: Callable = _parse_bool
    verify: Optional[Callable] = None
    format: Callable = lambda v: "Enabled" if v else "Disabled"


# DaemonMutableOptionLibrary (pkg/option/daemon.go:28) + the
# policy-verdict option later reference versions add
DAEMON_MUTABLE_OPTION_LIBRARY: Dict[str, OptionSpec] = {
    CONNTRACK: OptionSpec(
        "CONNTRACK", "Enable stateful connection tracking"
    ),
    CONNTRACK_ACCOUNTING: OptionSpec(
        "CONNTRACK_ACCOUNTING",
        "Enable per flow (conntrack) statistics",
        requires=(CONNTRACK,),
    ),
    CONNTRACK_LOCAL: OptionSpec(
        "CONNTRACK_LOCAL",
        "Use endpoint dedicated tracking table instead of global one",
        requires=(CONNTRACK,),
    ),
    DEBUG: OptionSpec(
        "DEBUG", "Enable debugging trace statements"
    ),
    DEBUG_LB: OptionSpec(
        "LB_DEBUG",
        "Enable debugging trace statements for load balancer",
    ),
    DROP_NOTIFICATION: OptionSpec(
        "DROP_NOTIFY", "Enable drop notifications"
    ),
    TRACE_NOTIFICATION: OptionSpec(
        "TRACE_NOTIFY", "Enable trace notifications"
    ),
    POLICY_VERDICT_NOTIFICATION: OptionSpec(
        "POLICY_VERDICT_NOTIFY",
        "Enable policy verdict notifications",
    ),
    MONITOR_AGGREGATION: OptionSpec(
        "MONITOR_AGGREGATION",
        "Set the level of aggregation for monitor events in the "
        "datapath",
        parse=parse_monitor_aggregation,
        format=format_monitor_aggregation,
    ),
    NAT46: OptionSpec(
        "ENABLE_NAT46",
        "Enable automatic NAT46 translation",
        requires=(CONNTRACK,),
        verify=_verify_nat46,
    ),
}

# DaemonOptionLibrary = mutable + PolicyTracing (daemon.go:24)
DAEMON_OPTION_LIBRARY: Dict[str, OptionSpec] = {
    **DAEMON_MUTABLE_OPTION_LIBRARY,
    POLICY_TRACING: OptionSpec(
        "POLICY_TRACING", "Enable tracing of policy decisions"
    ),
}


class OptionMap(dict):
    """Named options with parse/verify + dependency propagation
    (option.go:41 IntOptions over an OptionLibrary)."""

    library: Dict[str, OptionSpec] = DAEMON_OPTION_LIBRARY

    def is_enabled(self, name: str) -> bool:
        return bool(self.get(name, 0))

    def level(self, name: str) -> int:
        return int(self.get(name, 0))

    def parse_validate(self, name: str, value) -> int:
        """Library parse + verify for one (name, value); raises on
        unknown options or invalid values WITHOUT mutating."""
        spec = self.library.get(name)
        if spec is None:
            raise ValueError(f"unknown option {name}")
        parsed = spec.parse(value)
        if spec.verify is not None:
            spec.verify(name, value)
        return parsed

    def apply(self, changes: Dict[str, object],
              changed_hook: Optional[Callable] = None) -> int:
        """Parse/verify every change first, then apply with
        dependency propagation: enabling an option enables what it
        requires (option.go:419); disabling one disables dependents
        (option.go:445)."""
        parsed = {
            k: self.parse_validate(k, v) for k, v in changes.items()
        }
        n = 0

        def _set(k: str, v: int) -> None:
            nonlocal n
            if self.get(k, 0) != v:
                self[k] = v
                n += 1
                if changed_hook:
                    changed_hook(k, v)

        for k, v in parsed.items():
            spec = self.library[k]
            if v:
                for dep in spec.requires:
                    _set(dep, 1)
            else:
                for name, other in self.library.items():
                    if k in other.requires:
                        _set(name, 0)
            _set(k, v)
        return n

    def describe(self) -> Dict[str, Dict[str, str]]:
        """The option library rendered for GET /config."""
        return {
            name: {
                "define": spec.define,
                "description": spec.description,
                "requires": list(spec.requires),
                "value": spec.format(self.get(name, 0)),
            }
            for name, spec in sorted(self.library.items())
        }


def default_opts() -> OptionMap:
    """Boot-time defaults, as the reference daemon enables them
    (daemon bootstrap: conntrack + accounting + drop/trace
    notifications on)."""
    opts = OptionMap()
    opts.update(
        {
            CONNTRACK: 1,
            CONNTRACK_ACCOUNTING: 1,
            DROP_NOTIFICATION: 1,
            TRACE_NOTIFICATION: 1,
            # per-packet traces only when an operator dials the
            # aggregation down to `none`: the monitor fold is a
            # host-side Python loop, so the default keeps its cost on
            # the denied/sampled slice only
            MONITOR_AGGREGATION: MONITOR_AGG_MEDIUM,
        }
    )
    return opts


@dataclass
class DaemonConfig:
    """Global daemon configuration (pkg/option/config.go)."""

    policy_enforcement: str = DEFAULT_ENFORCEMENT
    allow_localhost: str = ALLOW_LOCALHOST_AUTO
    # HostAllowsWorld: legacy 1.0 behaviour, world shares host policy
    # (config.go:183).
    host_allows_world: bool = False
    # EndpointGenerationTimeout (pkg/endpoint/bpf.go:442): how long a
    # regeneration waits for proxy redirect ACKs before failing and
    # keeping old state
    redirect_ack_timeout: float = 30.0
    opts: OptionMap = field(default_factory=default_opts)

    def always_allow_localhost(self) -> bool:
        """config.go:277."""
        return self.allow_localhost == ALLOW_LOCALHOST_ALWAYS


# The process-global config, mirroring option.Config.
Config = DaemonConfig()
