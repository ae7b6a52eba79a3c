"""Daemon configuration: the fields the policy layer reads.

The port's copy of the part of the JAX package's option.py that rule
resolution needs (`policy/rule_resolve.py` `_l3_override_endpoints`):
the `DaemonConfig` fields `allow_localhost` and `host_allows_world`,
`always_allow_localhost()`, and the process-global `Config`
(pkg/option/config.go).  The option library, the mutable option map
and the compiler cache key wait for the daemon.
"""

from __future__ import annotations

from dataclasses import dataclass

# AllowLocalhost modes (pkg/option/config.go)
ALLOW_LOCALHOST_AUTO = "auto"
ALLOW_LOCALHOST_ALWAYS = "always"
ALLOW_LOCALHOST_POLICY = "policy"


@dataclass
class DaemonConfig:
    """Global daemon configuration (pkg/option/config.go)."""

    allow_localhost: str = ALLOW_LOCALHOST_AUTO
    # HostAllowsWorld: legacy 1.0 behaviour, world shares host policy
    # (config.go:183).
    host_allows_world: bool = False

    def always_allow_localhost(self) -> bool:
        """config.go:277."""
        return self.allow_localhost == ALLOW_LOCALHOST_ALWAYS


# The process-global config, mirroring option.Config.
Config = DaemonConfig()
