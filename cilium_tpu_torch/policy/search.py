"""Search context and policy decisions.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/policy.go (SearchContext, trace)
and pkg/policy/api/decision.go.  The trace buffer reproduces the
reference's `cilium policy trace` output format so explain-mode goldens
are comparable.
"""

from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from cilium_tpu_torch.labels import LabelArray


class Decision(enum.IntEnum):
    """api/decision.go: Undecided / Allowed / Denied."""

    UNDECIDED = 0
    ALLOWED = 1
    DENIED = 2

    def __str__(self) -> str:
        return {0: "undecided", 1: "allowed", 2: "denied"}[int(self)]


class Tracing(enum.IntEnum):
    """policy.go:29."""

    DISABLED = 0
    ENABLED = 1
    VERBOSE = 2


@dataclass
class Port:
    """api/v1 models.Port: a destination port in the search context."""

    port: int
    protocol: str = "ANY"  # "TCP" | "UDP" | "ANY" | ""


@dataclass
class SearchContext:
    """policy.go:64: the question being asked of the repository.

    ``from_labels``/``to_labels`` of None mirror the reference's nil
    LabelArray (relevant in mergeL4Ingress's ctx.From != nil check,
    rule.go:152).
    """

    from_labels: Optional[LabelArray] = None
    to_labels: Optional[LabelArray] = None
    dports: List[Port] = field(default_factory=list)
    trace: Tracing = Tracing.DISABLED
    depth: int = 0
    logging: Optional[io.StringIO] = None

    def policy_trace(self, fmt: str, *args) -> None:
        """policy.go:39 (format string compatible)."""
        if self.trace in (Tracing.ENABLED, Tracing.VERBOSE):
            if self.logging is not None:
                pad = "" .ljust(self.depth * 2)
                self.logging.write(pad + (fmt % args if args else fmt))

    def policy_trace_verbose(self, fmt: str, *args) -> None:
        """policy.go:53."""
        if self.trace == Tracing.VERBOSE and self.logging is not None:
            self.logging.write(fmt % args if args else fmt)

    def __str__(self) -> str:
        frm = ", ".join(str(l) for l in (self.from_labels or []))
        to = ", ".join(str(l) for l in (self.to_labels or []))
        ret = f"From: [{frm}] => To: [{to}]"
        if self.dports:
            ports = ", ".join(
                f"{p.port}/{p.protocol}" for p in self.dports
            )
            ret += f" Ports: [{ports}]"
        return ret

    def trace_output(self) -> str:
        return self.logging.getvalue() if self.logging is not None else ""
