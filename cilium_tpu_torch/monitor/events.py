"""Monitor event payload types.

Port of Cilium's pkg/monitor/{datapath_drop.go,datapath_trace.go,
agent.go} payloads and the bpf-side structs they decode
(bpf/lib/drop.h:40 drop_notify, bpf/lib/trace.h trace_notify).
Message type ids follow bpf/lib/common.h:209-215.  The port's copy of
the JAX package's module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

# bpf/lib/common.h:209-215
NOTIFY_UNSPEC = 0
NOTIFY_DROP = 1
NOTIFY_DBG_MSG = 2
NOTIFY_DBG_CAPTURE = 3
NOTIFY_TRACE = 4
# agent-level messages (pkg/monitor/messages.go)
NOTIFY_AGENT = 5
NOTIFY_LOG_RECORD = 6
NOTIFY_POLICY_VERDICT = 7

# bpf/lib/common.h:237-269 drop reasons (negative datapath returns).
DROP_REASONS: Dict[int, str] = {
    -130: "Invalid source mac",
    -131: "Invalid destination mac",
    -132: "Invalid source ip",
    -133: "Policy denied (L3)",
    -134: "Invalid packet",
    -135: "CT: Truncated or invalid header",
    -136: "CT: Missing ACK in known connection",
    -137: "CT: Unknown L4 protocol",
    -138: "CT: Can't create entry from packet",
    -139: "Unsupported L3 protocol",
    -140: "Missed tail call",
    -141: "Error writing to packet",
    -142: "Unknown L4 protocol",
    -143: "Unknown ICMPv4 code",
    -144: "Unknown ICMPv4 type",
    -145: "Unknown ICMPv6 code",
    -146: "Unknown ICMPv6 type",
    -147: "Error retrieving tunnel key",
    -148: "Error retrieving tunnel options",
    -149: "Invalid Geneve option",
    -150: "Unknown L3 target address",
    -151: "Not a local target address",
    -152: "No matching local container found",
    -153: "Error while correcting L3 checksum",
    -154: "Error while correcting L4 checksum",
    -155: "CT: Map insertion failed",
    -156: "Invalid IPv6 extension header",
    -157: "Fragmentation needed",
    -158: "No matching service",
    -159: "Policy denied (L4)",
    -160: "No tunnel/encapsulation endpoint",
    -161: "Failed to insert into proxymap",
    -162: "Policy denied (CIDR)",
    # framework extension: bounded-admission overload shedding (the
    # serving plane drops with attribution instead of queueing
    # unboundedly; no bpf/lib/common.h analog in the snapshot ported)
    -163: "Overload",
}

DROP_OVERLOAD = -163


def drop_reason_name(code: int) -> str:
    """pkg/monitor/datapath_drop.go dropReason."""
    return DROP_REASONS.get(code, f"unknown ({code})")


@dataclass
class DropNotify:
    """drop_notify (bpf/lib/drop.h:40)."""

    source: int  # endpoint id
    hash: int = 0
    orig_len: int = 0
    cap_len: int = 0
    src_label: int = 0
    dst_label: int = 0
    dst_id: int = 0
    reason: int = 0  # positive DROP_* magnitude (common.h sign flip)
    ifindex: int = 0

    type: int = NOTIFY_DROP


# trace observation points (bpf/lib/trace.h:30-47)
TRACE_TO_LXC = 0
TRACE_TO_PROXY = 1
TRACE_TO_HOST = 2
TRACE_TO_STACK = 3
TRACE_TO_OVERLAY = 4
TRACE_FROM_LXC = 5
TRACE_FROM_PROXY = 6
TRACE_FROM_HOST = 7
TRACE_FROM_STACK = 8
TRACE_FROM_OVERLAY = 9
TRACE_FROM_NETWORK = 10


@dataclass
class TraceNotify:
    """trace_notify (bpf/lib/trace.h:84 send_trace_notify)."""

    source: int
    obs_point: int = TRACE_TO_LXC
    hash: int = 0
    orig_len: int = 0
    cap_len: int = 0
    src_label: int = 0
    dst_label: int = 0
    dst_id: int = 0
    reason: int = 0
    ifindex: int = 0

    type: int = NOTIFY_TRACE


@dataclass
class PolicyVerdictNotify:
    """Per-tuple verdict record (the PolicyVerdictNotification option,
    pkg/option; payload shaped after the drop/trace structs)."""

    source: int
    src_label: int
    dst_label: int
    dport: int
    proto: int
    ingress: bool
    allowed: bool
    proxy_port: int = 0
    match_kind: int = 0

    type: int = NOTIFY_POLICY_VERDICT


@dataclass
class AgentNotify:
    """pkg/monitor/agent.go:27: agent-level event (policy updated,
    endpoint created/deleted, ...)."""

    kind: str
    text: str = ""

    type: int = NOTIFY_AGENT


@dataclass
class LogRecordNotify:
    """L7 access-log record reference (pkg/proxy/accesslog)."""

    endpoint_id: int
    l7_proto: str
    verdict: str
    info: str = ""

    type: int = NOTIFY_LOG_RECORD
