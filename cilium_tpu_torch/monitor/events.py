"""Monitor event names the telemetry fold needs, and the L7 access-log
record.

The port's copy of the reference's `DROP_REASONS` table and
`drop_reason_name` (monitor/events.py): the canonical bpf/lib/common.h
drop-reason strings that `cilium monitor` prints and that label
cilium_drop_count_total; and `LogRecordNotify`, the proxy's access-log
record (pkg/proxy/accesslog), with its message type id.  The other
event payload types and the monitor bus wait for the observability
plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# agent-level message type of an access-log record (pkg/monitor/messages.go)
NOTIFY_LOG_RECORD = 6

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
class LogRecordNotify:
    """L7 access-log record reference (pkg/proxy/accesslog)."""

    endpoint_id: int
    l7_proto: str
    verdict: str
    info: str = ""

    type: int = NOTIFY_LOG_RECORD
