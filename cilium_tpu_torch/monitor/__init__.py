"""Monitor: the datapath event bus (perf-ring analog).

Re-design of Cilium's monitor/ + pkg/monitor: the datapath emits
DropNotify (bpf/lib/drop.h:40), TraceNotify (bpf/lib/trace.h:84) and
debug events into a perf ring read by cilium-node-monitor and fanned
out to `cilium monitor` clients.  Here the verdict engine's batched
outputs are folded into events on an in-process bus with subscriber
fan-out; a remote-socket transport can wrap the same bus.  The port's
copy of the JAX package's package.
"""

from cilium_tpu_torch.monitor.events import (
    AgentNotify,
    DropNotify,
    LogRecordNotify,
    PolicyVerdictNotify,
    TraceNotify,
    drop_reason_name,
)
from cilium_tpu_torch.monitor.bus import MonitorBus, verdicts_to_events

__all__ = [
    "MonitorBus",
    "DropNotify",
    "TraceNotify",
    "PolicyVerdictNotify",
    "AgentNotify",
    "LogRecordNotify",
    "drop_reason_name",
    "verdicts_to_events",
]
