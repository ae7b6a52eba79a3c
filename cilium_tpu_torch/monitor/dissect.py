"""Monitor payload dissection — the `cilium monitor -v` renderer.

Behavioral analog of Cilium's pkg/monitor/dissect.go (+ the
per-event formatters of pkg/monitor/{drop,trace,logrecord}.go): the
reference decodes the raw packet bytes riding each perf event into a
connection summary ("tcp 10.1.2.3:80 -> 10.4.5.6:4001") and renders
each notification as one human line.  This framework's "payload" is
the native 24-byte flow record (native/tupledec.cpp `struct
flow_record`): `dissect_flow_buffer` walks a record buffer through the
record decoder and emits the same connection-summary shape, and
`dissect_event` renders monitor events the way the reference's
monitor formatters do.  The port's copy of the JAX package's module,
over the port's numpy record decoder (native/loader.py).
"""

from __future__ import annotations

import ipaddress
from typing import Iterator, List

from cilium_tpu_torch.monitor.events import drop_reason_name

_PROTO_NAMES = {1: "icmp", 6: "tcp", 17: "udp", 58: "icmpv6"}


def proto_name(proto: int) -> str:
    return _PROTO_NAMES.get(int(proto), str(int(proto)))


def _ip(addr: int) -> str:
    return str(ipaddress.IPv4Address(int(addr) & 0xFFFFFFFF))


def connection_summary(
    saddr: int, daddr: int, sport: int, dport: int, proto: int
) -> str:
    """GetConnectionSummary's output shape for one flow tuple."""
    return (
        f"{proto_name(proto)} "
        f"{_ip(saddr)}:{int(sport)} -> {_ip(daddr)}:{int(dport)}"
    )


def dissect_flow_buffer(buf: bytes) -> Iterator[str]:
    """Decode a native flow-record buffer (tupledec.cpp records) and
    yield one dissected line per record — the Dissect(true, data)
    path over this framework's wire format."""
    from cilium_tpu_torch.native.loader import decode_flow_records

    rec = decode_flow_records(buf)
    n = len(rec["saddr"])
    for i in range(n):
        direction = "ingress" if int(rec["direction"][i]) == 0 else "egress"
        yield (
            f"{connection_summary(rec['saddr'][i], rec['daddr'][i], rec['sport'][i], rec['dport'][i], rec['proto'][i])} "
            f"{direction} ep={int(rec['ep_id'][i])} "
            f"identity={int(rec['identity'][i])}"
        )


def dissect_event(ev: dict) -> str:
    """One monitor event (the REST stream's JSON form) → the
    reference's one-line monitor rendering."""
    kind = ev.get("event", "")
    if kind == "DropNotify":
        # "xx drop (reason) flow ... to endpoint N" (drop.go)
        return (
            f"xx drop ({drop_reason_name(-abs(int(ev.get('reason', 0))))}) "
            f"to endpoint {ev.get('source', 0)}, "
            f"identity {ev.get('src_label', 0)}"
        )
    if kind == "TraceNotify":
        # "-> endpoint N flow ..." (trace.go observation points)
        return (
            f"-> endpoint {ev.get('dst_id', 0)} "
            f"from endpoint {ev.get('source', 0)}, "
            f"identity {ev.get('src_label', 0)}"
        )
    if kind == "PolicyVerdictNotify":
        action = "allow" if ev.get("allowed") else "deny"
        direction = "ingress" if ev.get("ingress") else "egress"
        line = (
            f"Policy verdict log: flow to endpoint "
            f"{ev.get('source', 0)}, {direction}, "
            f"identity {ev.get('src_label', 0)}, "
            f"dport {ev.get('dport', 0)}/"
            f"{proto_name(ev.get('proto', 0))}, action {action}"
        )
        if ev.get("proxy_port"):
            line += f", redirected to proxy {ev['proxy_port']}"
        return line
    if kind == "LogRecordNotify":
        return (
            f"{ev.get('l7_proto', 'l7')} "
            f"{ev.get('verdict', '')} {ev.get('info', '')}".rstrip()
        )
    if kind == "AgentNotify":
        return f"agent: {ev.get('text', '')}"
    # unknown kinds render their raw fields, never drop silently
    return f"{kind or 'unknown'}: {ev}"


def dissect_events(events: List[dict]) -> List[str]:
    return [dissect_event(ev) for ev in events]
