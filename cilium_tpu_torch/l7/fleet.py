"""Fleet-scoped L7 policy: ONE compiled matcher set for every redirect
(K17b).

The reference hands each redirected flow to its proxy listener, which
enforces the L7 rules of the L4 filter that redirected it
(envoy/cilium_l7policy.cc:193 for HTTP, pkg/proxy/kafka.go:116 for
Kafka).  Here the union DFAs and the Kafka rule columns span the whole
fleet, and a per-flow scope mask (each compiled rule lives in exactly
one (endpoint, direction, L4 slot) scope) restricts matching to the
redirecting filter's rules.  The scope of a redirected flow is read
from the datapath's own outputs: (ep_index, direction, l4_slot).

`compile_fleet_from_specs` is the spec-to-tables tail of the
reference's `compile_fleet_l7`; the walk over a daemon's endpoints
that produces the specs needs the control plane and is not ported.
`evaluate_fleet_l7` is the entry point: CUDA tensors launch FLEET_L7
(kernels.py, csrc/l7.cu), CPU tensors run `evaluate_fleet_l7_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.l7.http import (
    HTTPPolicy,
    HTTPRuleSpec,
    compile_http_rules,
    evaluate_http_batch_plain,
)
from cilium_tpu_torch.l7.kafka import (
    KafkaRuleSpec,
    KafkaTables,
    compile_kafka_rules,
    evaluate_kafka_batch_plain,
)

PARSER_NONE_ID = 0
PARSER_HTTP_ID = 1
PARSER_KAFKA_ID = 2


@dataclass
class FleetL7:
    """Fleet-wide compiled L7 matchers + per-(ep, dir, slot) scoping."""

    http: Optional[HTTPPolicy]
    kafka: Optional[KafkaTables]
    scope_http: np.ndarray  # u32 [E, 2, Kg, Wh] rule-scope bits
    scope_kafka: np.ndarray  # u32 [E, 2, Kg, Wk]
    parser_kind: np.ndarray  # u8 [E, 2, Kg] PARSER_*_ID


def compile_fleet_from_specs(
    http_specs: Sequence[HTTPRuleSpec],
    kafka_specs: Sequence[KafkaRuleSpec],
    parser_kind: np.ndarray,
    n_identities: int,
) -> FleetL7:
    """Compile one fleet-wide matcher set per parser from specs whose
    `scope_key` is (endpoint, direction, L4 slot), with `parser_kind`
    u8 [E, 2, Kg] naming each scope's parser.  Raises on header rules,
    which the device path does not take."""
    e_count, _, kg = parser_kind.shape
    http = (
        compile_http_rules(list(http_specs), n_identities)
        if http_specs else None
    )
    kafka = (
        compile_kafka_rules(list(kafka_specs), n_identities)
        if kafka_specs else None
    )

    def scope_table(rules, n_rules) -> np.ndarray:
        w = max(1, -(-max(n_rules, 1) // 32))
        table = np.zeros((e_count, 2, kg, w), np.uint32)
        for r, spec in enumerate(rules):
            if spec.scope_key is None:
                continue
            e, dirv, j = spec.scope_key
            table[e, dirv, j, r // 32] |= np.uint32(1 << (r % 32))
        return table

    scope_http = scope_table(
        http.device_rules if http else [], http.tables.n_rules if http else 0
    )
    scope_kafka = scope_table(
        kafka.specs if kafka else [], kafka.n_rules if kafka else 0
    )
    if http and http.host_rules:
        raise ValueError(
            "fleet L7 compile does not support header rules on the "
            "device path (host_rules present)"
        )
    return FleetL7(
        http=http,
        kafka=kafka,
        scope_http=scope_http,
        scope_kafka=scope_kafka,
        parser_kind=np.asarray(parser_kind, np.uint8),
    )


def _take_rows(table: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """table[lin] along dim 0 as the reference's gather reads it: a
    negative index counts from the end, and an index still out of
    range clamps to the nearest row."""
    n = int(table.shape[0])
    lin = torch.where(lin < 0, lin + n, lin).clamp(0, n - 1)
    return table[lin]


def scope_rows(fleet: FleetL7, ep_index, direction, l4_slot) -> torch.Tensor:
    """The flat scope index of each flow: ep * 2Kg + dir * Kg +
    clip(slot, 0, Kg - 1), as int64."""
    kg = int(fleet.parser_kind.shape[2])
    return (
        ep_index.to(torch.int64) * (2 * kg)
        + direction.to(torch.int64) * kg
        + l4_slot.to(torch.int64).clamp(0, kg - 1)
    )


def evaluate_fleet_l7_plain(
    fleet: FleetL7,
    ep_index: torch.Tensor,  # i32 [B]
    direction: torch.Tensor,  # i32 [B]
    l4_slot: torch.Tensor,  # i32 [B] from DatapathVerdicts.l4_slot
    ident_idx: torch.Tensor,  # i32 [B]
    known: torch.Tensor,  # bool [B]
    http_fields: Optional[Tuple] = None,  # (m, ml, p, pl, h, hl)
    kafka_fields: Optional[Tuple] = None,  # pad_kafka_requests order
) -> torch.Tensor:
    """Plain version of K17b (the reference's `evaluate_fleet_l7`, on a
    device-form fleet).  Returns allowed bool [B]; a flow whose scope
    has no parser, or whose parser has no tables or fields, is denied
    (a redirect with no compiled policy fails closed)."""
    lin = scope_rows(fleet, ep_index, direction, l4_slot)
    kind = _take_rows(fleet.parser_kind.reshape(-1), lin)
    allowed = torch.zeros(ep_index.shape, dtype=torch.bool,
                          device=ep_index.device)
    if fleet.http is not None and http_fields is not None:
        wh = int(fleet.scope_http.shape[-1])
        scope = _take_rows(fleet.scope_http.reshape(-1, wh), lin)
        ok, _ = evaluate_http_batch_plain(
            fleet.http.tables, *http_fields, ident_idx, known,
            scope_bits=scope,
        )
        allowed = torch.where(kind == PARSER_HTTP_ID, ok, allowed)
    if fleet.kafka is not None and kafka_fields is not None:
        wk = int(fleet.scope_kafka.shape[-1])
        scope = _take_rows(fleet.scope_kafka.reshape(-1, wk), lin)
        ok = evaluate_kafka_batch_plain(
            fleet.kafka, *kafka_fields, ident_idx, known, scope_bits=scope,
        )
        allowed = torch.where(kind == PARSER_KAFKA_ID, ok, allowed)
    return allowed


def evaluate_fleet_l7(fleet: FleetL7, ep_index, direction, l4_slot,
                      ident_idx, known, http_fields=None,
                      kafka_fields=None) -> torch.Tensor:
    """K17b: L7 verdicts for a batch of redirected flows.  CUDA tensors
    launch FLEET_L7; CPU tensors run the plain version.  Returns
    allowed bool [B]."""
    args = (fleet, ep_index, direction, l4_slot, ident_idx, known)
    if ep_index.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.FLEET_L7(*args, http_fields=http_fields,
                                kafka_fields=kafka_fields)
    if ep_index.device.type == "cpu":
        return evaluate_fleet_l7_plain(*args, http_fields=http_fields,
                                       kafka_fields=kafka_fields)
    raise ValueError(f"unsupported device {ep_index.device}")
