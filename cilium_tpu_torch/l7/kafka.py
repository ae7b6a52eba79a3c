"""Kafka L7 policy: field-equality rule matching (K17a).

The port's own copy of the reference's host compiler and oracle, and
the device side in PyTorch.  Behaviour of pkg/kafka/policy.go:
  - RequestMessage.MatchesRule (policy.go:200): a request is allowed
    if a topic-less (or topic-free-request) rule matches, OR if every
    topic of the request is covered by some matching rule naming it;
  - ruleMatches (policy.go:144): APIKey/Role set membership, exact
    APIVersion (wildcard when unset), ClientID exact (only for the
    request structs that carry one);
  - matchNonTopicRequests (policy.go:54): an unparsed request can
    never satisfy a topic rule if its API key is topic-typed; its
    ClientID is NOT checked (reference TODO GH-3097, reproduced).

Strings (client ids, topics) are interned host-side to u32 ids, so the
device work is integer equality.  `evaluate_kafka_batch` is the entry
point: CUDA tensors launch KAFKA_MATCH (kernels.py, csrc/l7.cu), CPU
tensors run `evaluate_kafka_batch_plain`, the reference's [B, R] and
[B, T, R] compares written out in PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import array_tensor, table_device, widen

# Sanity ceiling only (ident_rules masks are multi-word; base matrix
# is [B, R] regardless) — not a semantic limit.
MAX_RULES = 4096
MAX_TOPICS = 8  # topics per request tensor row (excess → host path)

# api/kafka.go:110-133 — API keys whose REQUEST carries topics.
TOPIC_API_KEYS = frozenset(
    [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 19, 20, 21, 23, 24, 27, 28,
     34, 35, 37]
)

# Request kinds whose parsed struct carries a checked ClientID
# (policy.go:71-130: Produce/Fetch/Offset/Metadata/OffsetCommit/
# OffsetFetch).
CLIENT_CHECKED_KINDS = frozenset([0, 1, 2, 3, 8, 9])


class Interner:
    """Host-side string → dense u32 id (0 reserved for 'absent')."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}

    def intern(self, s: str) -> int:
        if s == "":
            return 0
        got = self._ids.get(s)
        if got is None:
            got = len(self._ids) + 1
            self._ids[s] = got
        return got

    def lookup(self, s: str) -> int:
        """0 when unseen — an unseen string can never equal a rule's."""
        return self._ids.get(s, 0) if s else 0


@dataclass
class KafkaRequest:
    """A parsed request (pkg/kafka/request.go RequestMessage)."""

    kind: int  # api key int16
    version: int
    client_id: str = ""
    topics: Tuple[str, ...] = ()
    parsed: bool = True  # False ⇒ only the generic header was parsed


@dataclass
class KafkaRuleSpec:
    """One (selector-scope, PortRuleKafka) pair, pre-resolved."""

    identity_indices: Sequence[int]
    api_keys: Tuple[int, ...] = ()  # empty = wildcard (post Role expand)
    api_version: Optional[int] = None  # None = wildcard
    client_id: str = ""
    topic: str = ""
    # fleet-scoped compiles (l7/fleet.py): rules merge only within
    # one (endpoint, direction, L4 slot) scope
    scope_key: "object" = None


@dataclass
class KafkaTables:
    """Device tables for one (endpoint, port, direction) Kafka filter."""

    rule_keys_lo: np.ndarray  # u32 [R] api keys 0-31 bitmask
    rule_keys_hi: np.ndarray  # u32 [R] api keys 32-63
    rule_keys_any: np.ndarray  # u8 [R] wildcard
    rule_version: np.ndarray  # i32 [R]; -1 = wildcard
    rule_client: np.ndarray  # u32 [R]; 0 = wildcard
    rule_topic: np.ndarray  # u32 [R]; 0 = wildcard
    ident_rules: np.ndarray  # u32 [N, W] per-identity rule bits
    n_rules: int
    interner: Interner = field(default_factory=Interner)
    # Deduped specs retained for the host path (requests with more
    # topics than the tensor rows hold re-run MatchesRule host-side).
    specs: List[KafkaRuleSpec] = field(default_factory=list)


def rule_spec_from_port_rule(rule, identity_indices) -> KafkaRuleSpec:
    """PortRuleKafka (sanitized) → spec."""
    return KafkaRuleSpec(
        identity_indices=identity_indices,
        api_keys=tuple(rule.api_key_int),
        api_version=rule.api_version_int,
        client_id=rule.client_id,
        topic=rule.topic,
    )


def _dedupe_specs(specs: Sequence[KafkaRuleSpec]) -> List[KafkaRuleSpec]:
    """Specs with identical match fields are one device rule with the
    union of their identity sets (allowed = OR over rules) — collapses
    the per-selector allow-all pseudo-rules that L3-only rules
    wildcard into every L7 filter (repository.go:170)."""
    merged: Dict[tuple, set] = {}
    order: List[tuple] = []
    for spec in specs:
        key = (
            tuple(sorted(spec.api_keys)),
            spec.api_version,
            spec.client_id,
            spec.topic,
            spec.scope_key,
        )
        if key not in merged:
            merged[key] = set()
            order.append(key)
        merged[key].update(spec.identity_indices)
    return [
        KafkaRuleSpec(
            identity_indices=sorted(merged[key]),
            api_keys=key[0],
            api_version=key[1],
            client_id=key[2],
            topic=key[3],
            scope_key=key[4],
        )
        for key in order
    ]


def compile_kafka_rules(
    specs: Sequence[KafkaRuleSpec], n_identities: int
) -> KafkaTables:
    specs = _dedupe_specs(specs)
    if len(specs) > MAX_RULES:
        raise ValueError(f"more than {MAX_RULES} Kafka rules per filter")
    r = max(len(specs), 1)
    n_words = max(1, -(-r // 32))
    interner = Interner()
    keys_lo = np.zeros(r, dtype=np.uint32)
    keys_hi = np.zeros(r, dtype=np.uint32)
    keys_any = np.zeros(r, dtype=np.uint8)
    version = np.full(r, -1, dtype=np.int32)
    client = np.zeros(r, dtype=np.uint32)
    topic = np.zeros(r, dtype=np.uint32)
    ident = np.zeros((n_identities, n_words), dtype=np.uint32)

    for i, spec in enumerate(specs):
        if not spec.api_keys:
            keys_any[i] = 1
        for k in spec.api_keys:
            if k < 32:
                keys_lo[i] |= np.uint32(1 << k)
            elif k < 64:
                keys_hi[i] |= np.uint32(1 << (k - 32))
            else:
                raise ValueError(f"api key {k} out of range")
        if spec.api_version is not None:
            version[i] = spec.api_version
        client[i] = interner.intern(spec.client_id)
        topic[i] = interner.intern(spec.topic)
        for idx in spec.identity_indices:
            ident[idx, i // 32] |= np.uint32(1 << (i % 32))

    return KafkaTables(
        rule_keys_lo=keys_lo,
        rule_keys_hi=keys_hi,
        rule_keys_any=keys_any,
        rule_version=version,
        rule_client=client,
        rule_topic=topic,
        ident_rules=ident,
        n_rules=len(specs),
        interner=interner,
        specs=list(specs),
    )


def pad_kafka_requests(
    tables: KafkaTables, requests: Sequence[KafkaRequest]
):
    """Requests → integer tensors (strings resolved via the tables'
    interner; unseen strings become 0 ≠ any rule value).

    A request with more unique topics than the tensor row holds is
    FLAGGED `overflow` (last return) — its device verdict must be
    discarded and the request re-run through matches_rules_host
    (evaluate_with_host_fallback does this)."""
    b = len(requests)
    kind = np.zeros(b, dtype=np.int32)
    version = np.zeros(b, dtype=np.int32)
    client = np.zeros(b, dtype=np.uint32)
    topics = np.zeros((b, MAX_TOPICS), dtype=np.uint32)
    # Sentinel for "no topic in this slot": topic ids are ≥1, and
    # 0xFFFFFFFF never equals an interned id.
    topics[:] = 0xFFFFFFFF
    topic_count = np.zeros(b, dtype=np.int32)
    parsed = np.zeros(b, dtype=bool)
    checks_client = np.zeros(b, dtype=bool)
    overflow = np.zeros(b, dtype=bool)
    for i, request in enumerate(requests):
        kind[i] = request.kind
        version[i] = request.version
        client[i] = tables.interner.lookup(request.client_id)
        # MatchesRule dedupes topics via reqTopicsMap (policy.go:205)
        uniq = list(dict.fromkeys(request.topics))
        if len(uniq) > MAX_TOPICS:
            overflow[i] = True
            uniq = uniq[:MAX_TOPICS]
        for j, t in enumerate(uniq):
            topics[i, j] = tables.interner.lookup(t)
        topic_count[i] = len(uniq)
        parsed[i] = request.parsed
        checks_client[i] = request.parsed and (
            request.kind in CLIENT_CHECKED_KINDS
        )
    return (
        kind, version, client, topics, topic_count, parsed,
        checks_client, overflow,
    )


# ---------------------------------------------------------------------------


def rule_matches_host(request: KafkaRequest, spec: KafkaRuleSpec) -> bool:
    """ruleMatches (policy.go:144)."""
    if spec.api_keys and request.kind not in spec.api_keys:
        return False
    if spec.api_version is not None and spec.api_version != request.version:
        return False
    if spec.topic == "" and spec.client_id == "":
        return True
    if not request.parsed:
        # matchNonTopicRequests (policy.go:54)
        if spec.topic != "" and request.kind in TOPIC_API_KEYS:
            return False
        return True
    if request.kind in CLIENT_CHECKED_KINDS:
        if spec.client_id != "" and spec.client_id != request.client_id:
            return False
        return True
    # ConsumerMetadataReq / default: no further checks (policy.go:183,195)
    return True


def matches_rules_host(
    request: KafkaRequest, specs: Sequence[KafkaRuleSpec],
    identity_index: Optional[int] = None,
) -> bool:
    """MatchesRule (policy.go:200), optionally identity-scoped."""
    scoped = [
        s
        for s in specs
        if identity_index is None or identity_index in s.identity_indices
    ]
    remaining = dict.fromkeys(request.topics, True)
    for spec in scoped:
        if spec.topic == "" or len(request.topics) == 0:
            if rule_matches_host(request, spec):
                return True
        elif remaining.get(spec.topic):
            if rule_matches_host(request, spec):
                del remaining[spec.topic]
                if not remaining:
                    return True
    return False


def evaluate_with_host_fallback(
    tables: KafkaTables,
    requests: Sequence[KafkaRequest],
    ident_idx,
    known,
) -> np.ndarray:
    """Full Kafka verdict on the device the tables lie on
    (`convert.l7_tables_to`): the requests packed on the host
    (`pad_kafka_requests`), uploaded with `ident_idx` (as i32) and
    `known`, judged by `evaluate_kafka_batch`, and the requests whose
    topic list exceeds the tensor rows re-run host-side.  Returns
    allowed bool [B] (numpy)."""
    dev = table_device(tables.ident_rules, "Kafka tables")
    packed = pad_kafka_requests(tables, requests)
    overflow = packed[-1]
    ident_idx = np.asarray(ident_idx)
    known = np.asarray(known)
    fields = (*packed, ident_idx.astype(np.int32), known.astype(bool))
    allowed = evaluate_kafka_batch(
        tables, *(array_tensor(a, dev) for a in fields)
    ).cpu().numpy().copy()
    for i in np.nonzero(overflow)[0]:
        allowed[i] = bool(known[i]) and matches_rules_host(
            requests[i], tables.specs, int(ident_idx[i])
        )
    return allowed


# ---------------------------------------------------------------------------
# device side: plain PyTorch version and the entry point
# ---------------------------------------------------------------------------


def evaluate_kafka_batch_plain(
    tables: KafkaTables,
    kind: torch.Tensor,  # i32 [B] api key
    version: torch.Tensor,  # i32 [B]
    client: torch.Tensor,  # u32 bits [B] interned client id
    topics: torch.Tensor,  # u32 bits [B, T] interned topics, -1 = empty
    topic_count: torch.Tensor,  # i32 [B]
    parsed: torch.Tensor,  # bool [B]
    checks_client: torch.Tensor,  # bool [B]
    overflow: torch.Tensor,  # bool [B]
    ident_idx: torch.Tensor,  # i32 [B]
    known: torch.Tensor,  # bool [B]
    scope_bits: Optional[torch.Tensor] = None,  # u32 bits [B, W]
) -> torch.Tensor:
    """Plain version of K17a (the reference's `evaluate_kafka_batch`, on
    device-form tables): [B, R] and [B, T, R] integer compares.  Rows
    flagged `overflow` are denied.  Returns allowed bool [B]."""
    dev = kind.device
    keys_lo = widen(tables.rule_keys_lo)[None, :]
    keys_hi = widen(tables.rule_keys_hi)[None, :]
    keys_any = tables.rule_keys_any.bool()[None, :]
    rule_version = tables.rule_version[None, :]
    rule_client = tables.rule_client[None, :]
    rule_topic = tables.rule_topic[None, :]

    k = kind.to(torch.int64)[:, None]
    # api-key membership; a negative key never aliases into the
    # clipped shift range, and a key of 64 or more matches no word
    in_lo = (keys_lo >> k.clamp(0, 31)) & 1
    in_hi = (keys_hi >> (k - 32).clamp(0, 31)) & 1
    key_ok = (k >= 0) & (
        keys_any
        | torch.where(k < 32, in_lo, torch.where(k < 64, in_hi, 0)).bool()
    )
    ver_ok = (rule_version < 0) | (rule_version == version[:, None])
    client_ok = (
        (rule_client == 0) | (rule_client == client[:, None])
        | ~checks_client[:, None]
    )
    topic_kinds = torch.tensor(
        sorted(TOPIC_API_KEYS), dtype=torch.int64, device=dev
    )
    is_topic_kind = torch.isin(k, topic_kinds)
    nontopic_ok = ~((rule_topic != 0) & is_topic_kind & ~parsed[:, None])
    base = key_ok & ver_ok & client_ok & nontopic_ok  # [B, R]

    n = int(tables.ident_rules.shape[0])
    ident_bits = tables.ident_rules[ident_idx.to(torch.int64).clamp(0, n - 1)]
    r = base.shape[1]
    word_of_rule = torch.arange(r, device=dev) // 32
    bit_of_rule = (torch.arange(r, device=dev) % 32)[None, :]
    rule_bit = (widen(ident_bits)[:, word_of_rule] >> bit_of_rule) & 1
    base = base & rule_bit.bool() & known[:, None]
    if scope_bits is not None:
        scope_bit = (widen(scope_bits)[:, word_of_rule] >> bit_of_rule) & 1
        base = base & scope_bit.bool()

    count = topic_count.to(torch.int64)
    allow_all = (base & ((rule_topic == 0) | (count[:, None] == 0))).any(1)
    covered = (
        base[:, None, :] & (rule_topic[:, None, :] == topics[:, :, None])
    ).any(2)  # [B, T]
    slot_active = (
        torch.arange(topics.shape[1], device=dev)[None, :] < count[:, None]
    )
    all_covered = (count > 0) & (covered | ~slot_active).all(1)
    return (allow_all | all_covered) & ~overflow


def evaluate_kafka_batch(tables: KafkaTables, kind, version, client, topics,
                         topic_count, parsed, checks_client, overflow,
                         ident_idx, known, scope_bits=None) -> torch.Tensor:
    """K17a: the Kafka verdicts of a batch of requests (the fields in
    pad_kafka_requests' order).  CUDA tensors launch KAFKA_MATCH; CPU
    tensors run the plain version.  Returns allowed bool [B]."""
    args = (tables, kind, version, client, topics, topic_count, parsed,
            checks_client, overflow, ident_idx, known)
    if kind.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.KAFKA_MATCH(*args, scope_bits=scope_bits)
    if kind.device.type == "cpu":
        return evaluate_kafka_batch_plain(*args, scope_bits=scope_bits)
    raise ValueError(f"unsupported device {kind.device}")
