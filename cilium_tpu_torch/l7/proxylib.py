"""Generic L7 parser framework — the proxylib analog.

The port's own copy of the JAX package's l7/proxylib.py.  A parser's
`compile_device` returns numpy tables, as the reference's does; the
caller moves them to a device (the Proxy does, with
`convert.l7_tables_to`), and their `evaluate` runs there.

The reference's extensibility story is proxylib: a parser registered
by name gets wire bytes per connection (OnNewConnection/OnData,
proxylib/proxylib.go:57,142) and matches parsed
requests against NPDS-downloaded key/value rules
(proxylib/proxylib/policymap.go:150).  Policy rules
carry `l7proto` + a list of key/value dicts (api/l7.go PortRuleL7),
which this framework dispatches to the registered parser's rule
compiler and matcher.

Tensor-first split, same as the Kafka design (l7/kafka.py): parsers
compile their rules into integer tensors wherever the match is
tensorizable (exact-value fields via string interning, set-membership
via bitmasks), batch-evaluate on device, and host-fallback only the
rows the device form cannot express (regex/prefix rules, oversized
requests).  A parser that provides no device matcher simply runs its
host matcher — the registry contract is the extension point, not the
acceleration.

Registered parsers: `binarymemcache` (l7/memcached.py — the reference
proxylib's memcached binary parser,
proxylib/memcached/binary/parser.go:142).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class L7Request:
    """One parsed request: the protocol name plus the parser's field
    dict (the cilium.L7LogEntry 'fields' shape)."""

    proto: str
    fields: Tuple[Tuple[str, str], ...]

    def get(self, key: str, default: str = "") -> str:
        for k, v in self.fields:
            if k == key:
                return v
        return default


@dataclass
class ParserEntry:
    """Registry row (proxylib.RegisterParserFactory +
    RegisterL7RuleParser collapsed into one registration)."""

    name: str
    # bytes → ([parsed requests], consumed bytes)
    decode_stream: Callable[[bytes], Tuple[List[L7Request], int]]
    # rule dicts + identity indices → list of compiled rule specs
    compile_rules: Callable[[Sequence[dict], Sequence[int]], list]
    # host matcher: (request, spec) → bool
    rule_matches: Callable[[L7Request, object], bool]
    # optional device compiler: (specs, n_identities) → tables with
    # an `evaluate(requests, ident_idx, known) -> allowed [B]` —
    # None = host-only parser
    compile_device: Optional[Callable[[list, int], object]] = None
    # denied-response synthesizer (the broker-in-the-middle deny)
    deny_response: Optional[Callable[[L7Request], bytes]] = None


_REGISTRY: Dict[str, ParserEntry] = {}


def register_parser(entry: ParserEntry) -> None:
    """proxylib.RegisterParserFactory: last registration wins, as the
    reference's init() hooks overwrite by name."""
    _REGISTRY[entry.name] = entry


def get_parser(name: str) -> ParserEntry:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KeyError(
            f"no L7 parser registered for l7proto {name!r} "
            f"(known: {sorted(_REGISTRY)})"
        )
    return entry


def known_parsers() -> List[str]:
    return sorted(_REGISTRY)


@dataclass
class GenericL7Tables:
    """Compiled per-redirect state for a generic parser: the specs
    (host path), per-identity rule-membership bitmask, and the
    parser's device tables when it provides them."""

    parser: ParserEntry
    specs: list
    n_identities: int
    device: object = None

    def identity_rules(self, ident_idx: int) -> list:
        return [
            s
            for s in self.specs
            if ident_idx in s.identity_indices
        ]


def compile_generic_rules(
    l7proto: str,
    per_selector: Sequence[Tuple[Sequence[int], Sequence[dict]]],
    n_identities: int,
) -> GenericL7Tables:
    """Lower {selector identity-indices → rule dicts} for one
    redirect.  An empty dict list is the L7 allow-all wildcard, like
    an empty kafka/http rule set."""
    parser = get_parser(l7proto)
    specs: list = []
    for indices, dicts in per_selector:
        specs.extend(parser.compile_rules(dicts, indices))
    device = (
        parser.compile_device(specs, n_identities)
        if parser.compile_device is not None
        else None
    )
    return GenericL7Tables(
        parser=parser,
        specs=specs,
        n_identities=n_identities,
        device=device,
    )


def matches_rules_host(
    tables: GenericL7Tables, request: L7Request, ident_idx: int
) -> bool:
    """proxylib policymap matching: any rule of the identity matches
    (wildcard specs match everything)."""
    for spec in tables.identity_rules(ident_idx):
        if tables.parser.rule_matches(request, spec):
            return True
    return False


def evaluate_requests(
    tables: GenericL7Tables,
    requests: Sequence[L7Request],
    ident_idx,
    known,
) -> np.ndarray:
    """Batched verdicts: device path when the parser compiled one,
    host loop otherwise; device-inexpressible rows fall back to the
    host matcher (the parser's device tables flag them)."""
    ident_idx = np.asarray(ident_idx)
    known = np.asarray(known)
    if tables.device is not None:
        allowed, needs_host = tables.device.evaluate(
            requests, ident_idx, known
        )
        allowed = np.asarray(allowed).copy()
        for i in np.nonzero(np.asarray(needs_host))[0]:
            allowed[i] = bool(known[i]) and matches_rules_host(
                tables, requests[i], int(ident_idx[i])
            )
        return allowed
    out = np.zeros(len(requests), dtype=bool)
    for i, request in enumerate(requests):
        out[i] = bool(known[i]) and matches_rules_host(
            tables, request, int(ident_idx[i])
        )
    return out
