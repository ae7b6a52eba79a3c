"""HTTP L7 policy: rules -> DFA tables -> batched matching (K16).

The port's own copy of the reference's host compiler, leaf for leaf
the tables it emits (tests/test_torch_l7.py), and the device side in
PyTorch.  Reference semantics:
  * pkg/envoy/server.go:316 getHTTPRule: Path/Method/Host become
    Envoy regex HeaderMatchers, which FULL-match the value; all fields
    of one PortRuleHTTP must match (AND); a request is allowed if ANY
    rule of the relevant L7Rules matches (OR).
  * pkg/policy/l4.go:118 GetRelevantRules: rules apply per remote
    identity through their selector; a rule with every field empty is
    an L7 allow-all for its identities.
  * Header constraints stay host-evaluated: rules carrying headers are
    kept out of the device tables (`HTTPPolicy.host_rules`).

Device layout (R rules, W = ceil(R/32) mask words; rule r lives in
bit r%32 of word r//32):
  method/path/host DFAs  union DFAs with per-rule accept bits
                         (trans u16 [S, C], accept u32 [S, W],
                         classes u8 [256]);
  absent_<field> u32 [W] rules that omit the field (auto-match);
  ident_rules u32 [N, W] bit r set iff rule r admits identity index n.

`evaluate_http_batch` is the entry point.  On CUDA tensors it launches
the hand-written kernel HTTP_MATCH (kernels.py, csrc/l7.cu), which
scans each field byte by byte with the base DFA; on CPU tensors it
runs `evaluate_http_batch_plain`, which takes the reference's branch:
the strided scan when a strided DFA is present, the byte scan
otherwise.  Both end in the same state (padding maps to the identity
class of the strided form), so the outputs are equal.

Tables are numpy as compiled; `convert.l7_tables_to` moves them to
a device (u32 words as int32 tensors with the same bits, u16 as
int32, u8 as uint8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import array_tensor, table_device
from cilium_tpu_torch.l7.regex_dfa import (
    DFA,
    RegexTooComplex,
    RegexUnsupported,
    compile_union,
)


# Sanity ceiling only (accept masks are multi-word): guards against a
# pathological compile blowing up accept-table width, not a semantic
# limit — the reference's per-filter rule count is bounded by policy
# size, not a constant.
MAX_RULES = 4096


@dataclass
class HTTPRuleSpec:
    """One (selector-scope, PortRuleHTTP) pair, pre-resolved: the
    identity indices the selector admits over the current universe."""

    identity_indices: Sequence[int]  # indices into the padded universe
    path: str = ""
    method: str = ""
    host: str = ""
    headers: Tuple[str, ...] = ()
    # fleet-scoped compiles (l7/fleet.py) key each rule to its
    # (endpoint, direction, L4 slot); None = filter-local rule.
    # Participates in dedupe: rules only merge within one scope.
    scope_key: "object" = None


@dataclass
class HTTPTables:
    """Device tables for one (endpoint, port, direction) HTTP filter."""

    # DFAs (trans u16 [S,C], accept u32 [S,W], classes u8 [256], start)
    method_dfa: DFA
    path_dfa: DFA
    host_dfa: DFA
    absent_method: np.ndarray  # u32 [W] bitmask
    absent_path: np.ndarray
    absent_host: np.ndarray
    ident_rules: np.ndarray  # u32 [N, W] per-identity rule bits
    n_rules: int
    n_words: int
    # strided forms (None = fall back to the byte-at-a-time scan)
    method_sdfa: "Optional[StridedDFA]" = None
    path_sdfa: "Optional[StridedDFA]" = None
    host_sdfa: "Optional[StridedDFA]" = None


@dataclass
class HTTPPolicy:
    """Compiled HTTP policy + host-fallback rules."""

    tables: HTTPTables
    host_rules: List[HTTPRuleSpec]  # header-carrying rules
    # Deduped device rules retained for the host path: overflowed
    # requests (fields beyond the padded budgets) re-evaluate against
    # these with re.fullmatch instead of the truncated tensors.
    device_rules: List[HTTPRuleSpec] = field(default_factory=list)


def resolve_selector_indices(
    selector, identity_cache, id_index, selector_cache=None
) -> List[int]:
    """selector → dense identity indices.  With a SelectorCache the
    resolution is one memoized set lookup (O(matched)); without, it
    falls back to the per-identity matches() walk — identical result,
    O(identities)."""
    if selector_cache is not None:
        return [
            id_index[num_id]
            for num_id in selector_cache.matches(selector)
            if num_id in id_index
        ]
    return [
        id_index[num_id]
        for num_id, labels in identity_cache.items()
        if selector.matches(labels) and num_id in id_index
    ]


def specs_from_filter(
    l4_filter, identity_cache, id_index, selector_cache=None
) -> List["HTTPRuleSpec"]:
    """L4Filter.l7_rules_per_ep (selector → L7Rules, pkg/policy/l4.go:31)
    → flat HTTPRuleSpec list over the identity universe.

    A selector entry with EMPTY L7Rules becomes an allow-all
    pseudo-rule (all fields absent ⇒ matches every request) — the
    L3-override / wildcard entries of createL4IngressFilter
    (l4.go:209) and wildcardL3L4Rules (repository.go:170).
    """
    specs: List[HTTPRuleSpec] = []
    for selector, l7 in l4_filter.l7_rules_per_ep.items():
        indices = resolve_selector_indices(
            selector, identity_cache, id_index, selector_cache
        )
        http_rules = l7.http or []
        if not http_rules:
            specs.append(HTTPRuleSpec(identity_indices=indices))
            continue
        for rule in http_rules:
            specs.append(
                HTTPRuleSpec(
                    identity_indices=indices,
                    path=rule.path or "",
                    method=rule.method or "",
                    host=rule.host or "",
                    headers=tuple(rule.headers or ()),
                )
            )
    return specs


def _dedupe_specs(rules: List[HTTPRuleSpec]) -> List[HTTPRuleSpec]:
    """Rules with identical patterns are one device rule with the
    union of their identity sets — allowed = OR over rules, so this
    is semantics-preserving.  The dominant case is the allow-all
    pseudo-rules that every L3-only rule wildcards into each L7
    filter (repository.go:170): they all collapse to one."""
    merged: Dict[Tuple[str, str, str, object], set] = {}
    order: List[Tuple[str, str, str, object]] = []
    for rule in rules:
        key = (rule.method, rule.path, rule.host, rule.scope_key)
        if key not in merged:
            merged[key] = set()
            order.append(key)
        merged[key].update(rule.identity_indices)
    return [
        HTTPRuleSpec(
            identity_indices=sorted(merged[key]),
            method=key[0],
            path=key[1],
            host=key[2],
            scope_key=key[3],
        )
        for key in order
    ]


def compile_http_rules(
    rules: Sequence[HTTPRuleSpec],
    n_identities: int,
    max_states: int = 4096,
) -> HTTPPolicy:
    """Split rules into device/host sets and build the union DFAs."""
    device_rules: List[HTTPRuleSpec] = []
    host_rules: List[HTTPRuleSpec] = []
    for rule in rules:
        if rule.headers:
            host_rules.append(rule)
            continue
        device_rules.append(rule)
    device_rules = _dedupe_specs(device_rules)
    if len(device_rules) > MAX_RULES:
        raise RegexTooComplex(
            f"more than {MAX_RULES} device HTTP rules per filter"
        )
    n_words = max(1, -(-len(device_rules) // 32))

    def _to_words(mask: int) -> np.ndarray:
        return np.array(
            [(mask >> (32 * w)) & 0xFFFFFFFF for w in range(n_words)],
            dtype=np.uint32,
        )

    def union_for(field_name: str) -> Tuple[DFA, np.ndarray]:
        """DFA over the present patterns; absent bitmask for the rest.
        Pattern bit positions == rule positions (absent patterns
        compile as never-matching placeholders via the absent mask)."""
        patterns = []
        absent = 0
        for i, rule in enumerate(device_rules):
            pattern = getattr(rule, field_name)
            if pattern == "":
                absent |= 1 << i
                patterns.append("[^\\x00-\\xff]")  # matches nothing
            else:
                patterns.append(pattern)
        try:
            dfa = compile_union(patterns, max_states=max_states)
        except (RegexUnsupported, RegexTooComplex):
            raise
        return dfa, _to_words(absent)

    method_dfa, absent_method = union_for("method")
    path_dfa, absent_path = union_for("path")
    host_dfa, absent_host = union_for("host")

    ident_rules = np.zeros((n_identities, n_words), dtype=np.uint32)
    for i, rule in enumerate(device_rules):
        for idx in rule.identity_indices:
            ident_rules[idx, i // 32] |= np.uint32(1 << (i % 32))

    tables = HTTPTables(
        method_sdfa=build_strided(method_dfa),
        path_sdfa=build_strided(path_dfa),
        host_sdfa=build_strided(host_dfa),
        method_dfa=method_dfa,
        path_dfa=path_dfa,
        host_dfa=host_dfa,
        absent_method=absent_method,
        absent_path=absent_path,
        absent_host=absent_host,
        ident_rules=ident_rules,
        n_rules=len(device_rules),
        n_words=n_words,
    )
    return HTTPPolicy(
        tables=tables, host_rules=host_rules, device_rules=device_rules
    )


@dataclass
class StridedDFA:
    """A DFA squared k times: one scan step consumes 2^k bytes.

    The sequential byte-at-a-time scan is the HTTP path's cost center;
    squaring the transition table — with column deduplication between
    rounds and an artificial identity class so padding can never move
    the state — divides the step count by the stride.  The union DFAs
    here are tiny (tens of states), so the tables stay kilobytes.

    Level map l takes a pair of level-(l-1) classes to a level-l
    class.  The strided evaluation maps byte values to level-0 classes
    and folds pairs level by level BEFORE the scan (while the pair
    table stays within MXU_LOOKUP_MAX_K entries), then scans the
    remaining positions with the transition table OF THAT LEVEL
    (level_trans[d], retained per round)."""

    classes: np.ndarray  # byte → level-0 class (identity class added)
    id_class0: int
    base_trans: np.ndarray  # [S, nc0] incl identity column (level 0)
    level_maps: List[np.ndarray]  # [nc_prev * nc_prev] → class id
    level_ncs: List[int]  # nc INPUT of each level
    level_ids: List[int]  # identity class id at each level OUTPUT
    # transition table AFTER each level (level_trans[k] pairs with a
    # class sequence folded through level_maps[:k+1]); the scan picks
    # its fold depth by table size, so every depth's table is kept
    # (they are kilobytes)
    level_trans: List[np.ndarray]
    trans: np.ndarray  # [S, nc_final] == level_trans[-1]
    start: int
    accept: np.ndarray


# the strided scan folds a level only while its pair table holds at
# most this many entries (the reference's fold-depth rule; the fold
# depth changes the step count, never the final state)
MXU_LOOKUP_MAX_K = 2048


def build_strided(
    dfa: DFA, rounds: int = 4, max_table_bytes: int = 1 << 22
) -> "Optional[StridedDFA]":
    """Square the transition table `rounds` times (stride 2^rounds),
    deduping equivalent columns between rounds and carrying an
    identity class for padding."""
    trans = dfa.trans.astype(np.int64)
    s_count, nc = trans.shape
    # identity column: padding bytes leave the state unchanged, so a
    # stride group that crosses the end of the string is exact
    trans = np.concatenate(
        [trans, np.arange(s_count, dtype=np.int64)[:, None]], axis=1
    )
    id_class = nc
    nc += 1
    base_trans = trans.astype(np.int32)

    level_maps: List[np.ndarray] = []
    level_ncs: List[int] = []
    level_ids: List[int] = []
    level_trans: List[np.ndarray] = []
    cur_id = id_class
    for _ in range(rounds):
        if s_count * nc * nc * 8 > max_table_bytes:
            break
        # T2[s, c1, c2] = trans[trans[s, c1], c2]
        t2 = trans[trans, :]  # t2[s, c1, c2] = trans[trans[s, c1], c2]
        flat = t2.reshape(s_count, nc * nc)
        cols, inverse = np.unique(flat.T, axis=0, return_inverse=True)
        level_maps.append(inverse.astype(np.int32))
        level_ncs.append(nc)
        trans = cols.T.astype(np.int64)  # [S, n_unique]
        cur_id = int(inverse[cur_id * nc + cur_id])
        level_ids.append(cur_id)
        level_trans.append(trans.astype(np.int32))
        nc = trans.shape[1]

    if not level_maps:
        # squaring never fit the budget: no strided form — callers
        # use the byte-at-a-time scan
        return None

    return StridedDFA(
        classes=dfa.classes.astype(np.int32),
        id_class0=id_class,
        base_trans=base_trans,
        level_maps=level_maps,
        level_ncs=level_ncs,
        level_ids=level_ids,
        level_trans=level_trans,
        trans=level_trans[-1],
        start=dfa.start,
        accept=dfa.accept,
    )


def http_rule_matches_host(
    rule: HTTPRuleSpec,
    method: bytes,
    path: bytes,
    host: bytes,
    headers: Optional[Dict[str, str]] = None,
) -> bool:
    """Host reference matcher (Python re.fullmatch ≙ Envoy regex
    HeaderMatcher full-match)."""
    import re

    if rule.method and not re.fullmatch(
        rule.method.encode(), method, re.DOTALL
    ):
        return False
    if rule.path and not re.fullmatch(rule.path.encode(), path, re.DOTALL):
        return False
    if rule.host and not re.fullmatch(rule.host.encode(), host, re.DOTALL):
        return False
    for header in rule.headers:
        # "Name: value" exact or "Name" presence (server.go:352-366)
        if ":" in header:
            name, _, value = header.partition(":")
            want = value.strip()
        else:
            name, want = header, None
        got = (headers or {}).get(name.strip().lower())
        if got is None:
            return False
        if want is not None and got != want:
            return False
    return True


def pad_requests(
    requests: Sequence[Tuple[bytes, bytes, bytes]],
    lm: int = 16,
    lp: int = 128,
    lh: int = 64,
):
    """(method, path, host) bytes → padded u8 tensors + lengths +
    overflow flags.

    A field longer than its budget is NOT silently truncated into the
    tensors-with-shorter-length (that would corrupt full-match
    semantics in both directions); the row is flagged `overflow` and
    must be routed to the host matcher (evaluate_with_host_fallback
    does this).  The tensor row still carries the truncated prefix so
    shapes stay static, but its device verdict is discarded."""
    b = len(requests)
    method = np.zeros((b, lm), dtype=np.uint8)
    path = np.zeros((b, lp), dtype=np.uint8)
    host = np.zeros((b, lh), dtype=np.uint8)
    lens = np.zeros((3, b), dtype=np.int32)
    overflow = np.zeros(b, dtype=bool)
    for i, (m, p, h) in enumerate(requests):
        overflow[i] = len(m) > lm or len(p) > lp or len(h) > lh
        m, p, h = m[:lm], p[:lp], h[:lh]
        method[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        path[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        host[i, : len(h)] = np.frombuffer(h, dtype=np.uint8)
        lens[0, i], lens[1, i], lens[2, i] = len(m), len(p), len(h)
    return method, lens[0], path, lens[1], host, lens[2], overflow


def trim_packed(
    data: "np.ndarray", lengths: "np.ndarray", min_width: int = 8
) -> "np.ndarray":
    """Slice a padded [B, L] byte tensor down to the smallest
    power-of-two column count covering every row's actual length.
    The DFA scans cost per PROCESSED byte (pad positions fold through
    the identity class but still pay their gathers/matmuls), so a
    batch of short requests should not pay the full field budget."""
    data = np.asarray(data)
    need = int(np.max(lengths, initial=0))
    width = min_width
    while width < need:
        width *= 2
    return data[:, : min(width, data.shape[1])]



# ---------------------------------------------------------------------------
# device side: plain PyTorch versions and the entry point
# ---------------------------------------------------------------------------


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a small integer table.  The reference lowers this
    lookup as a one-hot x table matrix product (`_mxu_lookup`), a device
    for the TPU's matrix unit whose output is exactly this gather."""
    return table.to(torch.int64)[idx]


def _dfa_scan_strided(sdfa: StridedDFA, data: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] u8 -> accept bitmask [B, W] (u32 bits in int32), by the
    strided form: positions past the length become the identity
    class, pairs of classes fold level by level while the level's pair
    table holds at most MXU_LOOKUP_MAX_K entries, and the remaining
    positions scan with that level's transition table."""
    b, l = data.shape
    dev = data.device
    pos = torch.arange(l, device=dev)
    p = torch.where(
        pos[None, :] < lengths.to(torch.int64)[:, None],
        data.to(torch.int64), 256,  # the pad pseudo-byte
    )
    classes_e = torch.cat([
        sdfa.classes.to(torch.int64),
        torch.tensor([sdfa.id_class0], dtype=torch.int64, device=dev),
    ])
    c = _lookup(classes_e, p)  # [B, L]
    pad_id = sdfa.id_class0
    depth = -1
    for k, (pair_map, nc_in, out_id) in enumerate(
        zip(sdfa.level_maps, sdfa.level_ncs, sdfa.level_ids)
    ):
        if nc_in * nc_in > MXU_LOOKUP_MAX_K:
            break
        if c.shape[1] % 2:
            c = torch.cat(
                [c, torch.full((b, 1), pad_id, dtype=torch.int64, device=dev)],
                dim=1,
            )
        c = _lookup(pair_map, c[:, 0::2] * nc_in + c[:, 1::2])  # [B, L/2]
        pad_id = out_id
        depth = k
    trans = sdfa.base_trans if depth < 0 else sdfa.level_trans[depth]
    nc_final = int(trans.shape[1])
    flat = trans.reshape(-1).to(torch.int64)
    state = torch.full((b,), int(sdfa.start), dtype=torch.int64, device=dev)
    for col in range(c.shape[1]):
        state = flat[state * nc_final + c[:, col]]
    return sdfa.accept[state]


def _dfa_scan(dfa: DFA, data: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Step a [B, L] u8 tensor through the DFA one byte per position,
    positions at or past the row's length leaving the state as it is;
    returns the accept bitmask [B, W] (u32 bits in int32)."""
    b, l = data.shape
    classes = dfa.classes.to(torch.int64)
    n_classes = int(dfa.trans.shape[1])
    flat = dfa.trans.reshape(-1).to(torch.int64)
    state = torch.full(
        (b,), int(dfa.start), dtype=torch.int64, device=data.device
    )
    for pos in range(l):
        nxt = flat[state * n_classes + classes[data[:, pos].to(torch.int64)]]
        state = torch.where(pos < lengths, nxt, state)
    return dfa.accept[state]


def evaluate_http_batch_plain(
    tables: HTTPTables,
    method: torch.Tensor,  # u8 [B, Lm]
    method_len: torch.Tensor,  # i32 [B]
    path: torch.Tensor,
    path_len: torch.Tensor,
    host: torch.Tensor,
    host_len: torch.Tensor,
    ident_idx: torch.Tensor,  # i32 [B] identity index
    known: torch.Tensor,  # bool [B]
    scope_bits: Optional[torch.Tensor] = None,  # u32 bits [B, W]
):
    """Plain version of K16 (the reference's `evaluate_http_batch`, on
    device-form tables).  Returns (allowed bool [B], matched rule bits
    [B, W] as int32)."""

    def scan(dfa, sdfa, data, lens):
        if sdfa is not None:
            return _dfa_scan_strided(sdfa, data, lens)
        return _dfa_scan(dfa, data, lens)

    acc_m = scan(tables.method_dfa, tables.method_sdfa, method, method_len)
    acc_p = scan(tables.path_dfa, tables.path_sdfa, path, path_len)
    acc_h = scan(tables.host_dfa, tables.host_sdfa, host, host_len)
    matched = (
        (acc_m | tables.absent_method[None, :])
        & (acc_p | tables.absent_path[None, :])
        & (acc_h | tables.absent_host[None, :])
    )
    n = int(tables.ident_rules.shape[0])
    ident_bits = tables.ident_rules[
        ident_idx.to(torch.int64).clamp(0, n - 1)
    ]
    matched = matched & ident_bits & torch.where(
        known, -1, 0
    ).to(torch.int32)[:, None]
    if scope_bits is not None:
        matched = matched & scope_bits
    return (matched != 0).any(dim=1), matched


def evaluate_http_batch(tables: HTTPTables, method, method_len, path,
                        path_len, host, host_len, ident_idx, known,
                        scope_bits=None):
    """K16: the HTTP verdicts of a batch of requests.  CUDA tensors
    launch HTTP_MATCH; CPU tensors run the plain version.  Returns
    (allowed bool [B], matched rule bits [B, W] as int32)."""
    args = (tables, method, method_len, path, path_len, host, host_len,
            ident_idx, known)
    if method.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.HTTP_MATCH(*args, scope_bits=scope_bits)
    if method.device.type == "cpu":
        return evaluate_http_batch_plain(*args, scope_bits=scope_bits)
    raise ValueError(f"unsupported device {method.device}")


def evaluate_with_host_fallback(
    policy: HTTPPolicy,
    requests: Sequence[Tuple[bytes, bytes, bytes]],
    ident_idx,  # i32 [B] identity index
    known,  # bool [B]
    headers: Optional[Sequence[Optional[Dict[str, str]]]] = None,
    lm: int = 16,
    lp: int = 128,
    lh: int = 64,
) -> np.ndarray:
    """Full HTTP policy verdict: the device scan + host-side merge, on
    the device that `policy.tables` lies on (`convert.l7_tables_to`).

    Reference semantics (pkg/envoy/server.go:316,448 +
    envoy/cilium_l7policy.cc): a request is allowed if ANY rule of the
    filter matches — including header-carrying rules, which the device
    tables exclude.  The requests are packed on the host
    (`pad_requests`, `trim_packed`), uploaded with `ident_idx` (as i32,
    as jnp.asarray takes it) and `known`, and judged by
    `evaluate_http_batch`; then three host merges over that verdict:

      1. header rules (policy.host_rules): evaluated with re.fullmatch
         + header present/exact checks, OR-ed into the device verdict;
      2. overflow rows (fields beyond the padded budgets): the device
         verdict for those rows is discarded and recomputed from
         policy.device_rules host-side — never decided from truncated
         bytes;
      3. unknown identities stay denied.

    Returns allowed bool [B] (numpy).
    """
    dev = table_device(policy.tables.ident_rules, "HTTP tables")
    packed = pad_requests(requests, lm=lm, lp=lp, lh=lh)
    m, mlen, p, plen, h, hlen, overflow = packed
    ident_idx = np.asarray(ident_idx)
    known = np.asarray(known)
    fields = (
        trim_packed(m, mlen), mlen, trim_packed(p, plen), plen,
        trim_packed(h, hlen), hlen,
        ident_idx.astype(np.int32), known.astype(bool),
    )
    allowed_dev, _ = evaluate_http_batch(
        policy.tables, *(array_tensor(a, dev) for a in fields)
    )
    allowed = allowed_dev.cpu().numpy().copy()

    # 2: overflowed rows re-evaluate the device rules host-side.
    for i in np.nonzero(overflow)[0]:
        mm, pp, hh = requests[i]
        allowed[i] = bool(known[i]) and any(
            int(ident_idx[i]) in spec.identity_indices
            and http_rule_matches_host(spec, mm, pp, hh)
            for spec in policy.device_rules
        )

    # 1: header rules can only widen (OR semantics across rules).
    if policy.host_rules:
        for i in np.nonzero(~allowed & known)[0]:
            mm, pp, hh = requests[i]
            hdrs = headers[i] if headers is not None else None
            if any(
                int(ident_idx[i]) in spec.identity_indices
                and http_rule_matches_host(spec, mm, pp, hh, hdrs)
                for spec in policy.host_rules
            ):
                allowed[i] = True
    return allowed
