"""Binary-memcached parser for the generic L7 framework (K17c).

The port's own copy of the JAX package's l7/memcached.py: the wire
codec, the rule compiler, the host matcher and the device tables,
leaf for leaf the reference's, with the device match in PyTorch.

Behavioral port of the reference proxylib parser
(proxylib/memcached/binary/parser.go): 24-byte binary
header (magic 0x80 request / 0x81 response), opcode at byte 1, key of
keyLength bytes after the extras; rules name an opcode or opcode
group plus at most one of keyExact / keyPrefix / keyRegex; denied
requests are answered with the 'access denied' response frame
(DeniedMsgBase, parser.go:293).

Tensor matching (the l7/kafka.py design): opcodes become a 256-bit
rule mask (8 u32 words), exact keys intern to dense u32 ids, and the
batch evaluates as pure integer [B, R] compares on device; rules with
keyPrefix/keyRegex are host-only — the device result flags any row
whose identity owns such a rule for host fallback, so the fast path
never false-denies (nor false-allows: flagged rows are re-run, not
trusted).

`MemcacheDeviceTables.evaluate` packs the requests on the host (a
Python loop, as in the reference), uploads them to the device its
tables lie on (`convert.l7_tables_to`) and calls `memcache_match`:
CUDA tensors launch the hand-written kernel MEMCACHE_MATCH
(kernels.py, csrc/l7.cu), CPU tensors run `memcache_match_plain`, the
reference's [B, R] compares written out in PyTorch.  Both clip the
opcode to [0, 255] to pick the mask word and bit and refuse a negative
raw opcode, clip the identity index to [0, N - 1] (`known` masks the
row), read rule j's membership from word j >> 5, bit j & 31, and
compare key ids as u32 bits.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import array_tensor, table_device, widen
from cilium_tpu_torch.l7.kafka import Interner
from cilium_tpu_torch.l7.proxylib import (
    L7Request,
    ParserEntry,
    register_parser,
)

PARSER_NAME = "binarymemcache"
HEADER_SIZE = 24
REQUEST_MAGIC = 0x80
RESPONSE_MAGIC = 0x81

# parser.go:306 MemcacheOpCodeMap — names and groups to opcodes
OPCODE_MAP: Dict[str, Tuple[int, ...]] = {
    "get": (0,), "set": (1,), "add": (2,), "replace": (3,),
    "delete": (4,), "increment": (5,), "decrement": (6,), "quit": (7,),
    "flush": (8,), "getq": (9,), "noop": (10,), "version": (11,),
    "getk": (12,), "getkq": (13,), "append": (14,), "prepend": (15,),
    "stat": (16,), "setq": (17,), "addq": (18,), "replaceq": (19,),
    "deleteq": (20,), "incrementq": (21,), "decrementq": (22,),
    "quitq": (23,), "flushq": (24,), "appendq": (25,), "prependq": (26,),
    "verbosity": (27,), "touch": (28,), "gat": (29,), "gatq": (30,),
    "sasl-list-mechs": (32,), "sasl-auth": (33,), "sasl-step": (34,),
    "rget": (48,), "rset": (49,), "rsetq": (50,), "rappend": (51,),
    "rappendq": (52,), "rprepend": (53,), "rprependq": (54,),
    "rdelete": (55,), "rdeleteq": (56,), "rincr": (57,), "rincrq": (58,),
    "rdecr": (59,), "rdecrq": (60,), "set-vbucket": (61,),
    "get-vbucket": (62,), "del-vbucket": (63,), "tap-connect": (64,),
    "tap-mutation": (65,), "tap-delete": (66,), "tap-flush": (67,),
    "tap-opaque": (68,), "tap-vbucket-set": (69,),
    "tap-checkpoint-start": (70,), "tap-checkpoint-end": (71,),
    "readGroup": (0, 9, 12, 13),
    "writeGroup": (
        1, 2, 3, 4, 5, 6, 14, 15, 17, 18, 19, 20, 21, 22, 25, 26,
        28, 29, 30,
    ),
}

# parser.go:293 DeniedMsgBase: status 0x0008, body 'access denied'
DENIED_MSG = bytes(
    [0x81, 0, 0, 0, 0, 0, 0, 8, 0, 0, 0, 0x0D, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0]
) + b"access denied"


class MemcacheParseError(ValueError):
    pass


@dataclass(frozen=True)
class MemcacheRuleSpec:
    """One compiled rule (BinaryMemcacheRule, parser.go:32)."""

    identity_indices: frozenset
    op_codes: Tuple[int, ...]
    key_exact: str = ""
    key_prefix: str = ""
    key_regex: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "identity_indices", frozenset(self.identity_indices)
        )

    @property
    def device_expressible(self) -> bool:
        return self.key_prefix == "" and self.key_regex == ""


def compile_rules(
    dicts: Sequence[dict], identity_indices: Sequence[int]
) -> List[MemcacheRuleSpec]:
    """L7BinaryMemcacheRuleParser (parser.go:89): each dict carries
    `opCode` (required) and at most one key matcher.  An EMPTY dict
    list is the wildcard allow-all for the selector."""
    if not dicts:
        return [
            MemcacheRuleSpec(
                identity_indices=identity_indices,
                op_codes=tuple(range(256)),
            )
        ]
    specs = []
    for d in dicts:
        op_name = d.get("opCode", "")
        if op_name not in OPCODE_MAP:
            raise ValueError(
                f"unsupported or missing opCode {op_name!r}"
            )
        unknown = set(d) - {"opCode", "keyExact", "keyPrefix", "keyRegex"}
        if unknown:
            raise ValueError(f"unsupported keys: {sorted(unknown)}")
        matchers = [
            k
            for k in ("keyExact", "keyPrefix", "keyRegex")
            if d.get(k, "")
        ]
        if len(matchers) > 1:
            raise ValueError(
                f"at most one key matcher allowed, got {matchers}"
            )
        specs.append(
            MemcacheRuleSpec(
                identity_indices=identity_indices,
                op_codes=OPCODE_MAP[op_name],
                key_exact=d.get("keyExact", ""),
                key_prefix=d.get("keyPrefix", ""),
                key_regex=d.get("keyRegex", ""),
            )
        )
    return specs


def rule_matches(request: L7Request, spec: MemcacheRuleSpec) -> bool:
    """BinaryMemcacheRule.Matches (parser.go:52)."""
    opcode = int(request.get("opcode", "-1"))
    if opcode not in spec.op_codes:
        return False
    key = request.get("key")
    if spec.key_exact != "":
        return spec.key_exact == key
    if spec.key_prefix != "":
        return key.startswith(spec.key_prefix)
    if spec.key_regex != "":
        return re.search(spec.key_regex, key) is not None
    return True  # no key rule: match by opcode


def decode_stream(buf: bytes) -> Tuple[List[L7Request], int]:
    """Parse complete request frames; returns (requests, consumed).
    Trailing partial frames stay unconsumed (proxylib.MORE); a
    response-magic frame in the request direction is connection-fatal
    (parser.go getOpcodeAndKey ERROR_INVALID_FRAME_TYPE)."""
    requests = []
    off = 0
    while off + HEADER_SIZE <= len(buf):
        magic = buf[off]
        if magic != REQUEST_MAGIC:
            # includes response magic 0x81 in the request direction:
            # connection-fatal, as the reference's
            # ERROR_INVALID_FRAME_TYPE
            raise MemcacheParseError(
                f"invalid request magic 0x{magic:02x}"
            )
        opcode = buf[off + 1]
        key_len = struct.unpack_from(">H", buf, off + 2)[0]
        extras_len = buf[off + 4]
        body_len = struct.unpack_from(">I", buf, off + 8)[0]
        if extras_len + key_len > body_len:
            raise MemcacheParseError(
                f"frame claims extras {extras_len} + key {key_len} "
                f"beyond body length {body_len}"
            )
        total = HEADER_SIZE + body_len
        if off + total > len(buf):
            break  # MORE
        key = b""
        if key_len:
            ks = off + HEADER_SIZE + extras_len
            key = buf[ks : ks + key_len]
        requests.append(
            L7Request(
                proto=PARSER_NAME,
                fields=(
                    ("opcode", str(opcode)),
                    ("key", key.decode("utf-8", "replace")),
                ),
            )
        )
        off += total
    return requests, off


def encode_request(
    opcode: int, key: str = "", extras: bytes = b"", value: bytes = b""
) -> bytes:
    """Wire synthesis for tests/bench (the reverse of decode)."""
    kb = key.encode()
    body = extras + kb + value
    return (
        struct.pack(
            ">BBHBBHIIQ",
            REQUEST_MAGIC,
            opcode & 0xFF,
            len(kb),
            len(extras),
            0,
            0,
            len(body),
            0,
            0,
        )
        + body
    )


def deny_response(request: L7Request) -> bytes:
    return DENIED_MSG


@dataclass
class MemcacheDeviceTables:
    """Integer-tensor form: [R] rules with 256-bit opcode masks and
    interned exact keys; [W]-word identity membership bitmasks.  The
    arrays are numpy as compiled (padded to one row when R is 0) and
    int32 tensors with the same bits once moved to a device."""

    opcode_mask: np.ndarray  # u32 [R, 8]
    key_id: np.ndarray  # u32 [R] (0 = no exact-key constraint)
    device_ok: np.ndarray  # bool [R] (False: prefix/regex, host only)
    ident_rules: np.ndarray  # u32 [N, W] rule-membership bits
    interner: Interner
    specs: List[MemcacheRuleSpec]

    def pack(self, requests) -> Tuple[np.ndarray, np.ndarray]:
        """The host loop: (opcode i32 [B], key id u32 [B]); an absent
        opcode is -1, an absent or unseen key 0."""
        b = len(requests)
        opcode = np.zeros(b, np.int32)
        key_id = np.zeros(b, np.uint32)
        for i, request in enumerate(requests):
            opcode[i] = int(request.get("opcode", "-1"))
            key_id[i] = self.interner.lookup(request.get("key"))
        return opcode, key_id

    def evaluate(self, requests, ident_idx, known):
        """(allowed [B], needs_host [B]) as numpy bools: pure integer
        compares on the device the tables lie on; needs_host marks
        rows whose identity owns a host-only rule AND the device path
        denied (a prefix/regex rule might still allow them).  With no
        rules the answer is all False and nothing is launched."""
        opcode, key_id = self.pack(requests)
        b = len(requests)
        if len(self.specs) == 0:
            return np.zeros(b, bool), np.zeros(b, bool)
        dev = table_device(self.ident_rules, "memcache tables")
        ident_idx = np.asarray(ident_idx).astype(np.int32)
        known = np.asarray(known).astype(bool)
        allowed, needs_host = memcache_match(
            self, *(array_tensor(a, dev)
                    for a in (opcode, key_id, ident_idx, known))
        )
        return allowed.cpu().numpy(), needs_host.cpu().numpy()


def memcache_match_plain(
    tables: MemcacheDeviceTables,
    opcode: torch.Tensor,  # i32 [B]
    key_id: torch.Tensor,  # u32 bits [B]
    ident_idx: torch.Tensor,  # i32 [B]
    known: torch.Tensor,  # bool [B]
):
    """Plain version of K17c (the reference's `evaluate` after its host
    pack) on device-form tables: (allowed bool [B], needs_host bool
    [B]).  Only the first R = len(specs) rules are read, never the
    padding row of an empty rule set."""
    dev = opcode.device
    b = int(opcode.shape[0])
    r = len(tables.specs)
    if r == 0:
        return (torch.zeros(b, dtype=torch.bool, device=dev),
                torch.zeros(b, dtype=torch.bool, device=dev))
    raw = opcode.to(torch.int64)
    op = raw.clamp(0, 255)
    mask = widen(tables.opcode_mask[:r])  # [R, 8]
    # select each request's mask word first ([B, R]), then test the bit
    words = mask.T[op >> 5]  # [B, R]
    op_ok = ((words >> (op & 31)[:, None]) & 1).bool() & (raw[:, None] >= 0)

    rk = widen(tables.key_id[:r])[None, :]
    key_ok = (rk == 0) | (rk == widen(key_id)[:, None])

    j = torch.arange(r, device=dev)
    n = int(tables.ident_rules.shape[0])
    ident_bits = widen(
        tables.ident_rules[ident_idx.to(torch.int64).clamp(0, n - 1)]
    )  # [B, W]
    rule_bit = ((ident_bits[:, j >> 5] >> (j & 31)[None, :]) & 1).bool()
    base = rule_bit & known[:, None]

    dev_ok = tables.device_ok[:r].bool()[None, :]
    allowed = (base & dev_ok & op_ok & key_ok).any(dim=1)
    needs_host = (base & ~dev_ok).any(dim=1) & ~allowed
    return allowed, needs_host


def memcache_match(tables: MemcacheDeviceTables, opcode, key_id, ident_idx,
                   known):
    """K17c: the memcached verdicts of packed requests.  CUDA tensors
    launch MEMCACHE_MATCH; CPU tensors run the plain version.  An
    empty rule set answers all False without a launch.  Returns
    (allowed bool [B], needs_host bool [B])."""
    if len(tables.specs) == 0:
        return memcache_match_plain(tables, opcode, key_id, ident_idx, known)
    if opcode.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.MEMCACHE_MATCH(tables, opcode, key_id, ident_idx,
                                      known)
    if opcode.device.type == "cpu":
        return memcache_match_plain(tables, opcode, key_id, ident_idx, known)
    raise ValueError(f"unsupported device {opcode.device}")


def compile_device(
    specs: Sequence[MemcacheRuleSpec], n_identities: int
) -> MemcacheDeviceTables:
    r = len(specs)
    opcode_mask = np.zeros((max(r, 1), 8), np.uint32)
    key_id = np.zeros(max(r, 1), np.uint32)
    device_ok = np.zeros(max(r, 1), bool)
    w = max((r + 31) // 32, 1)
    ident_rules = np.zeros((max(n_identities, 1), w), np.uint32)
    interner = Interner()
    for j, spec in enumerate(specs):
        for oc in spec.op_codes:
            opcode_mask[j, oc >> 5] |= np.uint32(1 << (oc & 31))
        key_id[j] = interner.intern(spec.key_exact)
        device_ok[j] = spec.device_expressible
        for idx in spec.identity_indices:
            if 0 <= idx < n_identities:
                ident_rules[idx, j >> 5] |= np.uint32(1 << (j & 31))
    return MemcacheDeviceTables(
        opcode_mask=opcode_mask,
        key_id=key_id,
        device_ok=device_ok,
        ident_rules=ident_rules,
        interner=interner,
        specs=list(specs),
    )


register_parser(
    ParserEntry(
        name=PARSER_NAME,
        decode_stream=decode_stream,
        compile_rules=compile_rules,
        rule_matches=rule_matches,
        compile_device=compile_device,
        deny_response=deny_response,
    )
)
