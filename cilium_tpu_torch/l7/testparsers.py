"""The proxylib test parsers — framing edge-case consumers of the
generic parser registry.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Ports of proxylib/testparsers/{lineparser,blockparser,
headerparser}.go: the reference ships these to exercise the parser
framework's framing contract (partial frames, length-prefixed blocks,
multi-frame buffers, invalid lengths) independently of any real
protocol.  Registering them here proves the same contract for this
framework's registry (l7/proxylib.py) beyond the bundled memcached
parser:

  * test.lineparser — newline-delimited frames; a line passes when it
    starts with "PASS" (lineparser.go:96-104's data-driven verdict);
  * test.blockparser — "<digits>:<content>" frames where the digit
    prefix counts the WHOLE block excluding the ':'; malformed or
    short lengths are framing errors (blockparser.go getBlock);
  * test.headerparser — line frames matched against policy rules with
    HasPrefix / Contains / HasSuffix keys over the whitespace-trimmed
    line (headerparser.go HeaderRule.Matches); no rule matching ⇒
    deny (fail closed, as the reference drops with a Denied log).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from cilium_tpu_torch.l7.proxylib import (
    L7Request,
    ParserEntry,
    register_parser,
)


class FramingError(ValueError):
    """Invalid frame (blockparser's ERROR_INVALID_FRAME_LENGTH)."""


# -- line framing ------------------------------------------------------------


def _decode_lines(data: bytes, proto: str):
    requests: List[L7Request] = []
    consumed = 0
    while True:
        idx = data.find(b"\n", consumed)
        if idx < 0:
            break  # partial line: wait for more (lineparser MORE)
        line = data[consumed : idx + 1]
        requests.append(
            L7Request(
                proto=proto,
                fields=(
                    ("line", line.decode("latin-1")),
                ),
            )
        )
        consumed = idx + 1
    return requests, consumed


# -- test.lineparser ---------------------------------------------------------


@dataclass(frozen=True)
class PassRule:
    """Data-driven verdict: lines starting with PASS pass."""

    identity_indices: Tuple[int, ...] = ()


def _line_compile(rules: Sequence[dict], identity_indices):
    # the line parser's verdict is data-driven; one pseudo-rule per
    # selector keeps the identity gating contract
    return [PassRule(identity_indices=tuple(identity_indices))]

def _line_matches(request: L7Request, spec) -> bool:
    return request.get("line").startswith("PASS")


register_parser(
    ParserEntry(
        name="test.lineparser",
        decode_stream=lambda data: _decode_lines(
            data, "test.lineparser"
        ),
        compile_rules=_line_compile,
        rule_matches=_line_matches,
        deny_response=lambda req: b"DROPPED\n",
    )
)


# -- test.blockparser --------------------------------------------------------


def _decode_blocks(data: bytes):
    """"<digits>:<content>" frames; the digit prefix counts digits +
    content (excluding ':').  Raises FramingError on a non-numeric or
    too-short length, exactly where the reference returns
    ERROR_INVALID_FRAME_LENGTH."""
    requests: List[L7Request] = []
    consumed = 0
    while True:
        colon = data.find(b":", consumed)
        if colon < 0:
            break  # no full length prefix yet
        digits = data[consumed:colon]
        if not digits.isdigit():
            raise FramingError(f"invalid block length {digits!r}")
        block_len = int(digits)
        if block_len <= len(digits):
            raise FramingError("block length too short")
        content_len = block_len - len(digits)
        if colon + 1 + content_len > len(data):
            break  # partial frame: wait for more
        content = data[colon + 1 : colon + 1 + content_len]
        requests.append(
            L7Request(
                proto="test.blockparser",
                fields=(("block", content.decode("latin-1")),),
            )
        )
        consumed = colon + 1 + content_len
    return requests, consumed


def _block_matches(request: L7Request, spec) -> bool:
    return request.get("block").startswith("PASS")


register_parser(
    ParserEntry(
        name="test.blockparser",
        decode_stream=_decode_blocks,
        compile_rules=_line_compile,
        rule_matches=_block_matches,
        # length counts digits + content: 1 + len("DROPPED") = 8
        deny_response=lambda req: b"8:DROPPED",
    )
)


# -- test.headerparser -------------------------------------------------------


@dataclass(frozen=True)
class HeaderRule:
    """headerparser.go HeaderRule: all present fields must match the
    whitespace-trimmed line."""

    identity_indices: Tuple[int, ...] = ()
    has_prefix: str = ""
    contains: str = ""
    has_suffix: str = ""


def _header_compile(rules: Sequence[dict], identity_indices):
    specs = []
    for rule in rules:
        specs.append(
            HeaderRule(
                identity_indices=tuple(identity_indices),
                has_prefix=rule.get("HasPrefix", ""),
                contains=rule.get("Contains", ""),
                has_suffix=rule.get("HasSuffix", ""),
            )
        )
    return specs


def _header_matches(request: L7Request, spec: HeaderRule) -> bool:
    line = request.get("line").strip()
    if spec.has_prefix and not line.startswith(spec.has_prefix):
        return False
    if spec.contains and spec.contains not in line:
        return False
    if spec.has_suffix and not line.endswith(spec.has_suffix):
        return False
    return True


register_parser(
    ParserEntry(
        name="test.headerparser",
        decode_stream=lambda data: _decode_lines(
            data, "test.headerparser"
        ),
        compile_rules=_header_compile,
        rule_matches=_header_matches,
    )
)
