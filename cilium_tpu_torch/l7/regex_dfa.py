"""POSIX-ERE-subset regex -> byte-class DFA compiler (host side, numpy).

The port's own copy of the reference compiler, kept identical in what
it emits (tests/test_torch_l7.py compares the tables leaf for leaf).
It compiles the HTTP rule regexes (pkg/policy/api/http.go:28
"extended POSIX regex", enforced FULL-match by Envoy's
HeaderMatcher_RegexMatch, pkg/envoy/server.go:332) into dense integer
transition tables that the device scan steps through:

  parse (recursive descent ERE) -> Thompson NFA -> byte-class
  compression -> subset construction -> Moore minimization.

Union automata: `compile_union` builds ONE DFA for a list of regexes
whose accept states carry a bitmask of which patterns matched, so the
union of R rules costs one pass instead of R.

Unsupported constructs (backrefs, lookaround, internal anchors,
inline flags) raise RegexUnsupported; state blowup past `max_states`
raises RegexTooComplex.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

ALL_BYTES = (1 << 256) - 1
DEFAULT_MAX_STATES = 4096
# Dead state is always state 0 in the emitted tables.
DEAD = 0


class RegexUnsupported(ValueError):
    """Construct outside the supported ERE subset."""


class RegexTooComplex(ValueError):
    """DFA state count exceeded the cap."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Node:
    pass


@dataclass
class Char(Node):
    mask: int  # 256-bit set of accepted bytes


@dataclass
class Concat(Node):
    parts: List[Node]


@dataclass
class Alt(Node):
    options: List[Node]


@dataclass
class Repeat(Node):
    node: Node
    lo: int
    hi: Optional[int]  # None = unbounded


@dataclass
class Empty(Node):
    pass


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_SPECIAL = set("|()[]{}*+?.^$\\")

_PERL_CLASSES = {
    "d": sum(1 << b for b in range(ord("0"), ord("9") + 1)),
    "w": (
        sum(1 << b for b in range(ord("0"), ord("9") + 1))
        | sum(1 << b for b in range(ord("a"), ord("z") + 1))
        | sum(1 << b for b in range(ord("A"), ord("Z") + 1))
        | (1 << ord("_"))
    ),
    "s": sum(1 << ord(c) for c in " \t\n\r\f\v"),
}
_PERL_CLASSES["D"] = ALL_BYTES & ~_PERL_CLASSES["d"]
_PERL_CLASSES["W"] = ALL_BYTES & ~_PERL_CLASSES["w"]
_PERL_CLASSES["S"] = ALL_BYTES & ~_PERL_CLASSES["s"]

_POSIX_CLASSES = {
    "alpha": sum(1 << b for b in range(256) if chr(b).isalpha() and b < 128),
    "digit": _PERL_CLASSES["d"],
    "alnum": sum(
        1 << b for b in range(128) if chr(b).isalnum()
    ),
    "upper": sum(1 << b for b in range(ord("A"), ord("Z") + 1)),
    "lower": sum(1 << b for b in range(ord("a"), ord("z") + 1)),
    "space": _PERL_CLASSES["s"],
    "blank": (1 << ord(" ")) | (1 << ord("\t")),
    "punct": sum(
        1 << b
        for b in range(33, 127)
        if not chr(b).isalnum()
    ),
    "xdigit": (
        _PERL_CLASSES["d"]
        | sum(1 << b for b in range(ord("a"), ord("f") + 1))
        | sum(1 << b for b in range(ord("A"), ord("F") + 1))
    ),
    "print": sum(1 << b for b in range(32, 127)),
    "graph": sum(1 << b for b in range(33, 127)),
    "cntrl": sum(1 << b for b in range(32)) | (1 << 127),
}

# '.' matches any byte except newline (Go regexp / Python re default).
DOT_MASK = ALL_BYTES & ~(1 << ord("\n"))


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> Node:
        # Leading ^ / trailing $ are redundant under full-match.
        if self.peek() == "^":
            self.next()
        node = self.parse_alt()
        if self.i < len(self.p):
            raise RegexUnsupported(
                f"unexpected {self.p[self.i]!r} at {self.i} in {self.p!r}"
            )
        return node

    def parse_alt(self) -> Node:
        options = [self.parse_concat()]
        while self.peek() == "|":
            self.next()
            options.append(self.parse_concat())
        return options[0] if len(options) == 1 else Alt(options)

    def parse_concat(self) -> Node:
        parts: List[Node] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                # Valid only at the very end (full-match makes it a
                # no-op); elsewhere it's an internal anchor.
                self.next()
                nxt = self.peek()
                if nxt is not None and nxt not in "|)":
                    raise RegexUnsupported("internal $ anchor")
                continue
            if c == "^":
                raise RegexUnsupported("internal ^ anchor")
            parts.append(self.parse_repeat())
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Concat(parts)

    def parse_repeat(self) -> Node:
        atom = self.parse_atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = Repeat(atom, 0, None)
            elif c == "+":
                self.next()
                atom = Repeat(atom, 1, None)
            elif c == "?":
                self.next()
                atom = Repeat(atom, 0, 1)
            elif c == "{":
                save = self.i
                rep = self._try_brace()
                if rep is None:
                    self.i = save
                    break
                lo, hi = rep
                if hi is not None and (hi < lo or hi > 255):
                    raise RegexUnsupported("bad {m,n} bounds")
                atom = Repeat(atom, lo, hi)
            else:
                break
            # Non-greedy suffixes don't change the matched LANGUAGE,
            # only submatch boundaries — accept and ignore for a
            # recognizer ... but flag them to stay conservative.
            if self.peek() == "?":
                raise RegexUnsupported("non-greedy quantifier")
        return atom

    def _try_brace(self) -> Optional[Tuple[int, Optional[int]]]:
        # consume '{'; return None if not a valid counted repeat
        # (Go/POSIX treat a non-numeric '{' literally).
        self.next()
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.next()
        if self.peek() == "}":
            if not digits:
                return None
            self.next()
            n = int(digits)
            return (n, n)
        if self.peek() == ",":
            self.next()
            digits2 = ""
            while self.peek() is not None and self.peek().isdigit():
                digits2 += self.next()
            if self.peek() == "}" and digits:
                self.next()
                lo = int(digits)
                hi = int(digits2) if digits2 else None
                return (lo, hi)
        return None

    def parse_atom(self) -> Node:
        c = self.peek()
        if c is None:
            return Empty()
        if c == "(":
            self.next()
            if self.peek() == "?":
                # (?:...) non-capturing is fine; other (?...) are not.
                self.next()
                if self.peek() == ":":
                    self.next()
                else:
                    raise RegexUnsupported("inline flags / lookaround")
            node = self.parse_alt()
            if self.peek() != ")":
                raise RegexUnsupported("unbalanced paren")
            self.next()
            return node
        if c == "[":
            return self.parse_class()
        if c == ".":
            self.next()
            return Char(DOT_MASK)
        if c == "\\":
            self.next()
            return Char(self.parse_escape())
        if c in "*+?{":
            if c == "{":
                # literal '{' when not a valid counted repeat
                self.next()
                return Char(1 << ord("{"))
            raise RegexUnsupported(f"dangling quantifier {c!r}")
        self.next()
        return Char(1 << (ord(c) & 0xFF)) if ord(c) < 256 else Char(
            self._utf8_mask(c)
        )

    def _utf8_mask(self, c: str) -> int:
        raise RegexUnsupported("non-ASCII literal")

    def parse_escape(self) -> int:
        c = self.peek()
        if c is None:
            raise RegexUnsupported("trailing backslash")
        self.next()
        if c in _PERL_CLASSES:
            return _PERL_CLASSES[c]
        simple = {
            "n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
            "a": "\a", "0": "\0",
        }
        if c in simple:
            return 1 << ord(simple[c])
        if c == "x":
            h = ""
            while len(h) < 2 and self.peek() is not None and self.peek() in "0123456789abcdefABCDEF":
                h += self.next()
            if not h:
                raise RegexUnsupported(r"bad \x escape")
            return 1 << int(h, 16)
        if c.isdigit():
            raise RegexUnsupported("backreference")
        if c.isalpha():
            raise RegexUnsupported(f"unsupported escape \\{c}")
        return 1 << (ord(c) & 0xFF)

    def parse_class(self) -> Node:
        self.next()  # '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unterminated class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "[" and self.p[self.i : self.i + 2] == "[:":
                end = self.p.find(":]", self.i)
                if end < 0:
                    raise RegexUnsupported("bad [: :] class")
                name = self.p[self.i + 2 : end]
                if name not in _POSIX_CLASSES:
                    raise RegexUnsupported(f"unknown class [:{name}:]")
                mask |= _POSIX_CLASSES[name]
                self.i = end + 2
                continue
            if c == "\\":
                self.next()
                m = self.parse_escape()
                # range like \x41-\x5a
                if self.peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                    if bin(m).count("1") != 1:
                        raise RegexUnsupported("class range from multi-set")
                    lo = m.bit_length() - 1
                    self.next()
                    hi = self._class_endpoint()
                    mask |= self._range_mask(lo, hi)
                else:
                    mask |= m
                continue
            self.next()
            if self.peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self.next()
                hi = self._class_endpoint()
                mask |= self._range_mask(ord(c), hi)
            else:
                mask |= 1 << (ord(c) & 0xFF)
        if negate:
            mask = ALL_BYTES & ~mask
        return Char(mask)

    def _class_endpoint(self) -> int:
        c = self.next()
        if c == "\\":
            m = self.parse_escape()
            if bin(m).count("1") != 1:
                raise RegexUnsupported("class range to multi-set")
            return m.bit_length() - 1
        return ord(c)

    @staticmethod
    def _range_mask(lo: int, hi: int) -> int:
        if hi < lo or hi > 255:
            raise RegexUnsupported("bad class range")
        return sum(1 << b for b in range(lo, hi + 1))


def parse(pattern: str) -> Node:
    return _Parser(pattern).parse()


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[int, int]]] = []  # (mask, target)

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add(self, node: Node, start: int, end: int) -> None:
        """Wire `node` between start and end."""
        if isinstance(node, Empty):
            self.eps[start].append(end)
        elif isinstance(node, Char):
            self.trans[start].append((node.mask, end))
        elif isinstance(node, Concat):
            cur = start
            for part in node.parts[:-1]:
                nxt = self.new_state()
                self.add(part, cur, nxt)
                cur = nxt
            self.add(node.parts[-1], cur, end)
        elif isinstance(node, Alt):
            for option in node.options:
                self.add(option, start, end)
        elif isinstance(node, Repeat):
            # bounded repeats were rewritten by _expand_bounded
            assert node.hi is None, "bounded Repeat must be pre-expanded"
            cur = start
            for _ in range(node.lo):
                nxt = self.new_state()
                self.add(node.node, cur, nxt)
                cur = nxt
            loop = self.new_state()
            self.eps[cur].append(loop)
            self.add(node.node, loop, loop)
            self.eps[loop].append(end)
        else:  # pragma: no cover
            raise AssertionError(node)


def _expand_bounded(node: Node) -> Node:
    """Rewrite Repeat(lo, hi≠None) into concats/options so the NFA
    builder only sees unbounded loops."""
    if isinstance(node, Repeat):
        inner = _expand_bounded(node.node)
        if node.hi is None:
            return Repeat(inner, node.lo, None)
        parts: List[Node] = [inner] * node.lo
        for _ in range(node.hi - node.lo):
            parts.append(Alt([inner, Empty()]))
        if not parts:
            return Empty()
        return Concat(parts) if len(parts) > 1 else parts[0]
    if isinstance(node, Concat):
        return Concat([_expand_bounded(p) for p in node.parts])
    if isinstance(node, Alt):
        return Alt([_expand_bounded(o) for o in node.options])
    return node


# ---------------------------------------------------------------------------
# DFA
# ---------------------------------------------------------------------------


@dataclass
class DFA:
    """Dense byte-class DFA.

    trans  u16 [n_states, n_classes]   state 0 = dead (all self-loops)
    accept u32 [n_states, n_words]     per-pattern accept bitmask,
                                       pattern i → word i//32 bit i%32
    classes u8 [256]                   byte → class
    start  int
    """

    trans: np.ndarray
    accept: np.ndarray
    classes: np.ndarray
    start: int

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def n_words(self) -> int:
        return self.accept.shape[1]

    def run(self, data: bytes) -> int:
        """Host reference stepping; returns the accept bitmask (an
        arbitrary-width python int assembled from the accept words)."""
        s = self.start
        for b in data:
            s = int(self.trans[s, self.classes[b]])
        out = 0
        for w in range(self.accept.shape[1]):
            out |= int(self.accept[s, w]) << (32 * w)
        return out


def compile_union(
    patterns: Sequence[str], max_states: int = DEFAULT_MAX_STATES
) -> DFA:
    """One DFA accepting the union of full-match patterns, accept
    states labeled with the bitmask of patterns matched (multi-word:
    pattern i sets bit i%32 of accept word i//32 — there is no
    32-pattern cap; wide unions cost accept-table width, not states)."""
    n_words = max(1, -(-len(patterns) // 32))

    nfa = _NFA()
    start = nfa.new_state()
    accept_of: Dict[int, int] = {}  # nfa state -> pattern bit
    for bit, pattern in enumerate(patterns):
        node = _expand_bounded(parse(pattern))
        acc = nfa.new_state()
        nfa.add(node, start, acc)
        accept_of[acc] = 1 << bit

    # -- byte classes: partition 0-255 by the set of NFA masks that
    # contain each byte ------------------------------------------------------
    masks = sorted(
        {mask for trans in nfa.trans for (mask, _) in trans}
    )
    signatures: Dict[Tuple[bool, ...], int] = {}
    classes = np.zeros(256, dtype=np.uint8)
    for b in range(256):
        sig = tuple(bool(mask >> b & 1) for mask in masks)
        if sig not in signatures:
            signatures[sig] = len(signatures)
        classes[b] = signatures[sig]
    n_classes = max(len(signatures), 1)
    class_byte = [0] * n_classes  # a representative byte per class
    for b in range(255, -1, -1):
        class_byte[classes[b]] = b

    # -- epsilon closures ----------------------------------------------------
    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    # -- subset construction -------------------------------------------------
    dead = frozenset()
    start_set = closure(frozenset([start]))
    index: Dict[FrozenSet[int], int] = {dead: 0, start_set: 1}
    order = [dead, start_set]
    rows: List[List[int]] = []
    accepts: List[int] = []

    i = 0
    while i < len(order):
        current = order[i]
        i += 1
        acc = 0
        for s in current:
            acc |= accept_of.get(s, 0)
        accepts.append(acc)
        row = []
        for c in range(n_classes):
            byte = class_byte[c]
            nxt = set()
            for s in current:
                for mask, t in nfa.trans[s]:
                    if mask >> byte & 1:
                        nxt.add(t)
            target = closure(frozenset(nxt)) if nxt else dead
            if target not in index:
                if len(index) >= max_states:
                    raise RegexTooComplex(
                        f"more than {max_states} DFA states"
                    )
                index[target] = len(order)
                order.append(target)
            row.append(index[target])
        rows.append(row)

    trans = np.array(rows, dtype=np.uint16)
    accept = np.zeros((len(accepts), n_words), dtype=np.uint32)
    for s, acc in enumerate(accepts):
        for w in range(n_words):
            accept[s, w] = (acc >> (32 * w)) & 0xFFFFFFFF

    return _minimize(
        DFA(trans=trans, accept=accept, classes=classes, start=1)
    )


def _minimize(dfa: DFA) -> DFA:
    """Moore partition refinement (keeps state 0 dead, start first)."""
    n, c = dfa.trans.shape
    # initial partition by accept mask (dead state isolated by its id 0
    # only if it behaves identically to another all-reject state — safe
    # to merge, we just need SOME dead representative)
    part = {}
    block = np.zeros(n, dtype=np.int64)
    for s in range(n):
        key = tuple(int(w) for w in dfa.accept[s])
        if key not in part:
            part[key] = len(part)
        block[s] = part[key]

    while True:
        keys = {}
        new_block = np.zeros(n, dtype=np.int64)
        for s in range(n):
            key = (block[s],) + tuple(block[dfa.trans[s]])
            if key not in keys:
                keys[key] = len(keys)
            new_block[s] = keys[key]
        if len(keys) == len(set(block.tolist())):
            block = new_block
            break
        block = new_block

    # renumber: dead block of state 0 → 0, start block → 1 (unless same)
    remap: Dict[int, int] = {int(block[0]): 0}
    if int(block[dfa.start]) not in remap:
        remap[int(block[dfa.start])] = 1
    for s in range(n):
        b = int(block[s])
        if b not in remap:
            remap[b] = len(remap)
    m = len(remap)
    trans = np.zeros((m, c), dtype=np.uint16)
    accept = np.zeros((m, dfa.accept.shape[1]), dtype=np.uint32)
    for s in range(n):
        b = remap[int(block[s])]
        trans[b] = [remap[int(block[t])] for t in dfa.trans[s]]
        accept[b] = dfa.accept[s]
    return DFA(
        trans=trans,
        accept=accept,
        classes=dfa.classes,
        start=remap[int(block[dfa.start])],
    )
