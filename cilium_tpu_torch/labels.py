"""Label model: the atoms of policy identity.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

A re-design of the reference label model
(pkg/labels/labels.go, array.go, cidr.go).  Labels are
host-side control-plane objects; they never reach the device.  The device
sees only numeric identities (see cilium_tpu_torch.identity) and the
selector->identity bitmask matrices produced by cilium_tpu_torch.compiler.

Semantics reproduced bit-for-bit:
  * label sources (labels.go:124-162): unspec/any/k8s/container/reserved/cidr
  * ``$`` shorthand for reserved labels (labels.go:579-600)
  * extended keys ``source.key`` used by k8s-style selectors
    (labels.go:404-433)
  * LabelArray Has/Get with any-source semantics (array.go:90-131)
  * sorted-list serialization + sha256 used as identity key
    (labels.go:515-540)
  * CIDR -> label conversion (cidr.go:28-80): ':' -> '-', zero padding
"""

from __future__ import annotations

import hashlib
import ipaddress
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional

PATH_DELIMITER = "."

# Reserved label names (labels.go:31-53)
ID_NAME_ALL = "all"
ID_NAME_HOST = "host"
ID_NAME_WORLD = "world"
ID_NAME_CLUSTER = "cluster"
ID_NAME_HEALTH = "health"
ID_NAME_INIT = "init"
ID_NAME_UNKNOWN = "unknown"

# Label sources (labels.go:124-162)
SOURCE_UNSPEC = "unspec"
SOURCE_ANY = "any"
SOURCE_ANY_KEY_PREFIX = SOURCE_ANY + "."
SOURCE_K8S = "k8s"
SOURCE_MESOS = "mesos"
SOURCE_K8S_KEY_PREFIX = SOURCE_K8S + "."
SOURCE_CONTAINER = "container"
SOURCE_RESERVED = "reserved"
SOURCE_CIDR = "cidr"
SOURCE_RESERVED_KEY_PREFIX = SOURCE_RESERVED + "."
SOURCE_CILIUM_GENERATED = "cilium-generated"

LABEL_KEY_FIXED_IDENTITY = "io.cilium.fixed-identity"


@dataclass(frozen=True)
class Label:
    """A single ``source:key=value`` label (labels.go:165)."""

    key: str
    value: str = ""
    source: str = SOURCE_UNSPEC

    def equals(self, other: "Label") -> bool:
        """Label equality honoring the any-source wildcard (labels.go:312)."""
        if not self.is_any_source():
            if self.source != other.source:
                return False
        return self.key == other.key and self.value == other.value

    def is_all_label(self) -> bool:
        return self.source == SOURCE_RESERVED and self.key == ID_NAME_ALL

    def is_any_source(self) -> bool:
        return self.source == SOURCE_ANY

    def is_reserved_source(self) -> bool:
        return self.source == SOURCE_RESERVED

    def matches(self, target: "Label") -> bool:
        """True if self matches target (labels.go:337)."""
        return self.is_all_label() or self.equals(target)

    def get_extended_key(self) -> str:
        """``source.key`` form used by selectors (labels.go:405)."""
        return self.source + PATH_DELIMITER + self.key

    def is_valid(self) -> bool:
        return self.key != ""

    def __str__(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"


def parse_source(s: str) -> tuple:
    """Split a label string into (source, rest) (labels.go:579).

    ``$x`` is shorthand for ``reserved:x``.
    """
    if s == "":
        return "", ""
    if s[0] == "$":
        s = s.replace("$", SOURCE_RESERVED + ":", 1)
    parts = s.split(":", 1)
    if len(parts) != 2:
        nxt = parts[0]
        src = ""
        if nxt.startswith(SOURCE_RESERVED):
            src = SOURCE_RESERVED
            if nxt.startswith(SOURCE_RESERVED_KEY_PREFIX):
                nxt = nxt[len(SOURCE_RESERVED_KEY_PREFIX):]
        return src, nxt
    src = parts[0] if parts[0] != "" else ""
    return src, parts[1]


def new_label(key: str, value: str = "", source: str = "") -> Label:
    """Construct a label, parsing an embedded source prefix (labels.go:289)."""
    src, key = parse_source(key)
    if source == "":
        source = src if src != "" else SOURCE_UNSPEC
    if src == SOURCE_RESERVED and key == "":
        key = value
        value = ""
    return Label(key=key, value=value, source=source)


@lru_cache(maxsize=4096)
def parse_label(s: str) -> Label:
    """Parse ``[source:]key[=value]`` (labels.go:605).  Label is
    frozen, so the parse memoizes safely — selector matching parses
    the same handful of key strings millions of times per sweep."""
    src, nxt = parse_source(s)
    source = src if src != "" else SOURCE_UNSPEC
    key_split = nxt.split("=", 1)
    key = key_split[0]
    value = ""
    if len(key_split) > 1:
        if src == SOURCE_RESERVED and key_split[0] == "":
            key = key_split[1]
        else:
            value = key_split[1]
    return Label(key=key, value=value, source=source)


def parse_select_label(s: str) -> Label:
    """Like parse_label but unspecified source becomes ``any`` (labels.go:629)."""
    lbl = parse_label(s)
    if lbl.source == SOURCE_UNSPEC:
        return Label(key=lbl.key, value=lbl.value, source=SOURCE_ANY)
    return lbl


def get_cilium_key_from(ext_key: str) -> str:
    """``source.key`` extended key -> ``source:key`` (labels.go:411)."""
    parts = ext_key.split(PATH_DELIMITER, 1)
    if len(parts) == 2:
        return parts[0] + ":" + parts[1]
    return SOURCE_ANY + ":" + parts[0]


def get_extended_key_from(s: str) -> str:
    """``k8s:foo=bar`` -> ``k8s.foo``; ``foo`` -> ``any.foo`` (labels.go:424)."""
    src, nxt = parse_source(s)
    if src == "":
        src = SOURCE_ANY
    nxt = nxt.split("=", 2)[0]
    return src + PATH_DELIMITER + nxt


class LabelArray(list):
    """An ordered set of labels; the context unit of policy matching.

    Implements the k8s ``Labels`` interface semantics the selectors match
    against (array.go:90-131): ``has``/``get`` take extended keys and treat
    ``any.`` as source-wildcard.
    """

    @staticmethod
    def parse(*labels: str) -> "LabelArray":
        return LabelArray(parse_label(s) for s in labels)

    @staticmethod
    def parse_select(*labels: str) -> "LabelArray":
        return LabelArray(parse_select_label(s) for s in labels)

    def contains(self, needed: "LabelArray") -> bool:
        """True if every needed label matches one of ours (array.go:58)."""
        return all(any(n.matches(l) for l in self) for n in needed)

    def lacks(self, needed: "LabelArray") -> "LabelArray":
        return LabelArray(
            n for n in needed if not any(n.matches(l) for l in self)
        )

    def has(self, ext_key: str) -> bool:
        """k8s Labels.Has with any-source handling (array.go:92)."""
        ck = get_cilium_key_from(ext_key)
        key_label = parse_label(ck)
        if key_label.is_any_source():
            return any(l.key == key_label.key for l in self)
        return any(l.get_extended_key() == ext_key for l in self)

    def get(self, ext_key: str) -> str:
        """k8s Labels.Get with any-source handling (array.go:114)."""
        ck = get_cilium_key_from(ext_key)
        key_label = parse_label(ck)
        if key_label.is_any_source():
            for l in self:
                if l.key == key_label.key:
                    return l.value
        else:
            for l in self:
                if l.get_extended_key() == ext_key:
                    return l.value
        return ""

    def get_model(self) -> List[str]:
        return [str(l) for l in self]

    def sorted_list(self) -> bytes:
        """Canonical serialization used as the identity key (labels.go:525)."""
        by_key: Dict[str, Label] = {}
        for l in self:
            by_key[l.key] = l
        out = ""
        for k in sorted(by_key):
            l = by_key[k]
            out += f"{l.source}:{k}={l.value};"
        return out.encode()

    def sha256sum(self) -> str:
        """SHA-512/256 of the sorted list (labels.go:517)."""
        return hashlib.new("sha512_256", self.sorted_list()).hexdigest()

    def __hash__(self):  # type: ignore[override]
        return hash(self.sorted_list())


class Labels(dict):
    """Map key -> Label (labels.go:175)."""

    @staticmethod
    def from_model(base: Iterable[str]) -> "Labels":
        lbls = Labels()
        for s in base:
            l = parse_label(s)
            if l.key != "":
                lbls[l.key] = l
        return lbls

    @staticmethod
    def from_sorted_list(s: str) -> "Labels":
        return Labels.from_model(s.split(";"))

    def merge(self, other: "Labels") -> None:
        for k, v in other.items():
            self[k] = v

    def to_label_array(self) -> LabelArray:
        return LabelArray(self[k] for k in sorted(self))

    def sorted_list(self) -> bytes:
        out = ""
        for k in sorted(self):
            l = self[k]
            out += f"{l.source}:{k}={l.value};"
        return out.encode()

    def sha256sum(self) -> str:
        return hashlib.new("sha512_256", self.sorted_list()).hexdigest()

    def find_reserved(self) -> Optional["Labels"]:
        found = Labels(
            {k: l for k, l in self.items() if l.source == SOURCE_RESERVED}
        )
        return found if found else None

    def equals(self, other: "Labels") -> bool:
        if len(self) != len(other):
            return False
        for k, l1 in self.items():
            l2 = other.get(k)
            if l2 is None:
                return False
            if (l1.source, l1.key, l1.value) != (l2.source, l2.key, l2.value):
                return False
        return True


# ---------------------------------------------------------------------------
# CIDR labels (pkg/labels/cidr.go)
# ---------------------------------------------------------------------------


def _masked_ip_to_label_string(ip: str, prefix: int) -> str:
    """Serialize ip/prefix into a selectable label string (cidr.go:28-45).

    IPv6 ':' becomes '-'; a leading/trailing '-' gets a '0' guard.
    """
    ip_no_colons = ip.replace(":", "-")
    pre = "0" if ip_no_colons[0] == "-" else ""
    post = "0" if ip_no_colons[-1] == "-" else ""
    return f"{SOURCE_CIDR}:{pre}{ip_no_colons}{post}/{prefix}"


def ip_net_to_label(network: ipaddress._BaseNetwork) -> Label:
    """CIDR network -> label (cidr.go:49)."""
    return parse_label(
        _masked_ip_to_label_string(str(network.network_address),
                                   network.prefixlen)
    )


def ip_string_to_label(ip: str) -> Optional[Label]:
    """Parse an IP or CIDR string into a cidr: label (cidr.go:57-73)."""
    try:
        net = ipaddress.ip_network(ip, strict=False)
    except ValueError:
        return None
    return ip_net_to_label(net)


def masked_ip_net_to_label_string(network: ipaddress._BaseNetwork,
                                  prefix: int) -> str:
    """Mask a network to 'prefix' bits then serialize (cidr.go:76)."""
    bits = network.max_prefixlen
    masked = ipaddress.ip_network(
        (int(network.network_address) & _mask_int(prefix, bits), prefix),
        strict=False,
    )
    return _masked_ip_to_label_string(str(masked.network_address), prefix)


def _mask_int(prefix: int, bits: int) -> int:
    if prefix <= 0:
        return 0
    return ((1 << prefix) - 1) << (bits - prefix)


def get_cidr_labels(network: ipaddress._BaseNetwork) -> LabelArray:
    """All-prefix-length label expansion of a CIDR (pkg/labels/cidr/cidr.go).

    A /24 yields labels for /0../24 plus reserved:world, so that a CIDR
    identity is selectable by any covering prefix.
    """
    out = LabelArray()
    out.append(Label(key=ID_NAME_WORLD, value="", source=SOURCE_RESERVED))
    for plen in range(0, network.prefixlen + 1):
        out.append(parse_label(masked_ip_net_to_label_string(network, plen)))
    return out


def labels_from_json(items: list) -> "Labels":
    """Wire/checkpoint label decoding: [{key, value?, source?}] →
    Labels.  One definition for every JSON surface (REST endpoint
    create, endpoint checkpoints) — raises ValueError on an item
    without a key, so transports can classify it as a client fault."""
    out = {}
    for item in items:
        if "key" not in item:
            raise ValueError(f"label item without key: {item!r}")
        out[item["key"]] = Label(
            key=item["key"],
            value=item.get("value", ""),
            source=item.get("source", "unspec"),
        )
    return Labels(out)
