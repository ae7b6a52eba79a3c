"""EndpointSelector: k8s-style label selectors over LabelArrays.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Re-design of pkg/policy/api/selector.go.  The reference
wraps k8s.io LabelSelector; we implement the identical matching semantics
natively: match_labels (AND of key==value) plus match_expressions with
In/NotIn/Exists/DoesNotExist operators, evaluated against
LabelArray.has/get (reference selector.go:277-302 and
k8s.io/apimachinery labels.Requirement.Matches).

IMPORTANT identity semantics: the reference keys L7DataMap by the
EndpointSelector *struct*, whose embedded pointers give it pointer
equality as a map key (pkg/policy/l4.go:32).  We mirror that: selectors
hash/compare by object identity, and module-level singletons
(WILDCARD_SELECTOR, reserved selectors) play the role of the reference's
package-level vars so wildcard lookups hit the same key.  Use
``deep_equal`` for structural comparison.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch import labels as lbl
from cilium_tpu_torch.labels import Label, LabelArray

# Operators (k8s LabelSelectorOperator)
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"


class Requirement:
    """One selector requirement: (key, operator, values).

    Matching semantics are those of k8s labels.Requirement.Matches, with
    keys being extended keys (``source.key``) evaluated against
    LabelArray.has/get.
    """

    __slots__ = ("key", "operator", "values")

    def __init__(self, key: str, operator: str, values: Sequence[str] = ()):
        self.key = key
        self.operator = operator
        self.values = list(values)

    def matches(self, labels: LabelArray) -> bool:
        if self.operator == OP_IN:
            if not labels.has(self.key):
                return False
            return labels.get(self.key) in self.values
        if self.operator == OP_NOT_IN:
            if not labels.has(self.key):
                return True
            return labels.get(self.key) not in self.values
        if self.operator == OP_EXISTS:
            return labels.has(self.key)
        if self.operator == OP_DOES_NOT_EXIST:
            return not labels.has(self.key)
        return False

    def copy(self) -> "Requirement":
        return Requirement(self.key, self.operator, list(self.values))

    def __repr__(self) -> str:
        return f"Requirement({self.key!r},{self.operator},{self.values})"


class EndpointSelector:
    """Selector over endpoint labels (selector.go:32).

    match_labels keys are stored in extended-key form (``any.role``,
    ``k8s.app`` ...) exactly as the reference converts them on
    UnmarshalJSON (selector.go:66-72).
    """

    def __init__(
        self,
        match_labels: Optional[Dict[str, str]] = None,
        match_expressions: Optional[List[Requirement]] = None,
    ):
        self.match_labels: Dict[str, str] = dict(match_labels or {})
        self.match_expressions: List[Requirement] = list(
            match_expressions or []
        )

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def from_labels(*labels_in: Label) -> "EndpointSelector":
        """NewESFromLabels (selector.go:178)."""
        ml = {l.get_extended_key(): l.value for l in labels_in}
        return EndpointSelector(match_labels=ml)

    @staticmethod
    def from_dict(d: dict) -> "EndpointSelector":
        """Parse the JSON form {matchLabels: {...}, matchExpressions: [...]}.

        Keys get extended-key conversion like UnmarshalJSON
        (selector.go:60-83).
        """
        ml = {
            lbl.get_extended_key_from(k): v
            for k, v in (d.get("matchLabels") or {}).items()
        }
        mes = [
            Requirement(
                lbl.get_extended_key_from(e["key"]),
                e["operator"],
                e.get("values") or [],
            )
            for e in (d.get("matchExpressions") or [])
        ]
        return EndpointSelector(match_labels=ml, match_expressions=mes)

    def to_dict(self) -> dict:
        d: dict = {}
        if self.match_labels:
            d["matchLabels"] = {
                lbl.get_cilium_key_from(k): v
                for k, v in self.match_labels.items()
            }
        if self.match_expressions:
            d["matchExpressions"] = [
                {
                    "key": lbl.get_cilium_key_from(e.key),
                    "operator": e.operator,
                    "values": list(e.values),
                }
                for e in self.match_expressions
            ]
        return d

    # -- matching ------------------------------------------------------------

    def requirements(self) -> List[Requirement]:
        """Flatten match_labels into In-requirements + match_expressions.

        Mirrors LabelSelectorAsSelector: matchLabels become single-value In
        requirements.  Sorted by key for determinism.
        """
        reqs = [
            Requirement(k, OP_IN, [v])
            for k, v in sorted(self.match_labels.items())
        ]
        reqs.extend(self.match_expressions)
        return reqs

    def matches(self, labels_to_match: Optional[LabelArray]) -> bool:
        """selector.go:277: reserved.all short-circuits; else AND of reqs.

        Memoized per label-array OBJECT (identity-pinned): per-endpoint
        resolution matches the same selectors against the same cached
        identity label arrays every sweep, and both sides are stable
        after construction.  The requirement list is cached too —
        matches() used to rebuild it per call."""
        memoize = labels_to_match is not None
        if labels_to_match is None:
            # fresh object per call — memoizing it would only churn
            # the cache with never-hittable ids
            labels_to_match = LabelArray()
        memo = self.__dict__.setdefault("_match_memo", {})
        if memoize:
            hit = memo.get(id(labels_to_match))
            if hit is not None and hit[0] is labels_to_match:
                return hit[1]
        for k in self.match_labels:
            if k == lbl.SOURCE_RESERVED_KEY_PREFIX + lbl.ID_NAME_ALL:
                # no memo insert: the short-circuit is already O(1),
                # and memoizing here would grow a wildcard selector's
                # memo unboundedly (this path skips the cap below)
                return True
        reqs = self.__dict__.get("_reqs_cache")
        if reqs is None:
            reqs = self.requirements()
            self.__dict__["_reqs_cache"] = reqs
        result = all(r.matches(labels_to_match) for r in reqs)
        if memoize:
            if len(memo) > 4096:
                memo.clear()
            memo[id(labels_to_match)] = (labels_to_match, result)
        return result

    def is_wildcard(self) -> bool:
        """selector.go:305."""
        return len(self.match_labels) + len(self.match_expressions) == 0

    def has_key(self, key: str) -> bool:
        if key in self.match_labels:
            return True
        return any(e.key == key for e in self.match_expressions)

    def has_key_prefix(self, prefix: str) -> bool:
        if any(k.startswith(prefix) for k in self.match_labels):
            return True
        return any(e.key.startswith(prefix) for e in self.match_expressions)

    def get_match(self, key: str) -> Tuple[Optional[List[str]], bool]:
        """selector.go:143."""
        if key in self.match_labels:
            return [self.match_labels[key]], True
        for e in self.match_expressions:
            if e.key == key and e.operator == OP_IN:
                return list(e.values), True
        return None, False

    def convert_to_requirements(self) -> List[Requirement]:
        """ConvertToLabelSelectorRequirementSlice (selector.go:313)."""
        reqs = [e.copy() for e in self.match_expressions]
        for k in sorted(self.match_labels):
            reqs.append(Requirement(k, OP_IN, [self.match_labels[k]]))
        return reqs

    def add_requirements(self, reqs: List[Requirement]) -> "EndpointSelector":
        """Return a copy with extra requirements appended.

        Used for FromRequires/ToRequires injection
        (pkg/policy/rule.go:247-257).  A copy to mirror the reference's
        DeepCopy-then-modify.
        """
        out = EndpointSelector(
            match_labels=dict(self.match_labels),
            match_expressions=[e.copy() for e in self.match_expressions],
        )
        out.match_expressions.extend(r.copy() for r in reqs)
        return out

    # -- identity / display --------------------------------------------------

    def deep_equal(self, other: "EndpointSelector") -> bool:
        if self.match_labels != other.match_labels:
            return False
        if len(self.match_expressions) != len(other.match_expressions):
            return False
        for a, b in zip(self.match_expressions, other.match_expressions):
            if (a.key, a.operator, a.values) != (b.key, b.operator, b.values):
                return False
        return True

    def label_selector_string(self) -> str:
        """Stable human-readable form (FormatLabelSelector analog)."""
        parts = [f"{k}={v}" for k, v in sorted(self.match_labels.items())]
        for e in self.match_expressions:
            if e.operator == OP_IN:
                parts.append(f"{e.key} in ({','.join(sorted(e.values))})")
            elif e.operator == OP_NOT_IN:
                parts.append(f"{e.key} notin ({','.join(sorted(e.values))})")
            elif e.operator == OP_EXISTS:
                parts.append(e.key)
            elif e.operator == OP_DOES_NOT_EXIST:
                parts.append(f"!{e.key}")
        return ",".join(parts)

    def __repr__(self) -> str:
        return f"EndpointSelector({self.label_selector_string() or '<all>'})"

    # Pointer-identity hashing (see module docstring).
    __hash__ = object.__hash__

    def __eq__(self, other):  # noqa: D105
        return self is other


def new_reserved_endpoint_selector(name: str) -> EndpointSelector:
    """selector.go:215."""
    return EndpointSelector.from_labels(
        Label(key=name, value="", source=lbl.SOURCE_RESERVED)
    )


# Package-level singletons (selector.go:220-231): these mirror the
# reference's globals so identity-keyed L7 maps behave identically.
WILDCARD_SELECTOR = EndpointSelector.from_labels()

RESERVED_ENDPOINT_SELECTORS = {
    lbl.ID_NAME_HOST: new_reserved_endpoint_selector(lbl.ID_NAME_HOST),
    lbl.ID_NAME_WORLD: new_reserved_endpoint_selector(lbl.ID_NAME_WORLD),
}


def selects_all_endpoints(selectors: Sequence[EndpointSelector]) -> bool:
    """EndpointSelectorSlice.SelectsAllEndpoints (selector.go:356)."""
    if len(selectors) == 0:
        return True
    return any(s.is_wildcard() for s in selectors)


def slice_matches(selectors: Sequence[EndpointSelector],
                  ctx: LabelArray) -> bool:
    """EndpointSelectorSlice.Matches (selector.go:344)."""
    return any(s.matches(ctx) for s in selectors)
