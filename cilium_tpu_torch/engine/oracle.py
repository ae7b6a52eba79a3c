"""Host reference evaluator: the 3-probe verdict lattice on a
PolicyMapState dict.

Line for line `__policy_can_access` (bpf/lib/policy.h:46-110):

  probe 1: exact (identity, dport, proto)   [skipped for fragments]
  probe 2: L3-only (identity, 0, 0)         -> plain allow, no proxy
  probe 3: L4 wildcard (0, dport, proto)    [skipped for fragments]
  miss:    DROP_POLICY (DROP_FRAG_NOSUPPORT for fragments)

Probe hits bump the matched entry's packets/bytes counters
(policy.h:66-68, 92-93, 101-102), which is why the oracle mutates the
state's entries unless `count_hits=False`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from cilium_tpu_torch.maps.policymap import PolicyKey, PolicyMapState

# Match-kind codes returned beside the verdict; the device lattice
# returns the same codes, so the two compare element by element.
MATCH_NONE = 0  # DROP_POLICY
MATCH_L4 = 1  # probe 1 hit
MATCH_L3 = 2  # probe 2 hit
MATCH_L4_WILD = 3  # probe 3 hit
MATCH_FRAG_DROP = 4  # DROP_FRAG_NOSUPPORT

# Drop reason codes (bpf/lib/common.h; negative returns).
DROP_POLICY = -133
DROP_FRAG_NOSUPPORT = -157


@dataclass
class Verdict:
    allowed: bool
    proxy_port: int
    match_kind: int


def policy_can_access(state: PolicyMapState, identity: int, dport: int,
                      proto: int, direction: int, is_fragment: bool = False,
                      pkt_len: int = 0, count_hits: bool = True) -> Verdict:
    """One tuple through the lattice (policy.h:46).  With
    `count_hits=False` the matched entry's counters are left as they
    are."""

    def hit(entry):
        if count_hits:
            entry.packets += 1
            entry.bytes += pkt_len

    if not is_fragment:
        entry = state.get(PolicyKey(identity, dport, proto, direction))
        if entry is not None:
            hit(entry)
            return Verdict(True, entry.proxy_port, MATCH_L4)

    entry = state.get(PolicyKey(identity, 0, 0, direction))
    if entry is not None:
        hit(entry)
        return Verdict(True, 0, MATCH_L3)

    if not is_fragment:
        entry = state.get(PolicyKey(0, dport, proto, direction))
        if entry is not None:
            hit(entry)
            return Verdict(True, entry.proxy_port, MATCH_L4_WILD)

    if is_fragment:
        return Verdict(False, 0, MATCH_FRAG_DROP)
    return Verdict(False, 0, MATCH_NONE)


def evaluate_batch_oracle(states: Sequence[PolicyMapState],
                          ep_index: np.ndarray, identity: np.ndarray,
                          dport: np.ndarray, proto: np.ndarray,
                          direction: np.ndarray,
                          is_fragment: np.ndarray | None = None):
    """A batch of tuples against E map states; returns (allowed u8,
    proxy_port u16, match_kind u8) arrays.  Counts hits, as
    policy_can_access does by default."""
    b = len(ep_index)
    if is_fragment is None:
        is_fragment = np.zeros(b, dtype=bool)
    allowed = np.zeros(b, dtype=np.uint8)
    proxy = np.zeros(b, dtype=np.uint16)
    kind = np.zeros(b, dtype=np.uint8)
    for i in range(b):
        v = policy_can_access(
            states[int(ep_index[i])], int(identity[i]), int(dport[i]),
            int(proto[i]), int(direction[i]), bool(is_fragment[i]),
        )
        allowed[i] = 1 if v.allowed else 0
        proxy[i] = v.proxy_port
        kind[i] = v.match_kind
    return allowed, proxy, kind
