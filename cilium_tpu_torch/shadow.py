"""Shadow policy rollout: the candidate world and the verdict diff.

The port's own copy of the parts of the JAX package's shadow.py that
do not need the daemon's dispatch: the transition codes, the diff
record, `compile_candidate_world` (a candidate rule set compiled into a
full shadow world against the live identity universe and endpoint set)
and `diff_codes`, the per-row diff of two verdict sets.

`diff_codes(la, lp, lk, sa, sp, sk)` takes the live and shadow
`Verdicts` columns (allowed u8, proxy_port int32, match_kind u8, all
[B]) and returns four u8 [B] columns: the changed flags of the three
verdict columns and the transition code.  On CUDA tensors it launches
SHADOW_DIFF (K19, `csrc/shadow.cu`) or raises; on CPU tensors it runs
the plain version `diff_codes_plain`; `diff_codes_np` is the host
oracle's numpy form (the reference's `xp=np`).

`ShadowPlane` (the armed window, its sampled dual-epoch dispatch and
its drain) waits for the daemon's dispatch and drain (ROADMAP queue 1
item 5).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

# diff transition codes (the device diff kernel's per-row output)
TRANS_NONE = 0
TRANS_ALLOW_TO_DENY = 1
TRANS_DENY_TO_ALLOW = 2
TRANS_CHANGED = 3  # verdict kept, match_kind/proxy_port moved

TRANS_NAMES = {
    TRANS_NONE: "",
    TRANS_ALLOW_TO_DENY: "allow_to_deny",
    TRANS_DENY_TO_ALLOW: "deny_to_allow",
    TRANS_CHANGED: "changed",
}

_DIRECTION_NAMES = {0: "INGRESS", 1: "EGRESS"}

# the verdict columns the diff covers — every column the lattice
# dispatch returns (engine.verdict.Verdicts)
DIFF_COLUMNS = ("allowed", "proxy_port", "match_kind")


def diff_codes_np(live_allowed, live_proxy, live_kind, shadow_allowed,
                  shadow_proxy, shadow_kind):
    """The diff definition over numpy columns (the host oracle's
    form): per-row changed flags per verdict column plus a transition
    code, from int32 compares of the widened values."""
    la = np.asarray(live_allowed).astype(np.int32)
    ca = la != np.asarray(shadow_allowed).astype(np.int32)
    cp = (np.asarray(live_proxy).astype(np.int32)
          != np.asarray(shadow_proxy).astype(np.int32))
    ck = (np.asarray(live_kind).astype(np.int32)
          != np.asarray(shadow_kind).astype(np.int32))
    a2d = ca & (la != 0)
    d2a = ca & (la == 0)
    trans = np.where(
        a2d, np.int32(TRANS_ALLOW_TO_DENY),
        np.where(d2a, np.int32(TRANS_DENY_TO_ALLOW),
                 np.where(cp | ck, np.int32(TRANS_CHANGED),
                          np.int32(TRANS_NONE))))
    return (ca.astype(np.uint8), cp.astype(np.uint8), ck.astype(np.uint8),
            trans.astype(np.uint8))


def diff_codes_plain(live_allowed, live_proxy, live_kind, shadow_allowed,
                     shadow_proxy, shadow_kind):
    """SHADOW_DIFF's plain version over tensors: the same int32
    compares and the same nested choice (allow to deny, then deny to
    allow, then changed)."""
    la = live_allowed.to(torch.int32)
    ca = la != shadow_allowed.to(torch.int32)
    cp = live_proxy.to(torch.int32) != shadow_proxy.to(torch.int32)
    ck = live_kind.to(torch.int32) != shadow_kind.to(torch.int32)
    a2d = ca & (la != 0)
    d2a = ca & (la == 0)
    trans = torch.full_like(la, TRANS_NONE)
    trans = torch.where(cp | ck, TRANS_CHANGED, trans)
    trans = torch.where(d2a, TRANS_DENY_TO_ALLOW, trans)
    trans = torch.where(a2d, TRANS_ALLOW_TO_DENY, trans)
    return (ca.to(torch.uint8), cp.to(torch.uint8), ck.to(torch.uint8),
            trans.to(torch.uint8))


def diff_codes(live_allowed, live_proxy, live_kind, shadow_allowed,
               shadow_proxy, shadow_kind):
    """The per-row diff of two verdict sets (the reference's jitted
    `shadow.diff`): SHADOW_DIFF on CUDA tensors, the plain version on
    CPU tensors.  Returns (ca, cp, ck, trans), u8 [B] each."""
    cols = (live_allowed, live_proxy, live_kind, shadow_allowed,
            shadow_proxy, shadow_kind)
    devs = {c.device for c in cols}
    if len(devs) != 1:
        raise ValueError(f"diff_codes: columns on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.SHADOW_DIFF(*cols)
    if dev.type == "cpu":
        return diff_codes_plain(*cols)
    raise ValueError(f"unsupported device {dev}")


@dataclass
class DiffRecord:
    """One re-verdicted tuple of an armed shadow window (the changed
    row's old/new verdict pair, Hubble-oriented identities, and the
    drop-reason transition an operator greps for)."""

    ts: float
    ep_id: int
    src_identity: int
    dst_identity: int
    dport: int
    proto: int
    direction: int  # 0=ingress 1=egress
    live_allowed: bool
    shadow_allowed: bool
    live_match_kind: int
    shadow_match_kind: int
    live_proxy_port: int
    shadow_proxy_port: int
    transition: str  # allow_to_deny | deny_to_allow | changed
    live_reason: str = ""  # canonical drop reason ("" = forwarded)
    shadow_reason: str = ""
    tenant: str = ""
    trace_id: str = ""
    seq: int = 0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["direction"] = _DIRECTION_NAMES.get(
            self.direction, str(self.direction)
        )
        return d


def _drop_reason_of(allowed, kind) -> str:
    """Canonical reason name of a denied lattice verdict — the SAME
    classification the flow plane applies (telemetry's policy/frag
    split; the audit path has no prefilter column)."""
    from cilium_tpu_torch.engine.oracle import MATCH_FRAG_DROP
    from cilium_tpu_torch.telemetry import (
        DROP_COLUMN_REASONS,
        TELEM_DROP_FRAG,
        TELEM_DROP_POLICY,
    )

    if allowed:
        return ""
    return DROP_COLUMN_REASONS[
        TELEM_DROP_FRAG if kind == MATCH_FRAG_DROP else TELEM_DROP_POLICY
    ]


def _norm_stamp(gen) -> int:
    """Normalize a table generation to the store-scoped publish
    counter bits (a device round trip without x64 truncates to u32 —
    the engine.publish._norm convention)."""
    return int(np.asarray(gen)) & 0xFFFFFFFF


def compile_candidate_world(daemon, rules):
    """Compile candidate rules into a full shadow world against the
    LIVE identity universe and endpoint set, without touching any
    live daemon state: live rules with same-labeled rules replaced by
    the candidates (the ``policy_add(replace=True)`` semantics a
    later promote applies), lowered per endpoint through the same
    ``compute_desired_policy_map_state`` the real regeneration path
    runs, stacked by a FRESH FleetCompiler.

    Returns (tables, index, states) with ``index`` guaranteed equal
    to the live published index (same endpoint axis — the diff
    dispatches ONE staged batch against both worlds).

    Boundary: candidate rules are resolved against the live identity
    universe — CIDR selectors match only already-allocated prefix
    identities, and L7 redirects not already realized on an endpoint
    surface with proxy_port 0 (the reference defers them to port
    allocation at real cutover).  Both are exactly what an operator
    wants answered pre-cutover: how does THIS world's traffic
    re-verdict."""
    from cilium_tpu_torch.compiler.mapstate import (
        compute_desired_policy_map_state,
        resolve_l4_policy,
    )
    from cilium_tpu_torch.compiler.selectorcache import SelectorCache
    from cilium_tpu_torch.compiler.tables import FleetCompiler
    from cilium_tpu_torch.policy.repository import Repository

    with daemon.lock:
        live_rules = [pr.rule for pr in daemon.repo.rules]
    keep = list(live_rules)
    for cand in rules:
        keep = [
            r for r in keep if not r.labels.contains(cand.labels)
        ]
    repo2 = Repository()
    repo2.add_list(keep + list(rules))
    cache, _ = daemon.identity_allocator.identity_cache_versioned()
    sc = SelectorCache()
    sc.sync(cache)
    entries = []
    eps = sorted(
        daemon.endpoint_manager.endpoints(), key=lambda e: e.id
    )
    for i, ep in enumerate(eps):
        if ep.security_identity is None:
            entries.append((ep.id, {}, ("shadow", i)))
            continue
        ep_labels = ep.security_identity.label_array
        ing, eg = ep.compute_policy_enforcement(repo2)
        l4 = resolve_l4_policy(repo2, ep_labels, ing, eg)
        state = compute_desired_policy_map_state(
            repo2,
            cache,
            ep_labels,
            endpoint_id=ep.id,
            ingress_enabled=ing,
            egress_enabled=eg,
            realized_redirects=dict(ep.realized_redirects),
            l4_policy=l4,
            selector_cache=sc,
        )
        entries.append((ep.id, state, ("shadow", i)))
    tables, index = FleetCompiler().compile(entries, list(cache))
    states_by_id = {eid: st for eid, st, _ in entries}
    states: list = [None] * (max(index.values(), default=-1) + 1)
    for ep_id, idx in index.items():
        states[idx] = states_by_id.get(ep_id)
    return tables, index, states
