"""Host half of the datapath telemetry plane.

The instrumented single-batch forms (engine/datapath.py
`datapath_step_telem`, `datapath_step_accum_telem`) and the pair step
carry a [2, TELEM_COLS] u32 stage/drop accumulator beside the counter
buffer.  This module folds that accumulator, or the same histogram
computed on the host from per-tuple DatapathVerdicts columns, into:

  * the metrics registry (metrics.py): cilium_drop_count_total
    {reason,direction}, cilium_forward_count_total,
    cilium_policy_verdict_total and cilium_datapath_stage_total;
  * summary dicts for status output.

Both folds derive from the one mask set (engine/verdict.py
`telemetry_masks`), as the reference's do.  `fold_telemetry_per_chip`
takes a [n_chips, 2, TELEM_COLS] histogram (one chip on one card) and
`telemetry_consistent` checks one histogram's invariants.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cilium_tpu_torch.engine.verdict import (
    TELEM_COLS,
    TELEM_CT_BYPASS_ALLOW,
    TELEM_CT_DELETE,
    TELEM_CT_ESTABLISHED,
    TELEM_CT_NEW,
    TELEM_CT_RELATED,
    TELEM_CT_REPLY,
    TELEM_DENIED,
    TELEM_DROP_FRAG,
    TELEM_DROP_POLICY,
    TELEM_DROP_PREFILTER,
    TELEM_FORWARDED,
    TELEM_IPCACHE_WORLD,
    TELEM_LB_DNAT,
    TELEM_MATCH_FRAG,
    TELEM_MATCH_L3,
    TELEM_MATCH_L4,
    TELEM_MATCH_L4_WILD,
    TELEM_MATCH_NONE,
    TELEM_NAMES,
    TELEM_PROXY_REDIRECT,
    TELEM_TOTAL,
    telemetry_masks,
)
from cilium_tpu_torch.monitor.events import drop_reason_name

DIRECTION_NAMES = ("INGRESS", "EGRESS")

# drop column -> canonical bpf/lib/common.h reason string
DROP_COLUMN_REASONS = {
    TELEM_DROP_PREFILTER: drop_reason_name(-162),  # Policy denied (CIDR)
    TELEM_DROP_POLICY: drop_reason_name(-133),  # Policy denied (L3)
    TELEM_DROP_FRAG: drop_reason_name(-157),  # Fragmentation needed
}

# match column -> (match label, action label) of
# cilium_policy_verdict_total
MATCH_COLUMN_LABELS = {
    TELEM_MATCH_L4: ("l4", "allowed"),
    TELEM_MATCH_L3: ("l3", "allowed"),
    TELEM_MATCH_L4_WILD: ("l4_wild", "allowed"),
    TELEM_MATCH_NONE: ("none", "denied"),
    TELEM_MATCH_FRAG: ("frag", "denied"),
}

# stage column -> cilium_datapath_stage_total{stage} label
STAGE_COLUMN_LABELS = {
    TELEM_LB_DNAT: "lb_dnat",
    TELEM_CT_NEW: "ct_new",
    TELEM_CT_ESTABLISHED: "ct_established",
    TELEM_CT_REPLY: "ct_reply",
    TELEM_CT_RELATED: "ct_related",
    TELEM_CT_BYPASS_ALLOW: "ct_bypass_allow",
    TELEM_CT_DELETE: "ct_delete",
    TELEM_IPCACHE_WORLD: "ipcache_world",
    TELEM_PROXY_REDIRECT: "proxy_redirect",
}

_OUT_COLUMNS = ("pre_dropped", "ct_result", "match_kind", "allowed",
                "ct_delete", "proxy_port", "lb_slave", "ipcache_miss")


def _host(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return torch.from_numpy(np.array(x))


def telemetry_from_outputs(out, directions,
                           valid: Optional[int] = None) -> np.ndarray:
    """The [2, TELEM_COLS] u64 histogram of per-tuple DatapathVerdicts
    columns (tensors on any device, or numpy), as the reference folds
    it: row d sums each mask over the rows whose direction is d, so a
    direction outside {0, 1} counts in neither row.  `directions` is the
    per-tuple direction column (DatapathVerdicts does not carry it);
    `valid` keeps the first rows of a padded batch."""
    if directions is None:
        raise ValueError(
            "telemetry_from_outputs needs the per-tuple direction array "
            "(DatapathVerdicts does not carry it)"
        )
    cols = {name: _host(getattr(out, name)) for name in _OUT_COLUMNS}
    dirs = _host(directions).to(torch.int64)
    if valid is not None:
        cols = {k: a[:valid] for k, a in cols.items()}
        dirs = dirs[:valid]
    masks = telemetry_masks(*(cols[name] for name in _OUT_COLUMNS))
    telem = np.zeros((2, TELEM_COLS), np.uint64)
    for d in (0, 1):
        in_dir = dirs == d
        for c, mask in enumerate(masks):
            telem[d, c] = int((mask & in_dir).sum())
    return telem


def fold_telemetry(telem, registry=None) -> None:
    """Fold a [2, TELEM_COLS] histogram delta into the metrics registry
    (the process-global one by default).  Callers pass what accumulated
    since their last fold: the counters are cumulative."""
    if registry is None:
        from cilium_tpu_torch.metrics import registry as registry_

        registry = registry_
    telem = np.asarray(telem)
    for d, dname in enumerate(DIRECTION_NAMES):
        row = telem[d]
        if int(row[TELEM_FORWARDED]):
            registry.forward_count.inc(dname, value=int(row[TELEM_FORWARDED]))
        for col, reason in DROP_COLUMN_REASONS.items():
            if int(row[col]):
                registry.drop_count.inc(reason, dname, value=int(row[col]))
        for col, (match, action) in MATCH_COLUMN_LABELS.items():
            if int(row[col]):
                registry.policy_verdict_total.inc(
                    dname, match, action, value=int(row[col])
                )
        for col, stage in STAGE_COLUMN_LABELS.items():
            if int(row[col]):
                registry.datapath_stage_total.inc(
                    stage, dname, value=int(row[col])
                )


def fold_telemetry_per_chip(per_chip, registry=None) -> np.ndarray:
    """Fold a [n_chips, 2, TELEM_COLS] per-chip histogram delta into the
    registry: the chip-summed total through fold_telemetry, and each
    chip's rows under the `chip` label of
    cilium_datapath_telemetry_per_chip_total (summing a column over
    `chip` gives the total).  Returns the [2, TELEM_COLS] u64 total."""
    if registry is None:
        from cilium_tpu_torch.metrics import registry as registry_

        registry = registry_
    per_chip = np.asarray(per_chip).astype(np.uint64)
    total = per_chip.sum(axis=0)
    fold_telemetry(total, registry=registry)
    for chip in range(per_chip.shape[0]):
        for d, dname in enumerate(DIRECTION_NAMES):
            row = per_chip[chip, d]
            for col, name in enumerate(TELEM_NAMES):
                if int(row[col]):
                    registry.telemetry_per_chip.inc(
                        str(chip), name, dname, value=int(row[col])
                    )
    return total


def telemetry_summary(telem) -> Dict[str, Dict[str, int]]:
    """{direction: {column name: count}} of a histogram, zero columns
    left out."""
    telem = np.asarray(telem)
    out: Dict[str, Dict[str, int]] = {}
    for d, dname in enumerate(DIRECTION_NAMES):
        out[dname.lower()] = {
            name: int(v) for name, v in zip(TELEM_NAMES, telem[d]) if int(v)
        }
    return out


def telemetry_consistent(telem) -> bool:
    """One histogram's invariants: per direction, the outcomes
    partition the rows, the drop columns partition the denials and the
    CT results partition the rows."""
    telem = np.asarray(telem)
    ok = True
    for d in (0, 1):
        row = [int(v) for v in telem[d]]
        ok &= row[TELEM_TOTAL] == row[TELEM_FORWARDED] + row[TELEM_DENIED]
        ok &= row[TELEM_DENIED] == (row[TELEM_DROP_PREFILTER]
                                    + row[TELEM_DROP_POLICY]
                                    + row[TELEM_DROP_FRAG])
        ok &= row[TELEM_TOTAL] == (row[TELEM_CT_NEW] + row[TELEM_CT_ESTABLISHED]
                                   + row[TELEM_CT_REPLY] + row[TELEM_CT_RELATED])
    return bool(ok)
