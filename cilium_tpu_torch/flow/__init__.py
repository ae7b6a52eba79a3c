"""Hubble-style per-flow observability plane.

Cilium grew the monitor perf ring into Hubble: a bounded in-agent
ring of structured flow records, queryable with filters and served
over an API (hubble/pkg/server observe + the `hubble observe` CLI).
This package is that plane for the datapath (the port's copy of the
JAX package's):

  * ``store``   — FlowRecord + the bounded, lock-protected FlowStore
    ring with follow-mode wakeups and aggregation summaries;
  * ``capture`` — the fold from batched verdict outputs into records
    (all drops + head-sampled allows, classification derived from
    the SAME ``telemetry_masks`` definition set as the device
    histogram, so the two planes are bit-consistent by construction).

Fed by ``replay.replay(flow_store=...)``.
"""

from cilium_tpu_torch.flow.capture import (
    allow_sample_for_level,
    capture_batch,
    chip_of_rows,
)
from cilium_tpu_torch.flow.store import (
    VERDICT_DROPPED,
    VERDICT_FORWARDED,
    FlowFilter,
    FlowRecord,
    FlowStore,
)

__all__ = [
    "FlowFilter",
    "FlowRecord",
    "FlowStore",
    "VERDICT_DROPPED",
    "VERDICT_FORWARDED",
    "allow_sample_for_level",
    "capture_batch",
    "chip_of_rows",
]
