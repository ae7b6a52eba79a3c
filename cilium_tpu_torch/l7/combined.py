"""The combined datapath + proxy step: config 5's full serving system.

Counterpart of the reference bench's combined step (bench.py
`_combined_step_fn`): the fused datapath verdicts, with the fleet L7
matchers applied inline to the flows the datapath redirects to a
proxy.  One step, for a pair of half-batches of pool rows (ingress
picks, egress picks), does:

  1. gather the pool's packed4 rows by the picks into one [2, 4, B]
     pair and run the pair step on it (ingress half, then egress
     half), counters and telemetry carried in place;
  2. per half, mark `redirected = (proxy_port > 0) & allowed` and
     compact stably to the first `cap` rows: the redirected rows in
     row order, then the others in row order (the order of the
     reference's stable argsort of where(redirected, row, B));
  3. run the fleet L7 matchers on both halves' compacted rows in one
     call (the flow's endpoint, direction, L4 slot, and its sec_id,
     which the pair step emits as the lattice index, as the identity
     index) and AND the verdict with `redirected`;
  4. per half, the u32 header (combined allowed, redirected, L7
     allowed, overflow) with the reference's wraparound sums: the
     redirected flows count as allowed only when their L7 verdict
     allows them, and `overflow` counts redirected flows past the cap.

The picks come from the caller (the reference draws them on the
device with jax.random).  `combined_step` goes through the entry
points, so CUDA tensors launch DATAPATH_PAIR and FLEET_L7;
`combined_step_plain` runs the plain versions of both.  The
compaction and the sums are PyTorch glue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from cilium_tpu_torch.device import array_tensor, narrow, u32_tensor
from cilium_tpu_torch.engine.datapath import (
    FLOW_COLUMNS,
    DatapathVerdicts,
    datapath_pair_plain,
    datapath_step_accum_pair_telem_packed4_stacked,
    pack_flow_records4,
)
from cilium_tpu_torch.l7.fleet import evaluate_fleet_l7, evaluate_fleet_l7_plain

L7_CAP = 1 << 17  # bench.py's _L7_CAP
COMBINED_BATCH = 1 << 21  # bench.py's _COMBINED_BATCH, per half
HEADER = ("combined", "redirected", "l7_allowed", "overflow")


@dataclass
class L7Pool:
    """The flow pool on a device, with each row's L7 request."""

    packed4: torch.Tensor  # [4, P] u32 bits in int32
    ep_index: torch.Tensor  # [P] int32
    direction: torch.Tensor  # [P] int32
    http: Tuple  # (m, ml, p, pl, h, hl), rows aligned with the pool
    kafka: Tuple  # pad_kafka_requests' order, rows aligned with the pool


def pool_to(pool: dict, http_fields, kafka_fields, device) -> L7Pool:
    """A world's pool columns and its per-row L7 fields (numpy) -> an
    L7Pool on `device`."""
    packed = pack_flow_records4(**{c: pool[c] for c in FLOW_COLUMNS})
    return L7Pool(
        packed4=u32_tensor(packed, device),
        ep_index=array_tensor(np.asarray(pool["ep_index"], np.int32), device),
        direction=array_tensor(np.asarray(pool["direction"], np.int32),
                               device),
        http=tuple(array_tensor(a, device) for a in http_fields),
        kafka=tuple(array_tensor(a, device) for a in kafka_fields),
    )


@dataclass
class CombinedOut:
    """One combined step's outputs: per half (0 ingress, 1 egress) the
    header u32 [4] (HEADER order, bits in int32), the L7 verdict of
    each compacted row (already ANDed with `redirected`), the
    compacted rows' indices into the half, and the datapath
    verdicts."""

    header: torch.Tensor  # [2, 4] int32
    l7_allowed: torch.Tensor  # [2, K] bool, K = min(cap, B)
    order: torch.Tensor  # [2, K] int64
    verdicts: Tuple[DatapathVerdicts, DatapathVerdicts]


def _compact(out: DatapathVerdicts, k: int):
    """Stable compaction of one half: (order [k], redirected [B])."""
    redirected = (out.proxy_port > 0) & (out.allowed != 0)
    b = redirected.shape[0]
    row = torch.arange(b, device=redirected.device)
    key = torch.where(redirected, row, b)
    order = torch.argsort(key, stable=True)[:k]
    return order, redirected


def fleet_inputs(pool: L7Pool, picks: torch.Tensor, order: torch.Tensor,
                 verdicts) -> tuple:
    """The fleet L7 matchers' inputs for both halves' compacted rows,
    ingress rows first: ((ep_index, direction, l4_slot, ident_idx,
    known), HTTP fields, Kafka fields)."""
    out_i, out_e = verdicts
    rows_pool = torch.gather(picks, 1, order).reshape(-1)  # [2k]
    slot = torch.stack([out_i.l4_slot, out_e.l4_slot]).gather(1, order)
    sec = torch.stack([out_i.sec_id, out_e.sec_id]).gather(1, order)
    cols = (
        pool.ep_index[rows_pool],
        pool.direction[rows_pool],
        slot.reshape(-1),
        sec.reshape(-1),  # the pair step's sec_id is the lattice index
        torch.ones(rows_pool.shape[0], dtype=torch.bool,
                   device=rows_pool.device),
    )
    return (cols, tuple(a[rows_pool] for a in pool.http),
            tuple(a[rows_pool] for a in pool.kafka))


def _combined(tables, fleet, pool: L7Pool, picks: torch.Tensor, acc, telem,
              cap: int, pair_fn, fleet_fn) -> CombinedOut:
    if picks.dim() != 2 or picks.shape[0] != 2:
        raise ValueError(f"picks must be [2, B], got {tuple(picks.shape)}")
    picks = picks.to(torch.int64)
    b = int(picks.shape[1])
    k = min(cap, b)
    pair = pool.packed4[:, picks].permute(1, 0, 2).contiguous()  # [2, 4, B]
    out_i, out_e, acc, telem = pair_fn(tables, pair, acc, telem)

    orders, redirs = zip(*(_compact(o, k) for o in (out_i, out_e)))
    order = torch.stack(orders)  # [2, k]
    redirected = torch.stack(redirs)  # [2, B]
    valid = torch.gather(redirected, 1, order)
    cols, http_fields, kafka_fields = fleet_inputs(
        pool, picks, order, (out_i, out_e))
    ok = fleet_fn(fleet, *cols, http_fields=http_fields,
                  kafka_fields=kafka_fields)
    l7 = ok.reshape(2, k) & valid

    allowed = torch.stack([out_i.allowed, out_e.allowed]).to(torch.int64)
    n_redirected = redirected.sum(dim=1)
    l7_allowed = l7.sum(dim=1)
    overflow = n_redirected - valid.sum(dim=1)
    combined = allowed.sum(dim=1) - n_redirected + l7_allowed
    header = narrow(
        torch.stack([combined, n_redirected, l7_allowed, overflow], dim=1)
    )
    return CombinedOut(header=header, l7_allowed=l7, order=order,
                       verdicts=(out_i, out_e))


def combined_step(tables, fleet, pool: L7Pool, picks: torch.Tensor,
                  acc: torch.Tensor, telem: torch.Tensor,
                  cap: int = L7_CAP) -> CombinedOut:
    """One combined step (see the module docstring) through the entry
    points: the pair step and the fleet L7 matchers launch their
    kernels on CUDA tensors.  `picks` [2, B] are pool rows (ingress,
    egress); `acc` and `telem` are updated in place."""
    return _combined(tables, fleet, pool, picks, acc, telem, cap,
                     datapath_step_accum_pair_telem_packed4_stacked,
                     evaluate_fleet_l7)


def combined_step_plain(tables, fleet, pool: L7Pool, picks: torch.Tensor,
                        acc: torch.Tensor, telem: torch.Tensor,
                        cap: int = L7_CAP) -> CombinedOut:
    """The same step through the plain versions of the pair step and
    the fleet L7 matchers, on any device."""
    return _combined(tables, fleet, pool, picks, acc, telem, cap,
                     datapath_pair_plain, evaluate_fleet_l7_plain)
