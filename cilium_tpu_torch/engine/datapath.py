"""Fused per-packet IPv4 datapath: the pair step and its dispatcher.

The reference's hot path is one BPF program per packet: the XDP
prefilter (bpf_xdp.c), then LB service DNAT, conntrack, identity
derivation and the policy verdict (bpf_lxc.c handle_ipv4_from_lxc /
ipv4_policy).  Here one step evaluates a *pair* of half-batches, an
ingress half and an egress half, each direction-specialized as
bpf_lxc's separate sections are (the ingress half runs no LB and no
service-scope CT probe).  Per flow:

  1. packed4 unpack;
  2. prefilter on the source address;
  3. one conntrack bucket row, fetched by the original tuple, probed
     for the service-scope key (egress) and then for the flow key;
  4. LB service select and DNAT (egress only);
  5. ipcache lookup of the peer: the lattice index and the L3 bit
     (the idx forms), or the raw identity, WORLD on a miss, indexed
     through id_direct (the generic form: a DIR-24-8 ipcache);
  6. the 3-probe policy lattice and its combine;
  7. counter scatter-add into the carried [E, 2, Kg + N] buffer;
  8. per-direction telemetry sums into the carried [2, 20] buffer;
  9. with a tunnel map (overlay mode), the tunnel endpoint of an
     allowed egress flow, on its post-DNAT destination.

On a CUDA tensor `datapath_step_accum_pair_telem_packed4_stacked`
launches the hand-written kernel (kernels.py, csrc/datapath.cu); on a
CPU tensor it runs `datapath_pair_plain`, the plain PyTorch version
of the same step.  The carried counter and telemetry buffers are
updated in place and returned.  `persistent_pair_program(k)` runs K
pair steps over a [K, 2, 4, B] super-batch: one PERSISTENT_PAIR launch
on CUDA tensors, `persistent_pair_plain` on CPU tensors; the headline's
`PersistentPairDispatcher` stages K host pairs, copies them as one
super-batch and launches it once.

The single-batch step (the reference's `datapath_step`, which its
churn loop runs) takes each flow's own direction, writes the identity
as `sec_id` and keeps no counters or telemetry.  Its forms, named as
the reference names them, add to that: `datapath_step_with_counters`
(fresh counters), `datapath_step_accum` (hits into a carried counter
buffer, the raw lattice index as `sec_id`), its per-direction
`_ingress` and `_egress` forms (a static direction: the ingress form
runs no service probe, no LB and no tunnel stage),
`datapath_step_telem` and `datapath_step_accum_telem` (the [2, 20]
telemetry sums).  On CUDA tensors each launches DATAPATH_STEP, over a
FlowBatch's [8, B] word pack or over pool[:, picks]
(`datapath_step_pool`); on CPU tensors `datapath_step_plain` runs it.
The unpacked pair forms (`datapath_step_accum_pair`, `_pair_telem`,
`_pair_telem_packed4`) pack their halves into a packed4 pair and
launch DATAPATH_PAIR.  Every plain version shares one body,
`_datapath_core`.  The host side of the CT write-back
(`apply_ct_writeback_host`) is here too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from cilium_tpu_torch.ct.device import ct_fetch_rows, ct_probe_rows
from cilium_tpu_torch.ct.table import (
    CT_ESTABLISHED,
    CT_INGRESS,
    CT_NEW,
    CT_RELATED,
    CT_REPLY,
    CT_SERVICE,
    TUPLE_F_IN,
    TUPLE_F_OUT,
    TUPLE_F_SERVICE,
    CTMap,
    CTTuple,
)
from cilium_tpu_torch.device import narrow, u32_tensor, widen
from cilium_tpu_torch.engine.verdict import (
    _accumulate_counters,
    _combine,
    _counter_cols,
    _probes,
    make_counter_buffers,
    make_telemetry_buffers,
    split_counters,
    telemetry_masks,
)
from cilium_tpu_torch.compiler.tables import RESERVED_WORLD
from cilium_tpu_torch.ipcache.lpm import (
    UNKNOWN_IDX,
    IPCacheDevice,
    ipcache_lookup_fused,
    lookup_plain,
)
from cilium_tpu_torch.lb.device import lb_select_batch
from cilium_tpu_torch.maps.policymap import EGRESS, INGRESS
from cilium_tpu_torch.prefilter import prefilter_drop
from cilium_tpu_torch.tunnel import tunnel_select


@dataclass
class DatapathTables:
    """Everything the fused step reads: the pinned maps a bpf_lxc
    program sees.  `tunnel` (TunnelTables) None is the no-overlay
    program."""

    prefilter: object  # PrefilterRanges or LPMTables
    ipcache: object  # IPCacheDevice or LPMTables
    ct: object  # CTSnapshot
    lb: object  # LBInline or LBTables
    policy: object  # PolicyTables
    tunnel: object = None


@dataclass
class FlowBatch:
    """Raw 5-tuple flows as int64 columns (u32 values for the
    addresses).  `packed` is the int32 [8, B] word pack the columns were
    split from, when they were (`flow_batch_from_packed`): the card's
    forms launch on it without packing again."""

    ep_index: torch.Tensor
    saddr: torch.Tensor
    daddr: torch.Tensor
    sport: torch.Tensor
    dport: torch.Tensor
    proto: torch.Tensor
    direction: torch.Tensor  # 0 = ingress, 1 = egress
    is_fragment: torch.Tensor  # bool
    packed: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)


VERDICT_COLUMNS = (
    "allowed", "proxy_port", "match_kind", "ct_result", "pre_dropped",
    "sec_id", "final_daddr", "final_dport", "rev_nat", "lb_slave",
    "ct_create", "ct_delete", "tunnel_endpoint", "l4_slot",
    "ipcache_miss",
)
# dtype of each column; u32 columns carry their bits in int32
VERDICT_DTYPES = {
    "allowed": torch.uint8,
    "proxy_port": torch.int32,
    "match_kind": torch.uint8,
    "ct_result": torch.uint8,
    "pre_dropped": torch.bool,
    "sec_id": torch.int32,
    "final_daddr": torch.int32,
    "final_dport": torch.int32,
    "rev_nat": torch.int32,
    "lb_slave": torch.int32,
    "ct_create": torch.bool,
    "ct_delete": torch.bool,
    "tunnel_endpoint": torch.int32,
    "l4_slot": torch.int32,
    "ipcache_miss": torch.bool,
}
U32_COLUMNS = ("sec_id", "final_daddr", "tunnel_endpoint")


@dataclass
class DatapathVerdicts:
    """Per-flow outcome of the fused step plus the CT writeback
    intents.  `sec_id` is the raw lattice index (the pair path's
    sec_idx form); `tunnel_endpoint` is zero without a tunnel map."""

    allowed: torch.Tensor  # u8
    proxy_port: torch.Tensor  # i32
    match_kind: torch.Tensor  # u8 MATCH_*
    ct_result: torch.Tensor  # u8 CT_*
    pre_dropped: torch.Tensor  # bool
    sec_id: torch.Tensor  # u32 bits in i32
    final_daddr: torch.Tensor  # u32 bits in i32
    final_dport: torch.Tensor  # i32
    rev_nat: torch.Tensor  # i32
    lb_slave: torch.Tensor  # i32
    ct_create: torch.Tensor  # bool
    ct_delete: torch.Tensor  # bool
    tunnel_endpoint: torch.Tensor  # u32 bits in i32
    l4_slot: torch.Tensor  # i32
    ipcache_miss: torch.Tensor  # bool


# THE column order of a packed [8, B] flow transfer (the pool pack of
# replay.pack_flow_pool): row j is FLOW_COLUMNS[j], each a full u32 word
FLOW_COLUMNS = (
    "ep_index", "saddr", "daddr", "sport", "dport", "proto",
    "direction", "is_fragment",
)


def flow_batch_from_packed(packed: torch.Tensor) -> FlowBatch:
    """Plain split of [8, B] rows in FLOW_COLUMNS order (u32 bits in
    any integer dtype).  The addresses are u32 values; the other
    columns are the reference's int32 casts of the words, as int64;
    `is_fragment` is any non-zero word.  No packed4 16-bit masks."""
    sign = narrow(widen(packed)).to(torch.int64)
    cols = dict(zip(FLOW_COLUMNS, sign))
    return FlowBatch(
        ep_index=cols["ep_index"],
        saddr=widen(packed[1]),
        daddr=widen(packed[2]),
        sport=cols["sport"],
        dport=cols["dport"],
        proto=cols["proto"],
        direction=cols["direction"],
        is_fragment=cols["is_fragment"] != 0,
        packed=packed if packed.dtype == torch.int32 else None,
    )


def pack_flow_batch(flows: FlowBatch) -> torch.Tensor:
    """The [8, B] int32 word pack of a FlowBatch (FLOW_COLUMNS order):
    the pack it was split from, or its columns stacked on their
    device."""
    if flows.packed is not None and flows.packed.is_contiguous():
        return flows.packed
    return narrow(torch.stack([widen(getattr(flows, c))
                               for c in FLOW_COLUMNS]))


# -- packed4: [4, B] u32 staging -----------------------------------------------
#   row 0  saddr
#   row 1  daddr
#   row 2  sport << 16 | dport
#   row 3  ep_index << 16 | proto << 8 | direction << 1 | is_fragment
def pack_flow_records4(ep_index, saddr, daddr, sport, dport, proto,
                       direction, is_fragment=None) -> np.ndarray:
    """Host half of the packed4 staging format: [4, B] u32."""
    b = len(ep_index)
    if is_fragment is None:
        is_fragment = np.zeros(b, dtype=bool)
    ep = np.asarray(ep_index).astype(np.uint32)
    if b and int(ep.max()) >= 1 << 16:
        raise ValueError("ep_index exceeds the packed4 16-bit field")
    packed = np.empty((4, b), dtype=np.uint32)
    packed[0] = np.asarray(saddr).astype(np.uint32, copy=False)
    packed[1] = np.asarray(daddr).astype(np.uint32, copy=False)
    packed[2] = ((np.asarray(sport).astype(np.uint32) & 0xFFFF) << 16) | (
        np.asarray(dport).astype(np.uint32) & 0xFFFF
    )
    packed[3] = (
        (ep << 16)
        | ((np.asarray(proto).astype(np.uint32) & 0xFF) << 8)
        | ((np.asarray(direction).astype(np.uint32) & 1) << 1)
        | np.asarray(is_fragment).astype(np.uint32)
    )
    return packed


def flow_batch_from_packed4(packed: torch.Tensor) -> FlowBatch:
    """Plain unpack of one [4, B] half (u32 bits in any int dtype)."""
    w = widen(packed)
    w3 = w[3]
    return FlowBatch(
        ep_index=w3 >> 16,
        saddr=w[0],
        daddr=w[1],
        sport=w[2] >> 16,
        dport=w[2] & 0xFFFF,
        proto=(w3 >> 8) & 0xFF,
        direction=(w3 >> 1) & 1,
        is_fragment=(w3 & 1).bool(),
    )


def _datapath_core(tables: DatapathTables, f: FlowBatch, ingress,
                   emit_sec_id: bool, lattice_fn=None):
    """Plain version of the fused per-flow pipeline, shared by both
    forms.  `ingress` is a bool [B] tensor (the single-batch form: each
    row's own direction == INGRESS) or a Python bool (one half of the
    pair form, whose ingress half runs no LB and no service-scope CT
    probe, as bpf_lxc's ingress section does not).  With a tensor the
    service probe and LB run for every row and apply where the row is
    not ingress, so a direction outside {0, 1} goes through LB.
    `emit_sec_id` writes the identity `id_table[idx]` as `sec_id`; the
    pair form writes the raw lattice index.  With a generic ipcache (not
    the idx form) `sec_id` is the looked-up identity in every form
    (WORLD on a miss), and the lattice resolves its index through
    id_direct.  Every table layout the builders pick is taken.  With a
    tunnel map, an allowed flow that is not ingress gets its post-DNAT
    destination's tunnel endpoint (the local node's IP is 0); the
    ingress half of the pair form runs no tunnel stage.  Returns
    (DatapathVerdicts, counter ingredients)."""
    ipc = tables.ipcache
    b = f.saddr.shape[0]
    dev = f.saddr.device
    if isinstance(ingress, bool):
        ing = torch.full((b,), ingress, dtype=torch.bool, device=dev)
    else:
        ing = ingress

    pre_drop = prefilter_drop(tables.prefilter, f.saddr)
    ct_rows = ct_fetch_rows(
        tables.ct, f.daddr, f.saddr, f.dport, f.sport, f.proto
    )
    if ingress is True:
        eff_daddr, eff_dport = widen(f.daddr), f.dport
        rev_nat = lb_slave = torch.zeros(b, dtype=torch.int64, device=dev)
    else:
        _, _, svc_slave = ct_probe_rows(
            tables.ct, ct_rows, f.daddr, f.saddr, f.dport, f.sport,
            f.proto, torch.full_like(f.direction, CT_SERVICE),
        )
        svc_found, slave, lb_daddr, lb_dport, lb_rev = lb_select_batch(
            tables.lb, f.saddr, f.daddr, f.sport, f.dport, f.proto,
            ct_slave=svc_slave,
        )
        do_lb = svc_found & ~ing
        eff_daddr = torch.where(do_lb, lb_daddr, widen(f.daddr))
        eff_dport = torch.where(do_lb, lb_dport, f.dport)
        rev_nat = torch.where(do_lb, lb_rev, 0)
        lb_slave = torch.where(do_lb, slave, 0)
    ct_res, _, _ = ct_probe_rows(
        tables.ct, ct_rows, eff_daddr, f.saddr, eff_dport, f.sport,
        f.proto, f.direction,
    )

    # identity derivation: the peer's ipcache entry, WORLD on a miss
    sec_ip = torch.where(ing, widen(f.saddr), eff_daddr)
    id_table = tables.policy.id_table
    ep = f.ep_index
    lattice = _probes if lattice_fn is None else lattice_fn
    if isinstance(ipc, IPCacheDevice) and ipc.values_are_idx:
        # the idx form: the entry is the lattice index + 1
        looked, l3_word = ipcache_lookup_fused(ipc, sec_ip, ing)
        n = int(id_table.shape[0])
        miss = looked == 0
        vp = torch.where(miss, int(ipc.world_plus1), looked)
        known = (vp != 0) & (vp != int(UNKNOWN_IDX))
        idx = torch.where(known, vp - 1, n - 1)
        if l3_word is None:
            idx_known = (idx, known)
        else:
            world_l3 = torch.where(ing, int(ipc.world_l3_in),
                                   int(ipc.world_l3_out))
            l3_word = torch.where(miss, world_l3, l3_word)
            l3_bit = torch.where(
                (ep >= 0) & (ep < 32), (l3_word >> ep.clamp(0, 31)) & 1, 0
            ).bool()
            idx_known = (idx, known, l3_bit)
        probe1, probe2, probe3, proxy, j, _ = lattice(
            tables.policy, ep, f.direction, eff_dport, f.proto,
            idx_known=idx_known,
        )
        sec_id = id_table[idx] if emit_sec_id else narrow(idx)
    else:
        # the generic form (DIR-24-8, or a raw-identity IPCacheDevice):
        # the identity itself, resolved to its index by the lattice;
        # sec_id is the identity in every form
        looked = lookup_plain(ipc, sec_ip)
        miss = looked == 0
        ident = torch.where(miss, RESERVED_WORLD, looked)
        probe1, probe2, probe3, proxy, j, idx = lattice(
            tables.policy, ep, f.direction, eff_dport, f.proto,
            identity=ident,
        )
        sec_id = narrow(ident)
    pol_allow, v_proxy, kind = _combine(
        probe1, probe2, probe3, proxy, f.is_fragment
    )
    idx32 = torch.where(idx >= (1 << 31), idx - (1 << 32), idx)
    cols = _counter_cols(
        kind, ep, f.direction, j, idx32, int(tables.policy.l4_meta.shape[2])
    )

    pass_ct = (ct_res == CT_REPLY) | (ct_res == CT_RELATED)
    allowed = ~pre_drop & (pass_ct | pol_allow)
    ct_delete = (ct_res == CT_ESTABLISHED) & ~pol_allow & ~pass_ct & ~pre_drop
    ct_create = (ct_res == CT_NEW) & allowed
    proxy_out = torch.where(
        pol_allow & ((ct_res == CT_NEW) | (ct_res == CT_ESTABLISHED))
        & allowed,
        v_proxy, 0,
    )
    if tables.tunnel is not None and ingress is not True:
        tunnel_ep = torch.where(
            allowed & ~ing, tunnel_select(tables.tunnel, eff_daddr), 0
        )
    else:
        tunnel_ep = torch.zeros(b, dtype=torch.int64, device=dev)
    out = DatapathVerdicts(
        allowed=allowed.to(torch.uint8),
        proxy_port=proxy_out.to(torch.int32),
        match_kind=kind,
        ct_result=ct_res,
        pre_dropped=pre_drop,
        sec_id=sec_id,
        final_daddr=narrow(eff_daddr),
        final_dport=eff_dport.to(torch.int32),
        rev_nat=rev_nat.to(torch.int32),
        lb_slave=lb_slave.to(torch.int32),
        ct_create=ct_create,
        ct_delete=ct_delete,
        tunnel_endpoint=narrow(tunnel_ep),
        l4_slot=j.to(torch.int32),
        ipcache_miss=miss,
    )
    return out, cols


def _datapath_half(tables: DatapathTables, f: FlowBatch, ingress: bool,
                   lattice_fn=None):
    """One direction-specialized half of the pair step.  Returns
    (DatapathVerdicts, counter ingredients, telemetry counts [20])."""
    out, cols = _datapath_core(tables, f, ingress, emit_sec_id=False,
                               lattice_fn=lattice_fn)
    masks = telemetry_masks(
        out.pre_dropped, out.ct_result, out.match_kind, out.allowed,
        out.ct_delete, out.proxy_port, out.lb_slave, out.ipcache_miss,
    )
    counts = torch.stack([m.sum() for m in masks])
    return out, cols, counts


def _telemetry_rows(out: DatapathVerdicts, ingress) -> torch.Tensor:
    """The [2, 20] telemetry sums (int64) of one single-batch step, as
    the reference forms them: the ingress row sums each mask over the
    rows that run as ingress, the egress row is the column total minus
    that row, so a direction word outside {0, 1} counts as egress."""
    masks = telemetry_masks(
        out.pre_dropped, out.ct_result, out.match_kind, out.allowed,
        out.ct_delete, out.proxy_port, out.lb_slave, out.ipcache_miss,
    )
    if isinstance(ingress, bool):
        ingress = torch.full_like(out.pre_dropped, ingress)
    row_in = torch.stack([(m & ingress).sum() for m in masks])
    total = torch.stack([m.sum() for m in masks])
    return torch.stack([row_in, total - row_in])


def datapath_step_plain(tables: DatapathTables, flows: FlowBatch, *,
                        acc: Optional[torch.Tensor] = None,
                        telem: Optional[torch.Tensor] = None,
                        emit_sec_id: bool = True,
                        static_dir=None) -> DatapathVerdicts:
    """Plain version of the single-batch step and its forms (the
    reference's `_datapath_core` without the pair split).  Each row
    takes its own direction, or with `static_dir` (INGRESS or EGRESS)
    runs as that side; `sec_id` is the identity or, without
    `emit_sec_id`, the raw lattice index; `acc` [E, 2, Kg + N] takes
    the counter hits (an XLA scatter's indexing) and `telem` [2, 20] the
    telemetry sums, both in place."""
    if static_dir is None:
        ingress = flows.direction == INGRESS
    else:
        ingress = static_dir == INGRESS
    out, cols = _datapath_core(tables, flows, ingress, emit_sec_id)
    if acc is not None:
        _accumulate_counters(acc, *cols)
    if telem is not None:
        telem.copy_(narrow(widen(telem) + _telemetry_rows(out, ingress)))
    return out


def _step(tables: DatapathTables, flows: FlowBatch, **form) -> DatapathVerdicts:
    """One single-batch form on the flows' device: CUDA flows launch
    DATAPATH_STEP on their [8, B] pack (direct mode, no picks), CPU
    flows run the plain version."""
    dev = flows.saddr.device
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DATAPATH_STEP(tables, pack_flow_batch(flows), None,
                                     **form)
    if dev.type == "cpu":
        return datapath_step_plain(tables, flows, **form)
    raise ValueError(f"unsupported device {dev}")


def pool_flows(pool: torch.Tensor, picks: torch.Tensor) -> FlowBatch:
    """The flows pool[:, picks] of an [8, P] pool, each pick clamped as
    an XLA gather clamps its int32 index: a pick past the pool takes
    the last row, one with bit 31 set (negative as int32) the first."""
    idx = picks.to(torch.int64)
    idx = torch.where(idx >= 1 << 31, idx - (1 << 32), idx)
    return flow_batch_from_packed(pool[:, idx.clamp(0, pool.shape[1] - 1)])


def pool_rows_of(pool: torch.Tensor) -> torch.Tensor:
    """An [8, P] flow pool's row-major copy [P, 8]: DATAPATH_STEP reads
    a picked flow's 32 B from it in two 16-byte loads."""
    return pool.t().contiguous()


def datapath_step_pool(tables: DatapathTables, pool: torch.Tensor,
                       picks: torch.Tensor,
                       pool_rows: Optional[torch.Tensor] = None
                       ) -> DatapathVerdicts:
    """The single-batch step over the flows `pool[:, picks]` of an
    [8, P] pool (FLOW_COLUMNS order, int32 words) and picks [B].  A
    CUDA pool launches DATAPATH_STEP, which gathers the rows itself
    from the pool's row-major copy (`pool_rows`, `pool_rows_of(pool)`,
    when the caller keeps one; else the wrapper makes it); a CPU pool
    runs the plain version."""
    if pool.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DATAPATH_STEP(tables, pool, picks, pool_rows=pool_rows)
    if pool.device.type == "cpu":
        return datapath_step_plain(tables, pool_flows(pool, picks))
    raise ValueError(f"unsupported device {pool.device}")


def datapath_step(tables: DatapathTables,
                  flows: FlowBatch) -> DatapathVerdicts:
    """The single-batch step (the reference's `datapath_step`): each
    flow its own direction, `sec_id` the identity, no counters and no
    telemetry.  CUDA flows launch DATAPATH_STEP on their [8, B] pack;
    CPU flows run the plain version."""
    return _step(tables, flows)


def datapath_step_with_counters(tables: DatapathTables, flows: FlowBatch):
    """The step with fresh per-batch counters (`sec_id` the identity):
    (out, l4 [E, 2, Kg], l3 [E, 2, N])."""
    acc = make_counter_buffers(tables.policy)
    out = _step(tables, flows, acc=acc)
    return (out, *split_counters(acc, tables.policy))


def datapath_step_accum(tables: DatapathTables, flows: FlowBatch,
                        acc: torch.Tensor):
    """The streaming step: counter hits into the carried `acc`
    [E, 2, Kg + N], in place; `sec_id` the raw lattice index.  Returns
    (out, acc)."""
    return _step(tables, flows, acc=acc, emit_sec_id=False), acc


def datapath_step_accum_ingress(tables: DatapathTables, flows: FlowBatch,
                                acc: torch.Tensor):
    """datapath_step_accum with every flow run as ingress: no service
    probe, no LB, no tunnel stage."""
    return _step(tables, flows, acc=acc, emit_sec_id=False,
                 static_dir=INGRESS), acc


def datapath_step_accum_egress(tables: DatapathTables, flows: FlowBatch,
                               acc: torch.Tensor):
    """datapath_step_accum with every flow run as egress."""
    return _step(tables, flows, acc=acc, emit_sec_id=False,
                 static_dir=EGRESS), acc


def datapath_step_telem(tables: DatapathTables, flows: FlowBatch):
    """The step (`sec_id` the identity) and this batch's [2, 20]
    telemetry sums (u32 bits in int32): (out, telem)."""
    telem = make_telemetry_buffers(flows.saddr.device)
    return _step(tables, flows, telem=telem), telem


def datapath_step_accum_telem(tables: DatapathTables, flows: FlowBatch,
                              acc: torch.Tensor, telem: torch.Tensor):
    """The streaming step with telemetry: counter hits into `acc` and
    the batch's telemetry sums into `telem`, both carried and updated in
    place.  Returns (out, acc, telem)."""
    out = _step(tables, flows, acc=acc, telem=telem, emit_sec_id=False)
    return out, acc, telem


def _pair_plain(tables: DatapathTables, f_in: FlowBatch, f_eg: FlowBatch,
                acc: torch.Tensor, telem: Optional[torch.Tensor]):
    out_i, cols_i, t_i = _datapath_half(tables, f_in, True)
    out_e, cols_e, t_e = _datapath_half(tables, f_eg, False)
    _accumulate_counters(
        acc, *(torch.cat([a, b]) for a, b in zip(cols_i, cols_e))
    )
    if telem is not None:
        telem.copy_(narrow(widen(telem) + torch.stack([t_i, t_e])))
    return out_i, out_e


def datapath_pair_plain(tables: DatapathTables, pair: torch.Tensor,
                        acc: torch.Tensor, telem: torch.Tensor):
    """Plain PyTorch version of the pair step: pair [2, 4, B] (u32
    bits in int32; half 0 ingress, half 1 egress).  Updates `acc`
    [E, 2, Kg + N] and `telem` [2, 20] in place and returns
    (out_in, out_eg, acc, telem)."""
    out_i, out_e = _pair_plain(
        tables, flow_batch_from_packed4(pair[0]),
        flow_batch_from_packed4(pair[1]), acc, telem,
    )
    return out_i, out_e, acc, telem


def datapath_step_accum_pair_telem_packed4_stacked(
    tables: DatapathTables, pair: torch.Tensor, acc: torch.Tensor,
    telem: torch.Tensor,
):
    """The headline pair step.  A CUDA `pair` launches the kernel; a
    CPU `pair` runs the plain version.  acc/telem are updated in
    place.  Returns (out_in, out_eg, acc, telem)."""
    if pair.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.DATAPATH_PAIR(tables, pair, acc, telem)
    if pair.device.type == "cpu":
        return datapath_pair_plain(tables, pair, acc, telem)
    raise ValueError(f"unsupported device {pair.device}")


def datapath_step_accum_pair_telem_packed4(tables: DatapathTables,
                                           packed_in: torch.Tensor,
                                           packed_eg: torch.Tensor,
                                           acc: torch.Tensor,
                                           telem: torch.Tensor):
    """The pair step on two packed4 halves [4, B]: stacked into one
    [2, 4, B] pair.  Returns (out_in, out_eg, acc, telem)."""
    return datapath_step_accum_pair_telem_packed4_stacked(
        tables, torch.stack([packed_in, packed_eg]), acc, telem)


def pack_flow_batch4(flows: FlowBatch) -> torch.Tensor:
    """A FlowBatch as one packed4 half [4, B] (int32 words) on its
    device.  Raises where a flow does not fit its packed4 field (ep_index
    16 bits, ports 16, proto 8, direction 0 or 1): the pair kernel would
    read another flow."""
    ep, sp, dp_, pr, d = (getattr(flows, c).to(torch.int64) for c in (
        "ep_index", "sport", "dport", "proto", "direction"))
    fits = ((ep >= 0) & (ep < 1 << 16) & (sp >= 0) & (sp < 1 << 16)
            & (dp_ >= 0) & (dp_ < 1 << 16) & (pr >= 0) & (pr < 1 << 8)
            & ((d == 0) | (d == 1)))
    if not bool(fits.all()):
        raise ValueError("flows outside the packed4 fields (ep_index, ports, "
                         "proto or direction) cannot take the pair kernel")
    frag = flows.is_fragment.to(torch.int64)
    return narrow(torch.stack([
        widen(flows.saddr), widen(flows.daddr), (sp << 16) | dp_,
        (ep << 16) | (pr << 8) | (d << 1) | frag,
    ]))


def _pair_step(tables, flows_in: FlowBatch, flows_eg: FlowBatch, acc,
               telem):
    """The unpacked pair forms: CUDA halves are packed into one
    [2, 4, B] pair and launch DATAPATH_PAIR (`telem` None gets a scratch
    buffer); CPU halves run both direction-specialized halves plainly,
    with one merged counter scatter."""
    dev = flows_in.saddr.device
    if dev.type == "cuda":
        if flows_in.saddr.shape != flows_eg.saddr.shape:
            raise ValueError("the pair kernel takes halves of one length")
        pair = torch.stack([pack_flow_batch4(flows_in),
                            pack_flow_batch4(flows_eg)])
        scratch = make_telemetry_buffers(dev) if telem is None else telem
        out_i, out_e, _, _ = datapath_step_accum_pair_telem_packed4_stacked(
            tables, pair, acc, scratch)
        return out_i, out_e
    if dev.type == "cpu":
        return _pair_plain(tables, flows_in, flows_eg, acc, telem)
    raise ValueError(f"unsupported device {dev}")


def datapath_step_accum_pair(tables: DatapathTables, flows_in: FlowBatch,
                             flows_eg: FlowBatch, acc: torch.Tensor):
    """Both direction-specialized halves in one step with one merged
    counter scatter: (out_in, out_eg, acc)."""
    return (*_pair_step(tables, flows_in, flows_eg, acc, None), acc)


def datapath_step_accum_pair_telem(tables: DatapathTables,
                                   flows_in: FlowBatch, flows_eg: FlowBatch,
                                   acc: torch.Tensor, telem: torch.Tensor):
    """datapath_step_accum_pair with the halves' telemetry sums in the
    carried `telem` (ingress half in row 0, egress half in row 1):
    (out_in, out_eg, acc, telem)."""
    return (*_pair_step(tables, flows_in, flows_eg, acc, telem), acc, telem)


def subword_datapath_tables(dtables: DatapathTables) -> DatapathTables:
    """Apply the three sub-word transforms to host tables: the compact
    2-word L4 entries, the 4-word CT rows and the packed ipcache
    planes.  Raises ValueError where a plane's values do not fit."""
    from cilium_tpu_torch.compiler.tables import repack_l4_subword
    from cilium_tpu_torch.ct.device import compact_ct_snapshot
    from cilium_tpu_torch.ipcache.lpm import subword_ipcache

    return dataclasses.replace(
        dtables,
        policy=repack_l4_subword(dtables.policy),
        ct=compact_ct_snapshot(dtables.ct),
        ipcache=subword_ipcache(dtables.ipcache),
    )


# -- the persistent pair program (K13) -------------------------------------------


def _stack_verdicts(outs) -> DatapathVerdicts:
    return DatapathVerdicts(**{
        c: torch.stack([getattr(o, c) for o in outs]) for c in VERDICT_COLUMNS
    })


def persistent_pair_plain(tables: DatapathTables, pairs: torch.Tensor,
                          acc: torch.Tensor, telem: torch.Tensor):
    """Plain version of the persistent pair program: datapath_pair_plain
    over pairs[k] for each k of a [K, 2, 4, B] super-batch in order, the
    carry threaded through, the columns stacked [K, B].  Returns
    (outs_in, outs_eg, acc, telem); acc and telem are updated in place."""
    outs_i, outs_e = [], []
    for k in range(int(pairs.shape[0])):
        out_i, out_e, acc, telem = datapath_pair_plain(tables, pairs[k], acc,
                                                       telem)
        outs_i.append(out_i)
        outs_e.append(out_e)
    return _stack_verdicts(outs_i), _stack_verdicts(outs_e), acc, telem


def _launch_class(tables: DatapathTables, pairs: torch.Tensor) -> tuple:
    """What a jit trace of the reference keys on: the device, the
    super-batch's shape (K and B) and the tables' plane layouts."""
    ipc = tables.ipcache
    return (
        pairs.device.type, tuple(pairs.shape),
        type(tables.prefilter).__name__, type(tables.lb).__name__,
        type(ipc).__name__, bool(getattr(ipc, "values_are_idx", False)),
        bool(getattr(ipc, "l3_planes", False)),
        int(getattr(tables.ct, "entry_words", 5)), tables.tunnel is not None,
    )


def _persistent_pair(tables: DatapathTables, pairs: torch.Tensor,
                     acc: torch.Tensor, telem: torch.Tensor):
    """K pair steps over `pairs` [K, 2, 4, B]: one PERSISTENT_PAIR launch
    on CUDA tensors, the plain version on CPU tensors."""
    if pairs.device.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.PERSISTENT_PAIR(tables, pairs, acc, telem)
    if pairs.device.type == "cpu":
        return persistent_pair_plain(tables, pairs, acc, telem)
    raise ValueError(f"unsupported device {pairs.device}")


class _Program:
    """A pair program with the launch classes it has run (device, K, B
    and table layouts) behind `_cache_size()`, as a jit function's cache
    counts its traces: tracing.track_jit reads it.  `k` set: the program
    takes [k, 2, 4, B] super-batches; None: one [2, 4, B] pair."""

    def __init__(self, fn, k: Optional[int] = None) -> None:
        self.fn = fn
        self.k = k
        self._classes = set()

    def _cache_size(self) -> int:
        return len(self._classes)

    def __call__(self, tables: DatapathTables, pairs: torch.Tensor,
                 acc: torch.Tensor, telem: torch.Tensor):
        if self.k is None:
            self._classes.add(_launch_class(tables, pairs[None]))
        elif pairs.dim() != 4 or int(pairs.shape[0]) != self.k:
            raise ValueError(f"the program takes [{self.k}, 2, 4, B] pairs, "
                             f"got {tuple(pairs.shape)}")
        else:
            self._classes.add(_launch_class(tables, pairs))
        return self.fn(tables, pairs, acc, telem)


_PERSISTENT_PROGRAMS = {}


def persistent_pair_program(k_pairs: int) -> _Program:
    """The persistent fused-pair program for K pairs (K13):
    fn(tables, pairs [K, 2, 4, B], acc, telem) -> (outs_in, outs_eg, acc,
    telem), the 15 columns of pair k at index k of each [K, B] output
    column, acc and telem updated in place.  Bit-identical per pair to
    K datapath_step_accum_pair_telem_packed4_stacked calls in order.  On
    CUDA tensors one PERSISTENT_PAIR launch; on CPU tensors the plain
    version.  One program per K, as the reference caches one jit per K."""
    k = int(k_pairs)
    if k not in _PERSISTENT_PROGRAMS:
        _PERSISTENT_PROGRAMS[k] = _Program(_persistent_pair, k)
    return _PERSISTENT_PROGRAMS[k]


# the dispatcher's remainder: the per-pair step, tracked as the
# reference's per-pair jit is
_PAIR_PROGRAM = _Program(datapath_step_accum_pair_telem_packed4_stacked)


class PersistentPairDispatcher:
    """Host side of the persistent program: stages up to `k_pairs`
    packed4 pair batches ([2, 4, B] u32 host arrays), stacks them into a
    [K, 2, 4, B] host buffer it allocates once and reuses (torch's copy,
    on every host thread, into pages already mapped: np.stack runs on one
    thread and maps a new array every super-batch), ships that as
    ONE host-to-device copy and ONE launch, and keeps the counter and
    telemetry carry on the device across launches.  The copy is pageable,
    so it has read the buffer when it returns.  `submit(pair)`
    returns the per-pair (out_in, out_eg) results of a completed
    super-batch (views of its fresh stacked outputs, which no later launch
    writes), [] while staging; `flush()` runs the staged remainder pair by
    pair through the per-pair step (DATAPATH_PAIR on the card; padding the
    super-batch would corrupt the carried counters) and returns (results,
    acc, telem).  The device is the carry's.

    Each super-launch counts in cilium_jit_cache_{hits,misses}{site}
    (tracing.track_jit), the remainder's launches at `site + ".remainder"`,
    and datapath_persistent_launches / _pairs count launches and pairs."""

    def __init__(self, tables: DatapathTables, k_pairs: int,
                 acc: torch.Tensor, telem: torch.Tensor,
                 site: str = "datapath.persistent") -> None:
        from cilium_tpu_torch import tracing

        self.tables = tables
        self.k = max(int(k_pairs), 1)
        self.acc = acc
        self.telem = telem
        self._staged: List[np.ndarray] = []
        self._host: Optional[np.ndarray] = None  # the [K, 2, 4, B] stack
        self._program = tracing.track_jit(persistent_pair_program(self.k),
                                          site)
        self._pair_fallback = tracing.track_jit(_PAIR_PROGRAM,
                                                site + ".remainder")
        self.launches = 0  # super-batch launches (K pair steps each)

    def submit(self, pair_host: np.ndarray):
        from cilium_tpu_torch.metrics import registry as metrics

        self._staged.append(pair_host)
        if len(self._staged) < self.k:
            return []
        stacked = u32_tensor(self._stack(self._staged), self.acc.device)
        staged, self._staged = self._staged, []
        outs_i, outs_e, self.acc, self.telem = self._program(
            self.tables, stacked, self.acc, self.telem)
        self.launches += 1
        metrics.datapath_persistent_launches.inc()
        metrics.datapath_persistent_pairs.inc(value=len(staged))
        return [
            (DatapathVerdicts(**{c: getattr(outs_i, c)[i]
                                 for c in VERDICT_COLUMNS}),
             DatapathVerdicts(**{c: getattr(outs_e, c)[i]
                                 for c in VERDICT_COLUMNS}))
            for i in range(self.k)
        ]

    def _stack(self, staged: List[np.ndarray]) -> np.ndarray:
        """np.stack(staged) as u32, into the reused host buffer."""
        shape = (len(staged),) + np.shape(staged[0])
        if self._host is None or self._host.shape != shape:
            self._host = np.empty(shape, np.uint32)
        host = torch.from_numpy(self._host.view(np.int32))
        for dst, pair in zip(host, staged):
            src = np.asarray(pair).astype(np.uint32, copy=False)
            if src.shape != shape[1:]:
                raise ValueError("all staged pairs must have the same "
                                 f"shape, got {src.shape} and {shape[1:]}")
            dst.copy_(torch.from_numpy(src.view(np.int32)))
        return self._host

    def flush(self):
        results = []
        for pair in self._staged:
            out_i, out_e, self.acc, self.telem = self._pair_fallback(
                self.tables, u32_tensor(pair, self.acc.device), self.acc,
                self.telem)
            results.append((out_i, out_e))
        self._staged = []
        return results, self.acc, self.telem


# -- CT write-back: the host side of the churn loop ----------------------------


def _unique_rows(cols: list, sel: np.ndarray) -> np.ndarray:
    """The selected rows of `cols` stacked as u64 and deduplicated;
    np.unique sorts them, and that sorted order is the order in which
    the write-back creates entries."""
    rows = np.stack(
        [np.asarray(c)[sel].astype(np.uint64) for c in cols], axis=1
    )
    if rows.shape[0] == 0:
        return rows
    return np.unique(rows, axis=0)


def apply_ct_writeback_host(ct: CTMap, create, delete, daddr, dport, saddr,
                            sport, proto, direction, rev_nat, slave,
                            now: int = 0, orig_daddr=None,
                            orig_dport=None) -> tuple:
    """Host CT mutation after a batch (all inputs host arrays): create
    entries for NEW and allowed flows (ct_create4) and delete
    ESTABLISHED flows the policy now denies (ct_delete4).  A
    load-balanced flow (rev_nat > 0 and a pre-DNAT frontend that
    differs) also gets its service-scope entry, carrying the backend
    for stickiness, as lb4_local creates it.  Returns (created_keys,
    deleted_keys) in creation order, for CTBucketIndex.apply."""
    created_keys = []
    deleted_keys = []
    if orig_daddr is None:
        orig_daddr, orig_dport = daddr, dport
    create_cols = [
        daddr, saddr, dport, sport, proto, direction, rev_nat, slave,
        orig_daddr, orig_dport,
    ]
    for row in _unique_rows(create_cols, create):
        (c_daddr, c_saddr, c_dport, c_sport, c_proto, c_dir, c_rev,
         c_slave, c_odaddr, c_odport) = (int(v) for v in row)
        flags = TUPLE_F_OUT if c_dir == CT_INGRESS else TUPLE_F_IN
        key = CTTuple(c_daddr, c_saddr, c_dport, c_sport, c_proto, flags)
        dnat = c_rev > 0 and (c_odaddr != c_daddr or c_odport != c_dport)
        if key not in ct.entries and ct.create_best_effort(
            CTTuple(c_daddr, c_saddr, c_dport, c_sport, c_proto), c_dir,
            now=now, rev_nat_index=c_rev, slave=c_slave,
            orig_daddr=c_odaddr if dnat else 0,
            orig_dport=c_odport if dnat else 0,
        ):
            created_keys.append(key)
        if dnat:
            svc_key = CTTuple(c_odaddr, c_saddr, c_odport, c_sport, c_proto,
                              TUPLE_F_SERVICE)
            if svc_key not in ct.entries and ct.create_best_effort(
                CTTuple(c_odaddr, c_saddr, c_odport, c_sport, c_proto),
                CT_SERVICE, now=now, rev_nat_index=c_rev, slave=c_slave,
            ):
                created_keys.append(svc_key)
    for row in _unique_rows([daddr, saddr, dport, sport, proto, direction],
                            delete):
        c_daddr, c_saddr, c_dport, c_sport, c_proto, c_dir = (
            int(v) for v in row
        )
        flags = TUPLE_F_OUT if c_dir == CT_INGRESS else TUPLE_F_IN
        key = CTTuple(c_daddr, c_saddr, c_dport, c_sport, c_proto, flags)
        if ct.entries.pop(key, None) is not None:
            deleted_keys.append(key)
    return created_keys, deleted_keys


def _host_column(t: torch.Tensor, u32: bool) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if u32 else a


def apply_ct_writeback(ct: CTMap, out: DatapathVerdicts, flows: FlowBatch,
                       now: int = 0) -> tuple:
    """apply_ct_writeback_host on a step's outputs and its flows (any
    device; u32 columns read as unsigned); returns (created, deleted)
    counts."""
    created_keys, deleted_keys = apply_ct_writeback_host(
        ct,
        _host_column(out.ct_create, False),
        _host_column(out.ct_delete, False),
        _host_column(out.final_daddr, True),
        _host_column(out.final_dport, False),
        _host_column(flows.saddr, False),
        _host_column(flows.sport, False),
        _host_column(flows.proto, False),
        _host_column(flows.direction, False),
        _host_column(out.rev_nat, False),
        _host_column(out.lb_slave, False),
        now=now,
        orig_daddr=_host_column(flows.daddr, False),
        orig_dport=_host_column(flows.dport, False),
    )
    return len(created_keys), len(deleted_keys)
