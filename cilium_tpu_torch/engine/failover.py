"""Per-chip failover: the shard router in front of the mesh evaluators
(the reference's engine/failover.py, its lattice half).

The per-chip failure domain's host half, on top of three pieces:

  * a ChipBreakerBank (resilience.py): one closed/open/half-open breaker
    per chip ordinal, fed by per-chip failure attribution: before every
    launch the router probes the `engine.dispatch` fault seam once per
    ordinal (faultinject's `chip=` scope), so a chaos schedule can kill
    exactly one chip;
  * the N+1 replica placement (sharded.make_replica_store and
    make_failover_evaluator): each sharded leaf's rows also live on a
    backup owner, the next shard over, and a dead primary's gathers read
    the backup region;
  * batch re-splitting: a mesh row with a table slice whose primary and
    backup are both dead is routed around, its tuple shard re-split over
    the surviving rows with valid-masked filler, so counters and
    telemetry count exactly the real tuples.  The host lattice fold
    (hostpath.lattice_fold_host) is the terminal fallback, taken only
    when no row survives or a chip fault (CHIP_FAULTS) ends the launch.

Readmission is a rebalance: a half-open probe first replays the rows
the chip missed while out (the store's outage ledger, through
DeviceTableStore.repair_rows and REPAIR_SCATTER on the card), then the
dispatch that includes the chip is its probe; success closes the
breaker.

A chip's ordinal is its coordinate's chip id in the mesh (engine.mesh
Mesh.ids, row-major unless a reshard grew or shrank the mesh), not a
torch device index: on one card every coordinate is a virtual chip of
the same device.  What the router
proves there, as the reference's CPU mesh does, is that no verdict,
counter or telemetry bit depends on a dead chip's table slice.

`attach_memo` puts the memo on the mesh (engine/memo_mesh.py) on the
dispatch path.  `attach_datapath` puts the fused datapath on the mesh
(engine/datapath_mesh.py) behind the same breakers: `dispatch_flows`
serves raw flows through it, `publish_datapath` publishes its epochs,
and a readmitted chip's datapath slices are repaired from the
DatapathStore (`repair_chip`) before its probe.  `adopt_reshard` re-aims
the router at a resharded mesh at the cutover of engine/reshard.py's
ReshardPlan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch import faultinject, tracing
from cilium_tpu_torch.engine.publish import next_pow2
from cilium_tpu_torch.kernels import KernelError
from cilium_tpu_torch.logging import get_logger
from cilium_tpu_torch.metrics import registry as metrics
from cilium_tpu_torch.resilience import (
    HALF_OPEN,
    STATE_CODES,
    ChipBreakerBank,
    DeadlineExceeded,
    wait_devices,
)

log = get_logger("failover")

# the launch failures that are a chip's: an injected fault (scoped to
# one chip or to all) and a watchdog deadline.  Anything else, a kernel
# that fails to build or launch above all, is the program's fault and
# propagates: no breaker opens and the host fold serves nothing.
CHIP_FAULTS = (faultinject.FaultInjected, DeadlineExceeded)


@dataclass
class FailoverResult:
    """One batch through the router, stream order restored (host numpy
    columns and counters)."""

    verdicts: object  # engine.verdict.Verdicts of numpy columns
    l4_counts: Optional[np.ndarray] = None
    l3_counts: Optional[np.ndarray] = None
    telemetry: Optional[np.ndarray] = None  # [dp, 2, T] or None
    replica_hits: int = 0
    rerouted: bool = False  # batch shard re-split across survivors
    degraded: bool = False  # served by the terminal host fold
    alive: Optional[np.ndarray] = None  # [dp, tp] snapshot
    rebalanced_chips: Tuple[int, ...] = ()
    rebalance_bytes: int = 0
    rebalance_ms: float = 0.0
    # the memo on the mesh: per-tuple hit flags in stream order, None
    # when the batch was served uncached
    cache_hit: Optional[np.ndarray] = None
    # the shadow leg's verdict columns, stream order, or None
    shadow_verdicts: Optional[object] = None


@dataclass
class RouterStats:
    batches: int = 0
    tuples: int = 0
    rerouted_batches: int = 0
    degraded_batches: int = 0
    replica_hits: int = 0
    rebalances: int = 0
    rebalance_bytes: int = 0
    last_rebalance_ms: float = 0.0
    chip_failures: Dict[int, int] = field(default_factory=dict)


def _host_verdicts(v, positions=None):
    """Verdicts of tensors -> Verdicts of numpy columns in stream order."""
    from cilium_tpu_torch.engine.verdict import Verdicts

    def take(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a if positions is None else a[positions]

    return Verdicts(allowed=take(v.allowed), proxy_port=take(v.proxy_port),
                    match_kind=take(v.match_kind))


def _u32(x) -> np.ndarray:
    """A counter tensor (u32 bits in int32) as a host u32 array."""
    return x.cpu().numpy().view(np.uint32)


class ChipFailoverRouter:
    """Shard router in front of the mesh evaluators: asks the
    ChipBreakerBank per dispatch, re-splits dead rows' batch shards over
    the survivors, routes dead primaries' gathers to their N+1 replicas,
    rebalances readmitted chips through the store's repair scatter, and
    folds on the host only when no row survives.

    `tables` (un-augmented host PolicyTables) fix the evaluator
    geometry; publish() installs epochs through the replica store.
    `host_fold(ep_index, identity, dport, proto, direction,
    is_fragment)` is the terminal fallback (e.g.
    hostpath.lattice_fold_host bound to the map states): without one a
    mesh-wide outage raises."""

    def __init__(self, mesh, tables, store=None,
                 bank: Optional[ChipBreakerBank] = None,
                 collect_telemetry: bool = False, host_fold=None,
                 batch_axis: str = "batch", table_axis: str = "table",
                 site: str = "engine.dispatch",
                 on_chip_transition=None) -> None:
        from cilium_tpu_torch.engine.sharded import (
            make_failover_evaluator,
            make_replica_store,
        )

        self.mesh = mesh
        self.batch_axis = batch_axis
        self.table_axis = table_axis
        self.site = site
        self.collect_telemetry = collect_telemetry
        self.host_fold = host_fold
        self._on_chip_transition = on_chip_transition
        self.dp = int(mesh.shape[batch_axis])
        self.tp = int(mesh.shape[table_axis])
        # the ordinal grid [dp, tp]: each coordinate's chip id
        self.ordinals = mesh.ids.copy()
        self.store = store or make_replica_store(mesh, table_axis)
        if bank is None:
            bank = ChipBreakerBank(name=site, on_transition=self._chip_event)
        elif bank.on_transition is None:
            bank.on_transition = self._chip_event
        else:
            # the router's own wiring (outage ledger, gauge, span
            # events) runs first, then the caller's listener
            caller = bank.on_transition

            def chained(ordinal, old, new, reason, _caller=caller):
                self._chip_event(ordinal, old, new, reason)
                _caller(ordinal, old, new, reason)

            bank.on_transition = chained
        self.bank = bank
        self._tables = tables
        self._ev = make_failover_evaluator(
            mesh, tables, batch_axis=batch_axis, table_axis=table_axis,
            collect_telemetry=collect_telemetry)
        self._geom = (tuple(tables.l4_hash_rows.shape),
                      tuple(tables.l3_allow_bits.shape))
        self.stats = RouterStats()
        # re-split plans keyed on the survivor set, cleared on every
        # breaker transition
        self._pack_plans: Dict[tuple, tuple] = {}
        # flushed on every chip breaker transition (a kill or a
        # readmission changes routing, and a readmission rewrites the
        # live epoch in place)
        self._verdict_cache = None
        self._memo = None
        # the fused datapath plane (attach_datapath): its store and
        # evaluator, the geometry the evaluator was built for, the
        # terminal fold, and the ordinals whose datapath slices a
        # readmission must repair
        self.dp_store = None
        self._dp_ev = None
        self._dp_geom = None
        self._host_datapath_fold = None
        self._dp_out = set()

    # -- breaker plumbing ----------------------------------------------------

    def attach_verdict_cache(self, cache) -> None:
        """Bind a memo.VerdictCache: every chip breaker transition
        flushes it."""
        self._verdict_cache = cache

    def attach_memo(self, n_rows_local: int = 1 << 10, entries: int = 8,
                    rep_shift: int = 2) -> None:
        """Put the memo on the mesh on the dispatch path: a cache whose
        bucket rows shard with the table slices
        (memo_mesh.make_partitioned_cache), probed and filled by the
        alive-masked memo evaluator (make_failover_memo_evaluator), so
        repeated policy keys are served from the cache and only the
        missed representatives run the replica-aware gathers.  An
        overflowing batch is re-dispatched through the uncached
        evaluator; breaker transitions and publishes flush."""
        from cilium_tpu_torch.engine.memo_mesh import make_partitioned_cache

        cache = make_partitioned_cache(self.mesh, n_rows_local, entries,
                                       batch_axis=self.batch_axis,
                                       table_axis=self.table_axis)
        self.attach_verdict_cache(cache)
        self._memo = {
            "cache": cache, "n_rows_local": int(n_rows_local),
            "entries": int(entries), "rep_shift": int(rep_shift),
            "evs": {},  # (geom, rep_cap) -> evaluator
            "hits": 0, "misses": 0, "overflow_redispatches": 0,
            "insert_faults": 0,
        }

    def _memo_evaluator(self, rep_cap: int):
        """The alive-masked memo evaluator of the current table geometry
        at this compaction capacity (cached; evaluators of another
        geometry are dropped)."""
        from cilium_tpu_torch.engine.memo_mesh import (
            make_failover_memo_evaluator,
        )

        key = (self._geom, rep_cap)
        ev = self._memo["evs"].get(key)
        if ev is None:
            self._memo["evs"] = {k: v for k, v in self._memo["evs"].items()
                                 if k[0] == self._geom}
            ev = make_failover_memo_evaluator(
                self.mesh, self._tables, self._memo["cache"].rows, rep_cap,
                batch_axis=self.batch_axis, table_axis=self.table_axis,
                collect_telemetry=self.collect_telemetry)
            self._memo["evs"][key] = ev
        return ev

    def _chip_event(self, ordinal, old, new, reason) -> None:
        """A chip breaker transition: the gauge, the span event, the
        store's outage ledger (an open chip starts missing publishes),
        the cache flush and the reset of the re-split plans."""
        metrics.chip_breaker_state.set(str(ordinal), value=STATE_CODES[new])
        self._pack_plans.clear()
        if self._verdict_cache is not None:
            self._verdict_cache.flush(
                reason=f"chip {int(ordinal)} {old}->{new}")
        tracing.add_event("chip.breaker", chip=int(ordinal), old=old,
                          new=new, reason=reason)
        if new == "open":
            self.store.mark_chip_out(ordinal)
            if self.dp_store is not None:
                self._dp_out.add(int(ordinal))
        log.warning("chip breaker transition", extra={"fields": {
            "chip": int(ordinal), "from": old, "to": new,
            "reason": reason}})
        if self._on_chip_transition is not None:
            self._on_chip_transition(ordinal, old, new, reason)

    # -- publication ---------------------------------------------------------

    def publish(self, tables, delta=None):
        """Install host tables as the serving epoch through the replica
        store.  A changed table geometry rebuilds the failover evaluator
        (the store's layout stamp forces the full upload it needs)."""
        from cilium_tpu_torch.engine.sharded import make_failover_evaluator

        got = (tuple(tables.l4_hash_rows.shape),
               tuple(tables.l3_allow_bits.shape))
        if got != self._geom:
            log.warning("table geometry changed; rebuilding failover "
                        "evaluator", extra={"fields": {
                            "from": str(self._geom), "to": str(got)}})
            self._ev = make_failover_evaluator(
                self.mesh, tables, batch_axis=self.batch_axis,
                table_axis=self.table_axis,
                collect_telemetry=self.collect_telemetry)
            self._geom = got
            self._pack_plans.clear()
        self._tables = tables
        return self.store.publish(tables, delta)

    # -- the fused datapath plane (engine/datapath_mesh.py) ------------------

    def attach_datapath(self, dtables, host_fold=None) -> None:
        """Adopt the fused pipeline: build the DatapathStore and the fused
        failover evaluator, and publish `dtables` (host, un-augmented)
        twice, so both epoch slots hold it and the next publish rides the
        row diff.  dispatch_flows then serves raw flows through prefilter,
        LB/DNAT, CT, ipcache and the lattice over the partitioned N+1
        tables, with this router's breakers, re-split and replica
        gathers.  `host_fold(ep_index, saddr, daddr, sport, dport, proto,
        direction, is_fragment)` -> DatapathVerdicts of host columns is
        the optional terminal fallback when no mesh row can serve."""
        from cilium_tpu_torch.engine.datapath_mesh import DatapathStore

        self.dp_store = DatapathStore(self.mesh, self.table_axis)
        self._dp_ev = None
        self._dp_geom = None
        self._host_datapath_fold = host_fold
        self.publish_datapath(dtables)
        self.publish_datapath(dtables)

    def publish_datapath(self, dtables, changes=None):
        """Install a fused-datapath world (host, un-augmented) as the
        serving epoch: churn rides the store's row diff (with a change
        record, `changes`, the scoped one; see DatapathStore.publish); a
        geometry change rebuilds the fused evaluator and uploads in
        full."""
        from cilium_tpu_torch.engine.datapath_mesh import (
            _geometry,
            make_failover_datapath_evaluator,
        )

        if self.dp_store is None:
            raise RuntimeError("no datapath plane attached: call "
                               "attach_datapath")
        geom = _geometry(dtables)
        if self._dp_ev is None or geom != self._dp_geom:
            self._dp_ev = make_failover_datapath_evaluator(
                self.mesh, dtables, batch_axis=self.batch_axis,
                table_axis=self.table_axis,
                collect_telemetry=self.collect_telemetry)
            self._dp_geom = geom
        return self.dp_store.publish(dtables, changes=changes)

    # -- live resharding (engine/reshard.py's cutover) -----------------------

    def adopt_reshard(self, target_mesh, dtables=None) -> None:
        """Adopt a resharded mesh at cutover: rebuild what closes over the
        mesh geometry (the ordinal grid, the failover evaluator, the
        re-split plans, the memo on the mesh, re-attached empty with its
        counters carried across, and the fused evaluator, from `dtables`,
        the un-augmented fused world, or at the next publish_datapath
        without it).  The stores' own cutover is the plan's; this runs
        between dispatches."""
        from cilium_tpu_torch.engine.sharded import make_failover_evaluator

        self.mesh = target_mesh
        self.dp = int(target_mesh.shape[self.batch_axis])
        self.tp = int(target_mesh.shape[self.table_axis])
        self.ordinals = target_mesh.ids.copy()
        self._ev = make_failover_evaluator(
            target_mesh, self._tables, batch_axis=self.batch_axis,
            table_axis=self.table_axis,
            collect_telemetry=self.collect_telemetry)
        self._pack_plans.clear()
        if self._memo is not None:
            # the cache's rows are laid out per chip: a new empty cache
            # on the target mesh
            carried = self._memo
            self.attach_memo(n_rows_local=carried["n_rows_local"],
                             entries=carried["entries"],
                             rep_shift=carried["rep_shift"])
            for k in ("hits", "misses", "overflow_redispatches",
                      "insert_faults"):
                self._memo[k] = carried[k]
        elif self._verdict_cache is not None:
            self._verdict_cache.flush(reason="mesh reshard cutover")
        if self.dp_store is not None:
            self._dp_ev = None
            self._dp_geom = None
            if dtables is not None:
                from cilium_tpu_torch.engine.datapath_mesh import (
                    _geometry,
                    make_failover_datapath_evaluator,
                )

                self._dp_ev = make_failover_datapath_evaluator(
                    target_mesh, dtables, batch_axis=self.batch_axis,
                    table_axis=self.table_axis,
                    collect_telemetry=self.collect_telemetry)
                self._dp_geom = _geometry(dtables)
        tracing.add_event("reshard.adopt", dp=self.dp, tp=self.tp)

    def _flow_batch(self, padded):
        """The padded flow columns as an int32 [8, B] word pack on the
        mesh's first device (engine/datapath.py FLOW_COLUMNS order)."""
        from cilium_tpu_torch.device import u32_tensor
        from cilium_tpu_torch.engine.datapath import FLOW_COLUMNS

        words = np.stack([np.asarray(padded[c]).astype(np.int64).astype(
            np.uint32) for c in FLOW_COLUMNS])
        return u32_tensor(words, self.mesh.devices[0, 0])

    def dispatch_flows(self, ep_index, saddr, daddr, sport, dport, proto,
                       direction, is_fragment=None) -> FailoverResult:
        """One raw-flow batch through the fused pipeline on the mesh: a
        FailoverResult whose `verdicts` is a DatapathVerdicts of host
        columns in stream order (u32 columns as uint32), equal to the
        single-device fused program whatever the survivor set while one
        owner of every table slice survives.  A mesh-wide outage, or a
        chip fault (CHIP_FAULTS) of the launch, folds on the host
        (`attach_datapath(host_fold=)`, else it raises); any other launch
        error, a kernel that fails to build or launch above all,
        propagates with no breaker opened and no fold."""
        from cilium_tpu_torch.engine.datapath import (
            U32_COLUMNS,
            VERDICT_COLUMNS,
            VERDICT_DTYPES,
            DatapathVerdicts,
        )

        if self.dp_store is None:
            raise RuntimeError("no datapath plane attached: call "
                               "attach_datapath")
        cols = {
            "ep_index": np.asarray(ep_index, np.int32),
            "saddr": np.asarray(saddr, np.uint32),
            "daddr": np.asarray(daddr, np.uint32),
            "sport": np.asarray(sport, np.int32),
            "dport": np.asarray(dport, np.int32),
            "proto": np.asarray(proto, np.int32),
            "direction": np.asarray(direction, np.int32),
            "is_fragment": (np.zeros(len(ep_index), bool)
                            if is_fragment is None
                            else np.asarray(is_fragment, bool)),
        }
        b = len(cols["ep_index"])

        def host_dtype(c):
            if c in U32_COLUMNS:
                return np.uint32
            return torch.empty(0, dtype=VERDICT_DTYPES[c]).numpy().dtype

        if b == 0:
            return FailoverResult(verdicts=DatapathVerdicts(**{
                c: np.zeros(0, host_dtype(c)) for c in VERDICT_COLUMNS}))
        plan, fold_args = self._plan_batch(cols)
        if plan is None:
            return self._terminal_flow_fold(
                cols, *fold_args,
                reason="no mesh row can serve every table slice")
        alive = plan["alive"]
        dev = self.dp_store.current()
        if dev is None:
            raise RuntimeError("no published datapath epoch: call "
                               "publish_datapath")
        flows = self._flow_batch(plan["padded"])
        valid = torch.from_numpy(plan["valid"])
        with tracing.tracer.span(
            "mesh.dispatch", site=self.site,
            attrs={"chips": int(alive.sum()), "rows": b,
                   "rerouted": plan["rerouted"], "fused": True},
        ) as sp:
            try:
                out = self._dp_ev(dev, flows, alive, valid)
                wait_devices(out)
            except CHIP_FAULTS as exc:
                sp.status = "error"
                sp.attrs["error"] = str(exc)
                self._blame_alive(alive, exc)
                return self._terminal_flow_fold(
                    cols, alive, plan["rebalanced"], plan["reb_bytes"],
                    plan["reb_ms"], reason=str(exc))
            except Exception as exc:
                sp.status = "error"
                sp.attrs["error"] = str(exc)
                for ordinal in plan["probed"]:
                    self.bank.release_probe(ordinal)
                raise
        self._credit_alive(alive)
        if self.collect_telemetry:
            v, l4c, l3c, replica_hits, trow = out
            telemetry = _u32(trow)
        else:
            v, l4c, l3c, replica_hits = out
            telemetry = None
        replica_hits = self._count_replica_hits(replica_hits)
        positions = plan["positions"]

        def col(c):
            a = getattr(v, c).cpu().numpy()
            if c in U32_COLUMNS:
                a = a.view(np.uint32)
            return a if positions is None else a[positions]

        return FailoverResult(
            verdicts=DatapathVerdicts(**{c: col(c) for c in VERDICT_COLUMNS}),
            l4_counts=_u32(l4c), l3_counts=_u32(l3c), telemetry=telemetry,
            replica_hits=replica_hits, rerouted=plan["rerouted"],
            degraded=False, alive=alive,
            rebalanced_chips=plan["rebalanced"],
            rebalance_bytes=plan["reb_bytes"], rebalance_ms=plan["reb_ms"])

    def _terminal_flow_fold(self, cols, alive, rebalanced, reb_bytes,
                            reb_ms, reason="") -> FailoverResult:
        """The host fold of the fused path, taken only when no owner of
        some slice survives (or a chip fault ended the launch); raises
        without a host datapath fold."""
        if self._host_datapath_fold is None:
            raise RuntimeError(f"fused mesh unserviceable ({reason}) and no "
                               f"host datapath fold configured")
        with tracing.tracer.span(
                "engine.hostpath", site="engine.hostpath",
                attrs={"failover": True, "fused": True, "reason": reason}):
            v = self._host_datapath_fold(
                cols["ep_index"], cols["saddr"], cols["daddr"], cols["sport"],
                cols["dport"], cols["proto"], cols["direction"],
                cols["is_fragment"])
        metrics.degraded_batches_total.inc()
        self.stats.degraded_batches += 1
        log.warning("fused mesh batch served by terminal host fold",
                    extra={"fields": {"reason": reason}})
        return FailoverResult(
            verdicts=v, degraded=True, alive=alive,
            rebalanced_chips=rebalanced, rebalance_bytes=reb_bytes,
            rebalance_ms=reb_ms)

    def _repair_datapath(self, ordinal: int, col: int) -> Tuple[int, float]:
        """The datapath half of a readmission: the chip's owned slices of
        both datapath epochs rewritten from the store's retained host
        snapshots.  Returns (bytes, ms)."""
        t0 = time.perf_counter()
        nbytes = self.dp_store.repair_chip(col)
        ms = (time.perf_counter() - t0) * 1e3
        self._dp_out.discard(ordinal)
        self.stats.rebalance_bytes += nbytes
        tracing.add_event("chip.rebalance", chip=ordinal, bytes_h2d=nbytes,
                          datapath=True)
        return nbytes, ms

    # -- readmission rebalance -------------------------------------------------

    def _owned_row_sets(self, ordinal: int, outage) -> Dict:
        """{leaf: (axis, augmented index array)} a readmitted chip must
        replay: the missed deltas' rows within the chip's owned regions
        (primary and backup), or the whole owned slice after a full
        upload, a whole-leaf replacement or a slab-shaped update."""
        from cilium_tpu_torch.compiler import partition

        _, cols = np.where(self.ordinals == int(ordinal))
        if not cols.size:
            return {}
        col = int(cols[0])
        axes = partition.replica_axes(self._tables, self.tp, self.table_axis)
        out = {}
        for name, axis in axes.items():
            n = getattr(self._tables, name).shape[axis] // self.tp
            lo, hi = col * 2 * n, (col + 1) * 2 * n
            whole_region = outage["needs_full"] or any(
                name in d.replace for d in outage["missed"])
            touched = []
            for d in outage["missed"]:
                up = d.updates.get(name)
                if up is None:
                    continue
                if axis < len(up.idx):
                    # the ledger's deltas are in augmented coordinates
                    touched.append(np.asarray(up.idx[axis], np.int64))
                else:
                    # the values span the sharded axis: the whole region
                    whole_region = True
            if whole_region:
                idx = np.arange(lo, hi, dtype=np.int64)
            else:
                if not touched:
                    continue
                idx = np.unique(np.concatenate(touched))
                idx = idx[(idx >= lo) & (idx < hi)]
            if idx.size:
                out[name] = (axis, idx)
        return out

    def _whole_owned_row_sets(self, ordinal: int) -> Dict:
        """A chip's entire owned regions: the spare epoch's repair."""
        return self._owned_row_sets(ordinal,
                                    {"needs_full": True, "missed": []})

    def _rebalance(self, ordinal: int) -> Tuple[int, float]:
        """Replay the rows a chip missed while out through the store's
        repair scatter: the live epoch from the outage ledger and, when
        publishes landed during the outage, the spare epoch's whole
        owned slice.  On a failure the ledger goes back (downgraded to
        needs_full) and the error propagates.  Returns (bytes, ms)."""
        outage = self.store.readmit_chip(ordinal)
        if outage is None:
            return 0, 0.0
        t0 = time.perf_counter()
        try:
            serving_digest = int(self.store.partition_digest)
            for which in ("live_layout", "spare_layout"):
                lay = outage.get(which)
                if lay is not None and (lay >> 32) != serving_digest:
                    raise RuntimeError(
                        f"chip {int(ordinal)} readmission races a mesh "
                        f"relayout ({which} digest {lay >> 32:#x} != "
                        f"serving {serving_digest:#x}); repair refused")
            row_sets = self._owned_row_sets(ordinal, outage)
            bytes_h2d = (self.store.repair_rows(
                row_sets, expect_layout=outage.get("live_layout"))
                if row_sets else 0)
            if outage.get("spare_stale"):
                spare_sets = self._whole_owned_row_sets(ordinal)
                if spare_sets:
                    bytes_h2d += self.store.repair_rows(
                        spare_sets, spare=True,
                        expect_epoch=outage.get("spare_epoch"),
                        expect_layout=outage.get("spare_layout"))
        except Exception:
            self.store.restore_outage(ordinal, outage)
            raise
        ms = (time.perf_counter() - t0) * 1000.0
        self.stats.rebalances += 1
        self.stats.rebalance_bytes += bytes_h2d
        self.stats.last_rebalance_ms = ms
        tracing.add_event(
            "chip.rebalance", chip=int(ordinal), bytes_h2d=bytes_h2d,
            ms=round(ms, 3), missed_deltas=len(outage["missed"]),
            needs_full=outage["needs_full"],
            spare_repaired=bool(outage.get("spare_stale")))
        log.info("chip re-admission rebalance", extra={"fields": {
            "chip": int(ordinal), "bytes_h2d": bytes_h2d,
            "ms": round(ms, 3)}})
        return bytes_h2d, ms

    # -- routing -------------------------------------------------------------

    def _admit(self):
        """One admission round: per-chip fault probes, per-chip breaker
        questions, and the rebalance of a half-open chip with an open
        outage ledger before its probe.  Returns (alive [dp, tp] bool,
        rebalanced ordinals, bytes, ms, ordinals whose admission took a
        half-open probe slot)."""
        alive = np.zeros((self.dp, self.tp), bool)
        rebalanced, probed = [], []
        reb_bytes, reb_ms = 0, 0.0
        for r in range(self.dp):
            for c in range(self.tp):
                ordinal = int(self.ordinals[r, c])
                try:
                    faultinject.fire(self.site, chip=ordinal)
                except faultinject.FaultInjected as exc:
                    self.bank.record_failure(ordinal, str(exc))
                    self.stats.chip_failures[ordinal] = (
                        self.stats.chip_failures.get(ordinal, 0) + 1)
                    continue
                was_half_open = self.bank.state(ordinal) == HALF_OPEN
                ok = self.bank.allow(ordinal)
                if ok and self.store.chip_outage(ordinal) is not None:
                    # the probe may not trust the chip's slice until the
                    # rows it missed are back
                    try:
                        b, ms = self._rebalance(ordinal)
                        rebalanced.append(ordinal)
                        reb_bytes += b
                        reb_ms += ms
                    except KernelError:
                        # REPAIR_SCATTER failing to build or launch is
                        # no fault of the chip: give back the probe
                        # slots taken so far and propagate
                        for o in probed + [ordinal] * was_half_open:
                            self.bank.release_probe(o)
                        raise
                    except Exception as exc:  # noqa: BLE001
                        self.bank.record_failure(
                            ordinal, f"rebalance failed: {exc}")
                        ok = False
                if ok and ordinal in self._dp_out:
                    # the chip's datapath slices (CT, ipcache, LB, policy)
                    # from the store's retained host snapshots: bytes of
                    # one chip's slices, never a full upload
                    try:
                        b, ms = self._repair_datapath(ordinal, c)
                        reb_bytes += b
                        reb_ms += ms
                        if ordinal not in rebalanced:
                            rebalanced.append(ordinal)
                    except KernelError:
                        for o in probed + [ordinal] * was_half_open:
                            self.bank.release_probe(o)
                        raise
                    except Exception as exc:  # noqa: BLE001
                        self.bank.record_failure(
                            ordinal, f"datapath repair failed: {exc}")
                        ok = False
                if ok and was_half_open:
                    probed.append(ordinal)
                alive[r, c] = ok
        return alive, tuple(rebalanced), reb_bytes, reb_ms, tuple(probed)

    def _usable_rows(self, alive: np.ndarray) -> np.ndarray:
        """A mesh row serves tuples iff every table slice has a live
        owner in it: its primary column or its backup (the next shard
        over)."""
        if self.tp == 1:
            return alive[:, 0].copy()
        from cilium_tpu_torch.compiler.partition import REPLICA_BACKUP_OFFSET

        ok = np.ones(self.dp, bool)
        for c in range(self.tp):
            backup = (c + REPLICA_BACKUP_OFFSET) % self.tp
            ok &= alive[:, c] | alive[:, backup]
        return ok

    def _pack_plan(self, b: int, usable: np.ndarray):
        """The routing plan of a (batch length, survivor set): shard
        size, valid mask, stream positions and the per-row copy chunks
        (None, None, None, None for the identity pass-through).
        Cached per survivor set."""
        key = (b, usable.tobytes())
        plan = self._pack_plans.get(key)
        if plan is not None:
            return plan
        rows = np.flatnonzero(usable)
        per = -(-b // len(rows))
        s = max(next_pow2(per), 1)
        if len(rows) == self.dp and self.dp * s == b:
            plan = None, None, None, None
        else:
            total = self.dp * s
            valid = np.zeros(total, bool)
            positions = np.empty(b, np.int64)
            chunks = []
            off = 0
            for r in rows:
                take = min(s, b - off)
                if take <= 0:
                    break
                sl = slice(r * s, r * s + take)
                chunks.append((sl, slice(off, off + take)))
                valid[sl] = True
                positions[off:off + take] = np.arange(r * s, r * s + take)
                off += take
            assert off == b, "batch re-split lost tuples"
            plan = total, valid, positions, tuple(chunks)
        self._pack_plans[key] = plan
        return plan

    def _pack(self, cols: Dict[str, np.ndarray], usable: np.ndarray):
        """Re-split the stream over the usable rows: each takes a
        contiguous chunk; unusable rows carry valid-masked copies of
        tuple 0.  Returns (padded cols, valid, positions of the real
        tuples, None for the identity pass-through)."""
        b = len(cols["ep_index"])
        total, valid, positions, chunks = self._pack_plan(b, usable)
        if total is None:
            return cols, np.ones(b, bool), None
        padded = {k: np.repeat(v[:1], total, axis=0).astype(v.dtype)
                  for k, v in cols.items()}
        for dst, src in chunks:
            for key, v in cols.items():
                padded[key][dst] = v[src]
        return padded, valid, positions

    def _plan_batch(self, cols: Dict[str, np.ndarray]):
        """Admission and re-split: (plan, None) on a servable mesh, or
        (None, fold args) when no row can serve (admitted half-open
        chips then give their probe slots back)."""
        self.stats.batches += 1
        self.stats.tuples += len(cols["ep_index"])
        alive, rebalanced, reb_bytes, reb_ms, probed = self._admit()
        usable = self._usable_rows(alive)
        if not usable.any():
            for ordinal in probed:
                self.bank.release_probe(ordinal)
            return None, (alive, rebalanced, reb_bytes, reb_ms)
        rerouted = not usable.all()
        if rerouted:
            metrics.rerouted_batches_total.inc()
            self.stats.rerouted_batches += 1
            tracing.add_event("chip.reroute", dead_rows=int((~usable).sum()),
                              survivors=int(usable.sum()))
        padded, valid, positions = self._pack(cols, usable)
        return {"alive": alive, "rebalanced": rebalanced, "probed": probed,
                "reb_bytes": reb_bytes, "reb_ms": reb_ms,
                "rerouted": rerouted, "padded": padded, "valid": valid,
                "positions": positions}, None

    def _blame_alive(self, alive, exc) -> None:
        """A chip fault of the launch: the chip an injected fault names,
        else every participating chip is suspect."""
        chip = getattr(exc, "chip", None)
        if chip is not None:
            self.bank.record_failure(int(chip), str(exc))
            return
        for r in range(self.dp):
            for c in range(self.tp):
                if alive[r, c]:
                    self.bank.record_failure(int(self.ordinals[r, c]),
                                             str(exc))

    def _credit_alive(self, alive) -> None:
        for r in range(self.dp):
            for c in range(self.tp):
                if alive[r, c]:
                    self.bank.record_success(int(self.ordinals[r, c]))

    def _count_replica_hits(self, replica_hits) -> int:
        replica_hits = int(torch.as_tensor(replica_hits).reshape(-1)[0])
        if replica_hits:
            metrics.replica_gather_total.inc(value=replica_hits)
            self.stats.replica_hits += replica_hits
        return replica_hits

    def _batch(self, padded):
        from cilium_tpu_torch.engine.verdict import TupleBatch

        return TupleBatch.from_numpy(**padded,
                                     device=self.mesh.devices[0, 0])

    def dispatch(self, ep_index, identity, dport, proto, direction,
                 is_fragment=None, shadow=None) -> FailoverResult:
        """One batch through the per-chip failure domain: a
        FailoverResult with the verdict columns in stream order, equal
        to the healthy mesh's whatever the survivor set while one owner
        of every slice survives; the host fold serves the batch beyond
        that.  A launch error that is no chip fault (CHIP_FAULTS), such
        as a kernel that fails to build or launch, propagates with no
        breaker opened and no fold.  `shadow` = (evaluator, device
        tables): a second failover evaluator and epoch run on the same
        re-split batch and alive mask; its verdicts come back on
        `shadow_verdicts` (None when a chip fault ends the shadow leg,
        which never degrades the batch)."""
        cols = {
            "ep_index": np.asarray(ep_index, np.int32),
            "identity": np.asarray(identity, np.uint32),
            "dport": np.asarray(dport, np.int32),
            "proto": np.asarray(proto, np.int32),
            "direction": np.asarray(direction, np.int32),
            "is_fragment": (np.zeros(len(ep_index), bool)
                            if is_fragment is None
                            else np.asarray(is_fragment, bool)),
        }
        if len(cols["ep_index"]) == 0:
            # nothing to route: no fault schedule or probe slot is spent
            from cilium_tpu_torch.engine.verdict import Verdicts

            return FailoverResult(verdicts=Verdicts(
                allowed=np.zeros(0, np.uint8),
                proxy_port=np.zeros(0, np.int32),
                match_kind=np.zeros(0, np.uint8)))
        plan, fold_args = self._plan_batch(cols)
        if plan is None:
            return self._terminal_fold(
                cols, *fold_args,
                reason="no mesh row can serve every table slice")
        alive = plan["alive"]
        current = self.store.current()
        if current is None:
            raise RuntimeError("no published epoch: call router.publish "
                               "first")
        _, dev_tables = current
        batch = self._batch(plan["padded"])
        valid = torch.from_numpy(plan["valid"])
        with tracing.tracer.span(
            "mesh.dispatch", site=self.site,
            attrs={"chips": int(alive.sum()), "rows": len(cols["ep_index"]),
                   "rerouted": plan["rerouted"]},
        ) as sp:
            out = hit_padded = None
            try:
                if self._memo is not None:
                    out, hit_padded = self._memo_dispatch(
                        current[0], dev_tables, batch, alive, valid, sp)
                if out is None:
                    out = self._ev(dev_tables, batch, alive, valid)
                    wait_devices(out)
            except CHIP_FAULTS as exc:
                sp.status = "error"
                sp.attrs["error"] = str(exc)
                self._blame_alive(alive, exc)
                return self._terminal_fold(
                    cols, alive, plan["rebalanced"], plan["reb_bytes"],
                    plan["reb_ms"], reason=str(exc))
            except Exception as exc:
                sp.status = "error"
                sp.attrs["error"] = str(exc)
                for ordinal in plan["probed"]:
                    self.bank.release_probe(ordinal)
                raise
            shadow_v = None
            if shadow is not None:
                shadow_ev, shadow_dev = shadow
                with tracing.tracer.span(
                    "shadow.dispatch", site="shadow.dispatch",
                    attrs={"rows": len(cols["ep_index"]), "routed": True,
                           "chips": int(alive.sum())},
                ) as ssp:
                    try:
                        sout = shadow_ev(shadow_dev, batch, alive, valid)
                        wait_devices(sout)
                        shadow_v = sout[0]
                    except CHIP_FAULTS as exc:
                        ssp.status = "error"
                        ssp.attrs["error"] = str(exc)
                    except Exception:
                        ssp.status = "error"
                        for ordinal in plan["probed"]:
                            self.bank.release_probe(ordinal)
                        raise
        self._credit_alive(alive)
        if self.collect_telemetry:
            v, l4c, l3c, replica_hits, trow = out
            telemetry = _u32(trow)
        else:
            v, l4c, l3c, replica_hits = out[:4]
            telemetry = None
        replica_hits = self._count_replica_hits(replica_hits)
        positions = plan["positions"]
        cache_hit = hit_padded
        if positions is not None and hit_padded is not None:
            cache_hit = hit_padded[positions]
        return FailoverResult(
            verdicts=_host_verdicts(v, positions),
            shadow_verdicts=(None if shadow_v is None
                             else _host_verdicts(shadow_v, positions)),
            l4_counts=_u32(l4c), l3_counts=_u32(l3c), telemetry=telemetry,
            replica_hits=replica_hits, rerouted=plan["rerouted"],
            degraded=False, alive=alive,
            rebalanced_chips=plan["rebalanced"],
            rebalance_bytes=plan["reb_bytes"], rebalance_ms=plan["reb_ms"],
            cache_hit=cache_hit)

    def _memo_dispatch(self, stamp, dev_tables, batch, alive, valid, sp):
        """One attempt through the alive-masked memo evaluator: (out,
        hit) with `out` shaped like the uncached evaluator's outputs, or
        (None, None) when the batch must be served uncached (the stamp
        raced a publish, the compaction overflowed, or an injected fault
        fired).  Any other launch error flushes the cache and
        propagates: a memo kernel that fails to build or launch is no
        reason to serve uncached."""
        from cilium_tpu_torch.engine import memo as vm

        cache = self._memo["cache"]
        cache.ensure(stamp)
        cur_stamp, rows_in = cache.acquire()
        if cur_stamp != stamp:
            return None, None
        local_b = int(batch.ep_index.shape[0]) // self.dp
        rep_cap = max(local_b >> self._memo["rep_shift"], min(local_b, 256))
        try:
            ev = self._memo_evaluator(rep_cap)
            out = ev(dev_tables, batch, alive, valid, rows_in)
            wait_devices(out)
        except faultinject.FaultInjected as exc:
            # surface an injected fault to the breaker plane (blame the
            # chip it names), then serve uncached
            sp.attrs["memo_fault"] = str(exc)
            if exc.chip is not None:
                self.bank.record_failure(int(exc.chip), str(exc))
            cache.flush(reason="memo-dispatch-fault")
            return None, None
        except Exception:
            cache.flush(reason="memo-dispatch-failure")
            raise
        if self.collect_telemetry:
            v, l4c, l3c, hits, cache2, hit, stats, trow = out
            rest = (trow,)
        else:
            v, l4c, l3c, hits, cache2, hit, stats = out
            rest = ()
        s = stats.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        if int(s[vm.STAT_OVERFLOW]):
            # more distinct keys than the compaction holds: re-dispatch
            # uncached, exactly once
            self._memo["overflow_redispatches"] += 1
            cache.account(s)
            return None, None
        # the memo.insert fault seam, once per alive ordinal before the
        # commit: a fired fault drops the write-back (the carried cache
        # stays as it was) and the batch goes uncached
        if faultinject.any_armed():
            try:
                for r in range(self.dp):
                    for c in range(self.tp):
                        if alive[r, c]:
                            faultinject.fire(
                                "memo.insert",
                                chip=int(self.ordinals[r, c]))
            except faultinject.FaultInjected as exc:
                metrics.memo_insert_faults_total.inc()
                sp.attrs["memo_insert_fault"] = str(exc)
                self._memo["insert_faults"] += 1
                return None, None
        cache.commit(stamp, cache2)
        row = cache.account(s)
        self._memo["hits"] += row["hits"]
        self._memo["misses"] += row["tuples"] - row["hits"]
        sp.attrs["cache_hits"] = row["hits"]
        return (v, l4c, l3c, hits) + rest, hit.cpu().numpy()

    def _terminal_fold(self, cols, alive, rebalanced, reb_bytes, reb_ms,
                       reason="") -> FailoverResult:
        """The host lattice fold, taken only when no owner of some slice
        survives (or a chip fault ended the launch)."""
        if self.host_fold is None:
            raise RuntimeError(f"mesh unserviceable ({reason}) and no "
                               f"host_fold terminal fallback configured")
        with tracing.tracer.span("engine.hostpath", site="engine.hostpath",
                                 attrs={"failover": True, "reason": reason}):
            v = self.host_fold(cols["ep_index"], cols["identity"],
                               cols["dport"], cols["proto"],
                               cols["direction"], cols["is_fragment"])
        metrics.degraded_batches_total.inc()
        self.stats.degraded_batches += 1
        log.warning("mesh batch served by terminal host fold",
                    extra={"fields": {"reason": reason}})
        return FailoverResult(
            verdicts=_host_verdicts(v), degraded=True, alive=alive,
            rebalanced_chips=rebalanced, rebalance_bytes=reb_bytes,
            rebalance_ms=reb_ms)

    # -- introspection -------------------------------------------------------

    def chip_states(self) -> Dict[int, str]:
        return self.bank.states()

    def snapshot(self) -> Dict:
        return {
            "chips": {str(o): s for o, s in self.bank.states().items()},
            "stats": {
                "batches": self.stats.batches,
                "tuples": self.stats.tuples,
                "rerouted_batches": self.stats.rerouted_batches,
                "degraded_batches": self.stats.degraded_batches,
                "replica_hits": self.stats.replica_hits,
                "rebalances": self.stats.rebalances,
                "rebalance_bytes": self.stats.rebalance_bytes,
                "last_rebalance_ms": self.stats.last_rebalance_ms,
            },
        }
