"""Live resharding of the mesh stores: a table-axis resize (tp 2 -> 4, 4
-> 2) of a ChipFailoverRouter's mesh as bounded-byte row migration while
the live epochs keep serving, with churn dual-applied, a mid-migration
chip fault either completed from the replicas or rolled back, and a
cutover between dispatches (the reference's engine/reshard.py).

The N+1 augmented layout keeps its total shape under any shard count (a
sharded axis [S] is [2S] whatever ntp: compiler/partition.py), so a
reshard is an index permutation of the augmented rows, and the rows
whose bytes are not already on their target chip
(partition.reshard_moved_rows, datapath_reshard_moved_rows) are the
migration's work queue.  A ReshardPlan:

  * `begin()` opens a relayout window on the router's policy replica
    store (DeviceTableStore.begin_relayout) and, with a fused datapath
    plane attached, on its DatapathStore: the spare epoch slot is seeded
    with the target layout, every moved row zeroed, while the live epoch
    serves untouched;
  * `step()` streams one bounded-byte batch of queued rows into the
    staged epoch through the chip-readmission scatter (repair_rows,
    relayout_scatter: REPAIR_SCATTER on the card), probing the
    `reshard.migrate` fault site once per target-column chip it is
    about to write;
  * `on_publish()` is the churn dual-apply: a publish during the window
    patched the LIVE epoch in place (the stores' relayout path), and the
    plan folds the same change into the staged target, re-queueing every
    row whose contents changed.  Churn the window cannot absorb (a
    geometry change, a full upload, a publish nobody dual-applied)
    restarts the migration as a full streamed upload into the target;
  * `cutover()` flips both stores, re-aims the router
    (ChipFailoverRouter.adopt_reshard) and closes an armed shadow window
    stale: the old live epoch stays as the source-layout spare, whose
    next delta publish is refused by the layout guard into one full
    upload;
  * a chip fault mid-migration either completes via the survivors (the
    dead column's own rows leave the queue: its slice stays reachable
    through the backup copies streamed to its right neighbour, and its
    breakers open so the router reads them there after cutover) or rolls
    back by dropping the staged epoch.

On one card every coordinate is a virtual chip of the same device, so
what the plan measures is the migration traffic a real topology would
ship: `reshard_bytes_h2d` counts the streamed rows (and their pow2-padded
indices), never the world except on a full restart.  The target mesh
keeps every surviving column on its chips (reshard_target_mesh).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch import faultinject, tracing
from cilium_tpu_torch.compiler import partition
from cilium_tpu_torch.engine.mesh import Mesh
from cilium_tpu_torch.logging import get_logger
from cilium_tpu_torch.metrics import registry as metrics

log = get_logger("reshard")

# the default streaming budget of a migration step: raw payload bytes
# (the pow2 padding of the scatter can at most double it)
DEFAULT_STEP_BYTES = 1 << 20


def _free_devices(src: Mesh) -> Optional[List[torch.device]]:
    """The devices a grown mesh's new columns may take: None when every
    coordinate of `src` is a virtual chip of one device (new columns are
    more virtual chips of it, as many as asked); else the CUDA cards of
    torch.cuda.device_count() that `src` does not use, in index order
    (none for a mesh of other devices)."""
    used = {(d.type, d.index or 0) for d in src.devices.flat}
    if len(used) == 1:
        return None
    if {t for t, _ in used} != {"cuda"}:
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            if ("cuda", i) not in used]


def reshard_target_mesh(router, target_tp: int) -> Mesh:
    """The target mesh of a table-axis resize to `target_tp`: every
    surviving source column keeps its coordinates' chips and devices;
    new columns take the next free chip ids, row by row.  On a mesh of
    virtual chips of one device a new column is more virtual chips of
    it; on a mesh of distinct cards each new coordinate takes the next
    card the mesh does not use, as the reference takes the next free
    jax device, and too few free cards is refused."""
    target_tp = int(target_tp)
    dp, tp_src = router.dp, router.tp
    used = {int(x) for x in router.ordinals.ravel()}
    need = dp * max(0, target_tp - tp_src)
    free = [c for c in range(len(used) + need) if c not in used]
    src = router.mesh
    cards = _free_devices(src)
    if cards is not None and len(cards) < need:
        raise ValueError(f"reshard to tp={target_tp} needs {need} free "
                         f"devices, have {len(cards)}")
    ids = np.empty((dp, target_tp), np.int64)
    devs = []
    for r in range(dp):
        row = []
        for c in range(target_tp):
            if c < tp_src:
                ids[r, c] = router.ordinals[r, c]
                row.append(src.devices[r, c])
            else:
                ids[r, c] = free.pop(0)
                row.append(src.devices[0, 0] if cards is None
                           else cards.pop(0))
        devs.append(row)
    return Mesh(devs, src.axis_names, ids=ids)


class ReshardPlan:
    """One live migration tp_src -> tp_dst over a ChipFailoverRouter.

    Drive it with `run()` (begin, bounded steps, cutover), or call
    `begin()`, `step()`, `cutover()` and `rollback()` to interleave
    serving, churn (`on_publish`) and fault injection between steps.
    `on_fault` picks the policy for a chip fault mid-migration:
    "complete" or "rollback".  `dtables` is the un-augmented fused world
    (required when the router has a datapath plane).  `shadow` is the
    shadow window to close stale at cutover; None, since the port has no
    shadow plane yet."""

    def __init__(self, router, target_mesh, step_bytes: int = DEFAULT_STEP_BYTES,
                 on_fault: str = "complete", dtables=None, shadow=None) -> None:
        if on_fault not in ("complete", "rollback"):
            raise ValueError(f"on_fault must be 'complete' or 'rollback', "
                             f"got {on_fault!r}")
        self.router = router
        self.target_mesh = target_mesh
        self.step_bytes = max(int(step_bytes), 1)
        self.on_fault = on_fault
        self.shadow = shadow
        self.table_axis = router.table_axis
        self.ntp_src = int(router.tp)
        self.ntp_dst = int(target_mesh.shape[self.table_axis])
        self._dtables = dtables
        self._pending: deque = deque()
        self._policy_host = None  # the staged target's augmented host tables
        self._pins: Optional[Tuple[int, int]] = None  # (epoch, layout)
        self._live_stamp_seen = None
        self._dp_epoch_seen = None
        self._dead_cols: set = set()
        self.state = "idle"  # idle | migrating | done | rolled_back
        self.stats = {"steps": 0, "bytes_h2d": 0, "restarts": 0,
                      "dead_cols": [], "outcome": None, "ms": 0.0,
                      "queued_items": 0}
        self._t0 = None

    # -- the work queue ----------------------------------------------------

    def _enqueue(self, plane: str, key, axis: int, idx, block) -> None:
        """One leaf's row set as bounded-byte chunks; `block` is the
        augmented rows per target column (None for a replicated leaf,
        which lands on every column)."""
        idx = np.asarray(idx, np.int64)
        if idx.size == 0:
            return
        if plane == "policy":
            leaf = getattr(self._policy_host, key)
        else:
            leaf = getattr(getattr(self._dp_host(), key[0]), key[1])
        arr = np.asarray(leaf)
        row_bytes = max(arr.nbytes // max(arr.shape[axis], 1), 1)
        per = max(1, self.step_bytes // row_bytes)
        for lo in range(0, idx.size, per):
            chunk = idx[lo:lo + per]
            cols = (tuple(range(self.ntp_dst)) if block is None
                    else tuple(int(c) for c in np.unique(chunk // block)))
            self._pending.append({
                "plane": plane, "key": key, "axis": int(axis), "idx": chunk,
                "block": block, "cols": cols,
                "bytes": int(chunk.size * row_bytes + chunk.nbytes)})
            self.stats["queued_items"] += 1

    def _enqueue_all(self, plane: str, moved, host_of) -> None:
        """Enqueue {key: (axis, idx)}, each leaf's block its augmented
        length over the target columns."""
        for key, (axis, idx) in sorted(moved.items()):
            n_aug = int(np.shape(host_of(key))[axis])
            self._enqueue(plane, key, axis, idx, n_aug // self.ntp_dst)

    def _dp_host(self):
        store = self.router.dp_store
        return store._slots[store._cur ^ 1]["host"]

    def _dp_leaf(self, key):
        return getattr(getattr(self._dp_host(), key[0]), key[1])

    # -- the lifecycle -----------------------------------------------------

    def _open_policy_window(self, moved_of) -> None:
        """Lay the router's tables out for the target, open the policy
        store's window and queue `moved_of(host_aug)`'s rows."""
        router = self.router
        t = router._tables
        host_aug = partition.replicate_table_leaves(t, self.ntp_dst,
                                                    self.table_axis)
        moved = moved_of(t, host_aug)
        shardings = partition.table_shardings(self.target_mesh, host_aug,
                                              self.table_axis)
        digest = partition.replica_partition_digest(self.table_axis,
                                                    ntp=self.ntp_dst)
        self._policy_host = host_aug
        self._pins = router.store.begin_relayout(host_aug, moved, shardings,
                                                 digest)
        self._enqueue_all("policy", moved,
                          lambda name: getattr(host_aug, name))

    def begin(self) -> "ReshardPlan":
        """Open the relayout windows and queue the moved rows.  The live
        epochs keep serving; nothing is drained."""
        if self.state != "idle":
            raise RuntimeError(f"plan already {self.state}")
        router = self.router
        if router.store._transform_fn is None:
            raise ValueError("resharding requires a replica store "
                             "(engine.sharded.make_replica_store)")
        self._t0 = time.perf_counter()
        self._open_policy_window(lambda t, aug: partition.reshard_moved_rows(
            t, self.ntp_src, self.ntp_dst, self.table_axis))
        if router.dp_store is not None:
            if self._dtables is None:
                raise ValueError("router has a fused datapath plane: pass "
                                 "dtables (the un-augmented fused world) to "
                                 "ReshardPlan")
            dmoved = router.dp_store.begin_relayout(self._dtables,
                                                    self.target_mesh)
            self._enqueue_all("datapath", dmoved, self._dp_leaf)
            self._dp_epoch_seen = router.dp_store.epoch
        self._live_stamp_seen = router.store.current_stamp()
        self.state = "migrating"
        tracing.add_event("reshard.begin", ntp_src=self.ntp_src,
                          ntp_dst=self.ntp_dst, queued=len(self._pending))
        return self

    def pending(self) -> int:
        return len(self._pending)

    # -- the churn dual-apply ----------------------------------------------

    def on_publish(self, tables, dtables=None) -> None:
        """Fold a publish (which just patched the LIVE epochs through the
        stores' relayout path) into the staged target: lay `tables` out
        for the target, diff it against the kept layout and re-queue
        every row whose contents changed.  Churn the window cannot
        absorb restarts the plan as a full upload into the target."""
        if self.state != "migrating":
            return
        store = self.router.store
        rel = store.relayout_state()
        if rel is None or rel["broken"]:
            self._restart_full()
            return
        new_aug = partition.replicate_table_leaves(tables, self.ntp_dst,
                                                   self.table_axis)
        old_aug = self._policy_host
        rep = partition.replica_axes(tables, self.ntp_dst, self.table_axis)
        queue: List[Tuple[str, int, np.ndarray, Optional[int]]] = []
        for f in dataclasses.fields(type(new_aug)):
            name = f.name
            if name == "generation":
                continue
            old, new = getattr(old_aug, name), getattr(new_aug, name)
            if old is None and new is None:
                continue
            if (old is None or new is None
                    or np.shape(old) != np.shape(new)):
                # a leaf appeared, vanished or resized: a layout change
                self._restart_full()
                return
            old_np, new_np = np.asarray(old), np.asarray(new)
            axis = rep.get(name)
            if axis is not None:
                mo = np.moveaxis(old_np, axis, 0)
                mn = np.moveaxis(new_np, axis, 0)
                chg = np.flatnonzero(np.any(
                    mn.reshape(mn.shape[0], -1)
                    != mo.reshape(mo.shape[0], -1), axis=1))
                if chg.size:
                    queue.append((name, axis, chg,
                                  new_np.shape[axis] // self.ntp_dst))
            elif not np.array_equal(old_np, new_np):
                queue.append((name, 0, np.arange(new_np.shape[0],
                                                 dtype=np.int64), None))
        self._policy_host = new_aug
        self._pins = store.relayout_update_host(new_aug)
        for name, axis, idx, block in queue:
            self._enqueue("policy", name, axis, idx, block)
        self._live_stamp_seen = store.current_stamp()
        dp_store = self.router.dp_store
        if dp_store is not None and dtables is not None:
            self._dtables = dtables
            changed = dp_store.relayout_update(dtables)
            if changed is None:
                self._restart_full()
                return
            self._enqueue_all("datapath", changed, self._dp_leaf)
            self._dp_epoch_seen = dp_store.epoch

    # -- the restart -------------------------------------------------------

    def _drifted(self) -> bool:
        """Whether the live world moved without a dual-apply (a publish
        nobody routed through on_publish, or a broken window): the
        staged target cannot be trusted to converge."""
        store = self.router.store
        rel = store.relayout_state()
        if rel is None or rel["broken"]:
            return True
        if store.current_stamp() != self._live_stamp_seen:
            return True
        dp_store = self.router.dp_store
        if dp_store is not None:
            drel = dp_store.relayout_state()
            if drel is None or drel["broken"]:
                return True
            if dp_store.epoch != self._dp_epoch_seen:
                return True
        return False

    def _restart_full(self) -> None:
        """Drop the staged epochs and open the windows again as a FULL
        streamed upload into the target layout (every augmented replica
        row queued) from the router's current world.  The live epoch
        serves throughout; only the bytes become the world's."""
        router = self.router
        router.store.rollback_relayout()
        if router.dp_store is not None:
            router.dp_store.rollback_relayout()
        self._pending.clear()
        self._dead_cols.clear()
        self.stats["restarts"] += 1
        metrics.reshard_total.inc("restart_full")
        tracing.add_event("reshard.restart_full", ntp_dst=self.ntp_dst)

        def every_row(t, aug):
            rep = partition.replica_axes(t, self.ntp_dst, self.table_axis)
            return {name: (axis, np.arange(np.shape(getattr(aug, name))[axis],
                                           dtype=np.int64))
                    for name, axis in rep.items()}

        self._open_policy_window(every_row)
        if router.dp_store is not None:
            router.dp_store.begin_relayout(self._dtables, self.target_mesh)
            drep = partition.datapath_all_replica_axes(
                self._dtables, self.ntp_dst, self.table_axis)
            self._enqueue_all("datapath", {
                key: (axis, np.arange(np.shape(self._dp_leaf(key))[axis],
                                      dtype=np.int64))
                for key, axis in drep.items()}, self._dp_leaf)
            self._dp_epoch_seen = router.dp_store.epoch
        self._live_stamp_seen = router.store.current_stamp()

    # -- chip faults -------------------------------------------------------

    def _target_ordinals_of_col(self, col: int) -> List[int]:
        return [int(x) for x in self.target_mesh.ids[:, int(col)]]

    def _col_of_ordinal(self, ordinal: int) -> Optional[int]:
        hit = np.argwhere(self.target_mesh.ids == int(ordinal))
        return int(hit[0][1]) if len(hit) else None

    def _handle_fault(self, exc, probed_col: int) -> Optional[dict]:
        """A chip died (the fault site fired) mid-migration; the fault
        domain is its target column.  Returns the terminal stats on
        rollback, None to go on (the complete leg)."""
        ordinal = getattr(exc, "chip", None)
        col = self._col_of_ordinal(ordinal) if ordinal is not None else None
        if col is None:
            col = int(probed_col)
        if self.on_fault == "rollback":
            # a chip of the serving mesh still failed: open its breakers
            # so the untouched source layout routes around it
            for o in self._target_ordinals_of_col(col):
                if (self.router.ordinals == o).any():
                    self.router.bank.record_failure(
                        o, f"reshard.migrate fault: {exc}")
            self.rollback(reason=f"fault on column {col}")
            return dict(self.stats)
        # complete via the survivors: the dead column's own rows stop
        # streaming (routing excludes dead owners); the backup copies of
        # its slice, in its right neighbour's region, keep streaming
        self._dead_cols.add(col)
        self.stats["dead_cols"] = sorted(self._dead_cols)
        kept = deque()
        for item in self._pending:
            if item["block"] is None:
                kept.append(item)
                continue
            mask = (item["idx"] // item["block"]) != col
            if mask.all():
                kept.append(item)
            elif mask.any():
                item = dict(item, idx=item["idx"][mask])
                item["cols"] = tuple(int(c) for c in np.unique(
                    item["idx"] // item["block"]))
                kept.append(item)
        self._pending = kept
        for o in self._target_ordinals_of_col(col):
            self.router.bank.record_failure(o, f"reshard.migrate fault: {exc}")
        tracing.add_event("reshard.chip_fault", col=col,
                          action="complete_via_replicas")
        log.warning("chip fault mid-migration; completing via replica copies",
                    extra={"fields": {"column": col}})
        return None

    # -- the migration steps -----------------------------------------------

    def step(self) -> dict:
        """Stream one bounded-byte batch of queued rows into the staged
        target epochs.  Returns {"done", "bytes", "cols"}; a fault on the
        rollback leg makes the plan terminal (state "rolled_back")."""
        if self.state != "migrating":
            raise RuntimeError(f"plan is {self.state}, not migrating")
        if self._drifted():
            self._restart_full()
        if not self._pending:
            return {"done": True, "bytes": 0}
        batch = []
        budget = self.step_bytes
        while self._pending and (not batch or budget > 0):
            item = self._pending.popleft()
            batch.append(item)
            budget -= item["bytes"]
        cols = sorted({c for it in batch for c in it["cols"]})
        # the fault seam, once per target-column chip this step writes;
        # nothing armed costs one lock-free read
        if faultinject.any_armed():
            for c in cols:
                if c in self._dead_cols:
                    continue
                for o in self._target_ordinals_of_col(c):
                    try:
                        faultinject.fire("reshard.migrate", chip=o)
                    except faultinject.FaultInjected as exc:
                        terminal = self._handle_fault(exc, c)
                        if terminal is not None:
                            return dict(terminal, done=True)
                        # this step's batch drops the column too
                        batch = [
                            dict(it, idx=it["idx"][
                                (it["idx"] // it["block"]) != c])
                            if it["block"] is not None else it
                            for it in batch]
                        batch = [it for it in batch if it["idx"].size]
        policy_sets: Dict[str, Tuple[int, np.ndarray]] = {}
        dp_sets: Dict[tuple, Tuple[int, np.ndarray]] = {}
        for it in batch:
            tgt = policy_sets if it["plane"] == "policy" else dp_sets
            prev = tgt.get(it["key"])
            tgt[it["key"]] = (it["axis"], it["idx"] if prev is None else
                              np.unique(np.concatenate([prev[1], it["idx"]])))
        bytes_h2d = 0
        if policy_sets:
            bytes_h2d += self.router.store.repair_rows(
                policy_sets, spare=True, expect_epoch=self._pins[0],
                expect_layout=self._pins[1])
        if dp_sets:
            bytes_h2d += self.router.dp_store.relayout_scatter(dp_sets)
        self.stats["steps"] += 1
        self.stats["bytes_h2d"] += bytes_h2d
        metrics.reshard_steps_total.inc()
        metrics.reshard_bytes_h2d_total.inc(value=bytes_h2d)
        return {"done": not self._pending, "bytes": bytes_h2d, "cols": cols}

    # -- the terminals -----------------------------------------------------

    def cutover(self) -> dict:
        """Flip both stores to the staged target epochs, re-aim the router
        and close an armed shadow window stale.  Runs between dispatches:
        batches already dispatched finished on the source epoch, whose
        tensors the migration never wrote."""
        if self.state != "migrating":
            raise RuntimeError(f"plan is {self.state}, not migrating")
        if self._drifted():
            self._restart_full()
            if self._pending:
                # churn forced a full restart at the brink of cutover:
                # the caller streams the refilled queue and tries again
                return dict(self.stats, deferred=True)
        if self._pending:
            raise RuntimeError(f"{len(self._pending)} migration chunks still "
                               f"queued; stream them before cutover")
        router = self.router
        ntp, axis, mesh = self.ntp_dst, self.table_axis, self.target_mesh
        router.store.cutover_relayout(
            shardings_fn=lambda aug: partition.table_shardings(mesh, aug,
                                                               axis),
            partition_digest=partition.replica_partition_digest(axis,
                                                                ntp=ntp),
            transform_fn=lambda t: partition.replicate_table_leaves(
                t, ntp, axis),
            delta_transform_fn=lambda d, pre: partition.replica_delta(
                d, pre, ntp, axis))
        if router.dp_store is not None:
            router.dp_store.cutover_relayout()
        router.adopt_reshard(mesh, dtables=self._dtables)
        if self.shadow is not None:
            self.shadow.notify_cutover()
        self.state = "done"
        self.stats["outcome"] = "cutover"
        self.stats["ms"] = (time.perf_counter() - self._t0) * 1000.0
        metrics.reshard_total.inc("cutover")
        metrics.reshard_seconds.observe(self.stats["ms"] / 1000.0)
        tracing.add_event("reshard.cutover", ntp_src=self.ntp_src,
                          ntp_dst=self.ntp_dst, steps=self.stats["steps"],
                          bytes_h2d=self.stats["bytes_h2d"],
                          restarts=self.stats["restarts"])
        log.info("reshard cutover complete", extra={"fields": {
            "tp": f"{self.ntp_src}->{self.ntp_dst}",
            "steps": self.stats["steps"],
            "bytes_h2d": self.stats["bytes_h2d"]}})
        return dict(self.stats)

    def rollback(self, reason: str = "operator") -> dict:
        """Abandon the migration: the staged epochs drop, the source
        layout keeps serving (the migration never wrote it), and the plan
        is terminal."""
        if self.state not in ("migrating", "idle"):
            return dict(self.stats)
        self.router.store.rollback_relayout()
        if self.router.dp_store is not None:
            self.router.dp_store.rollback_relayout()
        self._pending.clear()
        self.state = "rolled_back"
        self.stats["outcome"] = "rollback"
        self.stats["ms"] = ((time.perf_counter() - self._t0) * 1000.0
                            if self._t0 else 0.0)
        metrics.reshard_total.inc("rollback")
        if self._t0:
            metrics.reshard_seconds.observe(self.stats["ms"] / 1000.0)
        tracing.add_event("reshard.rollback", reason=reason)
        log.warning("reshard rolled back",
                    extra={"fields": {"reason": reason}})
        return dict(self.stats)

    def run(self, max_steps: int = 1 << 16) -> dict:
        """begin, stream, cutover in one call; a fault on the rollback leg
        ends early with outcome "rollback"."""
        if self.state == "idle":
            self.begin()
        steps = 0
        while self.state == "migrating":
            if self._pending:
                self.step()
                steps += 1
                if steps > max_steps:
                    self.rollback(reason="max_steps exceeded")
            else:
                self.cutover()  # a deferred restart loops back
        return dict(self.stats)
