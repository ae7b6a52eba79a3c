"""Device-resident table epochs and batch dispatch (the reference's
engine/publish.py, single-device).

`DeviceTableStore` keeps two epochs of PolicyTables on one device,
ping-ponging (the realized/backup map shuffle of Cilium's
pkg/datapath/ipcache/listener.go):

  * `publish(tables, delta)` installs the new generation into the SPARE
    epoch.  With a TableDelta that starts at the spare's stamp
    (FleetCompiler.delta_for), the changed rows are written into the
    spare's own tensors in place (on the card by PUBLISH_SCATTER, one
    launch for every scattered leaf; on the CPU by
    `scatter_segments_plain`), leaves whose shape class moved are
    uploaded fresh, and the generation is stamped: bytes shipped follow
    the change, not the world.  Without a usable delta it uploads in
    full.
  * batches dispatched against the CURRENT epoch finish on it
    untouched: only the spare's tensors are written.
  * `check_current` raises for tables whose epoch has since been
    written over (StaleEpochError).
  * the `publish.scatter` fault seam (faultinject) is probed once per
    chip that holds a slice of the spare epoch before its scatter; a
    fired fault de-registers the spare and the publish uploads in full
    (`publish_fallback_total`, the `publish.epoch` span's `fallback`).
  * the per-chip outage ledger: `mark_chip_out` starts recording what a
    chip misses (the deltas published while its breaker is open, or
    that it needs its whole slice); `readmit_chip` closes the record and
    `repair_rows` rewrites rows of the live (or spare) epoch from the
    host tables the epoch was placed from, which a store with a
    `transform_fn` retains (on the card by REPAIR_SCATTER, one launch
    for each device that holds a repaired slice; on the CPU by
    `repair_segments_plain`).

The scatter follows jax's `.at[idx].set(values)` on the reference's
spare epoch, not torch's indexing: a negative index counts from the end
once, and a row with any index still outside its axis is dropped.

On a mesh (`shardings` or `shardings_fn`, engine/mesh.py) an epoch is
MeshTables: each leaf placed under its NamedSharding.  A delta publish
routes each row to the shard that owns it on the host (its global index
minus the shard's offset; a payload that spans the sharded axis is
sliced), then scatters each device's rows in place, one launch per
device.  `transform_fn` lays the host tables out for the devices (the
replica store's N+1 copies) and `delta_transform_fn` rewrites a delta
into that layout; `partition_digest` is folded into the layout stamp.

A relayout window (engine/reshard.py, live resharding): `begin_relayout`
stages the target layout of another mesh in the spare slot, every moved
row zeroed, and `repair_rows(spare=True)` streams the moved rows in.
While the window is open a publish patches the LIVE epoch in place (a
delta against it, devices synchronized before and after) and never
touches the staged target; anything else (no usable delta, a scatter
fault) uploads the live epoch in full and marks the window broken, so
the plan restarts.  `cutover_relayout` flips the staged epoch live and
rebinds the store's partition seams; `rollback_relayout` drops it.

`AsyncBatchDispatcher` is the double-buffered async batch pipeline and
`next_pow2` the pow2 size class of every padded payload.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.compiler.delta import TableDelta, tables_nbytes
from cilium_tpu_torch.compiler.tables import (
    PolicyTables,
    tables_layout_version,
)
from cilium_tpu_torch import faultinject
from cilium_tpu_torch.device import array_tensor, resolve_device
from cilium_tpu_torch.logging import get_logger
from cilium_tpu_torch.metrics import registry as metrics

log = get_logger("publish")

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    size = 1
    while size < n:
        size <<= 1
    return size


def _pad_pow2(update):
    """A LeafUpdate's payload padded to the next power of two by
    repeating its last index and row (duplicate identical writes give
    the same bits): (idx tuple, values)."""
    k = len(update.values)
    size = next_pow2(k)
    if size == k:
        return update.idx, update.values
    pad = size - k
    idx = tuple(np.concatenate([i, np.repeat(i[-1:], pad)])
                for i in update.idx)
    values = np.concatenate(
        [update.values, np.repeat(update.values[-1:], pad, axis=0)])
    return idx, values


def delta_payloads(delta: TableDelta, device) -> dict:
    """The scatter payloads of `delta` on `device`, each padded to the
    next power of two (_pad_pow2): {leaf: (idx, values)}, idx a tuple
    of int64 tensors, values int32 (u32 bits; u16 widened), in leaf-name
    order."""
    from cilium_tpu_torch.convert import _leaf_to

    dev = resolve_device(device)
    out = {}
    for name in sorted(delta.updates):
        idx, values = _pad_pow2(delta.updates[name])
        out[name] = (tuple(array_tensor(np.asarray(i, np.int64), dev)
                           for i in idx),
                     _leaf_to(values, dev))
    return out


def scatter_segments_plain(segments) -> None:
    """PUBLISH_SCATTER's plain version: for each (dst, idx, values) of
    `segments`, in place, dst[idx] = values with jax's scatter rules: an
    index below 0 gets its axis size added once, and a row with any
    index still outside [0, size) is dropped.  `idx` is a tuple of
    int64 tensors, one per indexed leading axis; `values` has dst's
    trailing shape and dst's dtype."""
    for dst, idx, values in segments:
        keep = torch.ones(values.shape[0], dtype=torch.bool,
                          device=values.device)
        norm = []
        for axis, i in enumerate(idx):
            size = int(dst.shape[axis])
            i = torch.where(i < 0, i + size, i)
            keep &= (i >= 0) & (i < size)
            norm.append(i)
        dst[tuple(i[keep] for i in norm)] = values[keep]


def route_update(update, shape, sharding, coord):
    """The part of one LeafUpdate (host arrays, recorded against the
    global leaf of `shape`) that lands on coordinate `coord` under
    `sharding`, in the shard's coordinates: (idx, values), or None when
    no row lands there.  A replicated leaf takes the whole update.
    Where the update indexes the sharded axis, each row goes to the
    shard owning it (jax's rules first: a negative index counts from the
    end, a row outside the leaf is dropped) at its index minus the
    shard's offset; where the values span the sharded axis, each shard
    takes its slice of them."""
    idx = tuple(np.asarray(i, np.int64) for i in update.idx)
    values = np.asarray(update.values)
    block = sharding.slices(shape, coord)
    axes = [a for a, s in enumerate(block) if s != slice(None)]
    if not axes:
        return idx, values
    keep = np.ones(values.shape[0], bool)
    out_idx = list(idx)
    for a in axes:
        lo, hi = block[a].start, block[a].stop
        if a < len(idx):
            i = np.where(idx[a] < 0, idx[a] + shape[a], idx[a])
            keep &= (i >= lo) & (i < hi)
            out_idx[a] = i - lo
        else:
            va = a - len(idx) + 1
            values = np.take(values, np.arange(lo, hi), axis=va)
    if not keep.any():
        return None
    return tuple(i[keep] for i in out_idx), values[keep]


def repair_segments_plain(segments) -> None:
    """REPAIR_SCATTER's plain version: for each (dst, axis, idx, values)
    of `segments`, in place, dst[(slice(None),) * axis + (idx,)] =
    values with jax's scatter rules (an index below 0 gets the axis size
    added once; one still outside [0, size) is dropped).  `idx` is an
    int64 tensor [K]; `values` has dst's shape with K at `axis`."""
    for dst, axis, idx, values in segments:
        size = int(dst.shape[axis])
        i = torch.where(idx < 0, idx + size, idx)
        keep = (i >= 0) & (i < size)
        ix = (slice(None),) * axis
        dst[ix + (i[keep],)] = values[ix + (keep,)]


def repair_scatter(segments) -> None:
    """Write every repair segment in place: REPAIR_SCATTER when the
    destinations lie on a CUDA device (one launch for all), the plain
    version on the CPU."""
    if not segments:
        return
    dev = segments[0][0].device
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        kernels.REPAIR_SCATTER(segments)
    elif dev.type == "cpu":
        repair_segments_plain(segments)
    else:
        raise ValueError(f"unsupported device {dev}")


def route_repair(idx, values, axis: int, shape, sharding, coord):
    """The part of a repair payload (host `idx` along `axis` of the
    global leaf of `shape`, `values` with the leaf's shape but K rows at
    `axis`) that lands on coordinate `coord` under `sharding`, in the
    block's coordinates: (idx, values), or None.  Along a sharded
    `axis` each row goes to the block that owns it, at its index minus
    the block's offset; along any other sharded axis the values are
    sliced.  jax's rules come first: a negative index counts from the
    end once, and an index still out of range is dropped."""
    idx = np.asarray(idx, np.int64)
    values = np.asarray(values)
    idx = np.where(idx < 0, idx + shape[axis], idx)
    keep = (idx >= 0) & (idx < shape[axis])
    for a, blk in enumerate(sharding.slices(shape, coord)):
        if blk == slice(None):
            continue
        if a == axis:
            keep &= (idx >= blk.start) & (idx < blk.stop)
            idx = idx - blk.start
        else:
            values = np.take(values, np.arange(blk.start, blk.stop), axis=a)
    if not keep.any():
        return None
    return idx[keep], np.take(values, np.flatnonzero(keep), axis=axis)


def publish_scatter(segments) -> None:
    """Write every segment in place: PUBLISH_SCATTER when the
    destinations lie on a CUDA device (one launch for all), the plain
    version on the CPU."""
    if not segments:
        return
    dev = segments[0][0].device
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        kernels.PUBLISH_SCATTER(segments)
    elif dev.type == "cpu":
        scatter_segments_plain(segments)
    else:
        raise ValueError(f"unsupported device {dev}")


def _resident_bytes(tables) -> int:
    """Bytes of the tensors one device epoch holds."""
    total = 0
    for f in dataclasses.fields(tables):
        leaf = getattr(tables, f.name)
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


@dataclass
class PublishStats:
    epoch: int
    mode: str  # "full" | "delta"
    bytes_h2d: int
    seconds: float
    scatter_leaves: int = 0
    replaced_leaves: int = 0


class StaleEpochError(ValueError):
    pass


class DeviceTableStore:
    """Two PolicyTables epochs on one device (None = the card) with
    scatter-delta publication (see the module docstring).

    Each epoch carries its layout stamp (tables_layout_version): a
    delta recorded against another layout, or onto a spare epoch of
    another layout, is refused and the publish uploads in full.

    An injected `publish.scatter` fault (faultinject.FaultInjected)
    de-registers the spare slot and this publish uploads in full
    instead.  Any other failed scatter de-registers the spare slot (its
    rows can no longer be trusted; the next publish uploads in full)
    and raises.

    With a `transform_fn` or `delta_transform_fn` (the replica store)
    each epoch retains the transformed host tables it was placed from:
    the value source of `repair_rows`.  A plain store retains none.

    On a mesh: `shardings` (PolicyTables of NamedSharding) places every
    epoch, or `shardings_fn(tables)` resolves them per publish (leaf
    divisibility depends on the published shapes); `partition_digest`
    is folded into the layout stamp; `transform_fn(tables)` gives the
    device layout and `delta_transform_fn(delta, tables)` rewrites a
    delta recorded against `tables` into it."""

    def __init__(self, device=None, shardings=None, shardings_fn=None,
                 partition_digest: int = 0, transform_fn=None,
                 delta_transform_fn=None) -> None:
        self._lock = threading.Lock()
        # each slot: dict(tables=<device PolicyTables or MeshTables>,
        # stamp, epoch, nbytes (host), layout, chip_bytes {chip: bytes})
        self._slots = [None, None]
        self._cur = 0
        self._epoch = 0
        # a mesh store's devices are its mesh's
        mesh_store = shardings is not None or shardings_fn is not None
        self._device = None if mesh_store else resolve_device(device)
        self._shardings = shardings
        self._shardings_fn = shardings_fn
        self.partition_digest = int(partition_digest)
        self._transform_fn = transform_fn
        self._delta_transform_fn = delta_transform_fn
        # only a store with a device layout seam has a repair consumer
        # for the retained host tables
        self._retain_host = (transform_fn is not None
                             or delta_transform_fn is not None)
        # the per-chip outage ledger: chip -> {"epoch" at mark-out,
        # "missed" [transformed TableDelta], "needs_full"}
        self._out_chips: Dict[int, Dict] = {}
        self._missed_cap = 32
        # the open relayout window (begin_relayout): while set, the spare
        # slot holds the migration target and publish() patches the live
        # slot instead
        self._relayout: Optional[Dict] = None

    @property
    def on_mesh(self) -> bool:
        return self._shardings is not None or self._shardings_fn is not None

    def _sync(self) -> None:
        """Wait for the devices' queued work (the reference's
        block_until_ready): the epoch is complete when publish returns."""
        if self._shardings is not None:
            devs = set(self._shardings.generation.mesh.devices.flat)
        else:
            devs = {self._device}
        for dev in devs:
            if torch.device(dev).type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _specs(self):
        """Each leaf's PartitionSpec on a mesh store (None on one
        device)."""
        return _specs_of(self._shardings)

    def _put_tables(self, tables):
        """Full placement: one device, or the mesh's coordinates."""
        if self._shardings is None:
            from cilium_tpu_torch.convert import policy_tables_to

            return policy_tables_to(tables, self._device)
        from cilium_tpu_torch.engine.mesh import place_tables

        return place_tables(tables, self._shardings)

    # -- publication ---------------------------------------------------------

    def publish(self, tables: PolicyTables,
                delta: Optional[TableDelta] = None
                ) -> Tuple[PolicyTables, PublishStats]:
        """Install `tables` (host arrays) as the new current epoch.
        `delta` must describe every change from the SPARE slot's stamp
        to `tables` (FleetCompiler.delta_for); anything else, or None,
        uploads in full.  Returns (the device epoch, PublishStats).  Runs
        under a `publish.epoch` span."""
        from cilium_tpu_torch import tracing

        with self._lock, tracing.tracer.span(
            "publish.epoch", site="engine.publish"
        ) as sp:
            t0 = time.perf_counter()
            pre_transform = tables
            if self._transform_fn is not None:
                tables = self._transform_fn(tables)
            if self._shardings_fn is not None:
                self._shardings = self._shardings_fn(tables)
            base_layout = tables_layout_version(tables)
            layout = base_layout | (self.partition_digest << 32)
            spare_i = self._cur ^ 1
            spare = self._slots[spare_i]
            stamp = int(np.asarray(tables.generation))
            if self._relayout is not None and not self._relayout["broken"]:
                # the spare slot is the staged migration target: churn
                # lands on the live slot
                return self._publish_relayout_locked(
                    tables, pre_transform, delta, base_layout, layout,
                    stamp, sp, t0)
            use_delta = self._delta_fits(spare, delta, stamp, layout,
                                         base_layout)
            if use_delta and self._delta_transform_fn is not None:
                # into device coordinates: the delta was recorded
                # against the un-transformed tables
                delta = self._delta_transform_fn(delta, pre_transform)
            if use_delta:
                try:
                    self._probe_scatter_fault(spare)
                    publish = (self._publish_delta_mesh if self.on_mesh
                               else self._publish_delta)
                    dev, stats = publish(spare["tables"], tables, delta)
                except faultinject.FaultInjected as exc:
                    # the seam fires before any write: serve this
                    # publish by a full upload, and drop the spare whose
                    # bookkeeping the fault makes untrusted
                    self._slots[spare_i] = None
                    use_delta = False
                    metrics.publish_fallback_total.inc()
                    sp.attrs["fallback"] = str(exc)
                    log.warning(
                        "delta publish scatter faulted; falling back to "
                        "full upload", extra={"fields": {"error": str(exc)}})
                except Exception:
                    # the scatter may have written part of the spare's
                    # tensors: de-register the slot so the next publish
                    # uploads in full instead of scattering into it
                    self._slots[spare_i] = None
                    self._sample_bytes()
                    raise
                else:
                    metrics.device_table_retired_bytes.inc(
                        value=spare.get("nbytes", 0))
            if not use_delta:
                dev = self._put_tables(tables)
                self._sync()
                stats = PublishStats(epoch=0, mode="full",
                                     bytes_h2d=tables_nbytes(tables),
                                     seconds=0.0)
            self._install_locked(spare_i, dev, tables, stamp, layout)
            self._cur = spare_i
            return dev, self._published_locked(stats, use_delta, delta, sp,
                                               t0)

    def _delta_fits(self, slot, delta, stamp: int, layout: int,
                    base_layout: int) -> bool:
        """Whether `delta` takes `slot`'s epoch to `stamp`: it starts at
        the slot's stamp, and its indices mean something only against the
        layout (and partitioning) the slot holds and, on a mesh, the
        placement its rows route by."""
        return (delta is not None and slot is not None
                and slot["stamp"] == delta.base_stamp
                and stamp == delta.new_stamp
                and slot["layout"] == layout
                and delta.layout == base_layout
                and slot["specs"] == self._specs())

    def _install_locked(self, i: int, dev, tables, stamp: int,
                        layout: int) -> None:
        """A new epoch `dev` (placed from host `tables`) in slot `i`."""
        self._epoch += 1
        self._slots[i] = {
            "tables": dev, "stamp": stamp, "epoch": self._epoch,
            "nbytes": tables_nbytes(tables), "layout": layout,
            "chip_bytes": (dev.chip_bytes() if self.on_mesh else {
                self._device.index or 0: _resident_bytes(dev)}),
            "specs": self._specs(),
            "host": tables if self._retain_host else None,
            "shardings": self._shardings,
        }

    def _published_locked(self, stats, use_delta: bool, delta, sp, t0,
                          **attrs):
        """A publish's bookkeeping after its epoch is installed: the
        stats, the outage ledger (a delta is replayable row by row at
        readmission; a full upload, or a full miss list, makes the
        rebalance replay the chip's whole slice), the byte gauges and the
        span."""
        stats.epoch = self._epoch
        stats.seconds = time.perf_counter() - t0
        for rec in self._out_chips.values():
            if (use_delta and not rec["needs_full"]
                    and len(rec["missed"]) < self._missed_cap):
                rec["missed"].append(delta)
            else:
                rec["needs_full"] = True
        self._sample_bytes()
        sp.attrs.update(
            mode=stats.mode, epoch=stats.epoch, bytes_h2d=stats.bytes_h2d,
            scatter_leaves=stats.scatter_leaves,
            replaced_leaves=stats.replaced_leaves, **attrs)
        return stats

    def _publish_relayout_locked(self, tables, pre_transform, delta,
                                 base_layout: int, layout: int, stamp: int,
                                 sp, t0):
        """A publish while a relayout window is open (the caller holds the
        lock).  The spare slot is the staged migration target, so the
        churn lands on the LIVE slot: a usable delta against the live
        epoch patches its tensors in place (the devices synchronized
        before, so no queued batch reads a row while it is written);
        anything else (no usable delta, a scatter fault) uploads the live
        epoch in full and marks the window broken, the plan's restart
        signal."""
        live_i = self._cur
        live = self._slots[live_i]
        use_delta = self._delta_fits(live, delta, stamp, layout, base_layout)
        if use_delta and self._delta_transform_fn is not None:
            delta = self._delta_transform_fn(delta, pre_transform)
        if use_delta:
            try:
                self._probe_scatter_fault(live)
                self._sync()
                publish = (self._publish_delta_mesh if self.on_mesh
                           else self._publish_delta)
                dev, stats = publish(live["tables"], tables, delta)
            except faultinject.FaultInjected as exc:
                # the seam fires before any write: the live epoch is
                # intact, and the full upload below breaks the window
                use_delta = False
                metrics.publish_fallback_total.inc()
                sp.attrs["fallback"] = str(exc)
                log.warning(
                    "delta publish scatter faulted during relayout; "
                    "falling back to full upload",
                    extra={"fields": {"error": str(exc)}})
        if not use_delta:
            dev = self._put_tables(tables)
            self._sync()
            stats = PublishStats(epoch=0, mode="full",
                                 bytes_h2d=tables_nbytes(tables),
                                 seconds=0.0)
            self._relayout["broken"] = True
            sp.attrs["relayout_broken"] = True
        self._install_locked(live_i, dev, tables, stamp, layout)
        return dev, self._published_locked(stats, use_delta, delta, sp, t0,
                                           relayout=True)

    # -- live resharding (engine/reshard.py drives these) --------------------

    def begin_relayout(self, host_aug, moved_rows, shardings,
                       partition_digest: int) -> Tuple[int, int]:
        """Open a relayout window: place the migration target (host
        tables already laid out for the target mesh) under `shardings`
        into the SPARE slot, while the live epoch keeps serving.  The
        rows of `moved_rows` ({leaf: (axis, index array)},
        compiler.partition.reshard_moved_rows) are placed zeroed: the
        epoch becomes whole only as repair_rows(spare=True) streams them
        in.  The slot retains the true `host_aug` as the stream's source.
        Returns (epoch, layout), the pins of every migration step."""
        from cilium_tpu_torch import tracing
        from cilium_tpu_torch.engine.mesh import place_tables

        with self._lock, tracing.tracer.span(
                "publish.begin_relayout", site="engine.publish") as sp:
            if self._relayout is not None:
                raise RuntimeError("relayout window already open")
            if self._slots[self._cur] is None:
                raise RuntimeError("no live epoch to reshard from")
            layout = tables_layout_version(host_aug) | (
                int(partition_digest) << 32)
            kw = {}
            for name, (axis, idx) in moved_rows.items():
                arr = np.array(np.asarray(getattr(host_aug, name)))
                idx = np.asarray(idx, np.int64)
                if idx.size:
                    arr[(slice(None),) * int(axis) + (idx,)] = 0
                kw[name] = arr
            seed = dataclasses.replace(host_aug, **kw) if kw else host_aug
            dev = place_tables(seed, shardings)
            spare_i = self._cur ^ 1
            self._epoch += 1
            self._slots[spare_i] = {
                "tables": dev,
                "stamp": int(np.asarray(host_aug.generation)),
                "epoch": self._epoch, "nbytes": tables_nbytes(host_aug),
                "layout": layout, "chip_bytes": dev.chip_bytes(),
                "specs": _specs_of(shardings), "host": host_aug,
                "shardings": shardings,
            }
            self._relayout = {"epoch": self._epoch, "layout": layout,
                              "broken": False, "shardings": shardings,
                              "digest": int(partition_digest)}
            for d in {str(d) for d in shardings.generation.mesh.devices.flat}:
                if torch.device(d).type == "cuda":
                    torch.cuda.synchronize(d)
            self._sample_bytes()
            sp.attrs.update(epoch=self._epoch, layout=layout)
            return self._epoch, layout

    def relayout_state(self) -> Optional[Dict]:
        """{"epoch", "layout", "broken"} of the open relayout window, or
        None: the plan's restart detector."""
        with self._lock:
            rel = self._relayout
            if rel is None:
                return None
            return {"epoch": rel["epoch"], "layout": rel["layout"],
                    "broken": bool(rel["broken"])}

    def relayout_update_host(self, host_aug) -> Tuple[int, int]:
        """The churn dual-apply's staged half: the staged target retains
        `host_aug` from now on (the plan re-queues the rows whose
        contents changed, and later steps read the new values), and its
        generation stamp follows the live world.  Refused when no window
        is open or the window broke.  Returns the new pins."""
        with self._lock:
            rel = self._relayout
            if rel is None or rel["broken"]:
                raise RuntimeError("no open relayout window to update")
            slot = self._slots[self._cur ^ 1]
            if slot is None or slot["epoch"] != rel["epoch"]:
                raise RuntimeError("staged relayout epoch is gone")
            stamp = int(np.asarray(host_aug.generation))
            mt = slot["tables"]
            shards = np.empty(mt.shards.shape, dtype=object)
            for coord in mt.mesh.coords():
                shards[coord] = dataclasses.replace(mt.shards[coord],
                                                    generation=stamp)
            slot["tables"] = dataclasses.replace(mt, shards=shards,
                                                 generation=stamp)
            layout = tables_layout_version(host_aug) | (rel["digest"] << 32)
            slot.update(host=host_aug, stamp=stamp, layout=layout,
                        nbytes=tables_nbytes(host_aug))
            rel["layout"] = layout
            return slot["epoch"], layout

    def cutover_relayout(self, shardings_fn=None, partition_digest=None,
                         transform_fn=None, delta_transform_fn=None) -> int:
        """Flip the staged target epoch live (the reshard cutover) and
        rebind the store's partition seams (sharding resolver, digest,
        layout transform, delta rewrite) to the target layout.  The old
        live epoch stays as the source-layout spare: its next delta
        publish is refused by the layout guard into one full upload.
        Refused while the window is broken.  Returns the new live
        epoch."""
        from cilium_tpu_torch import tracing

        with self._lock, tracing.tracer.span(
                "publish.cutover_relayout", site="engine.publish") as sp:
            rel = self._relayout
            if rel is None:
                raise RuntimeError("no open relayout window")
            if rel["broken"]:
                raise RuntimeError("relayout window broken by a full "
                                   "publish; cutover refused: restart the "
                                   "migration")
            spare_i = self._cur ^ 1
            slot = self._slots[spare_i]
            if slot is None or slot["epoch"] != rel["epoch"]:
                raise RuntimeError("staged relayout epoch is gone; cutover "
                                   "refused")
            self._cur = spare_i
            self._relayout = None
            self._shardings = rel["shardings"]
            if shardings_fn is not None:
                self._shardings_fn = shardings_fn
            if partition_digest is not None:
                self.partition_digest = int(partition_digest)
            if transform_fn is not None:
                self._transform_fn = transform_fn
            if delta_transform_fn is not None:
                self._delta_transform_fn = delta_transform_fn
            self._retain_host = (self._transform_fn is not None
                                 or self._delta_transform_fn is not None)
            self._sample_bytes()
            sp.attrs.update(epoch=slot["epoch"], layout=slot["layout"])
            return slot["epoch"]

    def rollback_relayout(self) -> bool:
        """Drop the staged target epoch (the live source layout was never
        written by the migration); the next publish uploads the freed
        slot in full.  Returns True when a window was open."""
        with self._lock:
            rel = self._relayout
            if rel is None:
                return False
            spare_i = self._cur ^ 1
            slot = self._slots[spare_i]
            if slot is not None and slot["epoch"] == rel["epoch"]:
                self._slots[spare_i] = None
            self._relayout = None
            self._sample_bytes()
            return True

    def _sample_bytes(self) -> None:
        """cilium_device_table_bytes{epoch} and
        cilium_device_table_bytes_per_chip{chip}, sampled at every
        publish (the caller holds the lock)."""
        cur = self._slots[self._cur]
        spare = self._slots[self._cur ^ 1]
        metrics.device_table_bytes.set("live",
                                       value=(cur or {}).get("nbytes", 0))
        metrics.device_table_bytes.set("standby",
                                       value=(spare or {}).get("nbytes", 0))
        for chip, nbytes in sorted(self._chip_bytes_locked().items()):
            metrics.device_table_bytes_per_chip.set(str(chip), value=nbytes)

    @staticmethod
    def _probe_scatter_fault(spare) -> None:
        """The publish.scatter fault seam, probed once per chip holding
        a slice of the spare epoch (a chip-scoped schedule fires only
        when its chip receives the scatter).  Nothing armed costs one
        lock-free read."""
        if not faultinject.any_armed():
            return
        chips = sorted(spare.get("chip_bytes") or {})
        if not chips:
            faultinject.fire("publish.scatter")
        for chip in chips:
            faultinject.fire("publish.scatter", chip=chip)

    def _publish_delta(self, spare_dev: PolicyTables, tables: PolicyTables,
                       delta: TableDelta):
        from cilium_tpu_torch.convert import _leaf_to

        n_scatter = n_replace = bytes_h2d = 0
        # whole-leaf replacements are fresh uploads swapped into the
        # epoch (the spare's old tensor is dropped)
        replaced = {}
        for name, arr in delta.replace.items():
            replaced[name] = _leaf_to(arr, self._device)
            bytes_h2d += np.asarray(arr).nbytes
            n_replace += 1
        base = dataclasses.replace(spare_dev, **replaced)
        payloads = delta_payloads(delta, self._device)
        for name in payloads:
            bytes_h2d += delta.updates[name].nbytes
            n_scatter += 1
        # the spare's own tensors, written in place
        publish_scatter([(getattr(base, name), idx, values)
                         for name, (idx, values) in payloads.items()])
        dev = dataclasses.replace(
            base, generation=int(np.asarray(tables.generation)))
        self._sync()
        return dev, PublishStats(
            epoch=0, mode="delta", bytes_h2d=bytes_h2d, seconds=0.0,
            scatter_leaves=n_scatter, replaced_leaves=n_replace,
        )

    def _publish_delta_mesh(self, spare_dev, tables, delta: TableDelta):
        """The delta publish of a mesh epoch: whole-leaf replacements
        placed under their sharding; each scattered leaf's rows routed
        to their shards (route_update), uploaded to the shard's device
        and written in place there, one launch per device."""
        from cilium_tpu_torch.convert import _leaf_to
        from cilium_tpu_torch.engine.mesh import place

        mesh = self._shardings.generation.mesh
        n_scatter = n_replace = bytes_h2d = 0
        placed = {}
        for name, arr in delta.replace.items():
            placed[name] = place(arr, getattr(self._shardings, name))
            bytes_h2d += np.asarray(arr).nbytes
            n_replace += 1
        gen = int(np.asarray(tables.generation))
        shards = np.empty(mesh.devices.shape, dtype=object)
        for coord in mesh.coords():
            shards[coord] = dataclasses.replace(
                spare_dev.shard(*coord),
                **{**{n: v[coord] for n, v in placed.items()},
                   "generation": gen})
        by_dev: Dict[str, list] = {}
        seen = set()
        for name in sorted(delta.updates):
            up = delta.updates[name]
            bytes_h2d += up.nbytes
            n_scatter += 1
            sharding = getattr(self._shardings, name)
            shape = spare_dev.leaf_shape(name)
            for coord in mesh.coords():
                dst = getattr(shards[coord], name)
                if id(dst) in seen:
                    continue
                seen.add(id(dst))
                routed = route_update(up, shape, sharding, coord)
                if routed is None:
                    continue
                idx, values = routed
                dev = dst.device
                by_dev.setdefault(str(dev), []).append((
                    dst, tuple(torch.from_numpy(np.ascontiguousarray(
                        i, np.int64)).to(dev) for i in idx),
                    _leaf_to(values, dev)))
        from cilium_tpu_torch.kernels import MAX_SCATTER_SEGMENTS

        for segments in by_dev.values():
            for k in range(0, len(segments), MAX_SCATTER_SEGMENTS):
                publish_scatter(segments[k:k + MAX_SCATTER_SEGMENTS])
        shapes = dict(spare_dev.shapes)
        for name, arr in delta.replace.items():
            shape = tuple(getattr(arr, "shape", ()))
            if shape:
                shapes[name] = shape
        dev = dataclasses.replace(spare_dev, shards=shards, shapes=shapes,
                                  generation=gen)
        self._sync()
        return dev, PublishStats(
            epoch=0, mode="delta", bytes_h2d=bytes_h2d, seconds=0.0,
            scatter_leaves=n_scatter, replaced_leaves=n_replace,
        )

    # -- consumers -----------------------------------------------------------

    def current(self) -> Optional[Tuple[int, PolicyTables]]:
        with self._lock:
            slot = self._slots[self._cur]
            if slot is None:
                return None
            return slot["epoch"], slot["tables"]

    def current_stamp(self) -> Optional[int]:
        with self._lock:
            slot = self._slots[self._cur]
            return None if slot is None else slot["stamp"]

    def get(self, stamp: int) -> Optional[PolicyTables]:
        """The resident epoch carrying `stamp`, if any."""
        with self._lock:
            for slot in self._slots:
                if slot is not None and slot["stamp"] == stamp:
                    return slot["tables"]
            return None

    def spare_stamp(self) -> Optional[int]:
        """The standby epoch's stamp: the base the next delta must
        start at."""
        with self._lock:
            spare = self._slots[self._cur ^ 1]
            return None if spare is None else spare["stamp"]

    def live_stamps(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(s["stamp"] for s in self._slots if s is not None)

    def chip_bytes(self) -> Dict[int, int]:
        """Resident bytes over both epochs, by chip: the device ordinal,
        or on a mesh the coordinate's row-major ordinal."""
        with self._lock:
            return self._chip_bytes_locked()

    def _chip_bytes_locked(self) -> Dict[int, int]:
        per: Dict[int, int] = {} if self.on_mesh else {
            self._device.index or 0: 0}
        for slot in self._slots:
            for chip, nbytes in ((slot or {}).get("chip_bytes")
                                 or {}).items():
                per[chip] = per.get(chip, 0) + nbytes
        return per

    # -- the per-chip outage ledger and the repair ---------------------------

    def mark_chip_out(self, ordinal: int) -> None:
        """Start the outage ledger of a chip whose breaker opened: every
        publish from now on records what it missed.  Idempotent: a
        re-open after a failed probe keeps the first record."""
        with self._lock:
            self._out_chips.setdefault(int(ordinal), {
                "epoch": self._epoch, "missed": [], "needs_full": False})

    def chip_outage(self, ordinal: int) -> Optional[Dict]:
        with self._lock:
            rec = self._out_chips.get(int(ordinal))
            if rec is None:
                return None
            return {"epoch": rec["epoch"], "missed": list(rec["missed"]),
                    "needs_full": rec["needs_full"]}

    def readmit_chip(self, ordinal: int) -> Optional[Dict]:
        """Close a chip's outage ledger and return it, with the layouts
        of the live and spare epochs (`live_layout`, `spare_layout`: the
        repair pins them).  A spare epoch published during the outage
        is stale on the chip's slice: where it retains its host tables
        the record carries `spare_stale` and `spare_epoch` (the caller
        repairs the chip's whole slice of it with `repair_rows(...,
        spare=True)`); otherwise the spare is de-registered and the next
        publish uploads in full."""
        with self._lock:
            rec = self._out_chips.pop(int(ordinal), None)
            if rec is None:
                return None
            live = self._slots[self._cur]
            spare = self._slots[self._cur ^ 1]
            rec["live_layout"] = None if live is None else live["layout"]
            rec["spare_layout"] = None if spare is None else spare["layout"]
            if spare is not None and spare["epoch"] > rec["epoch"]:
                if spare.get("host") is not None:
                    rec["spare_stale"] = True
                    # the store's own counter: epochs may share a stamp
                    rec["spare_epoch"] = spare["epoch"]
                else:
                    self._slots[self._cur ^ 1] = None
            return rec

    def restore_outage(self, ordinal: int, rec: Dict) -> None:
        """Put a popped ledger back after a failed repair, downgraded to
        needs_full (the scatter may have partly landed); merged into a
        record that a re-open created meanwhile."""
        rec["needs_full"] = True
        with self._lock:
            existing = self._out_chips.get(int(ordinal))
            if existing is None:
                self._out_chips[int(ordinal)] = rec
            else:
                existing["epoch"] = min(existing["epoch"], rec["epoch"])
                existing["needs_full"] = True

    def repair_rows(self, row_sets: Dict[str, Tuple[int, object]],
                    spare: bool = False, expect_epoch: Optional[int] = None,
                    expect_layout: Optional[int] = None) -> int:
        """Rewrite `row_sets` ({leaf: (axis, index array)}, indices of
        the transformed layout along one axis) of the LIVE epoch (the
        SPARE with `spare=True`) from the host tables it retains: the
        readmission rebalance, bytes in proportion to the rows.  Refuses
        (RuntimeError) when the slot's epoch is not `expect_epoch` or
        its layout not `expect_layout`, or when it retains no host
        tables.  The epoch's tensors are written in place: the devices
        are synchronized first, and the caller keeps no batch queued
        against the epoch.  Returns the bytes shipped host to device
        (also counted in rebalance_bytes_h2d_total)."""
        from cilium_tpu_torch.convert import _leaf_to

        with self._lock:
            slot = self._slots[self._cur ^ 1 if spare else self._cur]
            which = "spare" if spare else "live"
            if slot is None:
                raise RuntimeError(f"no {which} epoch to repair")
            if expect_epoch is not None and slot["epoch"] != expect_epoch:
                raise RuntimeError(
                    f"{which} epoch changed since readmission (epoch "
                    f"{slot['epoch']} != expected {expect_epoch}); repair "
                    f"refused")
            if (expect_layout is not None
                    and slot["layout"] != expect_layout):
                raise RuntimeError(
                    f"{which} epoch layout changed since readmission "
                    f"(layout {slot['layout']:#x} != expected "
                    f"{int(expect_layout):#x}); repair refused")
            host = slot.get("host")
            if host is None:
                raise RuntimeError(
                    f"{which} epoch retains no host source; repair "
                    f"requires a publish through this store")
            payloads, bytes_h2d = [], 0
            for name in sorted(row_sets):
                axis, idx = row_sets[name]
                idx = np.asarray(idx, np.int64)
                if idx.size == 0:
                    continue
                # pow2 size classes, padded by repeating the last index
                # (duplicate identical writes give the same bits)
                size = next_pow2(idx.size)
                if size != idx.size:
                    idx = np.concatenate(
                        [idx, np.repeat(idx[-1:], size - idx.size)])
                values = np.take(np.asarray(getattr(host, name)), idx,
                                 axis=int(axis))
                payloads.append((name, int(axis), idx, values))
                bytes_h2d += idx.nbytes + values.nbytes
            if not payloads:
                return 0
            tables = slot["tables"]
            by_dev: Dict[str, list] = {}
            if isinstance(tables, PolicyTables):
                for name, axis, idx, values in payloads:
                    dst = getattr(tables, name)
                    by_dev.setdefault(str(dst.device), []).append(
                        (dst, axis, array_tensor(idx, dst.device),
                         _leaf_to(values, dst.device)))
            else:
                shardings = slot["shardings"]
                seen = set()
                for name, axis, idx, values in payloads:
                    shape = tables.leaf_shape(name)
                    for coord in tables.mesh.coords():
                        dst = getattr(tables.shard(*coord), name)
                        if id(dst) in seen:
                            continue
                        seen.add(id(dst))
                        routed = route_repair(idx, values, axis, shape,
                                              getattr(shardings, name),
                                              coord)
                        if routed is None:
                            continue
                        by_dev.setdefault(str(dst.device), []).append(
                            (dst, axis, array_tensor(routed[0], dst.device),
                             _leaf_to(routed[1], dst.device)))
            # nothing queued may read the rows while they are written
            self._sync()
            from cilium_tpu_torch.kernels import MAX_SCATTER_SEGMENTS

            for segments in by_dev.values():
                for k in range(0, len(segments), MAX_SCATTER_SEGMENTS):
                    repair_scatter(segments[k:k + MAX_SCATTER_SEGMENTS])
            self._sync()
            metrics.rebalance_bytes_h2d_total.inc(value=bytes_h2d)
            return bytes_h2d

    @staticmethod
    def _norm(stamp: int) -> int:
        # the reference's device generation keeps the low 32 bits (the
        # publish counter); stamps are store-scoped, so comparing those
        # stays unambiguous
        return int(stamp) & 0xFFFFFFFF

    def holds(self, tables) -> bool:
        """True when `tables` IS one of the live epochs (object
        identity: a host snapshot may share a stamp with an epoch)."""
        with self._lock:
            return any(slot is not None and slot["tables"] is tables
                       for slot in self._slots)

    def check_current(self, tables) -> None:
        """Raise StaleEpochError unless `tables` carries the stamp of
        one of the two live epochs: an older epoch's tensors have been
        written over by a newer publish."""
        raw = getattr(tables, "generation", None)
        stamp = self._norm(int(np.asarray(raw)) if raw is not None else 0)
        live = self.live_stamps()
        if not live or stamp in {self._norm(s) for s in live}:
            return
        raise StaleEpochError(
            f"stale device epoch: generation {stamp} is no longer "
            f"resident (live epochs: {live}) — its tensors were "
            f"written over by a newer publish"
        )


def _specs_of(shardings):
    """Each leaf's PartitionSpec of a dataclass of NamedSharding (None
    on one device): what a mesh epoch's rows route by."""
    if shardings is None:
        return None
    return tuple((f.name, tuple(getattr(shardings, f.name).spec))
                 for f in dataclasses.fields(shardings))


def _has_cuda_tensor(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_has_cuda_tensor(o) for o in out)
    if isinstance(out, dict):
        return any(_has_cuda_tensor(o) for o in out.values())
    fields = getattr(out, "__dataclass_fields__", None)
    if fields:
        return any(_has_cuda_tensor(getattr(out, f)) for f in fields)
    return False


class AsyncBatchDispatcher:
    """A bounded staging pipeline that overlaps the host pack of batch
    N + 1 with the device compute of batch N.

      * `submit(host_args, meta)` runs `pack_fn` (encode and upload, the
        host half) and `dispatch_fn` (the launches, which return before
        the device finishes), then drains the batches beyond `depth` in
        FIFO order: up to `depth + 1` batches are in flight.
      * results come back through submit()/flush() as `(meta, result,
        exc)` tuples in submission order.
      * a failure at pack, dispatch or drain is captured as that
        batch's `exc` instead of stopping the pipeline.

    Draining waits on a CUDA event recorded on the current stream right
    after the batch's dispatch (results on the CPU are complete when
    dispatch returns)."""

    def __init__(self, pack_fn, dispatch_fn, depth: int = 1) -> None:
        self.pack_fn = pack_fn
        self.dispatch_fn = dispatch_fn
        self.depth = max(int(depth), 0)
        self._pending = deque()
        self.submitted = 0
        self.failed = 0

    def _drain_one(self):
        meta, out, exc, event = self._pending.popleft()
        if exc is None and event is not None:
            try:
                event.synchronize()
            except Exception as drain_exc:  # the device failed mid-compute
                out, exc = None, drain_exc
                self.failed += 1
        return meta, out, exc

    def submit(self, host_args: tuple, meta=None) -> list:
        """Stage and dispatch one batch; returns the drained (meta,
        result, exc) tuples that completed (possibly none)."""
        self.submitted += 1
        out, exc, event = None, None, None
        try:
            out = self.dispatch_fn(*self.pack_fn(*host_args))
            if _has_cuda_tensor(out):
                event = torch.cuda.Event()
                event.record()
        except Exception as batch_exc:  # pack or dispatch
            out, exc = None, batch_exc
            self.failed += 1
        self._pending.append((meta, out, exc, event))
        done = []
        while len(self._pending) > self.depth:
            done.append(self._drain_one())
        return done

    def flush(self) -> list:
        """Drain every batch in flight, in order."""
        done = []
        while self._pending:
            done.append(self._drain_one())
        return done
