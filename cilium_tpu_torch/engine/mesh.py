"""The device mesh of the port: the reference's `jax.sharding.Mesh`,
`PartitionSpec` and `NamedSharding`, in PyTorch idiom.

  * `Mesh` is an `np.ndarray` of `torch.device` of shape [dp, tp] with
    the axis names ("batch", "table"), and `.shape[name]`.  `make_mesh`
    builds one on one device for every coordinate (virtual chips, as
    the reference's tests run 8 virtual host devices), or on a list of
    devices, one per coordinate.  `Mesh.ids` is the grid of chip ids
    (the reference's jax device ids): row-major by default, and after a
    reshard the grid engine/reshard.py `reshard_target_mesh` gives, in
    which a surviving column keeps its chips and a new column takes the
    next free ids.
  * `PartitionSpec` (`P`) is a tuple of axis names or None per leaf
    dimension, equal as a tuple to jax's.
  * `NamedSharding(mesh, spec)` places a leaf: `place` gives one tensor
    per mesh coordinate, on that coordinate's device, the sharded
    dimensions sliced by the coordinate's index along their axis.  A
    replicated leaf (or a slice) is placed once per device: coordinates
    on one device share the tensor.
  * `MeshTables` is a table dataclass (PolicyTables) placed on a mesh:
    `shard(b, t)` is the dataclass of coordinate (b, t)'s local leaves;
    `PlacedArray` one placed array (the mesh verdict cache's rows).

The reference's `shard_map` step becomes an explicit loop over the
coordinates in engine/sharded.py.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cilium_tpu_torch.device import resolve_device

BATCH_AXIS = "batch"
TABLE_AXIS = "table"
AXES = (BATCH_AXIS, TABLE_AXIS)


class PartitionSpec(tuple):
    """Per leaf dimension, the mesh axis it is split along (or None);
    trailing dimensions not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """Devices [dp, tp] under the axis names (batch, table), and the
    chip id of each coordinate, `ids` [dp, tp] (row-major when None)."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES,
                 ids=None) -> None:
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for ix in np.ndindex(arr.shape):
            arr[ix] = torch.device(devices[ix[0]][ix[1]])
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} for axes "
                             f"{tuple(axis_names)}")
        grid = (np.arange(arr.size, dtype=np.int64).reshape(arr.shape)
                if ids is None else np.array(ids, dtype=np.int64))
        if grid.shape != arr.shape or len(np.unique(grid)) != grid.size:
            raise ValueError(f"chip ids {grid.tolist()} for a mesh of shape "
                             f"{arr.shape}: one distinct id per coordinate")
        self.devices = arr
        self.ids = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every (b, t) coordinate, row-major."""
        return itertools.product(*(range(n) for n in self.devices.shape))

    def chip(self, coord) -> int:
        """The chip id (ordinal) of a coordinate."""
        return int(self.ids[tuple(coord)])

    def axis_index(self, name: str, coord) -> int:
        """The coordinate's index along axis `name` (jax's
        `lax.axis_index` inside the step)."""
        return int(coord[self.axis_names.index(name)])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat))
                and np.array_equal(self.ids, other.ids))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat),
                     tuple(self.ids.flat)))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(dp: int, tp: int, device=None,
              devices: Optional[Sequence] = None, ids=None) -> Mesh:
    """A (batch, table) mesh of dp x tp coordinates: `devices` gives
    one device per coordinate (row-major); otherwise every coordinate
    is `device` (None = the card), the virtual chips of one device.
    `ids` [dp, tp] sets the coordinates' chip ids (row-major 0 .. dp *
    tp - 1 when None)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != dp * tp:
            raise ValueError(f"{len(devs)} devices for a {dp} x {tp} mesh")
    else:
        devs = [resolve_device(device)] * (dp * tp)
    return Mesh([devs[b * tp:(b + 1) * tp] for b in range(dp)], ids=ids)


@dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec resolved against a mesh."""

    mesh: Mesh
    spec: PartitionSpec

    def slices(self, shape, coord) -> tuple:
        """The index of coordinate `coord`'s block of a leaf of `shape`
        (one slice per dimension); raises where a sharded dimension does
        not divide by its axis size."""
        out = []
        for dim, size in enumerate(shape):
            name = self.spec[dim] if dim < len(self.spec) else None
            if name is None:
                out.append(slice(None))
                continue
            parts = self.mesh.shape[name]
            if size % parts:
                raise ValueError(f"dimension {dim} of size {size} does not "
                                 f"split over {parts} {name!r} shards")
            n = size // parts
            i = self.mesh.axis_index(name, coord)
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)


def _block_key(ix: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in ix)


def _to_device(block, device: torch.device, owned: bool):
    """A host (numpy) or device block as a tensor on `device`, with the
    port's leaf conventions (u32 as int32 bits, u16 widened)."""
    from cilium_tpu_torch.convert import _leaf_to

    if isinstance(block, torch.Tensor):
        if block.device != device:
            return block.to(device).contiguous()
        # a block of a tensor is a fresh one: no shard aliases the leaf
        return block.contiguous().clone() if owned else block
    return _leaf_to(np.ascontiguousarray(block), device)


def place(leaf, sharding: NamedSharding, cache: Optional[dict] = None):
    """`leaf` (numpy array, tensor, scalar or None) under `sharding`: an
    object array [dp, tp] of the coordinates' local leaves.  Blocks are
    placed once per (device, block): coordinates that share a device
    and a block share the tensor.  A replicated tensor already on a
    coordinate's device is used as it is, not copied."""
    mesh = sharding.mesh
    out = np.empty(mesh.devices.shape, dtype=object)
    shape = tuple(getattr(leaf, "shape", ()))
    if leaf is None or not shape:
        scalar = leaf
        if isinstance(leaf, (np.integer, np.ndarray)) or (
                isinstance(leaf, torch.Tensor)):
            scalar = int(leaf)
        for coord in mesh.coords():
            out[coord] = scalar
        return out
    cache = {} if cache is None else cache
    for coord in mesh.coords():
        dev = mesh.devices[coord]
        ix = sharding.slices(shape, coord)
        sharded = any(s != slice(None) for s in ix)
        key = (id(leaf), str(dev), _block_key(ix) if sharded else None)
        if key not in cache:
            block = leaf[ix] if sharded else leaf
            cache[key] = _to_device(block, dev, owned=sharded)
        out[coord] = cache[key]
    return out


@dataclass
class MeshTables:
    """A table dataclass placed on a mesh.  `shards` is an object array
    [dp, tp] of the dataclass (its local leaves at each coordinate),
    `shardings` the dataclass of each leaf's NamedSharding, `shapes`
    each array leaf's global shape, `generation` the stamp."""

    mesh: Mesh
    shardings: object
    shards: np.ndarray
    shapes: Dict[str, tuple]
    generation: int = 0

    def shard(self, b: int, t: int):
        return self.shards[b, t]

    def spec(self, name: str) -> PartitionSpec:
        return getattr(self.shardings, name).spec

    def leaf_shape(self, name: str) -> Optional[tuple]:
        return self.shapes.get(name)

    def chip_bytes(self) -> Dict[int, int]:
        """Bytes each coordinate holds (its own leaves, whether or not
        it shares them with another coordinate of its device)."""
        per = {}
        for coord in self.mesh.coords():
            tab = self.shards[coord]
            per[self.mesh.chip(coord)] = sum(
                v.numel() * v.element_size()
                for v in (getattr(tab, f.name)
                          for f in dataclasses.fields(tab))
                if isinstance(v, torch.Tensor))
        return per


@dataclass
class PlacedArray:
    """One array placed on a mesh (jax's sharded jax.Array): `blocks`
    is an object array [dp, tp] of the coordinates' tensors, `shape` the
    global shape, `sharding` its NamedSharding."""

    sharding: NamedSharding
    blocks: np.ndarray
    shape: tuple

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def block(self, b: int, t: int) -> torch.Tensor:
        return self.blocks[b, t]

    def numpy(self) -> np.ndarray:
        """The global array on the host (int32 blocks as u32)."""
        first = self.blocks.flat[0]
        out = np.empty(self.shape, dtype=first.cpu().numpy().dtype)
        for coord in self.mesh.coords():
            out[self.sharding.slices(self.shape, coord)] = (
                self.blocks[coord].cpu().numpy())
        return out.view(np.uint32) if out.dtype == np.int32 else out


def place_array(arr, sharding: NamedSharding) -> PlacedArray:
    """A host array placed under `sharding` (u32 as int32 bits)."""
    return PlacedArray(sharding=sharding, blocks=place(arr, sharding),
                       shape=tuple(np.shape(arr)))


def place_tables(tables, shardings, cache: Optional[dict] = None
                 ) -> MeshTables:
    """A table dataclass (host numpy or tensors) placed leaf by leaf
    under `shardings` (the same dataclass of NamedSharding)."""
    names = [f.name for f in dataclasses.fields(tables)]
    mesh = getattr(shardings, names[0]).mesh
    cache = {} if cache is None else cache
    placed = {n: place(getattr(tables, n), getattr(shardings, n), cache)
              for n in names}
    shards = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        shards[coord] = dataclasses.replace(
            tables, **{n: placed[n][coord] for n in names})
    shapes = {n: tuple(getattr(tables, n).shape) for n in names
              if getattr(getattr(tables, n), "shape", ())}
    gen = getattr(tables, "generation", 0)
    return MeshTables(mesh=mesh, shardings=shardings, shards=shards,
                      shapes=shapes, generation=int(np.asarray(gen))
                      if gen is not None else 0)


def shardings_of(mesh: Mesh, specs):
    """The dataclass of NamedSharding for a dataclass of specs."""
    return dataclasses.replace(specs, **{
        f.name: NamedSharding(mesh, getattr(specs, f.name))
        for f in dataclasses.fields(specs)})
