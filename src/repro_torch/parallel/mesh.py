"""A named device mesh, its shardings, and the per-shard runner: the port's
own copy of what `jax.sharding` and ``shard_map`` give the reference.

**One process, one controller**, as the reference is: a mesh is a grid of
`torch.device`s held by one Python process, a global tensor is split
into per-position shards (`device_put`) and put back together
(`gather`), and `run_per_shard` calls a function once per mesh position
on that position's device. There are no ranks. Collectives stay outside
the kernels: here they are plain copies between devices.

A device may appear at several positions: eight ``cpu`` entries stand
for the reference's eight forced host devices in the tests, and one card
carries a whole cluster with ``cuda:0`` at every position. Positions
that share a CUDA device each launch on a stream of their own (the
cluster's cores sharing one card's SMs), joined back to the device's
current stream before `run_per_shard` returns. A tensor made on one
stream and read on another is marked with ``record_stream`` for the
reading stream, so the caching allocator cannot hand its memory out
again while that stream still reads it.

Shards are listed per mesh position, row-major over the mesh axes.
Positions that hold the same block on the same device share one tensor,
so a replicated leaf costs one copy per distinct device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import accounting


def _device(d) -> torch.device:
    """``d`` as a `torch.device`; a bare ``cuda`` names the current card,
    so positions compare equal to the tensors placed there."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named grid of devices: ``devices`` nested to one level per axis
    (or flat with ``shape`` given), ``axis_names`` one name per axis.
    ``shape`` maps each name to its size, as `jax.make_mesh` gives it."""

    def __init__(self, devices, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        grid = np.array(devices, dtype=object)
        flat = [_device(d) for d in grid.reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        if shape is None:
            shape = grid.shape
        self.devices = arr.reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh holds one device type, got {flat}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.flat[0].type

    @property
    def flat(self) -> List[torch.device]:
        """Devices by position, row-major over the axes."""
        return list(self.devices.reshape(-1))

    def coords(self, pos: int) -> Dict[str, int]:
        """Position -> its index along each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(pos, self.devices.shape)))

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.flat == other.flat)

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.flat)))

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.flat]})"

    def describe(self) -> str:
        """Distinct devices and how many positions each carries."""
        counts: Dict[str, int] = {}
        for d in self.flat:
            counts[str(d)] = counts.get(str(d), 0) + 1
        return ", ".join(f"{d} x{n}" if n > 1 else d
                         for d, n in counts.items())

    def stream(self, pos: int) -> torch.cuda.Stream:
        """The side stream of a CUDA position, made at first use."""
        s = self._streams.get(pos)
        if s is None:
            s = self._streams[pos] = torch.cuda.Stream(
                device=self.flat[pos])
        return s


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """``jax.make_mesh``'s counterpart: the first prod(shape) of
    ``devices`` (a list of devices, or one device for every position)
    laid out row-major."""
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices or "cpu"] * n
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, got "
                         f"{len(devices)}")
    return Mesh(devices[:n], axis_names, shape=shape)


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), an axis name, or a tuple of
    names (major first). Compares as the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _blocks(mesh: Mesh, spec, pos: int, ndim: int):
    """Per dim, (block index, block count) of mesh position ``pos``."""
    coords = mesh.coords(pos)
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for entry in spec:
        idx, count = 0, 1
        for a in _axes(entry):
            idx = idx * mesh.shape[a] + int(coords[a])
            count *= mesh.shape[a]
        out.append((idx, count))
    return tuple(out)


def _slices(shape, blocks):
    return tuple(slice(i * (n // c), (i + 1) * (n // c))
                 for n, (i, c) in zip(shape, blocks))


@dataclasses.dataclass
class Sharded:
    """A global tensor of ``shape`` as its per-position shards on
    ``sharding.mesh`` (``shards[pos]`` on ``mesh.flat[pos]``)."""

    shards: List[torch.Tensor]
    sharding: NamedSharding
    shape: Tuple[int, ...]

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(self.shards[0].shape)


def device_put(x, sharding: NamedSharding) -> Sharded:
    """Split ``x`` (a tensor, or a `Sharded` on any mesh) per
    ``sharding``. A dim must divide by the product of the axes its spec
    entry names. A shard on its position's device may be a view of
    ``x`` where the view is contiguous and starts 16-byte aligned (the
    kernels' cp.async copies need that start); otherwise it is a copy."""
    if isinstance(x, Sharded):
        if x.sharding == sharding:
            return x
        x = gather(x)
    mesh, shape = sharding.mesh, tuple(x.shape)
    spec = tuple(sharding.spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {sharding.spec} has more entries than "
                         f"the tensor's {len(shape)} dims")
    for dim, entry in zip(shape, spec):
        count = math.prod(mesh.shape[a] for a in _axes(entry))
        if dim % count:
            raise ValueError(
                f"dim {dim} of shape {shape} does not divide over mesh "
                f"axes {_axes(entry)} of size {count}")
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for pos, dev in enumerate(mesh.flat):
        blocks = _blocks(mesh, spec, pos, len(shape))
        key = (blocks, str(dev))
        if key not in made:
            t = x[_slices(shape, blocks)].to(dev).contiguous()
            if t.storage_offset() * t.element_size() % 16:
                t = t.clone()
            made[key] = accounting.move("scatter", t, pos)
        shards.append(made[key])
    return Sharded(shards=shards, sharding=sharding, shape=shape)


def gather(x, device=None) -> torch.Tensor:
    """One global tensor on ``device`` (default: the first position's)
    from a `Sharded`; a plain tensor is returned as it is (moved to
    ``device`` when one is given)."""
    if not isinstance(x, Sharded):
        return x if device is None else x.to(device)
    mesh = x.mesh
    device = torch.device(device) if device is not None else mesh.flat[0]
    first: Dict[tuple, int] = {}
    for pos in range(mesh.size):
        first.setdefault(_blocks(mesh, x.spec, pos, x.ndim), pos)
    if len(first) == 1:
        return accounting.move("gather", x.shards[next(iter(
            first.values()))].to(device), None)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for blocks, pos in first.items():
        out[_slices(x.shape, blocks)].copy_(
            accounting.move("gather", x.shards[pos], None))
    return out


def axis_positions(mesh: Mesh, axis: str) -> List[int]:
    """One position per index along ``axis`` (every other index 0), in
    axis order; [0] when the mesh lacks ``axis``."""
    return [p for p in range(mesh.size)
            if all(i == 0 for a, i in mesh.coords(p).items() if a != axis)]


# A data block is one coordinate of every axis but ``model`` (on a
# (pod, data, model) mesh one (pod, data) pair): the batch splits over the
# blocks, and each block's model positions run its rows tensor-parallel.

def block_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes that index the data blocks, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != "model")


def block_entry(mesh: Mesh):
    """The spec entry that splits a batch over the data blocks: the one
    block axis by name, several as a tuple, none as None."""
    axes = block_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def block_of(mesh: Mesh, pos: int) -> int:
    """The index of position ``pos``'s data block, row-major over
    `block_axes` (the order a batch split by `block_entry` takes)."""
    coords = mesh.coords(pos)
    idx = 0
    for a in block_axes(mesh):
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


def data_blocks(mesh: Mesh) -> List[int]:
    """The first position (model index 0) of each data block, in block
    order."""
    return [p for p in range(mesh.size)
            if int(mesh.coords(p).get("model", 0)) == 0]


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def run_per_shard(mesh: Mesh, fn: Callable, inputs: Sequence,
                  positions: Optional[Sequence[int]] = None) -> list:
    """``fn(pos, *inputs[i])`` for each ``pos`` of ``positions`` (default
    every position), on the position's device; returns the outputs by
    position, ready for the caller's current stream.

    Where several of these positions share a CUDA device, each launches
    on its own stream, which first waits for the device's current stream
    (the inputs were made there); every input tensor is marked with
    ``record_stream`` for the side stream, and every output, once the
    current stream has waited for the side stream, for the current one.
    """
    positions = list(range(mesh.size)) if positions is None else list(
        positions)
    flat = mesh.flat
    per_dev: Dict[str, int] = {}
    for p in positions:
        per_dev[str(flat[p])] = per_dev.get(str(flat[p]), 0) + 1
    outs, side = [], []
    for p, args in zip(positions, inputs):
        dev = flat[p]
        if dev.type != "cuda" or per_dev[str(dev)] == 1:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(fn(p, *args))
            else:
                outs.append(accounting.run_at(p, fn, p, *args))
            side.append(None)
            continue
        s = mesh.stream(p)
        cur = torch.cuda.current_stream(dev)
        s.wait_stream(cur)
        for t in _tensors(args):
            if t.device == dev:
                t.record_stream(s)
        with torch.cuda.device(dev), torch.cuda.stream(s):
            outs.append(fn(p, *args))
        side.append((s, cur))
    for out, sc in zip(outs, side):
        if sc is None:
            continue
        s, cur = sc
        cur.wait_stream(s)
        for t in _tensors(out):
            t.record_stream(cur)
    return outs


def assemble(mesh: Mesh, spec, shape, by_pos: Dict[int, torch.Tensor]
             ) -> Sharded:
    """A `Sharded` from the outputs of some positions: every position
    takes the tensor of a computed position holding the same block on
    the same device, else a copy of one on another device."""
    shape = tuple(shape)
    computed: Dict[tuple, List[int]] = {}
    for p in by_pos:
        computed.setdefault(_blocks(mesh, spec, p, len(shape)),
                            []).append(p)
    flat = mesh.flat
    shards = []
    for pos, dev in enumerate(flat):
        cands = computed[_blocks(mesh, spec, pos, len(shape))]
        same = [p for p in cands if flat[p] == dev]
        shards.append(by_pos[same[0]] if same
                      else by_pos[cands[0]].to(dev))
    return Sharded(shards=shards, sharding=NamedSharding(mesh, P(*spec)),
                   shape=shape)


def unique_positions(mesh: Mesh, spec, ndim: int) -> List[int]:
    """One position per distinct (block, device): the positions a
    per-shard op must run at to produce every shard of ``spec``."""
    seen, out = set(), []
    for pos, dev in enumerate(mesh.flat):
        key = (_blocks(mesh, spec, pos, ndim), str(dev))
        if key not in seen:
            seen.add(key)
            out.append(pos)
    return out


__all__ = ["Mesh", "NamedSharding", "P", "PartitionSpec", "Sharded",
           "assemble", "axis_positions", "block_axes", "block_entry",
           "block_of", "data_blocks", "device_put", "gather", "make_mesh",
           "run_per_shard", "tree_map", "unique_positions"]
