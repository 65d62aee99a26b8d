"""Explicit LM tensor parallelism over the ``model`` axis, in one
controller.

The reference gets its LM tensor parallelism from GSPMD: logical specs
on the parameters and ``constrain`` calls inside ``jit``. Eager torch has
no partitioner, so the port splits the work itself, Megatron style:

- the residual stream stays replicated over ``model`` between blocks
  (one tensor on the data block's first position, the *leader*);
- inside a block each model position runs its own heads, MLP columns,
  experts or recurrence channels, on its own device and stream
  (`repro_torch.parallel.mesh.run_per_shard`);
- a block ends in one reduction across the model positions: integer
  partial sums of a row-parallel packed projection are added exactly
  (int32 addition wraps the same in any order), then dequantized once.

A `TPGroup` is the model positions of one data block; `tp_scope` makes
it ambient for the blocks (and the mesh for `attn_strategy`). A
parameter split over the group is a `Split` leaf: its parts, one per
model position, along one dim, each part holding some ``runs`` of that
dim of the whole leaf. `place` turns a params tree plus a tree of `Cut`
s into such leaves; serving places once (weight-stationary, like
`shard_packed_linear`), training places inside each forward so that
autograd sends every part's gradient back to the whole leaf.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs import accounting
from repro_torch.parallel.ctx import activation_sharding
from repro_torch.parallel.mesh import Mesh, block_of, run_per_shard

Runs = Tuple[Tuple[int, int], ...]     # (start, end) pieces, in order

_GROUP = contextvars.ContextVar("repro_torch_tp_group", default=None)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one leaf splits: along ``dim`` (negative, so a stacked layer
    axis in front does not move it), position i holding ``runs[i]`` of
    that dim in *logical* units; ``packed``: the dim is a packed K axis
    of CHUNK-aligned container rows, ``logical`` values long."""
    dim: int
    runs: Tuple[Runs, ...]
    packed: bool = False
    logical: int = 0


class Split:
    """A leaf as per-position ``parts`` along ``dim`` (see `Cut`)."""

    def __init__(self, parts: List[Optional[torch.Tensor]], cut: Cut):
        self.parts = parts
        self.cut = cut

    @property
    def dim(self) -> int:
        return self.cut.dim

    def __getitem__(self, i):
        """Layer ``i`` of a stacked split leaf."""
        return Split([None if t is None else t[i] for t in self.parts],
                     self.cut)

    @property
    def dtype(self):
        return next(t for t in self.parts if t is not None).dtype

    def unbind(self) -> list:
        per = [None if t is None else torch.unbind(t, 0)
               for t in self.parts]
        n = next(len(u) for u in per if u is not None)
        return [Split([None if u is None else u[j] for u in per], self.cut)
                for j in range(n)]


class TPGroup:
    """The ``model`` positions of data block ``block`` of ``mesh`` (one
    coordinate of every other axis, `parallel.mesh.block_of`), in
    model-axis order; ``leader`` is the first one's device, where the
    replicated residual lives."""

    def __init__(self, mesh: Mesh, block: int = 0):
        self.mesh = mesh
        pos = [p for p in range(mesh.size) if block_of(mesh, p) == block]
        self.positions = sorted(
            pos, key=lambda p: int(mesh.coords(p).get("model", 0)))
        self.devices = [mesh.flat[p] for p in self.positions]
        self.leader = self.devices[0]
        self.m = len(self.positions)

    def run(self, fn: Callable, args: Sequence[tuple],
            which: Optional[Sequence[int]] = None) -> list:
        """``fn(i, *args[i])`` for model index ``i`` of ``which`` (default
        every one), each on its position's device and stream; returns
        the outputs by ``which``."""
        which = list(range(self.m)) if which is None else list(which)
        index = {self.positions[i]: i for i in which}
        return run_per_shard(self.mesh, lambda p, *a: fn(index[p], *a),
                             [tuple(a) for a in args],
                             [self.positions[i] for i in which])

    def to(self, x, i: int):
        """``x`` sent to model index ``i``: a slice of a larger tensor is
        a scatter's piece, a whole tensor a broadcast's."""
        if not torch.is_tensor(x):
            return x
        y = x.to(self.devices[i])
        if accounting.recorder() is None:
            return y
        kind = ("scatter" if _nbytes(x) < x.untyped_storage().nbytes()
                else "broadcast")
        return accounting.move(kind, y, self.positions[i])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def model_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


@contextlib.contextmanager
def tp_scope(group: Optional[TPGroup]):
    """Make ``group`` the blocks' ambient group, and its mesh the active
    one (`repro_torch.parallel.ctx`)."""
    tok = _GROUP.set(group)
    try:
        if group is None:
            yield
        else:
            with activation_sharding(group.mesh):
                yield
    finally:
        _GROUP.reset(tok)


def tp_group() -> Optional[TPGroup]:
    """The ambient group when it has more than one position, else None
    (a one-position group runs the meshless code)."""
    g = _GROUP.get()
    return g if g is not None and g.m > 1 else None


def ambient() -> Optional[TPGroup]:
    """The group `tp_scope` set, whatever its size (None outside one)."""
    return _GROUP.get()


# ------------------------------------------------------------ the runs ---

def even_runs(size: int, m: int, unit: int = 1) -> Tuple[Runs, ...]:
    """``size`` split into ``m`` contiguous runs of whole ``unit``s (the
    last unit may be short), as even as possible, earlier runs the
    larger: 86 CHUNKs over 4 are 22, 22, 21, 21. A run may be empty."""
    units = -(-size // unit)
    base, extra = divmod(units, m)
    out, u = [], 0
    for i in range(m):
        n = base + (1 if i < extra else 0)
        s, e = min(u * unit, size), min((u + n) * unit, size)
        out.append(((s, e),) if e > s else ())
        u += n
    return tuple(out)


def blocks_runs(n_blocks: int, block: int, m: int) -> Tuple[Runs, ...]:
    """Whole blocks of ``block`` values (heads of head_dim, experts) over
    ``m`` positions, evenly (``n_blocks`` divides ``m``)."""
    per = n_blocks // m
    return tuple((((i * per * block, (i + 1) * per * block),)
                  if per else ()) for i in range(m))


def scale_runs(runs: Tuple[Runs, ...], f: int) -> Tuple[Runs, ...]:
    return tuple(tuple((s * f, e * f) for s, e in r) for r in runs)


def run_len(r: Runs) -> int:
    return sum(e - s for s, e in r)


def _order(runs: Tuple[Runs, ...]) -> List[int]:
    return [j for r in runs for s, e in r for j in range(s, e)]


def is_identity(runs: Tuple[Runs, ...], size: int) -> bool:
    flat = [x for r in runs for x in r]
    return (all(a[1] == b[0] for a, b in zip(flat, flat[1:]))
            and (not flat or (flat[0][0] == 0 and flat[-1][1] == size)))


# ------------------------------------------------- slicing and joining ---

def take(x: torch.Tensor, r: Runs, dim: int) -> torch.Tensor:
    """The runs ``r`` of ``x`` along ``dim``, joined (a view for one
    run)."""
    if len(r) == 1:
        s, e = r[0]
        return x.narrow(dim, s, e - s)
    if not r:
        return x.narrow(dim, 0, 0)
    return torch.cat([x.narrow(dim, s, e - s) for s, e in r], dim=dim)


def split(x: torch.Tensor, runs: Tuple[Runs, ...], dim: int) -> list:
    """``x`` cut into one piece per position (empty runs give None)."""
    return [take(x, r, dim) if r else None for r in runs]


def join(parts: Sequence[Optional[torch.Tensor]], runs: Tuple[Runs, ...],
         dim: int, size: int, device) -> torch.Tensor:
    """The whole of ``size`` along ``dim`` from per-position ``parts``
    holding ``runs``, on ``device`` (differentiable). Where runs overlap
    (a replicated slice every position holds), the first holder's copy
    is read."""
    live = [accounting.move("gather", p.to(device), None)
            for p, r in zip(parts, runs) if p is not None and r]
    live_runs = tuple(r for p, r in zip(parts, runs) if p is not None and r)
    if len(live) == 1 and run_len(live_runs[0]) == size \
            and is_identity(live_runs, size):
        return live[0]
    cat = torch.cat(live, dim=dim)
    if is_identity(live_runs, size):
        return cat
    where = {}
    for j, src in enumerate(_order(live_runs)):
        where.setdefault(src, j)
    idx = torch.tensor([where[j] for j in range(size)], dtype=torch.long)
    return cat.index_select(dim if dim >= 0 else cat.dim() + dim,
                            idx.to(device))


def full_len(leaf, dim: int) -> int:
    """Size of ``dim`` of a whole tensor or of a `Split` leaf."""
    if isinstance(leaf, Split):
        if leaf.dim == dim:
            return len({j for j in _order(leaf.cut.runs)})
        return next(t for t in leaf.parts if t is not None).shape[dim]
    return leaf.shape[dim]


def whole(leaf, device=None):
    """A whole tensor from a `Split` leaf, on ``device`` (default the
    first part's); any other leaf as it is."""
    if not isinstance(leaf, Split):
        return leaf
    first = next(t for t in leaf.parts if t is not None)
    return join(leaf.parts, leaf.cut.runs, leaf.dim,
                full_len(leaf, leaf.dim), device or first.device)


def total(parts: Sequence[Optional[torch.Tensor]], device) -> torch.Tensor:
    """The sum of the live parts, on ``device``, in position order."""
    acc = None
    for p in parts:
        if p is None:
            continue
        p = accounting.move("reduce", p.to(device), None)
        acc = p if acc is None else acc + p
    return acc


# ------------------------------------------------------------ placement ---

def _packed_rows(cut: Cut, rows: int) -> Tuple[Runs, ...]:
    """A packed K cut's runs in container rows: every run starts at a
    CHUNK boundary and ends at one or at the logical end (then at the
    padded end)."""
    from repro_torch.core.packing import CHUNK, padded_size

    pf = padded_size(cut.logical) // rows
    out = []
    for r in cut.runs:
        rr = []
        for s, e in r:
            if s % CHUNK or (e % CHUNK and e != cut.logical):
                raise ValueError(f"packed K run {(s, e)} of {cut.logical} "
                                 "is not CHUNK-aligned")
            rr.append((s // pf, padded_size(e) // pf))
        out.append(tuple(rr))
    return tuple(out)


def place_leaf(x: torch.Tensor, cut: Cut, group: TPGroup) -> Split:
    runs = (_packed_rows(cut, x.shape[cut.dim]) if cut.packed
            else cut.runs)
    parts = []
    for i, r in enumerate(runs):
        if not r:
            parts.append(None)
            continue
        t = take(x, r, cut.dim)
        t = t if t.requires_grad else t.contiguous()
        parts.append(accounting.move("scatter", t.to(group.devices[i]),
                                     group.positions[i]))
    return Split(parts, cut)


def place(tree, cuts, group: TPGroup):
    """``tree`` with each leaf that has a `Cut` in ``cuts`` (a tree of
    the same structure, None or missing for a replicated leaf) placed as
    a `Split` over ``group``; replicated leaves stay on the leader."""
    if isinstance(tree, dict):
        cuts = cuts or {}
        return {k: place(v, cuts.get(k) if isinstance(cuts, dict) else None,
                         group) for k, v in tree.items()}
    if isinstance(tree, Split) or cuts is None:
        return tree
    return place_leaf(tree, cuts, group)


def local(tree, i: int, device=None):
    """Position ``i``'s view of a (partly) placed tree: a `Split` leaf
    gives its part, any other leaf itself (moved to ``device``)."""
    if isinstance(tree, dict):
        return {k: local(v, i, device) for k, v in tree.items()}
    if isinstance(tree, Split):
        return tree.parts[i]
    if device is None or not torch.is_tensor(tree):
        return tree
    grp = ambient()
    return accounting.move("broadcast", tree.to(device),
                           None if grp is None else grp.positions[i])


def parts_of(leaf, cut_runs: Tuple[Runs, ...], dim: int) -> list:
    """Per-position pieces of a state leaf: a `Split`'s parts, or pieces
    of a whole tensor along ``dim``: a view where the position holds one
    run (in-place writes reach the whole), a joined copy where it holds
    several (`write_back` returns it)."""
    if isinstance(leaf, Split):
        return leaf.parts
    return split(leaf, cut_runs, dim)


def write_back(leaf, parts, cut_runs: Tuple[Runs, ...], dim: int):
    """After an in-place update of `parts_of`'s pieces of a whole
    ``leaf``, copy each joined piece's runs back into it (a `Split`'s
    parts and one-run views are the state itself)."""
    if isinstance(leaf, Split):
        return
    for part, r in zip(parts, cut_runs):
        if part is None or len(r) < 2:
            continue
        off = 0
        for s, e in r:
            leaf.narrow(dim, s, e - s).copy_(part.narrow(dim, off, e - s))
            off += e - s


__all__ = ["Cut", "Split", "TPGroup", "ambient", "blocks_runs",
           "even_runs",
           "join", "local", "model_size", "parts_of", "place",
           "place_leaf", "run_len", "scale_runs", "split", "take",
           "total", "tp_group", "tp_scope", "write_back"]
