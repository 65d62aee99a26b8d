"""Per-position costs of one step run on torch's ``meta`` device: the
dry run's cost model (`repro_torch.launch.dryrun`), the port's
counterpart of the reference's ``launch/hlo_costs.py`` and
``launch/hlo_analysis.py``. XLA's HLO text has no torch counterpart, so
instead of walking a compiled program this runs the eager step itself
on ``meta`` tensors (shapes and dtypes, no data, nothing allocated)
under a `torch.utils._python_dispatch.TorchDispatchMode` that sees every
aten op, and accounts per mesh position:

- **float FLOPs**: the formulas of `torch.utils.flop_counter`
  (FlopCounterMode's registry: matmuls, convolutions, attention);
  elementwise ops count none, as in the reference's walker;
- **int8 operations**: each packed kernel call (qmatmul, the segmented
  GEMM, qconv) counts once at its boundary, 2 x its MACs as
  `obs.counters.qdot_costs` / `qconv_costs` reckon them (K padded to
  CHUNK; the conv's real Cin); its plain version's own ops (the float64
  ``mm`` of `kernels.common.int_matmul`) are not counted at all;
- **IO bytes**: the inputs plus outputs of every aten op that is not a
  view, the eager port's unfused traffic (the counterpart of the
  reference's HLO IO bytes); a packed call moves its operands (packed
  activations and weights, the epilogue vectors, the scale) and its
  output;
- **peak live bytes**: a high-water mark of the storages the step
  allocates, each attributed to the position that made it; a tensor
  moved to another position (`obs.accounting.move`) counts there while
  the moved handle lives. The step's inputs are not allocations: their
  bytes are the dry run's ``argument``;
- **collective bytes, by kind**: what the port sends between positions:
  ``reduce`` (`parallel.tp.total`), ``gather`` (`tp.join` / `whole`,
  `parallel.mesh.gather`), ``scatter`` (`tp.place_leaf`,
  `parallel.mesh.device_put`, a slice sent by `TPGroup.to`),
  ``broadcast`` (`tp.local` of a replicated leaf, a whole tensor sent by
  `TPGroup.to`), and ``other``: a tensor read at a position other than
  the one that holds it with no hook on the way (mostly the backward's
  gradients, which autograd returns across positions). Each is counted
  once per (storage, receiving position). The dry run adds the
  data-parallel gradient sum (``all-reduce``), which the port's single
  controller does implicitly.

Positions: `parallel.mesh.run_per_shard` says which position runs
(`obs.accounting.run_at`); a backward op runs at the position whose
forward made its autograd node (a `TorchFunctionMode` tags each new node
with it); anything else runs at the ambient tensor-parallel group's
leader, else at position 0.

`nn.rglru._scan` loops over time in Python; under a recorder it runs one
step with its costs counted once per step (`_SampledScan`), forward and
backward, so a 32k-token recurrence traces in one step's time.

`roofline` and `model_flops` keep the reference's contracts with H100
constants.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs import accounting
from repro_torch.parallel import tp

# NVIDIA H100 SXM5 80GB HBM3 at 700 W: data-sheet (spec) figures, dense,
# not measured
PEAK_BF16_FLOPS = 989.4e12     # float FLOPs (bf16 tensor cores)
PEAK_INT8_OPS = 1978.9e12      # packed MACs x 2 (int8 tensor cores)
HBM_BW = 3.35e12               # B/s
LINK_BW = 450e9                # NVLink, B/s per direction

KINDS = ("reduce", "gather", "scatter", "broadcast", "all-reduce", "other")

# allocate without writing: no IO
_NO_IO = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default}
_TAG = "repro_torch_position"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class PositionCosts:
    flops: float = 0.0          # float FLOPs
    int_ops: float = 0.0        # packed int8 operations (2 x MACs)
    io_bytes: float = 0.0
    live: int = 0
    peak: int = 0
    sent: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    received: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.rec._suspended:
            self.rec._op(func, args, kwargs, out)
        return out


class _Tagger(TorchFunctionMode):
    """Tags each autograd node a torch call makes (and the untagged
    nodes behind it, a composite op's) with the running position."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        nodes = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        if nodes:
            pos = self.rec.here()
            while nodes:
                n = nodes.pop()
                if n is None or _TAG in n.metadata:
                    continue
                n.metadata[_TAG] = pos
                nodes.extend(f for f, _ in n.next_functions)
        return out


class Recorder:
    """Accounts one step's aten ops per mesh position (module docstring).
    ``n`` positions; ``breakdown`` keeps IO bytes per op for
    `repro_torch.launch.breakdown`. Use as a context manager around the
    step; `own` the step's inputs first."""

    def __init__(self, n: int, breakdown: bool = False):
        self.positions = [PositionCosts() for _ in range(n)]
        self.by_op: Optional[Dict[str, list]] = {} if breakdown else None
        self._owner: Dict[int, set] = {}      # input storage -> positions
        self._alloc: Dict[int, list] = {}     # [bytes, pos, handles, ref]
        self._handles: Dict[int, int] = {}    # id(tensor) -> storage key
        self._pending: set = set()
        self._delivered: Dict[int, set] = {}
        self._suspended = 0
        self._repeat = 1
        self._flops = FlopCounterMode(display=False).flop_registry
        self._stack = None

    # ------------------------------------------------------- context ---
    def __enter__(self):
        from repro_torch.nn import layers, rglru
        # every trace makes its own per-device cached constants (on meta
        # one device stands for all), so what it counts does not depend
        # on what ran before it
        layers.const.cache_clear()
        layers._freqs.cache_clear()
        stack = contextlib.ExitStack()
        stack.enter_context(accounting.recording(self))
        stack.enter_context(_swap(rglru, "_scan", _sampled_scan))
        stack.enter_context(_Tagger(self))
        stack.enter_context(_Dispatch(self))
        self._stack = stack
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False

    @contextlib.contextmanager
    def suspended(self):
        """Nothing counted inside (a plain version, a re-run)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    @contextlib.contextmanager
    def repeated(self, n: int):
        """FLOPs, operations, IO and collective bytes counted ``n`` times
        inside (one loop step standing for ``n``); allocations once."""
        old = self._repeat
        self._repeat = old * n
        try:
            yield
        finally:
            self._repeat = old

    # ----------------------------------------------------- positions ---
    def own(self, tree, pos: int):
        """Mark the storages of ``tree``'s tensors as held at ``pos`` (the
        step's inputs: no allocation); a storage may be held at several
        (a replicated input)."""
        for t in _tensors(tree):
            self._owner.setdefault(t.untyped_storage()._cdata,
                                   set()).add(pos)

    def here(self) -> int:
        """The running position (module docstring)."""
        ctx = accounting.position()
        node = torch._C._current_autograd_node()
        if ctx is not None and ctx[1] is node:
            return ctx[0]
        if node is not None:
            tag = node.metadata.get(_TAG)
            if tag is not None:
                return tag
        if ctx is not None:
            return ctx[0]
        grp = tp.ambient()
        return grp.positions[0] if grp is not None else 0

    def _holders(self, key: int) -> set:
        """The positions holding storage ``key`` (none: not an input and
        not made by the step)."""
        entry = self._alloc.get(key)
        return {entry[1]} if entry is not None else self._owner.get(
            key, set())

    # ------------------------------------------------------ counting ---
    def _op(self, func, args, kwargs, out):
        p = self.here()
        pc = self.positions[p]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        r = self._repeat
        count = self._flops.get(func.overloadpacket)
        if count is not None:
            pc.flops += count(*args, **kwargs, out_val=out) * r
        if not func.is_view and func not in _NO_IO:
            for t in ins:        # a view reads nothing
                self._read(t, p)
            io = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            pc.io_bytes += io * r
            if self.by_op is not None:
                row = self.by_op.setdefault(str(func.overloadpacket),
                                            [0.0, 0, None])
                row[0] += io * r
                row[1] += r
                row[2] = tuple(outs[0].shape) if outs else None
        for t in outs:
            self._track(t, p)

    def packed(self, op: str, macs: int, operands, run):
        """A packed kernel call at its boundary (`obs.accounting.packed`)."""
        if self._suspended:
            return run()
        p = self.here()
        with self.suspended():
            out = run()
        ops = [t for t in operands if isinstance(t, torch.Tensor)]
        for t in ops:
            self._read(t, p)
        pc = self.positions[p]
        r = self._repeat
        io = sum(map(_nbytes, ops)) + _nbytes(out)
        pc.int_ops += 2.0 * macs * r
        pc.io_bytes += io * r
        if self.by_op is not None:
            row = self.by_op.setdefault(f"packed.{op}", [0.0, 0, None])
            row[0] += io * r
            row[1] += r
            row[2] = tuple(out.shape)
        self._track(out, p)
        return out

    def move(self, kind: str, t: torch.Tensor, dst: Optional[int]):
        """``t`` sent to position ``dst`` (None: the running one): its
        bytes cross once per (storage, ``dst``), and the copy counts at
        ``dst`` while the returned handle lives."""
        if dst is None:
            dst = self.here()
        key = t.untyped_storage()._cdata
        held = self._holders(key)
        if not held or dst in held or self._suspended:
            return t
        self._cross(kind, key, _nbytes(t), min(held), dst)
        with self.suspended():
            alias = t.view_as(t)
        self._virtual(alias, dst)
        return alias

    def _read(self, t: torch.Tensor, p: int):
        if t.dim() == 0:     # a scalar rides with the op's arguments
            return
        key = t.untyped_storage()._cdata
        held = self._holders(key)
        if held and p not in held:
            self._cross("other", key, _nbytes(t), min(held), p)

    def _cross(self, kind, key, nbytes, src, dst):
        got = self._delivered.setdefault(key, set())
        if dst in got:
            return
        got.add(dst)
        n = nbytes * self._repeat
        s, d = self.positions[src], self.positions[dst]
        s.sent[kind] += n
        s.counts[kind] += self._repeat
        d.received[kind] += n

    # ---------------------------------------------------- allocation ---
    def _track(self, t: torch.Tensor, p: int):
        if id(t) in self._handles:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owner:
            return
        entry = self._alloc.get(key)
        if entry is None:
            entry = self._alloc[key] = [st.nbytes(), p, 0,
                                        StorageWeakRef(st)]
            self._add(p, entry[0])
        entry[2] += 1
        self._handles[id(t)] = key
        weakref.finalize(t, self._dead, id(t))

    def _virtual(self, t: torch.Tensor, p: int):
        """``t``'s bytes held at ``p`` while the handle ``t`` lives."""
        nb = _nbytes(t)
        self._add(p, nb)
        weakref.finalize(t, self._sub, p, nb)

    def _add(self, p: int, nb: int):
        pc = self.positions[p]
        pc.live += nb
        if pc.live > pc.peak and self._pending:
            self._sweep()
        pc.peak = max(pc.peak, pc.live)

    def _sub(self, p: int, nb: int):
        self.positions[p].live -= nb

    def _dead(self, oid: int):
        key = self._handles.pop(oid, None)
        entry = self._alloc.get(key)
        if entry is None:
            return
        entry[2] -= 1
        if entry[2] == 0:
            if entry[3].expired():
                self._free(key)
            else:     # a handle autograd keeps (a saved output) holds it
                self._pending.add(key)

    def _sweep(self):
        for key in [k for k in self._pending
                    if self._alloc[k][3].expired()]:
            self._free(key)

    def _free(self, key: int):
        self._pending.discard(key)
        self._delivered.pop(key, None)
        nb, p, _, _ = self._alloc.pop(key)
        self.positions[p].live -= nb

    # -------------------------------------------------------- result ---
    def collective_bytes(self, p: int) -> float:
        """The link term of position ``p``: the larger of the bytes it
        sends and receives (a link carries both directions at once)."""
        pc = self.positions[p]
        return max(sum(pc.sent.values()), sum(pc.received.values()))


class _SampledScan(torch.autograd.Function):
    """`nn.rglru._scan` under a recorder: its loop body (``h_t = a_t *
    h_{t-1} + bx_t; h[:, t] = h_t``) runs once with its costs counted
    once per time step, forward and backward (the backward re-runs one
    step's autograd, so its per-step full-size gradient clones count as
    the loop's would); the states the loop saves for its backward are
    one float32 tensor of ``bx``'s shape. On ``meta`` the output has the
    loop's shape and no values."""

    @staticmethod
    def forward(ctx, a, bx):
        rec = accounting.recorder()
        h = torch.empty_like(bx)
        h_t = torch.zeros_like(bx[:, 0])
        with rec.repeated(bx.shape[1]):
            h_t = a[:, 0] * h_t + bx[:, 0]
            h[:, 0] = h_t
        states = torch.empty_like(bx) if any(ctx.needs_input_grad) else bx
        ctx.save_for_backward(a, bx, states)
        return h

    @staticmethod
    def backward(ctx, gh):
        rec = accounting.recorder()
        a, bx, _ = ctx.saved_tensors
        with torch.enable_grad():
            with rec.suspended():
                a1 = a.detach().requires_grad_(True)
                b1 = bx.detach().requires_grad_(True)
                h_prev = torch.zeros_like(b1[:, 0]).requires_grad_(True)
                h = torch.empty_like(b1)
                h[:, 0] = a1[:, 0] * h_prev + b1[:, 0]
            with rec.repeated(bx.shape[1]):
                ga, gb, _ = torch.autograd.grad(h, (a1, b1, h_prev), gh)
                # autograd adds each step's full-size gradient of a and
                # bx into their sums
                ga, gb = ga + ga, gb + gb
        return ga, gb


def _sampled_scan(a, bx):
    return _SampledScan.apply(a, bx)


@contextlib.contextmanager
def _swap(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def roofline(flops_per_device: float, bytes_per_device: float,
             collective_bytes: float, n_links: int = 1,
             int_ops_per_device: float = 0.0) -> dict:
    """Per-device seconds of each term at the H100's spec rates (float
    FLOPs at the bf16 peak, packed operations at the int8 peak), the
    dominant one, the bound, and the compute share of the bound: the
    reference's keys."""
    t_compute = (flops_per_device / PEAK_BF16_FLOPS
                 + int_ops_per_device / PEAK_INT8_OPS)
    t_memory = bytes_per_device / HBM_BW
    t_collective = collective_bytes / (LINK_BW * n_links)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update({
        "dominant": dom,
        "bound_s": bound,
        "roofline_fraction": (t_compute / bound) if bound > 0 else 1.0,
    })
    return terms


def model_flops(n_params_active: float, tokens: float) -> float:
    """6·N·D rule (fwd+bwd); callers pass N_active for MoE."""
    return 6.0 * n_params_active * tokens
