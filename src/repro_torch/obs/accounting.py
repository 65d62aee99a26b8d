"""The hooks through which a cost recorder (`repro_torch.launch.costs`,
the dry run's) sees what the aten ops of a step on ``meta`` tensors
cannot show it:

- which mesh position runs (`run_at`, called by
  `parallel.mesh.run_per_shard`): on ``meta`` every position has the
  same device, so work is attributed by position, never by device;
- the bytes that cross positions (`move`, called where the port moves a
  tensor to another position: `parallel.tp`'s reduction, gathers,
  scatters and broadcasts, `parallel.mesh.device_put` / `gather`). On
  ``meta`` a ``.to()`` moves nothing and makes no copy, so the hook says
  where the copy would land;
- each packed kernel call at its boundary (`packed`, called by the
  kernel wrappers where they run a plain version): counted once as the
  kernel would run it, the plain version's own ops not at all.

With no recorder active every hook is one context-variable read.
"""
from __future__ import annotations

import contextlib
import contextvars

_RECORDER = contextvars.ContextVar("repro_torch_cost_recorder", default=None)
_POSITION = contextvars.ContextVar("repro_torch_position", default=None)


def recorder():
    """The active recorder, or None."""
    return _RECORDER.get()


@contextlib.contextmanager
def recording(rec):
    """Make ``rec`` the active recorder for the block."""
    tok = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(tok)


def position():
    """(the mesh position `run_at` set, the autograd node running when it
    was set), or None outside one."""
    return _POSITION.get()


def run_at(pos: int, fn, *args):
    """``fn(*args)``, at mesh position ``pos`` while a recorder is
    active."""
    if _RECORDER.get() is None:
        return fn(*args)
    import torch
    tok = _POSITION.set((pos, torch._C._current_autograd_node()))
    try:
        return fn(*args)
    finally:
        _POSITION.reset(tok)


def move(kind: str, t, dst: int):
    """``t`` sent to mesh position ``dst`` (``kind``: reduce, gather,
    scatter or broadcast); returns what the caller should hold at
    ``dst`` (``t`` itself unless a recorder is active)."""
    rec = _RECORDER.get()
    if rec is None or t is None:
        return t
    return rec.move(kind, t, dst)


def packed(op: str, macs: int, operands, run):
    """``run()``, the plain version of packed kernel call ``op`` over
    ``operands`` (the tensors the kernel reads); a recorder counts it as
    2 x ``macs`` int8 operations and the operands' and the output's
    bytes."""
    rec = _RECORDER.get()
    if rec is None:
        return run()
    return rec.packed(op, macs, operands, run)
