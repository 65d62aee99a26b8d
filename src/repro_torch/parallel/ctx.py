"""Activation-sharding context: the ambient mesh and logical constraints.

**Paper analogy (XpulpNN §V):** an active mesh is the paper's parallel
cluster, one mesh position per core. `use_mesh` / `activation_sharding`
enter that context; `active_mesh()` reads it (`nn.attention.attn_strategy`
picks its strategy from it, and `models.api.Model` runs data block 0 of
it tensor-parallel when its ``model`` axis is above 1).
`repro_torch.parallel.tp.tp_scope` enters it too, with the group of
model positions the blocks split their work over.

`constrain(x, axes)` and `constrain_first(x, options)` keep the
reference's call shape but return ``x`` unchanged: the reference hands
the resolved PartitionSpec to GSPMD inside ``jit``, which moves the data;
eager torch has no partitioner to hand it to. The explicit blocks move
the data instead: the LM blocks split heads, MLP columns, experts,
recurrence channels and vocab rows over ``model`` themselves
(`repro_torch.parallel.tp`), and `repro_torch.kernels.api.qdot_sharded`
and the engines' data blocks split the rest, so a constraint has nothing
left to do.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.parallel.sharding import DEFAULT_RULES

_ACTIVE = contextvars.ContextVar("repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules=DEFAULT_RULES):
    tok = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def use_mesh(mesh):
    """The ambient-mesh context manager. The reference keeps two (jax's
    ambient mesh for ``jit`` and this module's for the constraints); the
    port has only this one, so `active_mesh()` returns ``mesh`` inside
    either."""
    return activation_sharding(mesh)


def active_mesh():
    ctx = _ACTIVE.get()
    return ctx[0] if ctx else None


def constrain(x, axes):
    """``x`` unchanged (module docstring)."""
    return x


def constrain_first(x, options):
    """``x`` unchanged (module docstring)."""
    return x
