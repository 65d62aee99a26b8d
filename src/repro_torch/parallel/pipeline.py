"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

Layer stacks split into n_stages contiguous stages (stage s holds rows
[s * L/n, (s+1) * L/n) of the stacked params, split on the stacking dim
over ``pod``), and microbatches flow through the stages: at every step
each stage applies its layers to the activation it holds and passes the
result to the next stage. Bubble fraction = (n_stages - 1) / (n_micro +
n_stages - 1).

**Paper analogy:** the pod axis is the multi-cluster tier; stage params
may be packed sub-byte artifacts, since the stacking dim is a layer
index and never the packed reduction axis.

The reference runs the schedule as a ``shard_map`` ring with
``ppermute``; with one controller the port steps the stages in lockstep,
each on its position's device, and copies the activation between
devices. A stage runs only at the steps where it holds a microbatch (the
reference's other steps compute values it discards).
"""
from __future__ import annotations

import torch

from repro_torch.parallel.mesh import (Mesh, NamedSharding, P,
                                       axis_positions, device_put,
                                       run_per_shard, tree_map)


def pipeline_apply(stage_fn, stage_params, x_micro, mesh: Mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run a GPipe forward.

    stage_fn(params_slice, h) -> h applies ONE stage's layers.
    stage_params: dict tree with leaves stacked (n_stages, ...) (tensors
    or `Sharded` split on dim 0 over ``axis``). x_micro: (n_micro, mb,
    ...) microbatches. Returns the (n_micro, mb, ...) outputs of the last
    stage on ``x_micro``'s device.
    """
    pos = axis_positions(mesh, axis)
    n_stages = len(pos)
    flat = mesh.flat
    sharding = NamedSharding(mesh, P(axis))
    placed = tree_map(lambda a: device_put(a, sharding), stage_params)
    stage = [tree_map(lambda a, p=p: a.shards[p][0], placed) for p in pos]
    n_micro = x_micro.shape[0]
    out = [None] * n_micro
    held = [None] * n_stages          # activation each stage works on next
    for t in range(n_micro + n_stages - 1):
        live = [s for s in range(n_stages) if 0 <= t - s < n_micro]
        ins = [(stage[s], x_micro[t].to(flat[pos[0]]) if s == 0
                else held[s]) for s in live]
        res = run_per_shard(mesh, lambda p, sp, h: stage_fn(sp, h), ins,
                            [pos[s] for s in live])
        for s, h in zip(live, res):
            if s == n_stages - 1:
                out[t - s] = h
            else:
                held[s + 1] = h.to(flat[pos[s + 1]])
    return torch.stack([o.to(x_micro.device) for o in out])


def stage_stack(params_stacked, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L / n_stages, ...)."""
    return tree_map(
        lambda a: a.reshape(n_stages, a.shape[0] // n_stages,
                            *a.shape[1:]), params_stacked)
