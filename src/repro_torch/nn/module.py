"""Minimal functional parameter system over nested dicts of tensors.

A module is a pair of plain functions:
  *_def(cfg)   -> tree of `ParamDef` (shape, logical axes, initializer)
  *_apply(p,.) -> forward

`init_params` materializes a `ParamDef` tree with one `torch.Generator`
per leaf, seeded from the seed and a stable hash of the leaf's path, so
adding a parameter never reshuffles the others. The values are the
port's own (a jax key gives other numbers); the reference's trees cross
over as numpy (`repro_torch.convert.fp_params_from_numpy`).
`logical_specs` extracts the logical-axis tree, and `stack_defs`
prepends a layer axis: a stacked layer tree holds (L, ...) leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape), None ok
    init: str = "normal"  # normal | zeros | ones | embed | scalar:<v>
    dtype: Any = torch.float32
    scale: float = 1.0   # stddev multiplier for "normal" (fan-in scaled)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_leaf(d: ParamDef, seed: int, device: torch.device):
    if device.type == "meta":       # shapes only: nothing to draw
        return torch.empty(d.shape, dtype=d.dtype, device=device)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init.startswith("scalar:"):
        return torch.full(d.shape, float(d.init.split(":")[1]),
                          dtype=d.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(d.shape, generator=gen, device=device)
    # scaled in place: one float32 draw is the only transient (a full
    # width expert leaf is 22.5 GB of float32)
    if d.init == "embed":
        return x.mul_(d.scale).to(d.dtype)
    # fan-in scaled normal: last-but-one dim is fan-in for matrices
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    return x.mul_(d.scale / fan_in ** 0.5).to(d.dtype)


def _is_def(x):
    return isinstance(x, ParamDef)


def init_params(defs, seed: int, device="cuda"):
    """Materialize a ParamDef tree on ``device`` (default the card). Each
    leaf draws from its own generator, seeded from ``seed`` folded with
    `_stable_hash` of every part of its path."""
    dev = resolve_device(device)
    out = {}
    for path, d in _flatten(defs):
        s = int(seed) & 0xFFFFFFFF
        for part in path:
            s = (s * 1000003 ^ _stable_hash(part)) & 0xFFFFFFFFFFFF
        _set(out, path, _init_leaf(d, s, dev))
    return out


def logical_specs(defs):
    out = {}
    for path, d in _flatten(defs):
        _set(out, path, d.axes)
    return out


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (layer parameters stacked (L, ...))."""
    if _is_def(defs):
        return ParamDef((n,) + defs.shape, (axis_name,) + defs.axes,
                        defs.init, defs.dtype, defs.scale)
    return {k: stack_defs(v, n, axis_name) for k, v in defs.items()}


def leaf_paths(tree, path=()):
    """[(path tuple, leaf)] of a nested dict in sorted-key order (the order
    ``jax.tree.leaves`` visits the reference's trees in)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaf_paths(tree[k],
                                                              path + (k,))]
    return [(path, tree)]


def get_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_like(paths_values) -> dict:
    """A nested dict from (path tuple, value) pairs."""
    out: dict = {}
    for path, v in paths_values:
        _set(out, path, v)
    return out


def tree_leaves(tree):
    return [x for _, x in leaf_paths(tree)]


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in str(s):
        h = (h ^ ord(ch)) * 16777619 & 0xFFFFFFFF
    return h


def _flatten(tree, path=()):
    if _is_def(tree):
        return [(path, tree)]
    out = []
    for k in sorted(tree.keys()):
        out.extend(_flatten(tree[k], path + (k,)))
    return out


def _set(d, path, value):
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = value
