"""AdamW with float32 or int8 optimizer states, over trees of tensors.

- ``state_bits=32``: float32 m / v, decoupled weight decay on matrices
  (``ndim >= 2``) only, global-norm clipping, cosine schedule with warmup.
- ``state_bits=8``: m row-wise linear int8 (`core.quantize`'s codec), v
  row-wise log-scale int8 (v's dynamic range would crush small entries
  to 0 on a linear grid, and 1/sqrt(v) then explodes). The codes keep the
  parameter's shape, so state shardings follow the params'.

Every update is functional: new tensors out, the inputs untouched. Leaves
are visited in sorted-key order (``jax.tree.leaves``'s), so the global
norm adds in the reference's order. Constants enter as float32 tensors,
as the reference's weakly typed Python floats do.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantize import (dequantize_int8_rowwise,
                                       quantize_int8_rowwise)
from repro_torch.nn.module import get_at, leaf_paths, tree_like



@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    state_bits: int = 32          # 32 | 8 (int8 m / v)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int32 0-dim tensor), float32."""
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.minimum(s / _f32(max(cfg.warmup, 1), dev), _f32(1.0, dev))
    prog = torch.clamp((step - cfg.warmup).to(torch.float32)
                       / _f32(max(cfg.total_steps - cfg.warmup, 1), dev),
                       0.0, 1.0)
    cos = _f32(0.5, dev) * (_f32(1.0, dev)
                            + torch.cos(_f32(math.pi, dev) * prog))
    return (_f32(cfg.lr, dev) * warm
            * (_f32(0.1, dev) + _f32(0.9, dev) * cos))


# ---------------------------------------------------------- int8 states ---

_LOG_FLOOR = 1e-30

# log(1e-30) in float32, the log-scale codec's empty-row minimum
_LOG_LMIN = float(torch.log(torch.tensor(_LOG_FLOOR, dtype=torch.float32)))

_q8_lin = quantize_int8_rowwise
_dq8_lin = dequantize_int8_rowwise


def _q8_log(x: torch.Tensor) -> dict:
    dev = x.device
    lx = torch.log(torch.maximum(x, _f32(_LOG_FLOOR, dev)))
    lmin = torch.amin(lx, dim=-1, keepdim=True)
    lrange = torch.maximum(torch.amax(lx, dim=-1, keepdim=True) - lmin,
                           _f32(1e-6, dev))
    codes = torch.clamp(torch.round((lx - lmin) / lrange * _f32(254.0, dev))
                        - 127, -127, 127).to(torch.int8)
    return {"codes": codes, "lmin": lmin[..., 0], "lrange": lrange[..., 0]}


def _dq8_log(s: dict, shape=None) -> torch.Tensor:
    dev = s["codes"].device
    lx = ((s["codes"].to(torch.float32) + _f32(127.0, dev))
          / _f32(254.0, dev) * s["lrange"][..., None] + s["lmin"][..., None])
    x = torch.exp(lx)
    return torch.where(x <= _f32(_LOG_FLOOR * 2, dev), _f32(0.0, dev), x)


def _zeros_state(p: torch.Tensor, bits: int, kind: str = "lin"):
    if bits == 8:
        s = {"codes": torch.zeros(p.shape, dtype=torch.int8,
                                  device=p.device)}
        lead = tuple(p.shape[:-1])
        if kind == "lin":
            s["scale"] = torch.zeros(lead, dtype=torch.float32,
                                     device=p.device)
        else:
            s["lmin"] = torch.full(lead, _LOG_LMIN, dtype=torch.float32,
                                   device=p.device)
            s["lrange"] = torch.full(lead, 1e-6, dtype=torch.float32,
                                     device=p.device)
        return s
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _read_state(s, bits: int, kind: str = "lin") -> torch.Tensor:
    if bits == 8:
        return _dq8_lin(s) if kind == "lin" else _dq8_log(s)
    return s


def _write_state(x: torch.Tensor, bits: int, kind: str = "lin"):
    if bits == 8:
        return _q8_lin(x) if kind == "lin" else _q8_log(x)
    return x


# -------------------------------------------------------------- adamw -----

def adamw_init(params, cfg: OptConfig) -> dict:
    leaves = leaf_paths(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_like((p, _zeros_state(x, cfg.state_bits, "lin"))
                       for p, x in leaves),
        "v": tree_like((p, _zeros_state(x, cfg.state_bits, "log"))
                       for p, x in leaves),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, x in leaf_paths(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    dev = step.device
    lr = _schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.clip_norm, dev) / (gn + _f32(1e-9, dev)))
    s_f = step.to(torch.float32)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1 = _f32(1.0, dev) - torch.pow(b1, s_f)
    c2 = _f32(1.0, dev) - torch.pow(b2, s_f)
    one_b1, one_b2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)
    new_p, new_m, new_v = [], [], []
    for path, p in leaf_paths(params):
        g = get_at(grads, path).to(torch.float32) * scale
        m = _read_state(get_at(state["m"], path), cfg.state_bits, "lin")
        v = _read_state(get_at(state["v"], path), cfg.state_bits, "log")
        m = b1 * m + one_b1 * g
        v = b2 * v + one_b2 * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.dim() >= 2:  # decay matrices only
            delta = delta + wd * p.to(torch.float32)
        new_p.append((path, (p.to(torch.float32) - lr * delta).to(p.dtype)))
        new_m.append((path, _write_state(m, cfg.state_bits, "lin")))
        new_v.append((path, _write_state(v, cfg.state_bits, "log")))
    return tree_like(new_p), {"step": step, "m": tree_like(new_m),
                              "v": tree_like(new_v)}, {
        "grad_norm": gn, "lr": lr}


def state_logical_specs(param_specs, cfg: OptConfig) -> dict:
    """Optimizer-state logical axes mirroring the params' (a tree whose
    leaves are axis tuples)."""
    def walk(tree, fn):
        if isinstance(tree, dict):
            return {k: walk(v, fn) for k, v in tree.items()}
        return fn(tree)

    if cfg.state_bits == 8:
        return {"step": (),
                "m": walk(param_specs, lambda a: {"codes": a,
                                                  "scale": a[:-1]}),
                "v": walk(param_specs, lambda a: {"codes": a,
                                                  "lmin": a[:-1],
                                                  "lrange": a[:-1]})}
    return {"step": (), "m": param_specs, "v": param_specs}
