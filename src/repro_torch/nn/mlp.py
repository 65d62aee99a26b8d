"""Feed-forward block (SwiGLU / GeGLU / GELU) over quantization-aware
dense layers, and the Mixture-of-Experts block (kimi-k2, llama4).

The MoE block routes each token to its top-k experts through a
group-limited, capacity-dropping dispatch, as the reference does: an
integer slot map (g, E, C) built with a scatter, token rows gathered
into the slots, the experts run as batched matmuls over all E, and a
combine of top-k gathers; no (g, t, E, C) one-hot is ever built. The
router and the routed experts are float leaves in every quantization
mode; the shared expert is an `MlpConfig` block whose denses pack.

Under tensor parallelism (`repro_torch.parallel.tp`) the MLP is
Megatron's: wi / wg column-parallel and wo row-parallel over one set of
d_ff runs (whole CHUNKs where wo is packed, so its K splits there), one
exact reduction at the end. The MoE block is expert-parallel: routing
and dispatch stay replicated on the leader, each position runs its
E / m experts on their slots, and the combine reads the gathered expert
outputs; the shared expert runs as `mlp_apply`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.layers import (QOFF, QuantConfig, dense_apply,
                                   dense_col, dense_cuts, dense_def,
                                   dense_row)
from repro_torch.nn.module import ParamDef
from repro_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    act: str = "swiglu"          # swiglu | geglu | gelu
    qcfg: QuantConfig = QOFF
    # mixed-precision deployment: per-dense override of qcfg, resolved
    # by this block's param path (e.g. "layers/mlp") + the dense name
    plan: Optional[PrecisionPlan] = None
    path: str = "layers/mlp"

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)


def mlp_def(cfg: MlpConfig, dtype=torch.float32):
    p = {"wi": dense_def(cfg.d_model, cfg.d_ff, ("embed", "mlp"),
                         qcfg=cfg.q("wi"), dtype=dtype),
         "wo": dense_def(cfg.d_ff, cfg.d_model, ("mlp", "embed"),
                         qcfg=cfg.q("wo"), dtype=dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = dense_def(cfg.d_model, cfg.d_ff, ("embed", "mlp"),
                            qcfg=cfg.q("wg"), dtype=dtype)
    return p


def _act(h, g, kind):
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "swiglu":
        return F.silu(g) * h
    if kind == "geglu":
        return F.gelu(g, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def mlp_runs(cfg: MlpConfig, m: int):
    """The d_ff runs of each model position: whole CHUNKs where wo's K
    is a packed container, single columns otherwise."""
    q = cfg.q("wo")
    unit = packing.CHUNK if q.mode == "int" and q.segments is None else 1
    return tp.even_runs(cfg.d_ff, m, unit)


def mlp_cuts(cfg: MlpConfig, m: int):
    runs = mlp_runs(cfg, m)
    return {"wi": dense_cuts(cfg.q("wi"), "col", runs, cfg.d_model),
            "wg": dense_cuts(cfg.q("wg"), "col", runs, cfg.d_model),
            "wo": dense_cuts(cfg.q("wo"), "row", runs, cfg.d_ff)}


def _mlp_tp(grp, p, x, cfg: MlpConfig):
    runs = mlp_runs(cfg, grp.m)
    p = tp.place(p, mlp_cuts(cfg, grp.m), grp)
    kw = dict(runs=runs, group=grp, k_full=cfg.d_model)
    hs = dense_col(p["wi"], x, qcfg=cfg.q("wi"), **kw)
    gs = (dense_col(p["wg"], x, qcfg=cfg.q("wg"), **kw) if "wg" in p
          else [None] * grp.m)
    acts = [None if h is None else _act(h, g, cfg.act)
            for h, g in zip(hs, gs)]
    return dense_row(p["wo"], acts, qcfg=cfg.q("wo"), runs=runs, group=grp,
                     k_full=cfg.d_ff)


def mlp_apply(p, x, cfg: MlpConfig):
    grp = tp.tp_group()
    if grp is not None:
        return _mlp_tp(grp, p, x, cfg)
    h = dense_apply(p["wi"], x, qcfg=cfg.q("wi"))
    g = dense_apply(p["wg"], x, qcfg=cfg.q("wg")) if "wg" in p else None
    return dense_apply(p["wo"], _act(h, g, cfg.act), qcfg=cfg.q("wo"))


# ------------------------------------------------------------------ MoE ---

@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 1024    # tokens per dispatch group
    shared_expert: bool = True
    act: str = "swiglu"
    qcfg: QuantConfig = QOFF
    plan: Optional[PrecisionPlan] = None
    path: str = "layers/moe"

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.n_experts) + 1
        return max(c, 4)

    def shared(self) -> MlpConfig:
        return MlpConfig(self.d_model, self.d_ff, self.act, self.qcfg,
                         self.plan, f"{self.path}/shared")


def moe_def(cfg: MoeConfig, dtype=torch.float32):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": ParamDef((d, e), ("embed", "experts"), "normal", dtype,
                           scale=0.02),
        "wi": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"),
                       "normal", dtype),
        "wg": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"),
                       "normal", dtype),
        "wo": ParamDef((e, f, d), ("experts", "expert_mlp", "embed"),
                       "normal", dtype),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_def(cfg.shared(), dtype)
    return p


def moe_route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoeConfig):
    """The routing of token groups (g, gs, d): the float32 router's
    softmax ``probs`` (g, gs, E), the top-k ``gate_vals`` and
    ``expert_idx`` (g, gs, k), each choice's position in its expert
    ``pos`` (g, gs, k) over the flattened (t, k) order, and ``keep`` (pos
    under the capacity). Top-k is a stable descending sort, so equal
    probabilities (the all-zero padding rows) pick the lower expert
    first, as ``lax.top_k`` does."""
    logits = torch.matmul(tokens.to(torch.float32),
                          router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = srt.values[..., :cfg.top_k]
    expert_idx = srt.indices[..., :cfg.top_k]
    ng, gs = tokens.shape[:2]
    onehot = F.one_hot(expert_idx, cfg.n_experts).to(torch.int32)
    flat = onehot.reshape(ng, gs * cfg.top_k, cfg.n_experts)
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1).reshape(
        ng, gs, cfg.top_k)
    keep = pos < cfg.capacity(gs)
    return probs, gate_vals * keep.to(gate_vals.dtype), expert_idx, pos, \
        keep


def _experts(expert_in: torch.Tensor, p, act: str) -> torch.Tensor:
    """(g, E, C, d) slot rows through each expert's gated FFN, as one
    batched matmul per weight over E, in the rows' dtype (a weight of
    that dtype is read as it is, not copied)."""
    ng, e, cap, d = expert_in.shape
    xe = expert_in.transpose(0, 1).reshape(e, ng * cap, d)
    h = torch.bmm(xe, p["wi"].to(xe.dtype))
    g = torch.bmm(xe, p["wg"].to(xe.dtype))
    out = torch.bmm(_act(h, g, act), p["wo"].to(xe.dtype))
    return out.reshape(e, ng, cap, d).transpose(0, 1)


def moe_apply(p, x, cfg: MoeConfig):
    """x: (B, S, d) -> (y (B, S, d), Switch aux loss). Tokens go in
    groups of ``min(group_size, B*S)`` (the last padded with zero rows);
    each group's choices fill their experts' ``capacity`` slots in (t, k)
    order and the rest are dropped (gate zero, landing nowhere)."""
    b, s, d = x.shape
    gs = min(cfg.group_size, b * s)
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    pad = (-n_tok) % gs
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // gs
    tokens = tokens.reshape(ng, gs, d)
    probs, gate_vals, expert_idx, pos, keep = moe_route(
        tokens, p["router"], cfg)
    cap, e, k = cfg.capacity(gs), cfg.n_experts, cfg.top_k

    # dispatch: token ids into (g, E, C) slots, gs naming the zero row;
    # dropped choices write the spare slot C, which is cut off
    pos_c = torch.where(keep, pos, cap)
    slot_tok = torch.full((ng, e, cap + 1), gs, dtype=torch.long,
                          device=x.device)
    g_ar = torch.arange(ng, device=x.device)[:, None, None].expand(
        ng, gs, k)
    t_ar = torch.arange(gs, device=x.device)[None, :, None].expand(
        ng, gs, k)
    slot_tok[g_ar, expert_idx, pos_c] = t_ar
    slot_tok = slot_tok[:, :, :cap]
    tokens_pad = torch.cat([tokens, tokens.new_zeros(ng, 1, d)], dim=1)
    expert_in = tokens_pad[torch.arange(ng, device=x.device)[:, None, None],
                           slot_tok]
    grp = tp.tp_group()
    if grp is None:
        expert_out = _experts(expert_in, p, cfg.act)
    else:
        expert_out = _experts_ep(grp, expert_in, p, cfg)

    # combine: top_k gathers of (g, t, d)
    flat_eo = expert_out.reshape(ng, e * cap, d)
    rows = torch.arange(ng, device=x.device)[:, None]
    y = torch.zeros((ng, gs, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        idx = torch.clamp(expert_idx[:, :, kk] * cap + pos_c[:, :, kk],
                          max=e * cap - 1)
        w = (gate_vals[:, :, kk] * keep[:, :, kk]).to(x.dtype)
        y = y + flat_eo[rows, idx] * w[..., None]
    y = y.reshape(-1, d)[:n_tok].reshape(b, s, d)
    if cfg.shared_expert:
        y = y + mlp_apply(p["shared"], x, cfg.shared())

    # Switch aux loss: E * sum_e(frac_tokens_e * frac_probs_e), from the
    # top-1 choices, padding rows included
    frac_tok = F.one_hot(expert_idx[:, :, 0], e).to(torch.float32).mean(1)
    frac_prob = probs.mean(1)
    aux = e * (frac_tok * frac_prob).sum(-1).mean()
    return y, aux


def moe_cuts(cfg: MoeConfig, m: int):
    """Experts over the model axis (EP), when they divide it; the router
    stays replicated."""
    c = None
    if cfg.n_experts % m == 0:
        c = tp.Cut(-3, tp.blocks_runs(cfg.n_experts, 1, m))
    out = {"wi": c, "wg": c, "wo": c}
    if cfg.shared_expert:
        out["shared"] = mlp_cuts(cfg.shared(), m)
    return out


def _experts_ep(grp, expert_in, p, cfg: MoeConfig):
    """`_experts` with each position running its block of experts on
    their slots; the outputs gathered on the leader."""
    ep = tp.place({k: p[k] for k in ("wi", "wg", "wo")},
                  moe_cuts(cfg, grp.m), grp)
    if not isinstance(ep["wi"], tp.Split):
        return _experts(expert_in, ep, cfg.act)
    runs = ep["wi"].cut.runs
    live = [i for i, r in enumerate(runs) if r]
    outs = grp.run(
        lambda i, xi: _experts(xi, tp.local(ep, i), cfg.act),
        [(grp.to(tp.take(expert_in, runs[i], 1), i),) for i in live], live)
    return tp.join(outs, tuple(runs[i] for i in live), 1, cfg.n_experts,
                   grp.leader)
