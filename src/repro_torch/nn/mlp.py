"""Feed-forward block (SwiGLU / GeGLU / GELU) over quantization-aware
dense layers, and the Mixture-of-Experts block (kimi-k2, llama4,
kimi-k2-instruct).

The default MoE block (``experts_held`` 0: kimi-k2-1t-a32b and
llama4) routes each token to its top-k experts through a group-limited,
capacity-dropping dispatch, as the reference does: an integer slot map
(g, E, C) built with a scatter, token rows gathered into the slots, the
experts run as batched matmuls over all E, and a combine of top-k
gathers; no (g, t, E, C) one-hot is ever built. There the router and the
routed experts are float leaves in every quantization mode; the shared
expert is an `MlpConfig` block whose denses pack.

The dropless block (``experts_held`` > 0: kimi-k2-instruct) is
expert parallelism's share on one device: the float32 router scores all
``n_experts`` (softmax, or DeepSeek-V3's sigmoid with a selection-only
bias), the layer holds experts [offset, offset + held), keeps every
(token, choice) pair whose expert it holds, groups the pairs by expert
(one read of the held experts' row counts to the host a layer: the
launches below take them as sizes), runs each held expert on its rows as
three dense layers (packed: three grouped launches of the packed GEMM
over all held experts, each input quantized once), and adds the
weighted outputs into the tokens' rows in float32, then the shared
expert once. Each routed expert is a dense subtree stacked over the
held experts, packed per expert along its own K in int mode (the
dropless configs: kimi-k2-instruct), float otherwise. What the
experts held elsewhere add is not computed here. Spans: ``lm/moe.route``
(router, selection, grouping, the count read), ``lm/moe.experts`` (the
held experts' GEMMs), ``lm/moe.shared`` (the combine and the shared
expert); counters ``moe.held_rows`` and ``moe.rows_max_expert`` (the
busiest held expert's rows, summed over calls) with ``REPRO_OBS=1``.

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
                                   dense_row, dequant_scale,
                                   quantize_activations)
from repro_torch.nn.module import ParamDef, stack_defs
from repro_torch.obs import trace as obs
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
    scoring: str = "softmax"          # softmax | sigmoid_noaux
    norm_topk: bool = False
    routed_scale: float = 1.0
    experts_held: int = 0             # > 0: the dropless share held
    experts_offset: int = 0

    @property
    def dropless(self) -> bool:
        return self.experts_held > 0

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.n_experts) + 1
        return max(c, 4)

    def shared(self) -> MlpConfig:
        return MlpConfig(self.d_model, self.d_ff, self.act, self.qcfg,
                         self.plan, f"{self.path}/shared")


def _check_moe(cfg: MoeConfig):
    if cfg.scoring not in ("softmax", "sigmoid_noaux"):
        raise ValueError(f"unknown MoE scoring {cfg.scoring!r}")
    if not cfg.dropless and (
            cfg.scoring != "softmax" or cfg.norm_topk
            or cfg.routed_scale != 1.0):
        raise ValueError("the capacity dispatch routes by softmax over all "
                         "experts, float; the rest needs the dropless one "
                         "(experts_held > 0)")
    if cfg.experts_offset + cfg.experts_held > cfg.n_experts:
        raise ValueError(f"experts [{cfg.experts_offset}, "
                         f"{cfg.experts_offset + cfg.experts_held}) are not "
                         f"all among the {cfg.n_experts} routed")


def moe_def(cfg: MoeConfig, dtype=torch.float32):
    _check_moe(cfg)
    if cfg.dropless:
        return _held_def(cfg, dtype)
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
    order and the rest are dropped (gate zero, landing nowhere). A
    dropless config runs `moe_held_apply`, with no aux loss (0.0)."""
    if cfg.dropless:
        return moe_held_apply(p, x, cfg), 0.0
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
    if cfg.dropless:
        raise NotImplementedError("the dropless MoE dispatch has no tensor "
                                  "parallel layout")
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


# ------------------------------------------------------ dropless, held ---

def _held_def(cfg: MoeConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    p = {"router": ParamDef((d, cfg.n_experts), ("embed", "experts"),
                            "normal", dtype, scale=0.02)}
    if cfg.scoring == "sigmoid_noaux":
        p["router_bias"] = ParamDef((cfg.n_experts,), ("experts",),
                                    "zeros", torch.float32)
    for name, (k, n) in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
        axes = ("embed", "expert_mlp") if name != "wo" else \
            ("expert_mlp", "embed")
        p[name] = stack_defs(dense_def(k, n, axes, qcfg=cfg.q(name),
                                       dtype=dtype), cfg.experts_held,
                           "experts")
    if cfg.shared_expert:
        p["shared"] = mlp_def(cfg.shared(), dtype)
    return p


def moe_select(tokens: torch.Tensor, p, cfg: MoeConfig):
    """The routing of tokens (T, d) over all ``n_experts``: (weights (T,
    k) float32, experts (T, k) int64). Float32 router logits; softmax:
    the top-k probabilities; sigmoid_noaux: the top-k of sigmoid + the
    selection-only ``router_bias``, weighted by their sigmoids; then
    renormalised to sum 1 where ``norm_topk``, times ``routed_scale``."""
    logits = torch.matmul(tokens.to(torch.float32),
                          p["router"].to(torch.float32))
    if cfg.scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
        choice = scores
    else:
        scores = torch.sigmoid(logits)
        choice = scores + p["router_bias"].to(torch.float32)
    idx = torch.topk(choice, cfg.top_k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    if cfg.norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    if cfg.routed_scale != 1.0:
        w = w * cfg.routed_scale
    return w, idx


def _held_experts(p, xs, counts, cfg: MoeConfig):
    """Each held expert's gated FFN on its rows of xs (R, d), grouped in
    expert order, ``counts[e]`` each: (R, d). Packed at one uniform
    width, the three denses run as grouped launches over all held
    experts (`kernels/api.py::int_gemm_grouped`), each input quantized
    once for all of them; the integers and their dequant are
    `dense_apply`'s. Otherwise each expert runs `dense_apply` in turn."""
    q = cfg.q("wi")
    if q.mode == "int" and q.segments is None and \
            cfg.q("wg") == q == cfg.q("wo"):
        from repro_torch.kernels.api import int_gemm_grouped

        def gemm(name, codes, k):
            return int_gemm_grouped(
                codes, p[name]["w_packed"],
                dequant_scale(p[name], q, xs.device), counts,
                a_bits=q.a_bits, w_bits=q.w_bits, out_dtype=xs.dtype,
                pipeline=q.pipeline, k_logical=k)

        xq, d = quantize_activations(xs, q), xs.shape[-1]
        a = _act(gemm("wi", xq, d), gemm("wg", xq, d), cfg.act)
        return gemm("wo", quantize_activations(a, q), a.shape[-1])
    outs, start = [], 0
    for e, c in enumerate(counts):
        if c:
            one = {name: {k: v[e] for k, v in p[name].items()}
                   for name in ("wi", "wg", "wo")}
            x = xs[start:start + c]
            h = dense_apply(one["wi"], x, qcfg=cfg.q("wi"))
            g = dense_apply(one["wg"], x, qcfg=cfg.q("wg"))
            outs.append(dense_apply(one["wo"], _act(h, g, cfg.act),
                                    qcfg=cfg.q("wo")))
        start += c
    return torch.cat(outs) if outs else xs.new_zeros(xs.shape)


def moe_held_apply(p, x, cfg: MoeConfig):
    """x: (B, S, d) -> y (B, S, d): the held experts' part of the routed
    output plus the shared expert (module docstring)."""
    if tp.tp_group() is not None:
        raise NotImplementedError("the dropless MoE dispatch runs on one "
                                  "device: its expert parallelism is the "
                                  "held share (experts_held)")
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    n, k, held = xt.shape[0], cfg.top_k, cfg.experts_held
    with obs.span("lm/moe.route"):
        w, idx = moe_select(xt, p, cfg)
        local = idx.reshape(-1) - cfg.experts_offset
        key = torch.where((local >= 0) & (local < held), local, held)
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=held + 1)[:held].tolist()
        rows = sum(counts)
        pairs = order[:rows]
        tok = torch.div(pairs, k, rounding_mode="floor")
        xs = xt[tok]
        obs.counter("moe.held_rows").add(rows)
        obs.counter("moe.rows_max_expert").add(max(counts))
    with obs.span("lm/moe.experts"):
        out = _held_experts(p, xs, counts, cfg)
    with obs.span("lm/moe.shared"):
        y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        y.index_add_(0, tok, out.to(torch.float32)
                     * w.reshape(-1)[pairs][:, None])
        y = y.to(x.dtype).reshape(b, s, d)
        if cfg.shared_expert:
            y = y + mlp_apply(p["shared"], x, cfg.shared())
    return y
