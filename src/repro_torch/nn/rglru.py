"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

A diagonal gated linear recurrence h_t = a_t h_{t-1} + sqrt(1-a_t^2)
(i_t*x_t), with a_t = exp(-c * softplus(Lambda) * r_t), in float32. A
full sequence runs it as a loop over the positions (the reference's
``associative_scan`` composes the same (a, b) pairs in another order, so
the two agree to float32 rounding); decode is the exact one-step update.
The projections are quantization-aware dense layers (the paper's GEMMs).

Under tensor parallelism (`repro_torch.parallel.tp`) each model
position holds runs of the LRU width (whole CHUNKs where a K over that
width is packed): in_x / in_gate column-parallel, the depthwise conv,
the gates' elementwise math and the per-channel recurrence local, w_a /
w_i (``mlp`` -> ``mlp2``) row-parallel with their sums read back at the
position's channels, and ``out`` row-parallel, the block's reduction.
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
from repro_torch.nn.ssm import _causal_conv_dw
from repro_torch.parallel import tp

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    d_model: int
    lru_width: int
    d_conv: int = 4
    qcfg: QuantConfig = QOFF
    plan: Optional[PrecisionPlan] = None
    path: str = "rec_layers/rec"

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)


def rglru_block_def(cfg: RglruConfig, dtype=torch.float32):
    d, w = cfg.d_model, cfg.lru_width
    return {
        "in_x": dense_def(d, w, ("embed", "mlp"), qcfg=cfg.q("in_x"),
                          dtype=dtype),
        "in_gate": dense_def(d, w, ("embed", "mlp"), qcfg=cfg.q("in_gate"),
                             dtype=dtype),
        "conv_w": ParamDef((cfg.d_conv, w), (None, "mlp"), "normal", dtype),
        "conv_b": ParamDef((w,), ("mlp",), "zeros", dtype),
        "w_a": dense_def(w, w, ("mlp", "mlp2"), bias=True, qcfg=cfg.q("w_a"),
                         dtype=dtype),
        "w_i": dense_def(w, w, ("mlp", "mlp2"), bias=True, qcfg=cfg.q("w_i"),
                         dtype=dtype),
        "lam": ParamDef((w,), ("mlp",), "scalar:0.5", torch.float32),
        "out": dense_def(w, d, ("mlp", "embed"), qcfg=cfg.q("out"),
                         dtype=dtype),
    }


def _gates(p, x, cfg: RglruConfig):
    """(a, sqrt(1 - a^2) * i), both float32."""
    return _gates_of(dense_apply(p["w_a"], x, qcfg=cfg.q("w_a")),
                     dense_apply(p["w_i"], x, qcfg=cfg.q("w_i")), p["lam"])


def _gates_of(ra, ia, lam):
    r = torch.sigmoid(ra.to(torch.float32))
    i = torch.sigmoid(ia.to(torch.float32))
    log_a = -_C * F.softplus(lam)[None, :] * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _scan(a, bx):
    h = torch.empty_like(bx)
    h_t = torch.zeros_like(bx[:, 0])
    for t in range(bx.shape[1]):
        h_t = a[:, t] * h_t + bx[:, t]
        h[:, t] = h_t
    return h


def rglru_block_apply(p, xin, cfg: RglruConfig):
    """Full-sequence recurrent block. xin: (B,L,d)."""
    grp = tp.tp_group()
    if grp is not None:
        return _rglru_tp(grp, p, xin, cfg)
    gate = _gelu(dense_apply(p["in_gate"], xin, qcfg=cfg.q("in_gate")))
    x = dense_apply(p["in_x"], xin, qcfg=cfg.q("in_x"))
    x = (_causal_conv_dw(x, p["conv_w"].to(xin.dtype))
         + p["conv_b"].to(xin.dtype)[None, None, :])
    a, bx_gate = _gates(p, x, cfg)
    h = _scan(a, bx_gate * x.to(torch.float32))
    y = h.to(xin.dtype) * gate
    return dense_apply(p["out"], y, qcfg=cfg.q("out"))


def rglru_init_cache(cfg: RglruConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_block_decode(p, xin, cache, cfg: RglruConfig):
    """Single-token decode. xin: (B,1,d). The state is written into
    ``cache`` in place (the returned cache is the same dict)."""
    grp = tp.tp_group()
    if grp is not None:
        return _rglru_tp(grp, p, xin, cfg, cache), cache
    gate = _gelu(dense_apply(p["in_gate"], xin, qcfg=cfg.q("in_gate")))[:, 0]
    x = dense_apply(p["in_x"], xin, qcfg=cfg.q("in_x"))[:, 0]
    conv_buf = torch.cat([cache["conv"].to(x.dtype), x[:, None, :]], dim=1)
    w = p["conv_w"].to(xin.dtype)
    xc = torch.einsum("bkc,kc->bc", conv_buf, w) + p["conv_b"].to(xin.dtype)
    a, bx_gate = _gates(p, xc, cfg)
    h = a * cache["h"] + bx_gate * xc.to(torch.float32)
    y = h.to(xin.dtype) * gate
    out = dense_apply(p["out"], y[:, None, :], qcfg=cfg.q("out"))
    cache["conv"].copy_(conv_buf[:, 1:])
    cache["h"].copy_(h)
    return out, cache


# ------------------------------------------- tensor parallel (model) ---

def rglru_runs(cfg: RglruConfig, m: int):
    """The LRU-width runs of each model position: whole CHUNKs where
    w_a, w_i or out packs its K."""
    qs = [cfg.q(n) for n in ("w_a", "w_i", "out")]
    unit = (packing.CHUNK if any(q.mode == "int" and q.segments is None
                                 for q in qs) else 1)
    return tp.even_runs(cfg.lru_width, m, unit)


def rglru_cuts(cfg: RglruConfig, m: int):
    r = rglru_runs(cfg, m)
    c = tp.Cut(-1, r)
    d, w = cfg.d_model, cfg.lru_width
    return {"in_x": dense_cuts(cfg.q("in_x"), "col", r, d),
            "in_gate": dense_cuts(cfg.q("in_gate"), "col", r, d),
            "conv_w": c, "conv_b": c, "lam": c,
            "w_a": dense_cuts(cfg.q("w_a"), "row", r, w),
            "w_i": dense_cuts(cfg.q("w_i"), "row", r, w),
            "out": dense_cuts(cfg.q("out"), "row", r, w)}


def rglru_cache_cuts(cfg: RglruConfig, m: int):
    c = tp.Cut(-1, rglru_runs(cfg, m))
    return {"conv": c, "h": c}


def _rglru_tp(grp, p, xin, cfg: RglruConfig, cache=None):
    """The block on the group; with ``cache`` one decode step."""
    runs = rglru_runs(cfg, grp.m)
    p = tp.place(p, rglru_cuts(cfg, grp.m), grp)
    live = [i for i, r in enumerate(runs) if r]
    kw = dict(runs=runs, group=grp, k_full=cfg.d_model)
    gates = dense_col(p["in_gate"], xin, qcfg=cfg.q("in_gate"), **kw)
    xs = dense_col(p["in_x"], xin, qcfg=cfg.q("in_x"), **kw)
    dt = xin.dtype
    loc = [tp.local(p, i, grp.devices[i]) for i in range(grp.m)]
    if cache is not None:
        convs = tp.parts_of(cache["conv"], runs, -1)
        hs = tp.parts_of(cache["h"], runs, -1)
    xcs = [None] * grp.m
    bufs = [None] * grp.m
    for i in live:
        w, b = loc[i]["conv_w"].to(dt), loc[i]["conv_b"].to(dt)
        if cache is None:
            xcs[i] = _causal_conv_dw(xs[i], w) + b[None, None, :]
        else:
            bufs[i] = torch.cat([convs[i].to(dt), xs[i]], dim=1)
            xcs[i] = (torch.einsum("bkc,kc->bc", bufs[i], w) + b)[:, None]
    kr = dict(runs=runs, group=grp, k_full=cfg.lru_width)
    ra = dense_row(p["w_a"], xcs, qcfg=cfg.q("w_a"), **kr)
    ia = dense_row(p["w_i"], xcs, qcfg=cfg.q("w_i"), **kr)
    ys = [None] * grp.m
    for i in live:
        a, bx_gate = _gates_of(grp.to(tp.take(ra, runs[i], -1), i),
                               grp.to(tp.take(ia, runs[i], -1), i),
                               loc[i]["lam"])
        bx = bx_gate * xcs[i].to(torch.float32)
        if cache is None:
            h = _scan(a, bx)
        else:
            h = a[:, 0] * hs[i] + bx[:, 0]
            convs[i].copy_(bufs[i][:, 1:])
            hs[i].copy_(h)
            h = h[:, None]
        ys[i] = h.to(dt) * _gelu(gates[i])
    return dense_row(p["out"], ys, qcfg=cfg.q("out"), **kr)
