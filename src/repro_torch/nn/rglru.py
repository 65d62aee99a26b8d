"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

A diagonal gated linear recurrence h_t = a_t h_{t-1} + sqrt(1-a_t^2)
(i_t*x_t), with a_t = exp(-c * softplus(Lambda) * r_t), in float32. A
full sequence runs it as a loop over the positions (the reference's
``associative_scan`` composes the same (a, b) pairs in another order, so
the two agree to float32 rounding); decode is the exact one-step update.
The projections are quantization-aware dense layers (the paper's GEMMs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.layers import QOFF, QuantConfig, dense_apply, dense_def
from repro_torch.nn.module import ParamDef
from repro_torch.nn.ssm import _causal_conv_dw

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
    r = torch.sigmoid(dense_apply(p["w_a"], x, qcfg=cfg.q("w_a"))
                      .to(torch.float32))
    i = torch.sigmoid(dense_apply(p["w_i"], x, qcfg=cfg.q("w_i"))
                      .to(torch.float32))
    log_a = -_C * F.softplus(p["lam"])[None, :] * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def rglru_block_apply(p, xin, cfg: RglruConfig):
    """Full-sequence recurrent block. xin: (B,L,d)."""
    gate = _gelu(dense_apply(p["in_gate"], xin, qcfg=cfg.q("in_gate")))
    x = dense_apply(p["in_x"], xin, qcfg=cfg.q("in_x"))
    x = (_causal_conv_dw(x, p["conv_w"].to(xin.dtype))
         + p["conv_b"].to(xin.dtype)[None, None, :])
    a, bx_gate = _gates(p, x, cfg)
    bx = bx_gate * x.to(torch.float32)
    h = torch.empty_like(bx)
    h_t = torch.zeros_like(bx[:, 0])
    for t in range(bx.shape[1]):
        h_t = a[:, t] * h_t + bx[:, t]
        h[:, t] = h_t
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
