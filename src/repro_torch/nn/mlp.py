"""Feed-forward block (SwiGLU / GeGLU / GELU) over quantization-aware
dense layers. The Mixture-of-Experts block arrives with the MoE models
(ROADMAP Queue 1 item 4)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.layers import QOFF, QuantConfig, dense_apply, dense_def


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


def mlp_apply(p, x, cfg: MlpConfig):
    h = dense_apply(p["wi"], x, qcfg=cfg.q("wi"))
    g = dense_apply(p["wg"], x, qcfg=cfg.q("wg")) if "wg" in p else None
    return dense_apply(p["wo"], _act(h, g, cfg.act), qcfg=cfg.q("wo"))
