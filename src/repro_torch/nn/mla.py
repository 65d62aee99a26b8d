"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437 §2.1.1;
Kimi-K2-Instruct).

Queries go through a low-rank latent: ``wq_a`` (d -> q_lora_rank),
RMSNorm ``q_norm``, ``wq_b`` to per-head queries of ``qk_nope_dim +
qk_rope_dim``. Keys and values share one latent: ``wkv_a`` (d ->
kv_lora_rank + qk_rope_dim) gives the latent ``c_kv``, RMSNorm
``kv_norm``, and one rotary key ``k_pe`` that every head shares;
``wkv_b`` expands the normalised latent into per-head ``k_nope``
(qk_nope_dim) and values (v_head_dim). A head's key is ``k_nope`` then
``k_pe``, its score width qk_nope_dim + qk_rope_dim against a value
width of v_head_dim; the rope part rotates (rotate-half) with the YaRN
tables where the config scales rope, and the scores are scaled by
(qk_nope_dim + qk_rope_dim)^-0.5 x mscale(factor, mscale_all_dim)^2.
The scores, softmax and values are `nn/attention.py::attn_core`'s.

Every projection is a quantization-aware dense (`dense_apply`), so a
W4A8 deployment runs the five through the packed GEMM. A decode cache
holds the latent: per layer and position ``c_kv`` (normalised) and the
rotated ``k_pe``, kv_lora_rank + qk_rope_dim values in place of per-head
K and V; a decode step expands the whole cache through ``wkv_b``, so it
reads the same keys and values the prefill computed. Meshless only:
under tensor parallelism or a mesh it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.attention import _sdpa, attn_core
from repro_torch.nn.layers import (QOFF, QuantConfig, Yarn, dense_apply,
                                   dense_def, norm_apply, norm_def,
                                   rope_apply, rope_single, yarn_mscale)
from repro_torch.parallel import tp
from repro_torch.parallel.ctx import active_mesh


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    theta: float = 10000.0
    yarn: Optional[Yarn] = None
    qcfg: QuantConfig = QOFF
    plan: Optional[PrecisionPlan] = None
    path: str = "layers/attn"

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def softmax_scale(self) -> float:
        s = self.qk_dim ** -0.5
        if self.yarn is not None and self.yarn.mscale_all_dim:
            m = yarn_mscale(self.yarn.factor, self.yarn.mscale_all_dim)
            s = s * m * m
        return s


def mla_def(cfg: MlaConfig, dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": dense_def(d, rq, ("embed", "q_lora"), qcfg=cfg.q("wq_a"),
                          dtype=dtype),
        "q_norm": norm_def(rq, "rmsnorm", dtype),
        "wq_b": dense_def(rq, h * cfg.qk_dim, ("q_lora", "heads"),
                          qcfg=cfg.q("wq_b"), dtype=dtype),
        "wkv_a": dense_def(d, rkv + cfg.qk_rope_dim, ("embed", "kv_lora"),
                           qcfg=cfg.q("wkv_a"), dtype=dtype),
        "kv_norm": norm_def(rkv, "rmsnorm", dtype),
        "wkv_b": dense_def(rkv, h * (cfg.qk_nope_dim + cfg.v_head_dim),
                           ("kv_lora", "heads"), qcfg=cfg.q("wkv_b"),
                           dtype=dtype),
        "wo": dense_def(h * cfg.v_head_dim, d, ("heads", "embed"),
                        qcfg=cfg.q("wo"), dtype=dtype),
    }


def _meshless(what: str):
    if tp.tp_group() is not None or active_mesh() is not None:
        raise NotImplementedError(
            f"latent attention ({what}) runs meshless only: no tensor "
            "parallel or mesh layout is defined for it")


def _queries(p, x, cfg: MlaConfig):
    """(B,S,H,qk) queries, their rope part not yet rotated."""
    b, s, _ = x.shape
    q_lat = norm_apply(p["q_norm"], dense_apply(p["wq_a"], x,
                                                qcfg=cfg.q("wq_a")))
    return dense_apply(p["wq_b"], q_lat, qcfg=cfg.q("wq_b")).reshape(
        b, s, cfg.n_heads, cfg.qk_dim)


def _latent(p, x, cfg: MlaConfig):
    """(normalised c_kv (B,S,rkv), k_pe (B,S,rope) not yet rotated)."""
    kv = dense_apply(p["wkv_a"], x, qcfg=cfg.q("wkv_a"))
    c_kv, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    return norm_apply(p["kv_norm"], c_kv), k_pe


def mla_qkv(p, x, cfg: MlaConfig, *, cos, sin):
    """Prefill projections of x (B,S,d): q (B,S,H,1,qk) with its rope
    part rotated, k (B,S,H,qk), v (B,S,H,dv), and the latent the cache
    keeps: c_kv (B,S,rkv), rotated k_pe (B,S,rope)."""
    _meshless("prefill")
    q = _queries(p, x, cfg)
    nope = cfg.qk_nope_dim
    q = torch.cat([q[..., :nope], rope_apply(q[..., nope:], cos, sin)],
                  dim=-1)
    c_kv, k_pe = _latent(p, x, cfg)
    k_pe = rope_apply(k_pe[:, :, None, :], cos, sin)[:, :, 0]
    k, v = mla_expand(p, c_kv, k_pe, cfg)
    return q[:, :, :, None], k, v, c_kv, k_pe


def mla_expand(p, c_kv, k_pe, cfg: MlaConfig):
    """Per-head keys (B,T,H,qk) and values (B,T,H,dv) of a latent c_kv
    (B,T,rkv) and its rotated k_pe (B,T,rope)."""
    b, t, _ = c_kv.shape
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    kv = dense_apply(p["wkv_b"], c_kv, qcfg=cfg.q("wkv_b")).reshape(
        b, t, h, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_pe[:, :, None, :].expand(b, t, h, cfg.qk_rope_dim)],
                  dim=-1)
    return k, kv[..., nope:]


def mla_core(q, k, v, cfg: MlaConfig):
    """Causal attention of `mla_qkv`'s q, k, v: (B,S,H*dv)."""
    return attn_core(q, k, v, mode="causal", window=None,
                     scale=cfg.softmax_scale)


def init_latent_cache(cfg: MlaConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu"):
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                dtype=dtype, device=device)}


def mla_decode(p, x, cache, index, cfg: MlaConfig):
    """One-token decode. x: (B,1,d); index the true position, a scalar or
    a (B,) vector; cache: dict(c_kv (B,T,rkv), k_pe (B,T,rope)), written
    in place at the position. Returns (wo's output (B,1,d), cache)."""
    _meshless("decode")
    b = x.shape[0]
    per_slot = torch.is_tensor(index) and index.dim() == 1
    index = index.to(x.device) if per_slot else int(index)
    q = _queries(p, x, cfg)
    nope = cfg.qk_nope_dim
    q = torch.cat([q[..., :nope],
                   rope_single(q[..., nope:], index, cfg.theta, cfg.yarn)],
                  dim=-1)
    c_new, pe_new = _latent(p, x, cfg)
    pe_new = rope_single(pe_new[:, :, None, :], index, cfg.theta,
                         cfg.yarn)[:, :, 0]
    t = cache["c_kv"].shape[1]
    k_pos = torch.arange(t, device=x.device)[None, :]
    if per_slot:
        rows = torch.arange(b, device=x.device)
        cache["c_kv"][rows, index.long()] = c_new[:, 0].to(
            cache["c_kv"].dtype)
        cache["k_pe"][rows, index.long()] = pe_new[:, 0].to(
            cache["k_pe"].dtype)
        allow = k_pos <= index[:, None]
    else:
        cache["c_kv"][:, index] = c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_pe"][:, index] = pe_new[:, 0].to(cache["k_pe"].dtype)
        allow = k_pos <= index
    k, v = mla_expand(p, cache["c_kv"].to(x.dtype),
                      cache["k_pe"].to(x.dtype), cfg)
    out = _sdpa(q[:, :, :, None], k, v, allow[:, None, None, None, :],
                cfg.softmax_scale).reshape(b, 1, -1)
    return dense_apply(p["wo"], out, qcfg=cfg.q("wo")), cache
