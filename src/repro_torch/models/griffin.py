"""RecurrentGemma / Griffin hybrid: a (rec, rec, local-attn) repeating
pattern.

38 layers = 12 groups of (RG-LRU, RG-LRU, local attention) + 2 trailing
RG-LRU blocks; every layer is followed by an MLP block (pre-norm
residual). The parameters stay stacked as the reference's are, (26, ...)
recurrent and (12, ...) attention leaves: group g runs recurrent layers
2g and 2g+1, then attention layer g, and the trailing recurrent layers
run after every group. Decode keeps the recurrent state and a ring KV
cache of ``min(max_len, window)`` slots, each written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (_attn_cfg, _compute_dtype, _embed,
                                   _logits, _mlp_cfg, layer_params, remat,
                                   unstack_layers, vocab_cuts)
from repro_torch.nn.attention import (attn_apply, attn_cuts, attn_decode,
                                      attn_def, init_cache, kv_cache_cut)
from repro_torch.nn.layers import (embedding_def, norm_apply, norm_def,
                                   rope_tables)
from repro_torch.nn.mlp import mlp_apply, mlp_cuts, mlp_def
from repro_torch.nn.module import stack_defs
from repro_torch.nn.rglru import (RglruConfig, rglru_block_apply,
                                  rglru_block_decode, rglru_block_def,
                                  rglru_cache_cuts, rglru_cuts,
                                  rglru_init_cache)


def _rcfg(cfg: ModelConfig) -> RglruConfig:
    return RglruConfig(cfg.d_model, cfg.lru_width or cfg.d_model,
                       cfg.d_conv, cfg.quant, cfg.quant_plan,
                       "rec_layers/rec")


def _group_counts(cfg: ModelConfig):
    """(n_groups, n_tail_rec): 38 -> (12, 2)."""
    plen = len(cfg.rnn_pattern)  # ("rec", "rec", "attn")
    n_groups = cfg.n_layers // plen
    return n_groups, cfg.n_layers - n_groups * plen


def _rec_per_group(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.rnn_pattern if k == "rec")


def _order(cfg: ModelConfig):
    """The layer order: ("rec", i) | ("attn", g) over the stacked
    indices."""
    ng, tail = _group_counts(cfg)
    nrg = _rec_per_group(cfg)
    out = []
    for g in range(ng):
        out += [("rec", g * nrg + j) for j in range(nrg)] + [("attn", g)]
    return out + [("rec", ng * nrg + j) for j in range(tail)]


def _rec_layer_def(cfg, dtype):
    return {"ln": norm_def(cfg.d_model, cfg.norm, dtype),
            "rec": rglru_block_def(_rcfg(cfg), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg, "rec_layers/mlp"), dtype)}


def _attn_layer_def(cfg, dtype):
    return {"ln": norm_def(cfg.d_model, cfg.norm, dtype),
            "attn": attn_def(_attn_cfg(cfg, "attn_layers/attn"), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg, "attn_layers/mlp"), dtype)}


def griffin_def(cfg: ModelConfig, dtype=torch.float32):
    ng, tail = _group_counts(cfg)
    return {
        "embed": embedding_def(cfg.vocab, cfg.d_model, dtype),
        "rec_layers": stack_defs(_rec_layer_def(cfg, dtype),
                                 ng * _rec_per_group(cfg) + tail),
        "attn_layers": stack_defs(_attn_layer_def(cfg, dtype), ng),
        "final_norm": norm_def(cfg.d_model, cfg.norm, dtype),
    }


def _mlp(cfg, lp, x, path):
    return x + mlp_apply(lp["mlp"], norm_apply(lp.get("ln2", {}), x,
                                               cfg.norm),
                         _mlp_cfg(cfg, path))


def _rec_layer(cfg, rcfg, lp, x):
    x = x + rglru_block_apply(
        lp["rec"], norm_apply(lp.get("ln", {}), x, cfg.norm), rcfg)
    return _mlp(cfg, lp, x, "rec_layers/mlp")


def _attn_layer(cfg, acfg, lp, x, cos, sin):
    h, _ = attn_apply(lp["attn"], norm_apply(lp.get("ln", {}), x, cfg.norm),
                      acfg, cos=cos, sin=sin, mode="local", window=cfg.window)
    return _mlp(cfg, lp, x + h, "attn_layers/mlp")


def forward(params, tokens, cfg: ModelConfig, *, src_embed=None,
            collect_kv: bool = False):
    """Full-sequence forward. tokens (B,S) -> (logits (B,S,V), aux_loss,
    None)."""
    dtype = _compute_dtype(cfg)
    x = _embed(params, tokens, cfg, dtype)
    cos, sin = rope_tables(tokens.shape[1], cfg.head_dim_, cfg.rope_theta,
                           dtype, x.device)
    rcfg, acfg = _rcfg(cfg), _attn_cfg(cfg, "attn_layers/attn")
    rec = unstack_layers(params["rec_layers"])
    att = unstack_layers(params["attn_layers"])
    for kind, i in _order(cfg):
        if kind == "rec":
            x = remat(cfg, _rec_layer, cfg, rcfg, rec[i], x)
        else:
            x = remat(cfg, _attn_layer, cfg, acfg, att[i], x, cos, sin)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), torch.zeros((), device=x.device), None


def griffin_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cpu"):
    """{"rec": {"conv", "h"} stacked over the recurrent layers, "kv":
    {"k", "v"} stacked over the attention layers}: local attention keeps
    a ring of ``min(max_len, window)`` slots."""
    ng, tail = _group_counts(cfg)
    attn_len = min(max_len, cfg.window)

    def stack(one, n):
        return {k: torch.zeros((n,) + a.shape, dtype=a.dtype,
                               device=a.device) for k, a in one.items()}

    return {
        "rec": stack(rglru_init_cache(_rcfg(cfg), batch, dtype, device),
                     ng * _rec_per_group(cfg) + tail),
        "kv": stack(init_cache(_attn_cfg(cfg, "attn_layers/attn"), batch,
                               attn_len, dtype, device), ng),
    }


def decode_step(params, cache, token, index, cfg: ModelConfig, *,
                src_embed=None):
    """One decode step. token (B,1) int; index a scalar or a (B,) vector
    of true positions. The cache is written in place. Returns (logits
    (B,1,V), cache)."""
    x = _embed(params, token, cfg, _compute_dtype(cfg))
    rcfg, acfg = _rcfg(cfg), _attn_cfg(cfg, "attn_layers/attn")
    for kind, i in _order(cfg):
        if kind == "rec":
            lp = layer_params(params["rec_layers"], i)
            h, _ = rglru_block_decode(
                lp["rec"], norm_apply(lp.get("ln", {}), x, cfg.norm),
                layer_params(cache["rec"], i), rcfg)
            x = _mlp(cfg, lp, x + h, "rec_layers/mlp")
        else:
            lp = layer_params(params["attn_layers"], i)
            h, _ = attn_decode(
                lp["attn"], norm_apply(lp.get("ln", {}), x, cfg.norm),
                layer_params(cache["kv"], i), index, acfg,
                theta=cfg.rope_theta, mode="local", window=cfg.window,
                ring=True)
            x = _mlp(cfg, lp, x + h, "attn_layers/mlp")
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache


def griffin_cuts(cfg: ModelConfig, m: int):
    """The `Cut` tree of a griffin params tree over ``m`` positions."""
    return {**vocab_cuts(cfg, m),
            "rec_layers": {"rec": rglru_cuts(_rcfg(cfg), m),
                           "mlp": mlp_cuts(_mlp_cfg(cfg, "rec_layers/mlp"),
                                           m)},
            "attn_layers": {
                "attn": attn_cuts(_attn_cfg(cfg, "attn_layers/attn"), m),
                "mlp": mlp_cuts(_mlp_cfg(cfg, "attn_layers/mlp"), m)}}


def griffin_cache_cuts(cfg: ModelConfig, cache, mesh):
    c = kv_cache_cut(_attn_cfg(cfg, "attn_layers/attn"),
                     cache["kv"]["k"].shape, mesh)
    return {"rec": rglru_cache_cuts(_rcfg(cfg), mesh.shape["model"]),
            "kv": {"k": c, "v": c}}
