"""Decoder LM of the dense family (olmo, phi3, qwen2.5, gemma3).

The layer parameters stay stacked, with (L, ...) leaves, so a converted
reference tree maps onto the port's one to one; a Python loop over the
layers takes the place of the reference's ``lax.scan``, and the
per-layer window and rope theta of a pattern schedule (gemma3's 5 local
: 1 global) are Python values. Mixture-of-Experts and cross-attention
layers arrive with those models (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import (AttnConfig, attn_apply, attn_decode,
                                      attn_def, init_cache)
from repro_torch.nn.layers import (const, dense_apply, dense_def,
                                   embedding_apply, embedding_def,
                                   embedding_logits, norm_apply, norm_def,
                                   padded_vocab, rope_tables)
from repro_torch.nn.mlp import MlpConfig, mlp_apply, mlp_def
from repro_torch.nn.module import stack_defs


def _check_dense(cfg: ModelConfig):
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: Mixture-of-Experts layers are ROADMAP Queue 1 "
            "item 4 (nn/mlp.py::moe_*, kimi-k2 and llama4)")
    if cfg.cross_every:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers are ROADMAP Queue 1 item 4 "
            "(llama-3.2-vision)")


def _attn_cfg(cfg: ModelConfig, path: str = "layers/attn") -> AttnConfig:
    """`path` locates this block in the param tree so the mixed-precision
    plan (cfg.quant_plan) can resolve per-projection bit-widths."""
    return AttnConfig(cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_,
                      qkv_bias=cfg.qkv_bias, kv_quant_bits=cfg.kv_quant_bits,
                      qcfg=cfg.quant, plan=cfg.quant_plan, path=path)


def _mlp_cfg(cfg: ModelConfig, path: str = "layers/mlp") -> MlpConfig:
    return MlpConfig(cfg.d_model, cfg.d_ff, cfg.act, cfg.quant,
                     cfg.quant_plan, path)


def _layer_def(cfg: ModelConfig, dtype):
    return {"ln1": norm_def(cfg.d_model, cfg.norm, dtype),
            "attn": attn_def(_attn_cfg(cfg), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg), dtype)}


def lm_def(cfg: ModelConfig, dtype=torch.float32):
    _check_dense(cfg)
    p = {"embed": embedding_def(cfg.vocab, cfg.d_model, dtype),
         "layers": stack_defs(_layer_def(cfg, dtype), cfg.n_layers),
         "final_norm": norm_def(cfg.d_model, cfg.norm, dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_def(cfg.d_model, padded_vocab(cfg.vocab),
                              ("embed", "vocab"), dtype=dtype)
    return p


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked (L, ...) tree, as views."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _schedule(cfg: ModelConfig, seq_len: int):
    """Per layer (window, uses the local rope): global layers attend over
    ``seq_len``, so one local mask covers pattern schedules."""
    return [(cfg.window if k == "local" else max(seq_len, 1),
             k == "local" and bool(cfg.rope_theta_local))
            for k in cfg.layer_kinds()]


def _compute_dtype(cfg: ModelConfig):
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32)


def _embed(params, tokens, cfg: ModelConfig, dtype):
    x = embedding_apply(params["embed"], tokens).to(dtype)
    if cfg.scale_embed:     # sqrt(d) in the compute dtype, as jax casts it
        x = x * const(cfg.d_model ** 0.5, dtype, x.device)
    return x


def forward(params, tokens, cfg: ModelConfig, *, src_embed=None,
            collect_kv: bool = False):
    """Prefill forward. tokens (B,S) -> logits (B,S,V). Returns (logits,
    aux_loss, (k, v) stacked (L,B,S,Hk,Dh) or None)."""
    _check_dense(cfg)
    dtype = _compute_dtype(cfg)
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg, dtype)
    dev = x.device
    glob = rope_tables(s, cfg.head_dim_, cfg.rope_theta, dtype, dev)
    loc = (rope_tables(s, cfg.head_dim_, cfg.rope_theta_local, dtype, dev)
           if cfg.rope_theta_local else glob)
    acfg, mcfg = _attn_cfg(cfg), _mlp_cfg(cfg)
    ks, vs = [], []
    for i, (window, local_rope) in enumerate(_schedule(cfg, s)):
        lp = layer_params(params["layers"], i)
        cos, sin = loc if local_rope else glob
        h, (k, v) = attn_apply(lp["attn"],
                               norm_apply(lp.get("ln1", {}), x, cfg.norm),
                               acfg, cos=cos, sin=sin, mode="local",
                               window=window)
        x = x + h
        x = x + mlp_apply(lp["mlp"],
                          norm_apply(lp.get("ln2", {}), x, cfg.norm), mcfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return _logits(params, x, cfg), torch.zeros((), device=dev), kvs


def _logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return embedding_logits(params["embed"], x, cfg.vocab)
    lg = dense_apply(params["head"], x)
    vp = lg.shape[-1]
    if vp != cfg.vocab:
        mask = torch.arange(vp, device=lg.device) < cfg.vocab
        lg = torch.where(mask, lg, -1e9)      # -1e9 in lg's dtype
    return lg


# ------------------------------------------------------------- serving ---

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu"):
    _check_dense(cfg)
    one = init_cache(_attn_cfg(cfg), batch, max_len, dtype, device)
    return {"kv": {k: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype,
                                  device=a.device)
                   for k, a in one.items()}}


def decode_step(params, cache, token, index, cfg: ModelConfig, *,
                src_embed=None):
    """One decode step. token (B,1) int; index a scalar or a (B,) vector
    of true positions. The cache is written in place. Returns (logits
    (B,1,V), cache)."""
    _check_dense(cfg)
    dtype = _compute_dtype(cfg)
    max_len = cache["kv"]["k"].shape[2]
    x = _embed(params, token, cfg, dtype)
    th_g = cfg.rope_theta
    th_l = cfg.rope_theta_local or cfg.rope_theta
    acfg, mcfg = _attn_cfg(cfg), _mlp_cfg(cfg)
    for i, (window, local_rope) in enumerate(_schedule(cfg, max_len)):
        lp = layer_params(params["layers"], i)
        kv = layer_params(cache["kv"], i)
        h, _ = attn_decode(lp["attn"],
                           norm_apply(lp.get("ln1", {}), x, cfg.norm), kv,
                           index, acfg, theta=th_l if local_rope else th_g,
                           mode="local", window=window)
        x = x + h
        x = x + mlp_apply(lp["mlp"],
                          norm_apply(lp.get("ln2", {}), x, cfg.norm), mcfg)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache
