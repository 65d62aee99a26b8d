"""Encoder-decoder LM (the seamless-m4t-large-v2 backbone).

The audio frontend is a stub: callers pass precomputed frame embeddings
(B, S_src, d). The encoder is a bidirectional transformer over those
frames (RoPE applied); the decoder is a causal transformer whose layers
also attend into the encoder states, projected once per layer to cross
K/V by `cross_kv_project` with ``dec_layers/xattn``'s weights. The
stacked ``enc_layers`` / ``dec_layers`` leaves are walked by Python loops
in place of the reference's ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (_attn_cfg, _compute_dtype, _logits,
                                   _mlp_cfg, layer_params, remat,
                                   unstack_layers, vocab_cuts)
from repro_torch.nn.attention import (attn_apply, attn_cuts, attn_decode,
                                      attn_def, cross_kv_project,
                                      init_cache, kv_cache_cut)
from repro_torch.nn.layers import (embedding_apply, embedding_def,
                                   norm_apply, norm_def, rope_tables)
from repro_torch.nn.mlp import mlp_apply, mlp_cuts, mlp_def
from repro_torch.nn.module import stack_defs


def _enc_layer_def(cfg, dtype):
    return {"ln1": norm_def(cfg.d_model, cfg.norm, dtype),
            "attn": attn_def(_attn_cfg(cfg, "enc_layers/attn"), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg, "enc_layers/mlp"), dtype)}


def _dec_layer_def(cfg, dtype):
    return {"ln1": norm_def(cfg.d_model, cfg.norm, dtype),
            "attn": attn_def(_attn_cfg(cfg, "dec_layers/attn"), dtype),
            "lnx": norm_def(cfg.d_model, cfg.norm, dtype),
            "xattn": attn_def(_attn_cfg(cfg, "dec_layers/xattn"), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg, "dec_layers/mlp"), dtype)}


def encdec_def(cfg: ModelConfig, dtype=torch.float32):
    return {
        "embed": embedding_def(cfg.vocab, cfg.d_model, dtype),
        "enc_layers": stack_defs(_enc_layer_def(cfg, dtype), cfg.enc_layers),
        "enc_norm": norm_def(cfg.d_model, cfg.norm, dtype),
        "dec_layers": stack_defs(_dec_layer_def(cfg, dtype), cfg.dec_layers),
        "final_norm": norm_def(cfg.d_model, cfg.norm, dtype),
    }


def encode(params, src_embed, cfg: ModelConfig):
    """Frame embeddings (B, S_src, d) -> encoder states in the compute
    dtype."""
    dtype = _compute_dtype(cfg)
    x = src_embed.to(dtype)
    cos, sin = rope_tables(x.shape[1], cfg.head_dim_, cfg.rope_theta, dtype,
                           x.device)
    acfg = _attn_cfg(cfg, "enc_layers/attn")
    mcfg = _mlp_cfg(cfg, "enc_layers/mlp")
    for lp in unstack_layers(params["enc_layers"])[:cfg.enc_layers]:
        x = remat(cfg, _enc_layer, cfg, acfg, mcfg, lp, x, cos, sin)
    return norm_apply(params.get("enc_norm", {}), x, cfg.norm)


def _enc_layer(cfg, acfg, mcfg, lp, x, cos, sin):
    h, _ = attn_apply(lp["attn"], norm_apply(lp.get("ln1", {}), x, cfg.norm),
                      acfg, cos=cos, sin=sin, mode="bidir")
    x = x + h
    return x + mlp_apply(lp["mlp"], norm_apply(lp.get("ln2", {}), x,
                                               cfg.norm), mcfg)


def _dec_layer(cfg, acfg, acfg_x, mcfg, lp, x, enc_out, cos, sin):
    h, _ = attn_apply(lp["attn"], norm_apply(lp.get("ln1", {}), x, cfg.norm),
                      acfg, cos=cos, sin=sin, mode="causal")
    x = x + h
    src_kv = cross_kv_project(lp["xattn"], enc_out, acfg_x)
    h, _ = attn_apply(lp["xattn"], norm_apply(lp.get("lnx", {}), x,
                                              cfg.norm),
                      acfg_x, cos=None, sin=None, mode="bidir",
                      cross_kv=src_kv)
    x = x + h
    return x + mlp_apply(lp["mlp"], norm_apply(lp.get("ln2", {}), x,
                                               cfg.norm), mcfg)


def decode_train(params, enc_out, tokens, cfg: ModelConfig):
    """Teacher-forced decoder pass in ``enc_out``'s dtype -> logits
    (B,S,V)."""
    dtype = enc_out.dtype
    x = embedding_apply(params["embed"], tokens).to(dtype)
    cos, sin = rope_tables(tokens.shape[1], cfg.head_dim_, cfg.rope_theta,
                           dtype, x.device)
    acfg = _attn_cfg(cfg, "dec_layers/attn")
    acfg_x = _attn_cfg(cfg, "dec_layers/xattn")
    mcfg = _mlp_cfg(cfg, "dec_layers/mlp")
    for lp in unstack_layers(params["dec_layers"])[:cfg.dec_layers]:
        x = remat(cfg, _dec_layer, cfg, acfg, acfg_x, mcfg, lp, x, enc_out,
                  cos, sin)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg)


def forward(params, tokens, cfg: ModelConfig, *, src_embed=None,
            collect_kv: bool = False):
    """Frames -> text: encode ``src_embed``, then the teacher-forced
    decoder. Returns (logits, aux_loss, None): decode fills its cross
    cache from `encode` instead."""
    if src_embed is None:
        raise ValueError(f"{cfg.name} needs src_embed input")
    enc_out = encode(params, src_embed, cfg)
    logits = decode_train(params, enc_out, tokens, cfg)
    return logits, torch.zeros((), device=logits.device), None


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu"):
    """{"kv": {k, v} of (dec_layers, B, max_len, Hk, Dh), "cross_kv":
    (dec_layers, 2, B, src_len, Hk, Dh)}; the cross K/V are zero until a
    caller fills them from `encode` through `cross_kv_project`."""
    acfg = _attn_cfg(cfg)
    one = init_cache(acfg, batch, max_len, dtype, device)
    return {
        "kv": {k: torch.zeros((cfg.dec_layers,) + a.shape, dtype=a.dtype,
                              device=a.device) for k, a in one.items()},
        "cross_kv": torch.zeros(
            (cfg.dec_layers, 2, batch, cfg.src_len, acfg.kv_heads,
             acfg.head_dim), dtype=dtype, device=device),
    }


def source_kv(params, src_embed, cfg: ModelConfig):
    """The cross cache for ``src_embed`` (B, S_src, d): `encode`'s states
    through each decoder layer's ``dec_layers/xattn`` K/V projection,
    stacked (dec_layers, 2, B, S_src, Hk, Dh)."""
    enc = encode(params, src_embed, cfg)
    acfg_x = _attn_cfg(cfg, "dec_layers/xattn")
    return torch.stack([torch.stack(cross_kv_project(
        layer_params(params["dec_layers"], i)["xattn"], enc, acfg_x))
        for i in range(cfg.dec_layers)])


def decode_step(params, cache, token, index, cfg: ModelConfig, *,
                src_embed=None):
    """One decoder token step over the cached self and cross K/V; the
    self cache is written in place. Returns (logits (B,1,V), cache)."""
    dtype = _compute_dtype(cfg)
    x = embedding_apply(params["embed"], token).to(dtype)
    acfg = _attn_cfg(cfg, "dec_layers/attn")
    acfg_x = _attn_cfg(cfg, "dec_layers/xattn")
    mcfg = _mlp_cfg(cfg, "dec_layers/mlp")
    for i in range(cfg.dec_layers):
        lp = layer_params(params["dec_layers"], i)
        h, _ = attn_decode(lp["attn"], norm_apply(lp.get("ln1", {}), x,
                                                  cfg.norm),
                           layer_params(cache["kv"], i), index, acfg,
                           theta=cfg.rope_theta, mode="causal")
        x = x + h
        xkv = cache["cross_kv"][i]
        h, _ = attn_decode(lp["xattn"], norm_apply(lp.get("lnx", {}), x,
                                                   cfg.norm),
                           None, index, acfg_x, mode="bidir",
                           cross_kv=(xkv[0], xkv[1]))
        x = x + h
        x = x + mlp_apply(lp["mlp"], norm_apply(lp.get("ln2", {}), x,
                                                cfg.norm), mcfg)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache


def encdec_cuts(cfg: ModelConfig, m: int):
    """The `Cut` tree of an enc-dec params tree over ``m`` positions."""
    def mlp(path):
        return mlp_cuts(_mlp_cfg(cfg, path), m)
    return {**vocab_cuts(cfg, m),
            "enc_layers": {"attn": attn_cuts(_attn_cfg(cfg,
                                                       "enc_layers/attn"), m),
                           "mlp": mlp("enc_layers/mlp")},
            "dec_layers": {"attn": attn_cuts(_attn_cfg(cfg,
                                                       "dec_layers/attn"), m),
                           "xattn": attn_cuts(
                               _attn_cfg(cfg, "dec_layers/xattn"), m),
                           "mlp": mlp("dec_layers/mlp")}}


def encdec_cache_cuts(cfg: ModelConfig, cache, mesh):
    c = kv_cache_cut(_attn_cfg(cfg, "dec_layers/attn"),
                     cache["kv"]["k"].shape, mesh)
    return {"kv": {"k": c, "v": c},
            "cross_kv": kv_cache_cut(_attn_cfg(cfg, "dec_layers/xattn"),
                                     cache["cross_kv"].shape, mesh)}
