"""Mamba-2 (SSD) language model: attention-free, O(1)-state decode.

The layer parameters and the decode state stay stacked, with (L, ...)
leaves, so a converted reference tree maps onto the port's one to one;
a Python loop over the layers takes the place of the reference's
``lax.scan``, and decode writes each layer's state rows in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (_compute_dtype, _logits, layer_params,
                                   remat, unstack_layers, vocab_cuts)
from repro_torch.nn.layers import (embedding_apply, embedding_def,
                                   norm_apply, norm_def)
from repro_torch.nn.module import stack_defs
from repro_torch.nn.ssm import (MambaConfig, mamba_apply,
                                mamba_cache_cuts, mamba_cuts, mamba_decode,
                                mamba_def, mamba_init_cache)


def _mcfg(cfg: ModelConfig) -> MambaConfig:
    return MambaConfig(cfg.d_model, cfg.d_state, cfg.d_conv, cfg.expand,
                       cfg.headdim, cfg.ssd_chunk, cfg.quant,
                       cfg.quant_plan, "layers/mixer")


def mamba_lm_def(cfg: ModelConfig, dtype=torch.float32):
    return {
        "embed": embedding_def(cfg.vocab, cfg.d_model, dtype),
        "layers": stack_defs({
            "ln": norm_def(cfg.d_model, cfg.norm, dtype),
            "mixer": mamba_def(_mcfg(cfg), dtype)}, cfg.n_layers),
        "final_norm": norm_def(cfg.d_model, cfg.norm, dtype),
    }


def _layer(cfg, mcfg, lp, x):
    return x + mamba_apply(lp["mixer"],
                           norm_apply(lp.get("ln", {}), x, cfg.norm), mcfg)


def forward(params, tokens, cfg: ModelConfig, *, src_embed=None,
            collect_kv: bool = False):
    """Full-sequence forward. tokens (B,S) -> (logits (B,S,V), aux_loss,
    None): there is no KV to collect."""
    x = embedding_apply(params["embed"], tokens).to(_compute_dtype(cfg))
    mcfg = _mcfg(cfg)
    for lp in unstack_layers(params["layers"])[:cfg.n_layers]:
        x = remat(cfg, _layer, cfg, mcfg, lp, x)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), torch.zeros((), device=x.device), None


def mamba_lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, device="cpu"):
    """{"ssm": {"conv": (L,B,d_conv-1,conv_dim) in ``dtype``, "ssm":
    (L,B,H,P,N) float32}}; ``max_len`` does not size a recurrent state."""
    one = mamba_init_cache(_mcfg(cfg), batch, dtype, device)
    return {"ssm": {k: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype,
                                   device=a.device)
                    for k, a in one.items()}}


def decode_step(params, cache, token, index, cfg: ModelConfig, *,
                src_embed=None):
    """One decode step. token (B,1) int; ``index`` is not read (the state
    carries the position). The cache is written in place. Returns (logits
    (B,1,V), cache)."""
    x = embedding_apply(params["embed"], token).to(_compute_dtype(cfg))
    mcfg = _mcfg(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h, _ = mamba_decode(lp["mixer"],
                            norm_apply(lp.get("ln", {}), x, cfg.norm),
                            layer_params(cache["ssm"], i), mcfg)
        x = x + h
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache


def mamba_lm_cuts(cfg: ModelConfig, m: int):
    """The `Cut` tree of a mamba params tree over ``m`` positions."""
    return {**vocab_cuts(cfg, m),
            "layers": {"mixer": mamba_cuts(_mcfg(cfg), m)}}


def mamba_lm_cache_cuts(cfg: ModelConfig, cache, mesh):
    return {"ssm": mamba_cache_cuts(_mcfg(cfg), mesh.shape["model"])}
