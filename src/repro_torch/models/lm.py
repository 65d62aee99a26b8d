"""Decoder LM of the dense family (olmo, phi3, qwen2.5, gemma3), the
Mixture-of-Experts LMs (kimi-k2, llama4, kimi-k2-instruct) and the vision
cross-attention LM (llama-3.2-vision).

The layer parameters stay stacked, with (L, ...) leaves, so a converted
reference tree maps onto the port's one to one; a Python loop over the
layers takes the place of the reference's ``lax.scan``, and the
per-layer window and rope theta of a pattern schedule (gemma3's 5 local
: 1 global) are Python values. A vision arch runs groups of
``cross_every`` self layers then one cross layer that attends into the
projected source embeddings: self layer j of group g is stacked row
``g * cross_every + j``. A MoE arch's layers hold a ``moe`` block in
place of the ``mlp`` one; the forward returns the sum of their Switch
aux losses. An arch with ``first_dense_layers`` (kimi-k2-instruct) runs
those first, from a second stacked tree ``dense_layers`` whose layers
hold an ``mlp`` of width ``dense_d_ff``, then the MoE layers of
``layers``. A latent-attention arch (``kv_lora_rank`` > 0, `nn/mla.py`)
holds an MLA block in every layer's ``attn``; its prefill returns, and
its decode cache holds, the latent (c_kv, k_pe) of every layer, dense
layers first, in place of per-head K/V.

Under tensor parallelism (`repro_torch.parallel.tp`, an ambient
`TPGroup`) every block splits its own work (`nn/attention.py`,
`nn/mlp.py`); the embedding and the logits are vocab-parallel (each
position its table rows or head columns, the logits gathered on the
leader for sampling); the norms and the residual stay replicated on the
leader. `lm_cuts` is the whole tree's split, which serving places once.

Spans (`repro_torch.obs`) of the prefill forward, one after another:
``lm/embed``; per meshless dense self layer, and per latent-attention
layer, ``lm/attn.qkv``, ``lm/attn.core``, ``lm/attn.out``, then
``lm/mlp`` for a dense FFN, or for a dropless MoE block ``lm/moe.route``
(ln2, router, selection, grouping, the count read), ``lm/moe.experts``
(the held experts' GEMMs) and ``lm/moe.shared`` (combine, shared expert,
residual add); ``lm/head``. Layers under tensor parallelism, cross
layers and the capacity MoE layers open none.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import (AttnConfig, attn_apply, attn_core,
                                      attn_cuts, attn_decode, attn_def,
                                      attn_qkv, cross_kv_project, init_cache,
                                      kv_cache_cut)
from repro_torch.nn.layers import (QOFF, const, dense_apply, dense_col,
                                   dense_cuts, dense_def, embedding_apply,
                                   embedding_def, embedding_logits,
                                   mask_vocab, norm_apply, norm_def,
                                   padded_vocab, rope_tables, vocab_runs)
from repro_torch.nn.mla import (MlaConfig, init_latent_cache, mla_core,
                                mla_decode, mla_def, mla_qkv)
from repro_torch.nn.mlp import (MlpConfig, MoeConfig, mlp_apply, mlp_cuts,
                                mlp_def, moe_apply, moe_cuts, moe_def,
                                moe_held_apply)
from repro_torch.nn.module import stack_defs
from repro_torch.obs import trace as obs
from repro_torch.parallel import tp


def _attn_cfg(cfg: ModelConfig, path: str = "layers/attn") -> AttnConfig:
    """`path` locates this block in the param tree so the mixed-precision
    plan (cfg.quant_plan) can resolve per-projection bit-widths."""
    return AttnConfig(cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_,
                      qkv_bias=cfg.qkv_bias, kv_quant_bits=cfg.kv_quant_bits,
                      qcfg=cfg.quant, plan=cfg.quant_plan, path=path)


def _mla_cfg(cfg: ModelConfig, path: str = "layers/attn") -> MlaConfig:
    return MlaConfig(cfg.d_model, cfg.n_heads, cfg.q_lora_rank,
                     cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim, cfg.rope_theta, cfg.rope_scaling,
                     cfg.quant, cfg.quant_plan, path)


def _mlp_cfg(cfg: ModelConfig, path: str = "layers/mlp") -> MlpConfig:
    d_ff = cfg.dense_d_ff if path.startswith("dense_layers/") else cfg.d_ff
    return MlpConfig(cfg.d_model, d_ff, cfg.act, cfg.quant,
                     cfg.quant_plan, path)


def _moe_cfg(cfg: ModelConfig, path: str = "layers/moe") -> MoeConfig:
    m = cfg.moe
    return MoeConfig(cfg.d_model, m.d_ff, m.n_experts, m.top_k,
                     m.capacity_factor, m.group_size, m.shared_expert,
                     cfg.act, cfg.quant, cfg.quant_plan, path, m.scoring,
                     m.norm_topk, m.routed_scale, m.experts_held,
                     m.experts_offset)


def _layer_def(cfg: ModelConfig, dtype, stack: str = "layers"):
    """One layer of the ``stack`` tree (``layers``, or ``dense_layers``
    whose FFN is always a dense MLP)."""
    p = {"ln1": norm_def(cfg.d_model, cfg.norm, dtype),
         "attn": (mla_def(_mla_cfg(cfg, f"{stack}/attn"), dtype) if cfg.mla
                  else attn_def(_attn_cfg(cfg, f"{stack}/attn"), dtype)),
         "ln2": norm_def(cfg.d_model, cfg.norm, dtype)}
    if cfg.moe is not None and stack == "layers":
        p["moe"] = moe_def(_moe_cfg(cfg), dtype)
    else:
        p["mlp"] = mlp_def(_mlp_cfg(cfg, f"{stack}/mlp"), dtype)
    return p


def _cross_layer_def(cfg: ModelConfig, dtype):
    return {"ln1": norm_def(cfg.d_model, cfg.norm, dtype),
            "xattn": attn_def(_attn_cfg(cfg, "cross_layers/xattn"), dtype),
            "ln2": norm_def(cfg.d_model, cfg.norm, dtype),
            "mlp": mlp_def(_mlp_cfg(cfg, "cross_layers/mlp"), dtype)}


def _layer_split(cfg: ModelConfig):
    """(self layers, cross layers): n_layers counts both kinds, one cross
    layer after every ``cross_every`` self layers (100 -> (80, 20)), and
    the leading dense layers, which neither counts."""
    if cfg.cross_every:
        n_cross = cfg.n_layers // (cfg.cross_every + 1)
        return cfg.n_layers - n_cross, n_cross
    return cfg.n_layers - cfg.first_dense_layers, 0


def lm_def(cfg: ModelConfig, dtype=torch.float32):
    if cfg.rope_scaling is not None and not cfg.mla:
        raise NotImplementedError(f"{cfg.name}: rope scaling is served on "
                                  "latent attention only")
    if cfg.first_dense_layers and (cfg.moe is None or not cfg.mla):
        raise NotImplementedError(f"{cfg.name}: leading dense layers are "
                                  "served before MoE layers of latent "
                                  "attention only")
    n_self, n_cross = _layer_split(cfg)
    p = {"embed": embedding_def(cfg.vocab, cfg.d_model, dtype),
         "layers": stack_defs(_layer_def(cfg, dtype), n_self),
         "final_norm": norm_def(cfg.d_model, cfg.norm, dtype)}
    if cfg.first_dense_layers:
        p["dense_layers"] = stack_defs(
            _layer_def(cfg, dtype, "dense_layers"), cfg.first_dense_layers)
    if n_cross:
        p["cross_layers"] = stack_defs(_cross_layer_def(cfg, dtype), n_cross)
    if not cfg.tie_embeddings:
        p["head"] = dense_def(cfg.d_model, padded_vocab(cfg.vocab),
                              ("embed", "vocab"), dtype=dtype)
    return p


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked (L, ...) tree, as views."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def unstack_layers(stacked) -> list:
    """Every layer of a stacked (L, ...) tree, sliced once per leaf with
    ``torch.unbind`` (views, as `layer_params` gives): its backward is one
    ``stack``, where indexing per layer would make one zero gradient the
    size of the whole stack per layer."""
    if isinstance(stacked, dict):      # an empty subtree (a norm without
        per = {k: unstack_layers(v)     # params) stays {} in every layer
               for k, v in stacked.items()}
        n = max((len(v) for v in per.values()), default=0)
        return [{k: v[i] if v else {} for k, v in per.items()}
                for i in range(n)]
    if isinstance(stacked, tp.Split):
        return stacked.unbind()
    return list(torch.unbind(stacked, 0))


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` and autograd recording, its
    activations are recomputed in the backward instead of kept (the
    reference's ``jax.checkpoint``: memory changes, values do not).
    The recomputation runs under the forward's tensor-parallel group:
    autograd may run it on a thread of its own, where the forward's
    context variables are not set."""
    if cfg.remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        grp = tp.ambient()
        if grp is not None:
            fn = functools.partial(_in_scope, grp, fn)
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _in_scope(grp, fn, *args):
    with tp.tp_scope(grp):
        return fn(*args)


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


def _cross_mlp(cfg, xp, x, h):
    """A cross layer's residual add of its attention output ``h``, then
    its MLP block."""
    x = x + h
    return x + mlp_apply(xp["mlp"],
                         norm_apply(xp.get("ln2", {}), x, cfg.norm),
                         _mlp_cfg(cfg, "cross_layers/mlp"))


def _ffn(cfg: ModelConfig, lp, x, stack: str = "layers"):
    """A self layer's FFN block on the residual ``x``: (x + its output,
    the block's aux loss, a float32 0-dim tensor or 0.0 for a dense MLP
    or a dropless MoE block, which opens its spans: module docstring).
    ``stack`` names the layer's tree (``dense_layers``: the MLP at
    ``dense_d_ff``)."""
    if "moe" in lp and cfg.moe.experts_held:
        with obs.span("lm/moe.route"):
            h = norm_apply(lp.get("ln2", {}), x, cfg.norm)
        y = moe_held_apply(lp["moe"], h, _moe_cfg(cfg))
        with obs.span("lm/moe.shared"):
            return x + y, 0.0
    h = norm_apply(lp.get("ln2", {}), x, cfg.norm)
    if "moe" in lp:
        y, aux = moe_apply(lp["moe"], h, _moe_cfg(cfg))
        return x + y, aux
    return x + mlp_apply(lp["mlp"], h, _mlp_cfg(cfg, f"{stack}/mlp")), 0.0


def _ropes(cfg: ModelConfig, seq_len: int, dtype, device):
    """(global, local) rope tables (cos, sin) over ``seq_len`` positions;
    the local ones are the global ones when the arch has no local
    theta. A latent-attention arch rotates its qk_rope_dim part, with
    YaRN where the config scales rope."""
    dim = cfg.qk_rope_dim if cfg.mla else cfg.head_dim_
    glob = rope_tables(seq_len, dim, cfg.rope_theta, dtype, device,
                       cfg.rope_scaling)
    loc = (rope_tables(seq_len, dim, cfg.rope_theta_local, dtype,
                       device) if cfg.rope_theta_local else glob)
    return glob, loc


def _block(cfg: ModelConfig, lp, x, cos, sin, window, stack="layers"):
    """One pre-norm self layer on the residual ``x`` with layer params
    ``lp`` of the ``stack`` tree: (x, its aux loss, (k, v), or the latent
    (c_kv, k_pe) of a latent-attention layer). The forward and the
    calibration replay (`deploy/calibrate.py`) both run it. A meshless
    dense layer and every latent-attention layer run their parts in
    their spans (module docstring)."""
    if cfg.mla:
        return _mla_block(cfg, lp, x, cos, sin, stack)
    acfg = _attn_cfg(cfg)
    if "moe" in lp or tp.tp_group() is not None:
        h, kv = attn_apply(lp["attn"],
                           norm_apply(lp.get("ln1", {}), x, cfg.norm), acfg,
                           cos=cos, sin=sin, mode="local", window=window)
        x, aux = _ffn(cfg, lp, x + h)
        return x, aux, kv
    with obs.span("lm/attn.qkv"):
        q, k, v = attn_qkv(lp["attn"],
                           norm_apply(lp.get("ln1", {}), x, cfg.norm), acfg,
                           cos=cos, sin=sin)
    with obs.span("lm/attn.core"):
        out = attn_core(q, k, v, mode="local", window=window)
    with obs.span("lm/attn.out"):
        x = x + dense_apply(lp["attn"]["wo"], out, qcfg=acfg.q("wo"))
    with obs.span("lm/mlp"):
        x, aux = _ffn(cfg, lp, x, stack)
    return x, aux, (k, v)


def _mla_block(cfg: ModelConfig, lp, x, cos, sin, stack: str):
    mcfg = _mla_cfg(cfg, f"{stack}/attn")
    with obs.span("lm/attn.qkv"):
        q, k, v, c_kv, k_pe = mla_qkv(
            lp["attn"], norm_apply(lp.get("ln1", {}), x, cfg.norm), mcfg,
            cos=cos, sin=sin)
    with obs.span("lm/attn.core"):
        out = mla_core(q, k, v, mcfg)
        del q, k, v
    with obs.span("lm/attn.out"):
        x = x + dense_apply(lp["attn"]["wo"], out, qcfg=mcfg.q("wo"))
    if "moe" in lp:
        x, aux = _ffn(cfg, lp, x, stack)
    else:
        with obs.span("lm/mlp"):
            x, aux = _ffn(cfg, lp, x, stack)
    return x, aux, (c_kv, k_pe)


def _cross_block(cfg: ModelConfig, xp, x, src, acfg_x):
    """One cross layer on the residual ``x`` attending into ``src``."""
    h, _ = attn_apply(xp["xattn"], norm_apply(xp.get("ln1", {}), x, cfg.norm),
                      acfg_x, cos=None, sin=None, mode="bidir",
                      cross_kv=cross_kv_project(xp["xattn"], src, acfg_x))
    return _cross_mlp(cfg, xp, x, h)


def _order(cfg: ModelConfig):
    """The layer order: ("dense", i) | ("self", i) | ("cross", g) over
    the stacked indices; the leading dense layers first; a vision arch's
    group g is self rows g*ce .. g*ce + ce - 1, then cross layer g."""
    n_self, n_cross = _layer_split(cfg)
    if not n_cross:
        return ([("dense", i) for i in range(cfg.first_dense_layers)]
                + [("self", i) for i in range(n_self)])
    ce = cfg.cross_every
    out = []
    for g in range(n_cross):
        out += [("self", g * ce + j) for j in range(ce)] + [("cross", g)]
    return out


_STACK = {"dense": "dense_layers", "self": "layers"}


def forward(params, tokens, cfg: ModelConfig, *, src_embed=None,
            collect_kv: bool = False):
    """Prefill forward. tokens (B,S) -> logits (B,S,V). ``src_embed``
    (B, S_src, d): the frontend's embeddings a vision arch attends into.
    Returns (logits, aux_loss, (k, v) stacked (L,B,S,Hk,Dh), for a
    latent-attention arch (c_kv (L,B,S,rkv), k_pe (L,B,S,rope)), or None
    when not collected or for a vision arch)."""
    dtype = _compute_dtype(cfg)
    s = tokens.shape[1]
    with obs.span("lm/embed"):
        x = _embed(params, tokens, cfg, dtype)
        dev = x.device
        glob, loc = _ropes(cfg, s, dtype, dev)
        acfg_x = _attn_cfg(cfg, "cross_layers/xattn")
        cross = _layer_split(cfg)[1] > 0
        if cross:
            if src_embed is None:
                raise ValueError(f"{cfg.name} needs src_embed input")
            src = src_embed.to(dtype)
        sched = _schedule(cfg, s)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        stacks = {"self": unstack_layers(params["layers"])}
        if cfg.first_dense_layers:
            stacks["dense"] = unstack_layers(params["dense_layers"])
        xlayers = unstack_layers(params["cross_layers"]) if cross else []
    ks, vs = [], []
    j = 0                          # attention layers so far (dense, self)
    for kind, i in _order(cfg):
        if kind == "cross":
            x = remat(cfg, _cross_block, cfg, xlayers[i], x, src, acfg_x)
            continue
        window, local_rope = sched[j]
        cos, sin = loc if local_rope else glob
        x, a, (k, v) = remat(cfg, _block, cfg, stacks[kind][i], x, cos, sin,
                             window, _STACK[kind])
        j += 1
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    with obs.span("lm/head"):
        x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
        kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv and not cross \
            else None
        logits = _logits(params, x, cfg)
    return logits, aux, kvs


def _logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return embedding_logits(params["embed"], x, cfg.vocab)
    grp = tp.tp_group()
    if grp is None:
        lg = dense_apply(params["head"], x)
    else:
        vp = padded_vocab(cfg.vocab)
        runs = vocab_runs(vp, grp.m)
        lg = tp.join(dense_col(params["head"], x, qcfg=QOFF, runs=runs,
                               group=grp, k_full=cfg.d_model),
                     runs, -1, vp, grp.leader)
    return mask_vocab(lg, lg.shape[-1], cfg.vocab)


def vocab_cuts(cfg: ModelConfig, m: int):
    """The embedding table's rows and an untied head's columns over the
    model axis."""
    runs = vocab_runs(padded_vocab(cfg.vocab), m)
    out = {"embed": {"table": tp.Cut(-2, runs)}}
    if not cfg.tie_embeddings:
        out["head"] = dense_cuts(QOFF, "col", runs, cfg.d_model)
    return out


def _no_tp(cfg: ModelConfig):
    if cfg.mla or (cfg.moe is not None and cfg.moe.experts_held):
        raise NotImplementedError(
            f"{cfg.name}: latent attention and the dropless MoE dispatch "
            "have no tensor-parallel layout")


def lm_cache_cuts(cfg: ModelConfig, cache, mesh):
    """The `Cut` tree of a decode cache (`lm_init_cache`) over
    ``mesh``'s model positions."""
    _no_tp(cfg)
    c = kv_cache_cut(_attn_cfg(cfg), cache["kv"]["k"].shape, mesh)
    out = {"kv": {"k": c, "v": c}}
    if "cross_kv" in cache:
        out["cross_kv"] = kv_cache_cut(_attn_cfg(cfg, "cross_layers/xattn"),
                                       cache["cross_kv"].shape, mesh)
    return out


def lm_cuts(cfg: ModelConfig, m: int):
    """The `Cut` tree of an ``lm`` params tree over ``m`` model
    positions."""
    _no_tp(cfg)
    layer = {"attn": attn_cuts(_attn_cfg(cfg), m)}
    if cfg.moe is not None:
        layer["moe"] = moe_cuts(_moe_cfg(cfg), m)
    else:
        layer["mlp"] = mlp_cuts(_mlp_cfg(cfg), m)
    out = {**vocab_cuts(cfg, m), "layers": layer}
    if _layer_split(cfg)[1]:
        out["cross_layers"] = {
            "xattn": attn_cuts(_attn_cfg(cfg, "cross_layers/xattn"), m),
            "mlp": mlp_cuts(_mlp_cfg(cfg, "cross_layers/mlp"), m)}
    return out


# ------------------------------------------------------------- serving ---

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu"):
    """{"kv": {k, v} of (n_self, B, max_len, Hk, Dh)}, and for a vision
    arch "cross_kv" (n_cross, 2, B, src_len, Hk, Dh): the source K/V each
    cross layer attends into (filled by `cross_kv_project`; zero
    otherwise). A latent-attention arch: {"latent": {c_kv (L, B,
    max_len, rkv), k_pe (L, B, max_len, rope)}} over every layer, the
    leading dense ones first."""
    n_self, n_cross = _layer_split(cfg)
    if cfg.mla:
        one = init_latent_cache(_mla_cfg(cfg), batch, max_len, dtype,
                                device)
        n = n_self + cfg.first_dense_layers
        return {"latent": {k: torch.zeros((n,) + a.shape, dtype=a.dtype,
                                          device=a.device)
                           for k, a in one.items()}}
    acfg = _attn_cfg(cfg)
    one = init_cache(acfg, batch, max_len, dtype, device)
    cache = {"kv": {k: torch.zeros((n_self,) + a.shape, dtype=a.dtype,
                                   device=a.device)
                    for k, a in one.items()}}
    if n_cross:
        cache["cross_kv"] = torch.zeros(
            (n_cross, 2, batch, cfg.src_len, acfg.kv_heads, acfg.head_dim),
            dtype=dtype, device=device)
    return cache


def source_kv(params, src_embed, cfg: ModelConfig):
    """The cross cache of a vision arch for ``src_embed`` (B, S_src, d):
    each cross layer's ``cross_layers/xattn`` K/V projection, stacked
    (n_cross, 2, B, S_src, Hk, Dh) in the compute dtype."""
    src = src_embed.to(_compute_dtype(cfg))
    acfg_x = _attn_cfg(cfg, "cross_layers/xattn")
    return torch.stack([torch.stack(cross_kv_project(
        layer_params(params["cross_layers"], g)["xattn"], src, acfg_x))
        for g in range(_layer_split(cfg)[1])])


def decode_step(params, cache, token, index, cfg: ModelConfig, *,
                src_embed=None):
    """One decode step. token (B,1) int; index a scalar or a (B,) vector
    of true positions. The self-attention cache is written in place; the
    cross layers read ``cache["cross_kv"]`` as it is (``src_embed`` is
    not read: the cache carries the source). A MoE layer's aux loss is
    dropped. Returns (logits (B,1,V), cache)."""
    if cfg.mla:
        return _decode_mla(params, cache, token, index, cfg)
    dtype = _compute_dtype(cfg)
    max_len = tp.full_len(cache["kv"]["k"], -3)
    x = _embed(params, token, cfg, dtype)
    th_g = cfg.rope_theta
    th_l = cfg.rope_theta_local or cfg.rope_theta
    acfg = _attn_cfg(cfg)
    acfg_x = _attn_cfg(cfg, "cross_layers/xattn")
    sched = _schedule(cfg, max_len)
    for kind, i in _order(cfg):
        if kind == "cross":
            xp = layer_params(params["cross_layers"], i)
            xkv = cache["cross_kv"][i]
            h, _ = attn_decode(xp["xattn"],
                               norm_apply(xp.get("ln1", {}), x, cfg.norm),
                               None, index, acfg_x, mode="bidir",
                               cross_kv=(xkv[0], xkv[1]))
            x = _cross_mlp(cfg, xp, x, h)
            continue
        window, local_rope = sched[i]
        lp = layer_params(params["layers"], i)
        h, _ = attn_decode(lp["attn"],
                           norm_apply(lp.get("ln1", {}), x, cfg.norm),
                           layer_params(cache["kv"], i), index, acfg,
                           theta=th_l if local_rope else th_g,
                           mode="local", window=window)
        x, _ = _ffn(cfg, lp, x + h)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache


def _decode_mla(params, cache, token, index, cfg: ModelConfig):
    """`decode_step` of a latent-attention arch over its latent cache."""
    x = _embed(params, token, cfg, _compute_dtype(cfg))
    for j, (kind, i) in enumerate(_order(cfg)):
        stack = _STACK[kind]
        lp = layer_params(params[stack], i)
        h, _ = mla_decode(lp["attn"],
                          norm_apply(lp.get("ln1", {}), x, cfg.norm),
                          layer_params(cache["latent"], j), index,
                          _mla_cfg(cfg, f"{stack}/attn"))
        x, _ = _ffn(cfg, lp, x + h, stack)
    x = norm_apply(params.get("final_norm", {}), x, cfg.norm)
    return _logits(params, x, cfg), cache


def cache_from_prefill(cfg: ModelConfig, kvs, max_len: int,
                       dtype=torch.bfloat16):
    """The latent decode cache of a latent-attention arch, ``max_len``
    positions, holding what `Model.prefill` returned for a (B, S) prompt
    (its ``kvs``: c_kv, k_pe) at positions [0, S); decoding goes on at
    position S."""
    if not cfg.mla:
        raise NotImplementedError(f"{cfg.name}: a prefill fills the latent "
                                  "cache of latent attention only")
    c_kv, k_pe = kvs
    cache = lm_init_cache(cfg, c_kv.shape[1], max_len, dtype, c_kv.device)
    s = c_kv.shape[2]
    cache["latent"]["c_kv"][:, :, :s] = c_kv
    cache["latent"]["k_pe"][:, :, :s] = k_pe
    return cache
