"""Plain reference of a DeepSeek-V3-block LM (Kimi-K2-Instruct): multi-head
latent attention, leading dense layers, then sigmoid-routed MoE layers,
served with packed integer dense layers.

The model, as DeepSeek-V3's public ``modeling_deepseek.py`` writes it,
over configuration keys of the published ``config.json``:
token embedding; per layer RMSNorm, then latent attention: q = wq_b(RMSNorm
(wq_a(h))) split per head into nope and rope parts; wkv_a(h) split into
the latent c_kv (kv_lora_rank), RMSNorm'd, and one shared rotary key k_pe;
wkv_b(c_kv) split per head into k_nope and v; the rope parts rotated
with YaRN's frequencies (``yarn_find_correction_range``,
``yarn_linear_ramp_mask``; cos / sin times mscale(factor, mscale) /
mscale(factor, mscale_all_dim)); scores (nope . nope + rope . rope)
times (nope + rope)^-0.5 x mscale(factor, mscale_all_dim)^2 under a
causal mask, softmax, values, wo. Then RMSNorm and the FFN: for the first
``first_k_dense_replace`` layers a SwiGLU MLP (silu(gate) x up); after
them the MoE block: float32 router logits, sigmoid scores, the top-k of
the scores plus the selection-only ``e_score_correction_bias`` (one group,
so no group limit), weights the chosen scores renormalised to sum 1
(``norm_topk_prob``) times ``routed_scaling_factor``, each chosen expert a
SwiGLU of ``moe_intermediate_size``, their weighted outputs summed in
float32, plus the shared expert. A final RMSNorm and the untied head.

Expert parallelism's share: the layer's routed experts are given as
those held on one device (a stack of ``E_held`` experts, experts
``experts_offset`` .. ``experts_offset + E_held - 1`` of the router's
outputs); a choice of any other expert adds nothing, as on that device.

Served W{w_bits}A{a_bits}: every projection of attention, the dense
MLP, the shared and the routed experts on per-output-channel symmetric
weight grids (scale = absmax / (2^(w_bits-1) - 1)), its input on the
static symmetric grid (absmax / (2^(a_bits-1) - 1), codes within +-127),
the integer product exact (float32 products of the integer codes, whose
sums stay below 2^24 up to K = 18,432: 127 x 7 x 18,432 < 2^24), then
dequantized in float32 with w_scale x a_scale and rounded to the compute
dtype (bfloat16). The router, norms, embedding and head are float. The
reference works all of this out from the float weights itself.

Departures from the published description: the rope dims rotate
rotate-half (the first half against the second) where the released
weights' rope dims are interleaved pairs; under random weights this is
a fixed permutation of wq_b's and wkv_a's rope columns. Attention
products are float32 matmuls (TF32 off), one batch row at a time; the
head is a float32 product of bfloat16-rounded operands. No cache, no
kernels. It imports neither the port nor the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def _dtype(cfg):
    return torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" \
        else torch.float32


def rms_norm(x, scale, eps: float):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _log(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float64).log())


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * _log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos):
    return (dim * _log(max_pos / (rotations * 2 * torch.pi))) \
        / (2 * _log(base))


def inv_freq(cfg, device):
    """The rope pairs' frequencies (dim / 2,), float32."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / torch.pow(torch.tensor(base, device=device), expo)
    ys = cfg.get("rope_scaling")
    if not ys:
        return extra
    factor = float(ys["factor"])
    inter = 1.0 / (factor * torch.pow(torch.tensor(base, device=device),
                                      expo))
    max_pos = ys["original_max_position_embeddings"]
    low = max(int(_correction_dim(ys["beta_fast"], dim, base,
                                  max_pos) // 1), 0)
    high = min(-int(-_correction_dim(ys["beta_slow"], dim, base,
                                     max_pos) // 1), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_tables(cfg, seq: int, dtype, device):
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device),
                      inv_freq(cfg, device))
    ys = cfg.get("rope_scaling")
    m = 1.0
    if ys:
        m = (_yarn_mscale(ys["factor"], ys.get("mscale", 1))
             / _yarn_mscale(ys["factor"], ys.get("mscale_all_dim", 0)))
    return (torch.cos(ang) * m).to(dtype), (torch.sin(ang) * m).to(dtype)


def rotate(x, cos, sin):
    """x (B, S, H, dr); tables (S, dr/2): rotate-half."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def softmax_scale(cfg) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    ys = cfg.get("rope_scaling")
    if ys and ys.get("mscale_all_dim"):
        m = _yarn_mscale(ys["factor"], ys["mscale_all_dim"])
        s = s * m * m
    return s


def quantize_weight(w, w_bits: int):
    """(..., K, N) float -> (codes as float32, per-column float32 scale
    (..., N))."""
    qmax = (1 << (w_bits - 1)) - 1
    absmax = torch.maximum(w.abs().amax(dim=-2),
                           torch.tensor(1e-8, dtype=w.dtype, device=w.device))
    scale = absmax / torch.tensor(qmax, dtype=w.dtype, device=w.device)
    codes = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -qmax, qmax)
    return codes.to(torch.float32), scale.to(torch.float32)


def dense(x, w, q):
    """Served dense of float weight w (K, N) with q = (w_bits, a_bits,
    a_absmax): activations to the static signed grid, the exact integer
    product, the float32 dequant, rounded to x's dtype. q None: the
    float product in x's dtype."""
    if q is None:
        return torch.matmul(x, w.to(x.dtype))
    w_bits, a_bits, a_absmax = q
    codes, w_scale = quantize_weight(w, w_bits)
    amax = min((1 << (a_bits - 1)) - 1, 127)
    a_scale = torch.tensor(a_absmax / amax, dtype=torch.float32,
                           device=x.device)
    xq = torch.clamp(torch.round(x.to(torch.float32) / a_scale), -amax, amax)
    acc = torch.matmul(xq.reshape(-1, xq.shape[-1]), codes)
    scale = w_scale * torch.tensor(float(a_scale), dtype=torch.float32,
                                   device=x.device)
    return (acc * scale).to(x.dtype).reshape(*x.shape[:-1], -1)


def _swiglu(x, wi, wg, wo, q):
    return dense(F.silu(dense(x, wg, q)) * dense(x, wi, q), wo, q)


def attention(q, k, v, scale: float):
    """q, k (B, S, H, dq), v (B, S, H, dv) -> (B, S, H, dv) in v's
    dtype; float32 scores and softmax under a causal mask, the
    probabilities rounded to v's dtype."""
    b, s = q.shape[:2]
    pos = torch.arange(s, device=q.device)
    allow = pos[None, :] <= pos[:, None]
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for i in range(b):
        qi = q[i].to(torch.float32).transpose(0, 1)           # (H, S, dq)
        ki = k[i].to(torch.float32).transpose(0, 1)
        sc = torch.matmul(qi, ki.transpose(1, 2)) * scale
        sc = torch.where(allow, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1).to(v.dtype).to(torch.float32)
        o = torch.matmul(p, v[i].to(torch.float32).transpose(0, 1))
        out[i] = o.transpose(0, 1).to(v.dtype)
    return out


def route(cfg, h, router, bias, on_route=None):
    """Tokens h (T, d) -> (weights (T, k) float32, experts (T, k)).
    ``on_route(experts)`` sees the choices; what it returns, when not
    None, is chosen instead, weighted by the reference's own scores."""
    if cfg.get("scoring_func", "sigmoid") != "sigmoid" or \
            cfg.get("topk_method", "noaux_tc") != "noaux_tc" or \
            cfg.get("n_group", 1) != 1:
        raise ValueError("the reference routes sigmoid / noaux_tc over one "
                         "group")
    logits = torch.matmul(h.to(torch.float32), router.to(torch.float32))
    scores = torch.sigmoid(logits)
    idx = torch.topk(scores + bias.to(torch.float32),
                     cfg["num_experts_per_tok"], dim=-1).indices
    if on_route is not None:
        pinned = on_route(idx)
        if pinned is not None:
            idx = pinned.to(device=idx.device, dtype=idx.dtype)
    w = torch.gather(scores, -1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * float(cfg["routed_scaling_factor"]), idx


def moe(cfg, h, m, q, on_route=None):
    """The held experts' part of the routed output plus the shared
    expert, for h (B, S, d), its tokens in (B, S) order."""
    b, s, d = h.shape
    ht = h.reshape(-1, d)
    w, idx = route(cfg, ht, m["router"], m["router_bias"], on_route)
    off = int(cfg.get("experts_offset", 0))
    y = torch.zeros(ht.shape, dtype=torch.float32, device=h.device)
    for e in range(m["wi"]["w"].shape[0]):
        tok, slot = torch.nonzero(idx == off + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(ht[tok], m["wi"]["w"][e], m["wg"]["w"][e],
                      m["wo"]["w"][e], q)
        y.index_add_(0, tok, out.to(torch.float32)
                     * w[tok, slot][:, None])
    y = y.to(h.dtype).reshape(b, s, d)
    if cfg.get("n_shared_experts", 0):
        sh = m["shared"]
        y = y + _swiglu(h, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"], q)
    return y


def layer(cfg, lp, x, cos, sin, q, on_latent=None, on_route=None):
    """One layer on the residual x (B, S, d) with its float weights ``lp``
    (``ln1``, ``attn``, ``ln2`` and ``mlp`` or ``moe``)."""
    eps = float(cfg["rms_norm_eps"])
    b, s, _ = x.shape
    h_n = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rkv, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    a = lp["attn"]
    hn = rms_norm(x, lp["ln1"]["scale"], eps)
    qq = dense(rms_norm(dense(hn, a["wq_a"]["w"], q), a["q_norm"]["scale"],
                        eps), a["wq_b"]["w"], q).reshape(b, s, h_n,
                                                          nope + rope)
    qq = torch.cat([qq[..., :nope], rotate(qq[..., nope:], cos, sin)], -1)
    kv = dense(hn, a["wkv_a"]["w"], q)
    c_kv = rms_norm(kv[..., :rkv], a["kv_norm"]["scale"], eps)
    k_pe = rotate(kv[..., rkv:][:, :, None, :], cos, sin)[:, :, 0]
    if on_latent is not None:
        on_latent(c_kv, k_pe)
    kvb = dense(c_kv, a["wkv_b"]["w"], q).reshape(b, s, h_n, nope + dv)
    k = torch.cat([kvb[..., :nope],
                   k_pe[:, :, None, :].expand(b, s, h_n, rope)], -1)
    o = attention(qq, k, kvb[..., nope:], softmax_scale(cfg))
    x = x + dense(o.reshape(b, s, h_n * dv), a["wo"]["w"], q)
    hn = rms_norm(x, lp["ln2"]["scale"], eps)
    if "moe" in lp:
        return x + moe(cfg, hn, lp["moe"], q, on_route)
    m = lp["mlp"]
    return x + _swiglu(hn, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"], q)


def logits(cfg: dict, top: dict, layer_weights, batches, a_bits: int, *,
           last_only: bool = True, on_latent=None, on_route=None):
    """Float32 logits of every (B, S) token batch of ``batches``: at the
    last position (B, vocab), or at every position (B, S, vocab).
    ``a_bits`` None: every dense a float product in the compute dtype.
    ``top``: {"embed": {"table"}, "final_norm": {"scale"}, "head": {"w"}};
    ``layer_weights(i)`` gives layer i's float weights, asked for once
    per layer, so one layer's weights live at a time. ``on_latent(i,
    slot, c_kv, k_pe)`` sees layer i's latent of batch ``slot`` in the
    compute dtype; ``on_route(i, slot, experts)`` MoE layer i's expert
    choices (B*S, k) of that batch, and what it returns, when not None,
    is chosen instead (`route`)."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return _logits(cfg, top, layer_weights, batches, a_bits,
                           last_only, on_latent, on_route)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _logits(cfg, top, layer_weights, batches, a_bits, last_only, on_latent,
            on_route):
    dt = _dtype(cfg)
    q = None if a_bits is None else (cfg["w_bits"], a_bits,
                                     float(cfg["a_absmax"]))
    xs = [top["embed"]["table"][t.long()].to(dt) for t in batches]
    tables = {}
    for i in range(cfg["num_hidden_layers"]):
        lp = layer_weights(i)
        for slot, x in enumerate(xs):
            s = x.shape[1]
            if s not in tables:
                tables[s] = rope_tables(cfg, s, dt, x.device)
            cb = None if on_latent is None else (
                lambda c, p, i=i, slot=slot: on_latent(i, slot, c, p))
            rb = None if on_route is None else (
                lambda e, i=i, slot=slot: on_route(i, slot, e))
            xs[slot] = layer(cfg, lp, x, *tables[s], q, cb, rb)
        del lp
    eps = float(cfg["rms_norm_eps"])
    w = top["head"]["w"].to(dt).to(torch.float32)
    out = []
    for x in xs:
        xl = rms_norm(x[:, -1] if last_only else x,
                      top["final_norm"]["scale"], eps)
        lg = torch.matmul(xl.to(torch.float32), w).to(dt)
        out.append(lg[..., :cfg["vocab_size"]].to(torch.float32))
    return out
