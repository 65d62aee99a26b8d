"""Plain reference of a decoder LM served with packed integer dense layers.

The model: token embedding, pre-norm layers of RMSNorm, multi-head
attention with rotary positions (rotate-half, theta from the
configuration) under a causal mask (and the sliding window where the
configuration gives one), RMSNorm, SwiGLU MLP (silu(gate) x up), a final
RMSNorm and the output head, computed in the configuration's compute
dtype (bfloat16) where the served model rounds to it.

Every dense projection is served W{w_bits}A{a_bits}: the weights on
per-output-channel symmetric grids (scale = absmax / (2^(w_bits-1) - 1)),
the activations on a static symmetric grid (absmax / (2^(a_bits-1) - 1),
8-bit codes within +-127), the integer product exact (float32 products
of these integers, whose sums stay below 2^24), then dequantized in
float32 with scale = w_scale x a_scale and rounded to the compute dtype.
The reference works all of this out from the float weights itself.

Attention products are float32 matmuls (TF32 off), one batch row at a
time. It imports neither the port nor the JAX package.
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


def rope_tables(seq: int, dh: int, theta: float, dtype, device):
    half = dh // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=device),
                      -torch.arange(0, half, dtype=torch.float32,
                                    device=device) / half)
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device),
                      freqs)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def rotate(x, cos, sin):
    """x (B, S, H, dh); tables (S, dh/2)."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def quantize_weight(w, w_bits: int):
    """(K, N) float -> (codes as float32, per-column float32 scale)."""
    qmax = (1 << (w_bits - 1)) - 1
    absmax = torch.maximum(w.abs().amax(dim=0),
                           torch.tensor(1e-8, dtype=w.dtype, device=w.device))
    scale = absmax / torch.tensor(qmax, dtype=w.dtype, device=w.device)
    codes = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return codes.to(torch.float32), scale.to(torch.float32)


def dense(x, codes, w_scale, a_bits: int, a_absmax: float):
    """Served dense: activations to the static signed grid, the exact
    integer product, the float32 dequant, rounded to x's dtype."""
    amax = min((1 << (a_bits - 1)) - 1, 127)
    a_scale = torch.tensor(a_absmax / amax, dtype=torch.float32,
                           device=x.device)
    xq = torch.clamp(torch.round(x.to(torch.float32) / a_scale), -amax, amax)
    acc = torch.matmul(xq.reshape(-1, xq.shape[-1]), codes)
    scale = w_scale * torch.tensor(float(a_scale), dtype=torch.float32,
                                   device=x.device)
    return (acc * scale).to(x.dtype).reshape(*x.shape[:-1], -1)


def attention(q, k, v, window: int):
    """q, k, v (B, S, H, dh) -> (B, S, H, dh) in v's dtype; float32
    scores and softmax, the probabilities rounded to v's dtype."""
    b, s, h, dh = q.shape
    pos = torch.arange(s, device=q.device)
    allow = pos[None, :] <= pos[:, None]
    if window:
        allow &= (pos[:, None] - pos[None, :]) < window
    out = torch.empty_like(v)
    for i in range(b):
        qi = q[i].to(torch.float32).transpose(0, 1)          # (H, S, dh)
        ki = k[i].to(torch.float32).transpose(0, 1)
        sc = torch.matmul(qi, ki.transpose(1, 2)) * (dh ** -0.5)
        sc = torch.where(allow, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1).to(v.dtype).to(torch.float32)
        o = torch.matmul(p, v[i].to(torch.float32).transpose(0, 1))
        out[i] = o.transpose(0, 1).to(v.dtype)
    return out


def last_logits(cfg: dict, fp: dict, tokens, a_bits: int, on_layer=None):
    """Float32 logits (B, vocab) at the last position of ``tokens`` (B,
    S). ``on_layer(i, k, v)`` sees layer i's rotated keys and values (B,
    S, Hk, dh) in the compute dtype."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            return _last_logits(cfg, fp, tokens, a_bits, on_layer)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _last_logits(cfg, fp, tokens, a_bits, on_layer):
    dt = _dtype(cfg)
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hk = cfg.get("num_key_value_heads", h)
    dh = cfg.get("head_dim") or d // h
    if hk != h:
        raise ValueError("the reference serves multi-head attention only")
    wb, amx = cfg["w_bits"], cfg["a_absmax"]
    window = cfg.get("sliding_window") or 0
    eps = float(cfg["rms_norm_eps"])
    b, s = tokens.shape
    x = fp["embed"]["table"][tokens.long()].to(dt)
    cos, sin = rope_tables(s, dh, float(cfg["rope_theta"]), dt, x.device)
    lay = fp["layers"]

    def proj(x, leaf, i):
        codes, sc = quantize_weight(leaf["w"][i], wb)
        return dense(x, codes, sc, a_bits, amx)

    for i in range(cfg["num_hidden_layers"]):
        a = lay["attn"]
        hn = rms_norm(x, lay["ln1"]["scale"][i], eps)
        q = rotate(proj(hn, a["wq"], i).reshape(b, s, h, dh), cos, sin)
        k = rotate(proj(hn, a["wk"], i).reshape(b, s, hk, dh), cos, sin)
        v = proj(hn, a["wv"], i).reshape(b, s, hk, dh)
        if on_layer is not None:
            on_layer(i, k, v)
        o = attention(q, k, v, window).reshape(b, s, h * dh)
        x = x + proj(o, a["wo"], i)
        m = lay["mlp"]
        hn = rms_norm(x, lay["ln2"]["scale"][i], eps)
        up, gate = proj(hn, m["wi"], i), proj(hn, m["wg"], i)
        x = x + proj(F.silu(gate) * up, m["wo"], i)
    xl = rms_norm(x[:, -1], fp["final_norm"]["scale"], eps)
    if cfg["tie_word_embeddings"]:
        w = fp["embed"]["table"].to(dt).to(torch.float32).T
    else:
        w = fp["head"]["w"].to(dt).to(torch.float32)
    lg = torch.matmul(xl.to(torch.float32), w).to(dt)
    return lg[:, :cfg["vocab_size"]].to(torch.float32)
