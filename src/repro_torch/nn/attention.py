"""Grouped-query attention with causal/local/bidirectional masks, cross
attention, and an (optionally int8) KV cache for decode: positional, or
a ring of window slots for local attention.

GQA keeps an explicit group dim (no KV head is ever replicated). Every
projection is a quantization-aware dense layer, so the packed sub-byte
GEMM serves all four. The score and value contractions are plain torch
einsums with a float32 softmax, as the reference leaves them to XLA
outside any kernel. `attn_strategy` names the reference's sharding
strategy for the active mesh; the port's attention runs whole on each
data block, so it reads the strategy nowhere yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.layers import (QOFF, QuantConfig, const, dense_apply,
                                   dense_def, rope_apply, rope_single)
from repro_torch.parallel.ctx import active_mesh

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    qkv_bias: bool = False        # qwen2.5
    kv_quant_bits: int = 16       # 16 (cache in the compute dtype) | 8
    qcfg: QuantConfig = QOFF
    # mixed-precision deployment: per-projection override of qcfg resolved
    # by this block's param path + projection name (wq/wk/wv/wo)
    plan: Optional[PrecisionPlan] = None
    path: str = "layers/attn"

    @property
    def groups(self):
        return self.n_heads // self.kv_heads

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)


def attn_def(cfg: AttnConfig, dtype=torch.float32):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "wq": dense_def(d, h * dh, ("embed", "heads"), bias=cfg.qkv_bias,
                        qcfg=cfg.q("wq"), dtype=dtype),
        "wk": dense_def(d, hk * dh, ("embed", "kv_heads"), bias=cfg.qkv_bias,
                        qcfg=cfg.q("wk"), dtype=dtype),
        "wv": dense_def(d, hk * dh, ("embed", "kv_heads"), bias=cfg.qkv_bias,
                        qcfg=cfg.q("wv"), dtype=dtype),
        "wo": dense_def(h * dh, d, ("heads", "embed"), qcfg=cfg.q("wo"),
                        dtype=dtype),
    }


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _mask_full(q_len, k_len, mode, window, device, q_offset=0):
    """(q_len, k_len) bool allow-mask. mode: causal|local|bidir."""
    if mode == "bidir":
        return torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    allow = k_pos <= q_pos
    if mode == "local":
        allow = allow & (q_pos - k_pos < window)
    return allow


def attn_strategy(hk: int, groups: int, s_len: int, t_len: int,
                  batch=None) -> str:
    """One sharding strategy per attention call on the active mesh
    (`repro_torch.parallel.ctx.active_mesh`):

    'tp'  kv_heads divide the model axis: classic tensor parallelism;
    'cp'  context parallel: q-seq (train / prefill) or kv-seq (decode)
          divides it;
    'gp'  the GQA group dim divides it (q-only tensor parallelism);
    'none' no mesh, or nothing divides.
    """
    mesh = active_mesh()
    if mesh is None:
        return "none"
    m = mesh.shape.get("model", 1)
    if hk % m == 0:
        return "tp"
    if (s_len > 1 and s_len % m == 0) or (s_len == 1 and t_len % m == 0):
        return "cp"
    if groups % m == 0:
        return "gp"
    return "none"


def _sdpa(q, k, v, mask):
    """q: (B,S,Hk,G,Dh), k/v: (B,T,Hk,Dh), mask broadcastable to
    (B,Hk,G,S,T). Scores in float32 (the reference's
    preferred_element_type; a bf16 product is exact in float32), float32
    softmax, values in v's dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bshgd,bthd->bhgst", q.to(torch.float32),
                          k.to(torch.float32))
    scores = torch.where(mask, scores * (dh ** -0.5), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)


def _kv_store(x, bits):
    if bits == 8:
        # static symmetric grid for normalized k/v
        scale = const(8.0 / 127.0, torch.float32, x.device)
        return torch.clamp(torch.round(x.to(torch.float32) / scale),
                           -127, 127).to(torch.int8)
    return x


def _kv_load(x, bits, dtype):
    if bits == 8:
        return (x.to(torch.float32)
                * const(8.0 / 127.0, torch.float32, x.device)).to(dtype)
    return x


def attn_apply(p, x, cfg: AttnConfig, *, cos, sin, mode="causal",
               window=None, cross_kv=None):
    """Full-sequence attention (prefill).

    cross_kv: (k_src, v_src), source K/V projected once by
    `cross_kv_project`, for cross attention (mode 'bidir'; RoPE skipped;
    the keys are the source's positions). Returns (out, (k, v)) so
    callers can build decode caches from prefill."""
    b, s, _ = x.shape
    h, hk, dh, g = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.groups
    q = _split_heads(dense_apply(p["wq"], x, qcfg=cfg.q("wq")), h, dh)
    if cross_kv is None:
        k = _split_heads(dense_apply(p["wk"], x, qcfg=cfg.q("wk")), hk, dh)
        v = _split_heads(dense_apply(p["wv"], x, qcfg=cfg.q("wv")), hk, dh)
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)
    else:
        k, v = cross_kv
    q = q.reshape(b, s, hk, g, dh)
    mask = _mask_full(s, k.shape[1], mode, window, x.device)
    out = _sdpa(q, k, v, mask[None, None, None]).reshape(b, s, h * dh)
    return dense_apply(p["wo"], out, qcfg=cfg.q("wo")), (k, v)


def cross_kv_project(p, src, cfg: AttnConfig):
    """Project the source states (encoder output or frontend embeddings)
    to K/V once; every decode step reuses them."""
    hk, dh = cfg.kv_heads, cfg.head_dim
    k = _split_heads(dense_apply(p["wk"], src, qcfg=cfg.q("wk")), hk, dh)
    v = _split_heads(dense_apply(p["wv"], src, qcfg=cfg.q("wv")), hk, dh)
    return k, v


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    store_t = torch.int8 if cfg.kv_quant_bits == 8 else dtype
    return {"k": torch.zeros(shape, dtype=store_t, device=device),
            "v": torch.zeros(shape, dtype=store_t, device=device)}


def attn_decode(p, x, cache, index, cfg: AttnConfig, *, theta=10000.0,
                mode="causal", window=None, cross_kv=None,
                ring: bool = False):
    """One-token decode. x: (B,1,d); index: the true position, a scalar
    (wave decode: every row at the same step) or a (B,) vector (each slot
    at its own position); cache: dict(k, v) of (B,T,Hk,Dh), written in
    place at the position (the returned cache is the same dict). The
    vector form runs the scalar form's per-element math, so an all-equal
    vector gives the scalar's result bit for bit. Returns (out, cache).

    ring=True treats the cache as a ring of T slots (local attention):
    the write slot is index % T, slot j holds true position index -
    ((index - j) mod T) (floor modulo: index - j is negative in slots
    not yet wrapped), and RoPE uses true positions, so relative phases
    stay exact across wraps.

    cross_kv: (k_src, v_src) of (B,T,Hk,Dh), for cross attention: no
    RoPE, every source position attended whatever the index, and no
    cache written (``cache`` is returned as it came, None included).
    """
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = _split_heads(dense_apply(p["wq"], x, qcfg=cfg.q("wq")), h, dh)
    if cross_kv is not None:
        k, v = cross_kv
        allow = torch.ones((1, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        return _attend_one(p, q, k, v, allow, cfg), cache
    per_slot = torch.is_tensor(index) and index.dim() == 1
    index = index.to(x.device) if per_slot else int(index)
    k_new = _split_heads(dense_apply(p["wk"], x, qcfg=cfg.q("wk")), hk, dh)
    v_new = _split_heads(dense_apply(p["wv"], x, qcfg=cfg.q("wv")), hk, dh)
    q = rope_single(q, index, theta)
    k_new = rope_single(k_new, index, theta)
    kq = _kv_store(k_new, cfg.kv_quant_bits)[:, 0]
    vq = _kv_store(v_new, cfg.kv_quant_bits)[:, 0]
    t = cache["k"].shape[1]
    if per_slot:
        # one write position per row; only the address is batched
        rows = torch.arange(b, device=x.device)
        slot = (torch.remainder(index, t) if ring else index).long()
        cache["k"][rows, slot] = kq.to(cache["k"].dtype)
        cache["v"][rows, slot] = vq.to(cache["v"].dtype)
        idx = index[:, None]                       # (B, 1)
    else:
        slot = index % t if ring else index
        cache["k"][:, slot] = kq.to(cache["k"].dtype)
        cache["v"][:, slot] = vq.to(cache["v"].dtype)
        idx = index
    k = _kv_load(cache["k"], cfg.kv_quant_bits, x.dtype)
    v = _kv_load(cache["v"], cfg.kv_quant_bits, x.dtype)
    k_pos = torch.arange(t, device=x.device)[None, :]
    if ring:
        true_pos = idx - torch.remainder(idx - k_pos, t)
        allow = true_pos >= 0
        if window is not None:
            allow = allow & (idx - true_pos < window)
    else:
        allow = k_pos <= idx
        if mode == "local":
            allow = allow & (idx - k_pos < window)
    return _attend_one(p, q, k, v, allow, cfg), cache


def _attend_one(p, q, k, v, allow, cfg: AttnConfig):
    """One query position over keys k/v (B,T,Hk,Dh); ``allow`` (B|1, T)
    broadcasts to (B,1,1,1,T). Returns wo's output (B,1,d)."""
    b = q.shape[0]
    q = q.reshape(b, 1, cfg.kv_heads, cfg.groups, cfg.head_dim)
    out = _sdpa(q, k, v, allow[:, None, None, None, :])
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return dense_apply(p["wo"], out, qcfg=cfg.q("wo"))
