"""Grouped-query attention with causal/local/bidirectional masks, cross
attention, and an (optionally int8) KV cache for decode: positional, or
a ring of window slots for local attention.

GQA keeps an explicit group dim (no KV head is ever replicated). Every
projection is a quantization-aware dense layer, so the packed sub-byte
GEMM serves all four. The reference leaves the score and value
contractions to XLA outside any kernel; here the meshless prefill
attention (`attn_core`) runs the fused attention kernel
(`kernels/api.py::attention`) on bf16 CUDA inputs that require no grad
in its domain, the scores never in device memory, and `_sdpa` (plain
torch einsums with a float32 softmax) on every other call: the CPU, a
float32 model, training, and decode and the tensor-parallel paths,
which call `_sdpa` themselves. With ``REPRO_OBS=1`` the counters
``attn.kernel_calls`` and ``attn.plain_calls`` count `attn_core`'s calls
on each path.

Under tensor parallelism (`repro_torch.parallel.tp`) the projections
split by `attn_layout`: wq column-parallel over whole heads ('tp', when
the kv heads divide the model axis) or over each kv head's q-group block
('gp', when the groups do), else over even column runs; wk / wv over
kv-head blocks ('tp') or even column runs; wo row-parallel over wq's
runs where its K can split there (a float weight, or a packed one at
CHUNK boundaries), else column-parallel over the model width with the
attention output gathered. The attention itself follows
`attn_strategy` per call: 'tp' kv-head blocks, 'gp' q-group blocks
against the whole K/V, 'cp' q-sequence blocks (prefill) or kv-sequence
blocks with partial softmaxes merged by log-sum-exp (decode), 'none' on
the leader. A decode cache follows `cache_shardings`' ``_kv_spec``: kv
heads over ``model`` under 'tp', the sequence under 'cp', else whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.kernels import api as kapi
from repro_torch.nn.layers import (QOFF, QuantConfig, const, dense_apply,
                                   dense_col, dense_cuts, dense_def,
                                   dense_row, rope_apply, rope_single,
                                   row_parallel_ok)
from repro_torch.obs import trace as obs
from repro_torch.parallel import tp
from repro_torch.parallel.ctx import active_mesh
from repro_torch.parallel.sharding import cache_shardings

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


def _sdpa(q, k, v, mask, scale=None):
    """q: (B,S,Hk,G,Dh), k: (B,T,Hk,Dh), v: (B,T,Hk,Dv) (Dv may differ
    from Dh, as in latent attention), mask broadcastable to (B,Hk,G,S,T).
    Scores in float32 (the reference's preferred_element_type; a bf16
    product is exact in float32) times ``scale`` (default Dh^-0.5),
    float32 softmax, values in v's dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bshgd,bthd->bhgst", q.to(torch.float32),
                          k.to(torch.float32))
    scores = torch.where(mask, scores * (dh ** -0.5 if scale is None
                                         else scale), NEG_INF)
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
    grp = tp.tp_group()
    if grp is not None:
        return _attn_apply_tp(grp, p, x, cfg, cos=cos, sin=sin, mode=mode,
                              window=window, cross_kv=cross_kv)
    q, k, v = attn_qkv(p, x, cfg, cos=cos, sin=sin, cross_kv=cross_kv)
    out = attn_core(q, k, v, mode=mode, window=window)
    return dense_apply(p["wo"], out, qcfg=cfg.q("wo")), (k, v)


def attn_qkv(p, x, cfg: AttnConfig, *, cos, sin, cross_kv=None):
    """`attn_apply`'s meshless projections: q (B,S,Hk,G,Dh) and k / v
    (B,T,Hk,Dh), RoPE applied to q and k; ``cross_kv`` as there."""
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
    return q.reshape(b, s, hk, g, dh), k, v


def attn_core(q, k, v, *, mode, window, scale=None):
    """`attn_apply`'s meshless attention over `attn_qkv`'s q, k, v: the
    mask, scores (times ``scale``, as `_sdpa`), softmax and values,
    (B,S,H*Dv) in v's dtype. The fused kernel where it takes the call
    (`kernels/api.py::attention_takes`), else `_sdpa`."""
    if kapi.attention_takes(q, k, v):
        obs.counter("attn.kernel_calls").add(1)
        return kapi.attention(q, k, v, mode=mode, window=window,
                              scale=scale)
    obs.counter("attn.plain_calls").add(1)
    b, s = q.shape[:2]
    mask = _mask_full(s, k.shape[1], mode, window, q.device)
    return _sdpa(q, k, v, mask[None, None, None], scale).reshape(b, s, -1)


def cross_kv_project(p, src, cfg: AttnConfig):
    """Project the source states (encoder output or frontend embeddings)
    to K/V once; every decode step reuses them."""
    hk, dh = cfg.kv_heads, cfg.head_dim
    grp = tp.tp_group()
    if grp is not None:
        lay = attn_layout(cfg, grp.m)
        return tuple(_split_heads(_col_full(grp, p[n], src, cfg, n,
                                            lay.kv_runs, cfg.d_model),
                                  hk, dh) for n in ("wk", "wv"))
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
    grp = tp.tp_group()
    if grp is not None:
        return _attn_decode_tp(grp, p, x, cache, index, cfg, theta=theta,
                               mode=mode, window=window, cross_kv=cross_kv,
                               ring=ring)
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
    allow = _decode_allow(idx, k_pos, t, ring=ring, mode=mode,
                          window=window)
    return _attend_one(p, q, k, v, allow, cfg), cache


def _decode_allow(idx, k_pos, t: int, *, ring: bool, mode, window):
    """(B|1, T') allow-mask of cache slots ``k_pos`` (1, T') for true
    position ``idx`` (an int or (B, 1)) in a cache of ``t`` slots."""
    if ring:
        true_pos = idx - torch.remainder(idx - k_pos, t)
        allow = true_pos >= 0
        if window is not None:
            allow = allow & (idx - true_pos < window)
    else:
        allow = k_pos <= idx
        if mode == "local":
            allow = allow & (idx - k_pos < window)
    return allow


def _attend_one(p, q, k, v, allow, cfg: AttnConfig):
    """One query position over keys k/v (B,T,Hk,Dh); ``allow`` (B|1, T)
    broadcasts to (B,1,1,1,T). Returns wo's output (B,1,d)."""
    b = q.shape[0]
    q = q.reshape(b, 1, cfg.kv_heads, cfg.groups, cfg.head_dim)
    out = _sdpa(q, k, v, allow[:, None, None, None, :])
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return dense_apply(p["wo"], out, qcfg=cfg.q("wo"))


# ------------------------------------------- tensor parallel (model) ---

@dataclasses.dataclass(frozen=True)
class AttnLayout:
    """How one attention block's projections split over ``m`` model
    positions (module docstring): ``kind`` 'tp' | 'gp' | 'even'; wq's
    column runs (wo's K runs when ``wo`` is 'row'), wk / wv's column
    runs, and wo's runs (K for 'row', N for 'col')."""
    kind: str
    q_runs: tuple
    kv_runs: tuple
    wo: str
    wo_runs: tuple


def attn_layout(cfg: AttnConfig, m: int) -> AttnLayout:
    h, hk, g, dh = cfg.n_heads, cfg.kv_heads, cfg.groups, cfg.head_dim
    if hk % m == 0:
        kind = "tp"
        q_runs = tp.blocks_runs(h, dh, m)
        kv_runs = tp.blocks_runs(hk, dh, m)
    elif g % m == 0:
        kind, gm = "gp", g // m
        q_runs = tuple(tuple((j * g * dh + i * gm * dh,
                              j * g * dh + (i + 1) * gm * dh)
                             for j in range(hk)) for i in range(m))
        kv_runs = tp.even_runs(hk * dh, m)
    else:
        kind = "even"
        q_runs = tp.even_runs(h * dh, m)
        kv_runs = tp.even_runs(hk * dh, m)
    if row_parallel_ok(cfg.q("wo"), q_runs, h * dh):
        return AttnLayout(kind, q_runs, kv_runs, "row", q_runs)
    return AttnLayout(kind, q_runs, kv_runs, "col",
                      tp.even_runs(cfg.d_model, m))


def attn_cuts(cfg: AttnConfig, m: int):
    lay = attn_layout(cfg, m)
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    return {"wq": dense_cuts(cfg.q("wq"), "col", lay.q_runs, d),
            "wk": dense_cuts(cfg.q("wk"), "col", lay.kv_runs, d),
            "wv": dense_cuts(cfg.q("wv"), "col", lay.kv_runs, d),
            "wo": dense_cuts(cfg.q("wo"), lay.wo, lay.wo_runs, hd)}


def kv_cache_cut(cfg: AttnConfig, shape, mesh):
    """The split of a KV cache leaf of ``shape`` over ``mesh``'s model
    positions where `cache_shardings` puts its ``model`` entry: the kv
    heads when they divide the axis ('tp'), else the slots ('cp' at
    decode), else none. A leaf is a layer's (B, T, Hk, Dh), the stack's
    (L, B, T, Hk, Dh) or the cross cache's (L, 2, B, S, Hk, Dh)."""
    shape = (1,) * (5 - len(shape)) + tuple(shape)
    spec = tuple(cache_shardings(torch.empty(shape, device="meta"),
                                 mesh).spec)
    if "model" not in spec:
        return None
    dim = spec.index("model") - len(spec)
    m = mesh.shape["model"]
    return tp.Cut(dim, _head_runs(cfg.kv_heads, m) if dim == -2
                  else tp.even_runs(shape[-3], m))


def _col_full(grp, p, x, cfg: AttnConfig, name: str, runs, k_full: int):
    """A column-parallel projection, its output gathered on the
    leader."""
    parts = dense_col(p, x, qcfg=cfg.q(name), runs=runs, group=grp,
                      k_full=k_full)
    n = sum(tp.run_len(r) for r in runs)
    return tp.join(parts, runs, -1, n, grp.leader)


def _wo(grp, p, out, cfg: AttnConfig, lay: AttnLayout):
    """wo over the attention output: per-position parts in wq's runs
    (a list) or the whole (B, S, h*dh) tensor on the leader."""
    hd = cfg.n_heads * cfg.head_dim
    if lay.wo == "row":
        parts = out if isinstance(out, list) else tp.split(out, lay.q_runs,
                                                           -1)
        return dense_row(p["wo"], parts, qcfg=cfg.q("wo"), runs=lay.q_runs,
                         group=grp, k_full=hd)
    if isinstance(out, list):
        out = tp.join(out, lay.q_runs, -1, hd, grp.leader)
    return _col_full(grp, p["wo"], out, cfg, "wo", lay.wo_runs, hd)


def _head_runs(hk: int, m: int):
    return tp.blocks_runs(hk, 1, m)


def _scores(q, k, mask):
    """Run 1 of the sequence-split attention on one block of keys: the
    masked, scaled float32 scores (`_sdpa`'s), their max and the sum of
    exp(score - max)."""
    dh = q.shape[-1]
    scores = torch.einsum("bshgd,bthd->bhgst", q.to(torch.float32),
                          k.to(torch.float32))
    scores = torch.where(mask, scores * (dh ** -0.5), NEG_INF)
    mx = scores.amax(-1, keepdim=True)
    return scores, mx, torch.exp(scores - mx).sum(-1, keepdim=True)


def _merge(grp, live, stats, vparts, dtype):
    """Run 2: the blocks' (max, sum) merged by log-sum-exp into the
    whole softmax's max and sum on the leader; each position then
    normalises its probabilities, rounds them to v's dtype as `_sdpa`
    does, and contracts them with its values in float32; the partial
    outputs add on the leader. A block whose keys are all masked weighs
    exp(NEG_INF - max) = 0."""
    top = None
    for _, mx, _ in stats:
        mx = mx.to(grp.leader)
        top = mx if top is None else torch.maximum(top, mx)
    den = sum(l.to(grp.leader) * torch.exp(mx.to(grp.leader) - top)
              for _, mx, l in stats)

    def pv(i, sc, tp_, dn, vi):
        probs = (torch.exp(sc - tp_) / dn).to(vi.dtype)
        return torch.einsum("bhgst,bthd->bshgd", probs.to(torch.float32),
                            vi.to(torch.float32))
    outs = grp.run(pv, [(st[0], grp.to(top, i), grp.to(den, i), vp)
                        for i, st, vp in zip(live, stats, vparts)], live)
    return tp.total(outs, grp.leader).to(dtype)


def _core(grp, strat, q, k, v, mask, dtype):
    """The attention over whole q (B,S,Hk,G,Dh) and k / v (B,T,Hk,Dh)
    with ``mask`` (bool, broadcastable to (B|1, Hk|1, G|1, S, T)) under
    ``strat``: a list of per-position outputs in wq's runs ('tp' / 'gp')
    or the whole (B, S, h*dh) on the leader. k / v may be `Split`
    leaves (a placed cross cache) under 'tp' / 'cp'."""
    b, s, hk, g, dh = q.shape
    m = grp.m
    if strat == "tp":
        hr = _head_runs(hk, m)
        kp = tp.parts_of(k, hr, -2)
        vp = tp.parts_of(v, hr, -2)

        def one(i, qi, ki, vi):
            (h0, h1), = hr[i]
            mi = mask if mask.shape[1] == 1 else mask[:, h0:h1]
            return _sdpa(qi, ki, vi, mi).reshape(b, s, -1)
        return grp.run(one, [(grp.to(q[:, :, h0:h1], i), grp.to(kp[i], i),
                              grp.to(vp[i], i))
                             for i, ((h0, h1),) in enumerate(hr)])
    if strat == "gp":
        gm = g // m
        k, v = (tp.whole(t, grp.leader) for t in (k, v))
        return grp.run(
            lambda i, qi, ki, vi: _sdpa(qi, ki, vi, mask).reshape(b, s, -1),
            [(grp.to(q[:, :, :, i * gm:(i + 1) * gm], i), grp.to(k, i),
              grp.to(v, i)) for i in range(m)])
    if strat == "cp" and s > 1:
        # q-sequence blocks against the whole keys
        k, v = (tp.whole(t, grp.leader) for t in (k, v))
        rr = tp.even_runs(s, m)
        live = [i for i, r in enumerate(rr) if r]

        def rows(i, qi, ki, vi):
            (r0, r1), = rr[i]
            mi = mask[..., r0:r1, :] if mask.shape[-2] > 1 else mask
            return _sdpa(qi, ki, vi, mi).reshape(qi.shape[0], r1 - r0, -1)
        outs = grp.run(rows, [(grp.to(q[:, rr[i][0][0]:rr[i][0][1]], i),
                               grp.to(k, i), grp.to(v, i)) for i in live],
                       live)
        return tp.join([o for o in outs], tuple(rr[i] for i in live), 1, s,
                       grp.leader)
    if strat == "cp":
        # one query: kv-sequence blocks, merged by log-sum-exp
        t = tp.full_len(k, -3)
        rr = tp.even_runs(t, m)
        kp = tp.parts_of(k, rr, -3)
        vp = tp.parts_of(v, rr, -3)
        live = [i for i, r in enumerate(rr) if r]

        def blk(i, qi, ki):
            (t0, t1), = rr[i]
            return _scores(qi, ki, mask[..., t0:t1])
        stats = grp.run(blk, [(grp.to(q, i), grp.to(kp[i], i))
                              for i in live], live)
        return _merge(grp, live, stats, [grp.to(vp[i], i) for i in live],
                      dtype).reshape(b, s, -1)
    k, v = (tp.whole(t, grp.leader) for t in (k, v))
    return _sdpa(q, k, v, mask).reshape(b, s, -1)


def _attn_apply_tp(grp, p, x, cfg: AttnConfig, *, cos, sin, mode, window,
                   cross_kv):
    b, s, _ = x.shape
    h, hk, dh, g, d = (cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.groups,
                       cfg.d_model)
    lay = attn_layout(cfg, grp.m)
    p = tp.place(p, attn_cuts(cfg, grp.m), grp)
    q = _split_heads(_col_full(grp, p["wq"], x, cfg, "wq", lay.q_runs, d),
                     h, dh)
    if cross_kv is None:
        k, v = (_split_heads(_col_full(grp, p[n], x, cfg, n, lay.kv_runs,
                                       d), hk, dh) for n in ("wk", "wv"))
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)
    else:
        k, v = cross_kv
    t = k.shape[1]
    strat = attn_strategy(hk, g, s, t)
    mask = _mask_full(s, t, mode, window, x.device)[None, None, None]
    out = _core(grp, strat, q.reshape(b, s, hk, g, dh), k, v, mask, v.dtype)
    return _wo(grp, p, out, cfg, lay), (k, v)


def _attn_decode_tp(grp, p, x, cache, index, cfg: AttnConfig, *, theta,
                    mode, window, cross_kv, ring):
    b = x.shape[0]
    h, hk, dh, g, d = (cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.groups,
                       cfg.d_model)
    m = grp.m
    lay = attn_layout(cfg, m)
    p = tp.place(p, attn_cuts(cfg, m), grp)
    q = _split_heads(_col_full(grp, p["wq"], x, cfg, "wq", lay.q_runs, d),
                     h, dh)
    if cross_kv is not None:
        k, v = cross_kv
        t = tp.full_len(k, -3)
        allow = torch.ones((1, t), dtype=torch.bool, device=x.device)
        strat = attn_strategy(hk, g, 1, t)
        out = _core(grp, strat, q.reshape(b, 1, hk, g, dh), k, v,
                    allow[:, None, None, None, :], x.dtype)
        return _wo(grp, p, out, cfg, lay), cache
    per_slot = torch.is_tensor(index) and index.dim() == 1
    index = index.to(x.device) if per_slot else int(index)
    k_new, v_new = (_split_heads(_col_full(grp, p[n], x, cfg, n,
                                           lay.kv_runs, d), hk, dh)
                    for n in ("wk", "wv"))
    q = rope_single(q, index, theta)
    k_new = rope_single(k_new, index, theta)
    kq = _kv_store(k_new, cfg.kv_quant_bits)[:, 0]
    vq = _kv_store(v_new, cfg.kv_quant_bits)[:, 0]
    t = tp.full_len(cache["k"], -3)
    strat = attn_strategy(hk, g, 1, t)
    if per_slot:
        slot = (torch.remainder(index, t) if ring else index).long()
        idx = index[:, None]
    else:
        slot = index % t if ring else index
        idx = index
    q = q.reshape(b, 1, hk, g, dh)
    bits = cfg.kv_quant_bits

    def mask_of(k_pos):
        a = _decode_allow(idx, k_pos, t, ring=ring, mode=mode,
                          window=window)
        return a[:, None, None, None, :]

    if strat in ("tp", "cp"):
        # the cache split over kv heads ('tp') or the sequence ('cp'):
        # each position writes what it holds and attends over it
        runs = _head_runs(hk, m) if strat == "tp" else tp.even_runs(t, m)
        dim = -2 if strat == "tp" else -3
        kc = tp.parts_of(cache["k"], runs, dim)
        vc = tp.parts_of(cache["v"], runs, dim)
        live = [i for i, r in enumerate(runs) if r]

        def one(i, qi, kn, vn, ki, vi, sl, ix):
            (r0, r1), = runs[i]
            dev = ki.device
            rows = torch.arange(b, device=dev)
            if strat == "tp":
                kn, vn = kn[:, r0:r1], vn[:, r0:r1]
                _write(ki, vi, kn, vn, rows, sl, per_slot)
                k_pos = torch.arange(t, device=dev)[None, :]
            else:
                _write_block(ki, vi, kn, vn, rows, sl, r0, r1, per_slot)
                k_pos = (r0 + torch.arange(r1 - r0, device=dev))[None, :]
            a = _decode_allow(ix, k_pos, t, ring=ring, mode=mode,
                              window=window)[:, None, None, None, :]
            kk = _kv_load(ki, bits, x.dtype)
            vv = _kv_load(vi, bits, x.dtype)
            if strat == "tp":
                return _sdpa(qi[:, :, r0:r1], kk, vv, a).reshape(b, 1, -1)
            return _scores(qi, kk, a), vv
        outs = grp.run(one, [(grp.to(q, i), grp.to(kq, i), grp.to(vq, i),
                              kc[i], vc[i], grp.to(slot, i),
                              grp.to(idx, i)) for i in live], live)
        if strat == "cp":
            out = _merge(grp, live, [o[0] for o in outs],
                         [o[1] for o in outs], x.dtype).reshape(b, 1, -1)
        else:
            out = outs
    else:
        # a whole cache, written once on the leader
        rows = torch.arange(b, device=x.device)
        _write(cache["k"], cache["v"], kq, vq, rows, slot, per_slot)
        k = _kv_load(cache["k"], bits, x.dtype)
        v = _kv_load(cache["v"], bits, x.dtype)
        k_pos = torch.arange(t, device=x.device)[None, :]
        out = _core(grp, strat, q, k, v, mask_of(k_pos), x.dtype)
    return _wo(grp, p, out, cfg, lay), cache


def _write(kc, vc, kq, vq, rows, slot, per_slot: bool):
    """The new K/V rows at ``slot`` of a cache (part)."""
    if per_slot:
        kc[rows, slot] = kq.to(kc.dtype)
        vc[rows, slot] = vq.to(vc.dtype)
    else:
        kc[:, slot] = kq.to(kc.dtype)
        vc[:, slot] = vq.to(vc.dtype)


def _write_block(kc, vc, kq, vq, rows, slot, t0: int, t1: int,
                 per_slot: bool):
    """The new K/V rows into a sequence block [t0, t1) of the cache:
    only the rows whose slot falls in it."""
    if not per_slot:
        if t0 <= slot < t1:
            _write(kc, vc, kq, vq, rows, slot - t0, False)
        return
    loc = slot - t0
    own = ((loc >= 0) & (loc < t1 - t0))[:, None, None]
    loc = torch.clamp(loc, 0, t1 - t0 - 1)
    kc[rows, loc] = torch.where(own, kq.to(kc.dtype), kc[rows, loc])
    vc[rows, loc] = torch.where(own, vq.to(vc.dtype), vc[rows, loc])
