"""Mamba-2 SSD (state-space duality) block: the chunked parallel form for
a full sequence and the O(1)-state update for decode (Dao & Gu,
arXiv:2405.21060, §6).

The paper's technique applies to the in / out projections (GEMM-shaped
quantization-aware dense layers); the causal conv, the SSD scan and the
recurrence are plain torch, as the reference leaves them to XLA outside
any kernel, with float32 state. Its einsums take compute-dtype operands
with float32 accumulation (``preferred_element_type``): here the
operands are cast to float32 first, and the decay factors are rounded to
the compute dtype where the reference rounds them.

Under tensor parallelism (`repro_torch.parallel.tp`) each model
position holds a block of heads: in_proj's columns of its z, x and dt
(and the B / C columns, which every head reads, replicated), the
depthwise conv over its x channels and B / C, the SSD scan or the
state update of its heads, and the gated RMSNorm over d_inner, whose
sum of squares adds across positions; out_proj is row-parallel over the
heads' d_inner runs where its K can split there (else column-parallel
over the gathered output). The decode state splits the same way: ssm
over heads, conv over its channels (B / C replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.nn.layers import (QOFF, QuantConfig, dense_apply,
                                   dense_col, dense_cuts, dense_def,
                                   dense_row, row_parallel_ok)
from repro_torch.nn.module import ParamDef
from repro_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    qcfg: QuantConfig = QOFF
    plan: Optional[PrecisionPlan] = None
    path: str = "layers/mixer"

    @property
    def d_inner(self):
        return self.expand * self.d_model

    def q(self, name: str) -> QuantConfig:
        return resolve_qcfg(self.plan, f"{self.path}/{name}", self.qcfg)

    @property
    def n_heads(self):
        return self.d_inner // self.headdim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.d_state  # x + B + C channels


def mamba_def(cfg: MambaConfig, dtype=torch.float32):
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    d_in_proj = 2 * di + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": dense_def(cfg.d_model, d_in_proj, ("embed", "mlp"),
                             qcfg=cfg.q("in_proj"), dtype=dtype),
        "conv_w": ParamDef((cfg.d_conv, cfg.conv_dim), (None, "mlp"),
                           "normal", dtype),
        "conv_b": ParamDef((cfg.conv_dim,), ("mlp",), "zeros", dtype),
        "a_log": ParamDef((h,), (None,), "zeros", torch.float32),
        "d_skip": ParamDef((h,), (None,), "ones", torch.float32),
        "dt_bias": ParamDef((h,), (None,), "zeros", torch.float32),
        "norm_scale": ParamDef((di,), ("mlp",), "ones", dtype),
        "out_proj": dense_def(di, cfg.d_model, ("mlp", "embed"),
                              qcfg=cfg.q("out_proj"), dtype=dtype),
    }


def _segsum(a):
    """(..., l) -> (..., l, l) lower-triangular cumulative segment sums,
    -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, ss, -torch.inf)


def _f32(*ts):
    return [t.to(torch.float32) for t in ts]


def _ssd_chunked(x, a, b, c, chunk):
    """SSD scan. x: (B,L,H,P) values; a: (B,L,H) float32 log-decay
    (= dt*A, <= 0); b, c: (B,L,H,N); L a multiple of ``chunk``. Returns y
    (B,L,H,P) float32 and the final state (B,H,P,N) float32."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    nc = l // chunk
    dt = x.dtype
    xs = x.reshape(bs, nc, chunk, h, p)
    as_ = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)    # (B,H,C,l)
    bs_ = b.reshape(bs, nc, chunk, h, n)
    cs_ = c.reshape(bs, nc, chunk, h, n)

    a_cum = torch.cumsum(as_, dim=-1)                         # (B,H,C,l)

    # 1. intra-chunk (diagonal blocks)
    ll = torch.exp(_segsum(as_)).to(dt)                       # (B,H,C,l,l)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp",
                          *_f32(cs_, bs_, ll, xs))

    # 2. states at chunk ends
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).to(dt)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn",
                          *_f32(bs_, decay_states, xs))

    # 3. inter-chunk recurrence
    chunk_decay = a_cum[..., -1]                              # (B,H,C)
    pad = F.pad(chunk_decay, (1, 0))
    dc = torch.exp(_segsum(pad))                              # (B,H,C+1,C+1)
    dc = torch.where(torch.isfinite(dc), dc, 0.0)
    init = torch.zeros((bs, 1) + states.shape[2:], dtype=states.dtype,
                       device=states.device)
    all_states = torch.cat([init, states], dim=1)             # (B,C+1,H,P,N)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, all_states)
    prev_states = new_states[:, :-1]                          # (B,C,H,P,N)
    final_state = new_states[:, -1]

    # 4. state -> output
    out_decay = torch.exp(a_cum).to(dt)                       # (B,H,C,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp",
                         *_f32(cs_, prev_states.to(dt), out_decay))
    y = (y_diag + y_off).reshape(bs, l, h, p)
    return y, final_state


def _causal_conv_dw(u, w):
    """(B,L,C) depthwise causal conv with (K,C) taps: a cross-correlation
    over the last K positions (left padding K-1), taps not flipped."""
    k, c = w.shape
    y = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)),
                 w.T[:, None, :].to(u.dtype), groups=c)
    return y.transpose(1, 2)


def _split_proj(zxbcdt, cfg: MambaConfig):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


def mamba_apply(p, xin, cfg: MambaConfig):
    """Full-sequence forward. xin: (B,L,d_model)."""
    grp = tp.tp_group()
    if grp is not None:
        return _mamba_tp(grp, p, xin, cfg)
    bs, l, _ = xin.shape
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    zxbcdt = dense_apply(p["in_proj"], xin, qcfg=cfg.q("in_proj"))
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = F.silu(_causal_conv_dw(xbc, p["conv_w"].to(xin.dtype))
                 + p["conv_b"].to(xin.dtype)[None, None, :])
    x = xbc[..., :di].reshape(bs, l, h, pd)
    b = xbc[..., di:di + n][:, :, None, :].expand(bs, l, h, n)
    c = xbc[..., di + n:][:, :, None, :].expand(bs, l, h, n)
    y = _ssd_heads(p, x, b, c, dt, cfg, xin.dtype) * F.silu(z)
    y = _rms(y, p["norm_scale"])
    return dense_apply(p["out_proj"], y, qcfg=cfg.q("out_proj"))


def _ssd_heads(p, x, b, c, dt, cfg: MambaConfig, dtype):
    """The SSD scan of heads x (B,L,H,P) with the shared b, c (B,L,H,N)
    and their dt (B,L,H) -> y (B,L,H*P) in ``dtype`` (before the gate)."""
    bs, l, h, _ = x.shape
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])[None, None, :] * dt            # log-decay
    # SSD operands in the compute dtype (the decay cumsums stay float32)
    xdt = (x.to(torch.float32) * dt[..., None]).to(dtype)
    # pad L to a chunk multiple; zero x-contributions keep outputs exact
    pad = (-l) % cfg.chunk
    if pad:
        def padt(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xdt, a, b, c = padt(xdt), padt(a), padt(b), padt(c)
    y, _ = _ssd_chunked(xdt, a, b.to(dtype), c.to(dtype), cfg.chunk)
    if pad:
        y = y[:, :l]
    y = y + x.to(torch.float32) * p["d_skip"][None, None, :, None]
    return y.reshape(bs, l, -1).to(dtype)


def _rms(x, scale, eps=1e-6, ms=None):
    """The gated RMSNorm; ``ms``: the mean square over the whole width
    when ``x`` is one position's block of it."""
    xf = x.to(torch.float32)
    if ms is None:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def mamba_init_cache(cfg: MambaConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p, xin, cache, cfg: MambaConfig):
    """Single-token decode. xin: (B,1,d_model). The O(1) state update is
    written into ``cache`` in place (the returned cache is the same
    dict)."""
    grp = tp.tp_group()
    if grp is not None:
        return _mamba_tp(grp, p, xin, cfg, cache), cache
    bs = xin.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    zxbcdt = dense_apply(p["in_proj"], xin, qcfg=cfg.q("in_proj"))
    z, xbc, dt = _split_proj(zxbcdt[:, 0], cfg)
    conv_buf = torch.cat([cache["conv"].to(xbc.dtype), xbc[:, None, :]],
                         dim=1)
    w = p["conv_w"].to(xin.dtype)
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", conv_buf, w)
                   + p["conv_b"].to(xin.dtype))
    x = xbc_c[..., :di].reshape(bs, h, pd).to(torch.float32)
    b = xbc_c[..., di:di + n].to(torch.float32)
    c = xbc_c[..., di + n:].to(torch.float32)
    ssm, y = _state_step(p, cache["ssm"], x, b, c, dt)
    y = y.reshape(bs, di).to(xin.dtype)
    y = y * F.silu(z)
    y = _rms(y, p["norm_scale"])
    out = dense_apply(p["out_proj"], y[:, None, :], qcfg=cfg.q("out_proj"))
    cache["conv"].copy_(conv_buf[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache


def _state_step(p, state, x, b, c, dt):
    """The O(1) update of heads x (B,H,P) float32 with b, c (B,N) ->
    (new state (B,H,P,N), y (B,H,P) float32)."""
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, :])
    a = torch.exp(-torch.exp(p["a_log"])[None, :] * dt)       # (B,H)
    ssm = state * a[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", x, b, dt)
    y = torch.einsum("bhpn,bn->bhp", ssm, c)
    return ssm, y + x * p["d_skip"][None, :, None]


# ------------------------------------------- tensor parallel (model) ---

def head_runs(cfg: MambaConfig, m: int):
    """Each model position's heads."""
    return tp.even_runs(cfg.n_heads, m)


def _layout(cfg: MambaConfig, m: int):
    """(head runs, d_inner runs, in_proj column runs, conv channel runs,
    out_proj's kind and runs)."""
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    hr = head_runs(cfg, m)
    dr = tp.scale_runs(hr, pd)
    proj = tuple(r and (r[0], (di + r[0][0], di + r[0][1]),
                        (2 * di, 2 * di + 2 * n),
                        (2 * di + 2 * n + hh[0][0], 2 * di + 2 * n + hh[0][1]))
                 for r, hh in zip(dr, hr))
    conv = tuple(r and (r[0], (di, di + 2 * n)) for r in dr)
    if row_parallel_ok(cfg.q("out_proj"), dr, di):
        return hr, dr, proj, conv, "row", dr
    return hr, dr, proj, conv, "col", tp.even_runs(cfg.d_model, m)


def mamba_cuts(cfg: MambaConfig, m: int):
    hr, dr, proj, conv, kind, oruns = _layout(cfg, m)
    hc = tp.Cut(-1, hr)
    return {"in_proj": dense_cuts(cfg.q("in_proj"), "col", proj,
                                  cfg.d_model),
            "conv_w": tp.Cut(-1, conv), "conv_b": tp.Cut(-1, conv),
            "a_log": hc, "d_skip": hc, "dt_bias": hc,
            "norm_scale": tp.Cut(-1, dr),
            "out_proj": dense_cuts(cfg.q("out_proj"), kind, oruns,
                                   cfg.d_inner)}


def mamba_cache_cuts(cfg: MambaConfig, m: int):
    hr, _, _, conv, _, _ = _layout(cfg, m)
    return {"conv": tp.Cut(-1, conv), "ssm": tp.Cut(-3, hr)}


def _mamba_tp(grp, p, xin, cfg: MambaConfig, cache=None):
    """The block on the group; with ``cache`` one decode step."""
    di, n, pd = cfg.d_inner, cfg.d_state, cfg.headdim
    hr, dr, proj, conv, kind, oruns = _layout(cfg, grp.m)
    p = tp.place(p, mamba_cuts(cfg, grp.m), grp)
    live = [i for i, r in enumerate(hr) if r]
    parts = dense_col(p["in_proj"], xin, qcfg=cfg.q("in_proj"), runs=proj,
                      group=grp, k_full=cfg.d_model)
    dtype = xin.dtype
    if cache is not None:
        convs = tp.parts_of(cache["conv"], conv, -1)
        states = tp.parts_of(cache["ssm"], hr, -3)

    def one(i, zxbcdt):
        lp = tp.local(p, i, grp.devices[i])
        nh = tp.run_len(hr[i])
        nd = nh * pd
        z = zxbcdt[..., :nd]
        xbc = zxbcdt[..., nd:2 * nd + 2 * n]
        dt = zxbcdt[..., 2 * nd + 2 * n:]
        w = lp["conv_w"].to(dtype)
        if cache is None:
            bs, l = xin.shape[:2]
            xbc = F.silu(_causal_conv_dw(xbc, w)
                         + lp["conv_b"].to(dtype)[None, None, :])
            x = xbc[..., :nd].reshape(bs, l, nh, pd)
            b = xbc[..., nd:nd + n][:, :, None, :].expand(bs, l, nh, n)
            c = xbc[..., nd + n:][:, :, None, :].expand(bs, l, nh, n)
            y = _ssd_heads(lp, x, b, c, dt, cfg, dtype)
        else:
            bs = xin.shape[0]
            buf = torch.cat([convs[i].to(xbc.dtype), xbc], dim=1)
            xc = F.silu(torch.einsum("bkc,kc->bc", buf, w)
                        + lp["conv_b"].to(dtype))
            x = xc[..., :nd].reshape(bs, nh, pd).to(torch.float32)
            b = xc[..., nd:nd + n].to(torch.float32)
            c = xc[..., nd + n:].to(torch.float32)
            ssm, y = _state_step(lp, states[i], x, b, c, dt[:, 0])
            convs[i].copy_(buf[:, 1:])
            states[i].copy_(ssm)
            y = y.reshape(bs, 1, nd).to(dtype)
        y = y * F.silu(z)
        yf = y.to(torch.float32)
        return y, (yf * yf).sum(-1, keepdim=True)

    outs = grp.run(one, [(parts[i],) for i in live], live)
    if cache is not None:
        tp.write_back(cache["conv"], convs, conv, -1)
        tp.write_back(cache["ssm"], states, hr, -3)
    ms = tp.total([o[1] for o in outs], grp.leader) / di
    ys = [None] * grp.m
    for i, o in zip(live, outs):
        ys[i] = _rms(o[0], tp.local(p, i)["norm_scale"], ms=grp.to(ms, i))
    if kind == "row":
        return dense_row(p["out_proj"], ys, qcfg=cfg.q("out_proj"),
                         runs=dr, group=grp, k_full=di)
    y = tp.join(ys, dr, -1, di, grp.leader)
    return tp.join(dense_col(p["out_proj"], y, qcfg=cfg.q("out_proj"),
                             runs=oruns, group=grp, k_full=di),
                   oruns, -1, cfg.d_model, grp.leader)
