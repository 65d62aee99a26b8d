"""Ring decode-attention and collective matmul as lockstep schedules over
the mesh positions of one axis.

**Paper analogy:** each per-position body here is what one core of the
XpulpNN cluster runs between synchronization points; the copies between
positions play the cluster's interconnect moving operand tiles between
cores. The reference writes these as ``shard_map`` bodies with
``ppermute`` / ``psum`` / ``pmax``; with one controller the port runs
every position's body in turn (each on its device, on its own stream
where positions share a card) and does the collective as explicit
copies between devices, in the order the reference's ring gives.

Packed sub-byte operands never enter these paths: they are float
patterns that need a cross-position combine, unlike the psum-free
integer GEMMs of `repro_torch.kernels.api.qdot_sharded`.

ring_decode_attention: flash-decoding over a KV cache split on the
sequence over ``axis``: each position computes a partial (numerator,
denominator, max) over its slice, and one log-sum-exp combine merges
them.

collective_matmul: x arrives split on K, w on N; at each ring hop a
position multiplies the x block it holds with the matching K rows of its
w columns, then passes the x block on.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.mesh import (Mesh, NamedSharding, P,
                                       axis_positions, device_put, gather,
                                       run_per_shard)


def ring_decode_attention(q, k_shard, v_shard, valid_mask, mesh: Mesh,
                          axis: str = "model") -> torch.Tensor:
    """q: (B, H, Dh) replicated; k / v: (B, T, H, Dh) split on T over
    ``axis`` (global tensors or `Sharded`); valid_mask: (B, T) bool.
    Returns (B, H, Dh) on ``q``'s device."""
    pos = axis_positions(mesh, axis)
    kv = NamedSharding(mesh, P(None, axis, None, None))
    ks = device_put(k_shard, kv)
    vs = device_put(v_shard, kv)
    ms = device_put(valid_mask, NamedSharding(mesh, P(None, axis)))
    qs = device_put(q, NamedSharding(mesh, P()))

    def local(p, q, k, v, mask):
        dh = q.shape[-1]
        s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) \
            * dh ** -0.5
        s = torch.where(mask[:, None, :], s, -torch.inf)
        m_loc = s.amax(dim=-1)                              # (B, H)
        has = torch.isfinite(m_loc)
        safe_m = torch.where(has, m_loc, 0.0)
        pr = torch.where(mask[:, None, :], torch.exp(s - safe_m[..., None]),
                         0.0)
        num = torch.einsum("bht,bthd->bhd", pr.to(v.dtype), v)
        den = pr.sum(dim=-1)
        return num, den, torch.where(has, m_loc, -torch.inf), safe_m, has

    parts = run_per_shard(
        mesh, local, [(qs.shards[p], ks.shards[p], vs.shards[p],
                       ms.shards[p]) for p in pos], pos)
    dev = q.device if isinstance(q, torch.Tensor) else mesh.flat[0]
    parts = [[t.to(dev) for t in part] for part in parts]
    m_glob = torch.stack([m for _, _, m, _, _ in parts]).amax(dim=0)
    num = den = None
    for n_p, d_p, _, safe_m, has in parts:
        scale = torch.exp(safe_m - m_glob) * has
        n_p = n_p * scale[..., None].to(n_p.dtype)
        d_p = d_p * scale
        num = n_p if num is None else num + n_p
        den = d_p if den is None else den + d_p
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(qs.dtype)


def collective_matmul(x, w, mesh: Mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """y = x @ w. x: (M, K) split on K over ``axis``; w: (K, N) split on
    N. After hop i the position at axis index d holds x block (d - i)
    mod n and adds its product with rows [(d-i)*kloc, (d-i+1)*kloc) of
    its w columns. Returns y (M, N) on ``x``'s device."""
    pos = axis_positions(mesh, axis)
    n = len(pos)
    flat = mesh.flat
    xs = device_put(x, NamedSharding(mesh, P(None, axis)))
    ws = device_put(w, NamedSharding(mesh, P(None, axis)))
    held = [xs.shards[p] for p in pos]
    kloc = held[0].shape[-1]
    dtype = torch.promote_types(xs.dtype, ws.dtype)
    acc = [torch.zeros((held[0].shape[0], ws.shards[p].shape[1]),
                       dtype=dtype, device=flat[p]) for p in pos]

    def hop(p, a, x_blk, w_loc, i):
        d = pos.index(p)
        src = (d - i) % n
        return a + x_blk.to(dtype) @ w_loc[src * kloc:(src + 1) * kloc] \
            .to(dtype)

    for i in range(n):
        acc = run_per_shard(
            mesh, hop, [(acc[d], held[d], ws.shards[p], i)
                        for d, p in enumerate(pos)], pos)
        # ppermute d -> d + 1
        held = [held[(d - 1) % n].to(flat[p]) for d, p in enumerate(pos)]
    out = torch.cat([a.to(xs.dtype).to(flat[pos[0]]) for a in acc], dim=1)
    return gather(out, x.device if isinstance(x, torch.Tensor) else None)
