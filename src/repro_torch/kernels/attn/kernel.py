"""Fused attention: the CUDA kernel and its plain version.

`attention_fused_cuda` launches the Hopper kernel (``csrc/attn.cu``:
bf16 scores on the tensor cores, online float32 softmax, bf16
probabilities times the values, the scores never in device memory) and
raises on a call outside its domain; nothing falls back.
`attention_fused_torch` is its plain version, the same arithmetic tile
by tile in torch, which the tests hold the kernel and `_sdpa` to.

The domain (`refusal` says why a call is outside it): q (B,S,Hk,G,Dh),
k (B,T,Hk,Dh), v (B,T,Hk,Dv), all bf16 on one CUDA device, none
requiring grad; Dh and Dv multiples of 8 in [8, 256]; the last stride
1, the others multiples of 8 elements (16-byte rows for cp.async) and
16-byte aligned data; mode 'causal' or 'local' (a window >= 1) with
S <= T, so that every query keeps a key, or 'bidir'. The launch is
planned here, where the CPU tests reach it (`attn_plan`): the value
width is padded to the narrowest instantiated width that holds it,
with the widest key tile whose shared memory fits.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = CudaKernel(
    "attn", "attn.cu", "attn_launch",
    [_P] * 4 + [_L] * 10 + [_I] * 9 + [ctypes.c_float] + [_I] * 2 + [_P],
    headers=("common.cuh", "mma_s8.cuh", "wgmma_bf16.cuh"))
# the kernel's K/V ring has two slots: its launches count under STAGES=2
STAGES = 2

MODES = ("causal", "local", "bidir")
BLOCK_M = 128                  # query rows a block
SMEM_MAX = 227 * 1024          # shared memory one block may use
# (padded value width, key tile) of each instantiation in attn.cu
ATTN_TILES = ((32, 128), (64, 128), (96, 128), (128, 128), (128, 64),
              (192, 64), (256, 64))
LOG2E = 1.4426950408889634


def smem_bytes(dh: int, dvp: int, bc: int) -> int:
    """Shared memory of a block: Q, two K and two V slots, bf16, each
    row padded to whole 64-value (128-byte) swizzle atoms."""
    def atoms(x):
        return -(-x // 64) * 64
    return 2 * (BLOCK_M * atoms(dh) + 2 * bc * atoms(dh)
                + 2 * bc * atoms(dvp))


def attn_plan(dh: int, dv: int) -> Optional[Tuple[int, int]]:
    """(padded value width, key tile) of the launch at head widths
    (``dh``, ``dv``): the narrowest instantiated value width that holds
    ``dv``, then the wider key tile whose shared memory fits; None
    outside the kernel's widths."""
    if not (8 <= dh <= 256 and dh % 8 == 0 and 8 <= dv <= 256
            and dv % 8 == 0):
        return None
    for dvp, bc in sorted(ATTN_TILES, key=lambda t: (t[0], -t[1])):
        if dvp >= dv and smem_bytes(dh, dvp, bc) <= SMEM_MAX:
            return dvp, bc
    return None


def _mask_args(mode: str, window) -> Tuple[int, int]:
    """(causal, window) as the kernel takes them."""
    if mode == "bidir":
        return 0, 0
    return 1, (int(window) if mode == "local" else 0)


def layout_refusal(q, k, v, *, mode: str, window=None) -> Optional[str]:
    """Why the kernel cannot take these shapes, strides and mask (None:
    it can), whatever their device and dtype."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        return (f"expected q (B,S,Hk,G,Dh), k (B,T,Hk,Dh), v (B,T,Hk,Dv); "
                f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hk, g, dh = q.shape
    t, dv = k.shape[1], v.shape[-1]
    if (tuple(k.shape) != (b, t, hk, dh)
            or tuple(v.shape[:3]) != (b, t, hk)):
        return (f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                f"{tuple(v.shape)} disagree")
    if min(b, s, t, hk, g) < 1:
        return "an empty dimension"
    if attn_plan(dh, dv) is None:
        return (f"head widths (Dh={dh}, Dv={dv}): the kernel takes "
                "multiples of 8 in [8, 256]")
    if mode not in MODES:
        return f"mode {mode!r}, expected one of {MODES}"
    if mode == "local" and (window is None or int(window) < 1):
        return f"local attention with window {window!r}"
    if mode != "bidir" and s > t:
        return (f"{mode} attention of S={s} queries over T={t} < S keys "
                "(a query could keep no key)")
    if -(-s * g // BLOCK_M) * b * hk > 2 ** 31 - 1:
        return f"{b * hk} heads of S x G = {s * g} rows exceed the grid"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]):
            return (f"{name} strides {x.stride()}: the kernel takes rows "
                    "of 16 bytes, the last stride 1")
        if x.data_ptr() % 16:
            return f"{name} does not start 16-byte aligned"
    return None


def refusal(q, k, v, *, mode: str, window=None) -> Optional[str]:
    """Why the CUDA kernel cannot take this call, the reasons that hold
    joined by '; ' (None: it can); the layout is read on CUDA tensors
    only."""
    why = []
    dev = q.device
    on_card = dev.type == "cuda" and k.device == dev and v.device == dev
    if not on_card:
        why.append(f"tensors on {q.device}, {k.device}, {v.device}: the "
                   "kernel takes one CUDA device")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        why.append(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                   "takes bf16")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        why.append("an input requires grad: the kernel has no backward")
    layout = on_card and layout_refusal(q, k, v, mode=mode, window=window)
    if layout:
        why.append(layout)
    return "; ".join(why) or None


def attention_fused_torch(q, k, v, *, mode: str, window=None,
                          scale: Optional[float] = None,
                          block: int = 128) -> torch.Tensor:
    """Plain version: the kernel's arithmetic in torch, key tile by key
    tile of ``block``: float32 scores of the inputs, the online softmax
    in the log2 domain, the probabilities rounded to v's dtype before the
    value product, the sum divided out at the end. (B,S,Hk*G*Dv) in v's
    dtype. Runs on whatever device the tensors are on."""
    b, s, hk, g, dh = q.shape
    t, dv = k.shape[1], v.shape[-1]
    causal, win = _mask_args(mode, window)
    sl2 = (dh ** -0.5 if scale is None else scale) * LOG2E
    dev = q.device
    qf = q.to(torch.float32)
    m = torch.full((b, hk, g, s, 1), -math.inf, device=dev)
    l = torch.zeros((b, hk, g, s, 1), device=dev)
    o = torch.zeros((b, hk, g, s, dv), device=dev)
    q_pos = torch.arange(s, device=dev)[:, None]
    for c0 in range(0, t, block):
        c1 = min(t, c0 + block)
        sc = torch.einsum("bshgd,bthd->bhgst", qf,
                          k[:, c0:c1].to(torch.float32))
        k_pos = torch.arange(c0, c1, device=dev)[None, :]
        allow = torch.ones((s, c1 - c0), dtype=torch.bool, device=dev)
        if causal:
            allow = allow & (k_pos <= q_pos)
        if win:
            allow = allow & (q_pos - k_pos < win)
        sc = torch.where(allow, sc, -math.inf)
        mn = torch.maximum(m, sc.amax(-1, keepdim=True) * sl2)
        base = torch.where(mn == -math.inf, 0.0, mn)
        alpha = torch.exp2(m - base)
        p = torch.exp2(sc * sl2 - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(v.dtype).to(torch.float32),
            v[:, c0:c1].to(torch.float32))
        m = mn
    out = torch.where(l > 0, o / l, 0.0).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hk * g * dv)


def attention_fused_cuda(q, k, v, *, mode: str, window=None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors as `attn_plan` plans it;
    raises on a call outside its domain (`refusal`)."""
    why = refusal(q, k, v, mode=mode, window=window)
    if why is not None:
        raise ValueError(f"fused attention kernel: {why}")
    b, s, hk, g, dh = q.shape
    t, dv = k.shape[1], v.shape[-1]
    dvp, bc = attn_plan(dh, dv)
    causal, win = _mask_args(mode, window)
    out = torch.empty((b, s, hk * g * dv), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(
            STAGES, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:4], *k.stride()[:3],
            *v.stride()[:3], b, s, t, hk, g, dh, dv, causal, win,
            float(dh ** -0.5 if scale is None else scale), dvp, bc, stream)
    return out

