"""Core layers: the quantization-aware dense layer, embeddings, norms,
RoPE.

The dense layer is where the paper's technique enters every LM
projection: `QuantConfig` selects float ('off'), fake-quant ('fake', the
QAT forward) or integer deployment ('int'), which holds chunk-planar
packed sub-byte weights and runs the packed GEMM with a per-channel
dequant epilogue (`repro_torch.kernels.api.int_gemm`: the Hopper kernel
on CUDA tensors, its plain version on CPU tensors). Under a ``segments``
plan the flat segmented container runs the mixed-operand GEMM, all runs
in one launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.packing import SegmentMap
from repro_torch.core.quantize import QuantSpec, fake_quantize
from repro_torch.kernels.common import check_pipeline
from repro_torch.nn.module import ParamDef


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "off"        # off | fake | int
    w_bits: int = 8
    a_bits: int = 8
    # static activation absmax in int mode (None: dynamic per tensor)
    a_absmax: Optional[float] = 4.0
    # backend a plan names ('cuda' | 'torch', checked against the device
    # the net is placed on); None: whatever the device runs
    backend: Optional[str] = None
    # kernel pipeline ('off' | 'double_buffer'); None resolves at run time
    pipeline: Optional[str] = None
    # fine-grain (n_start, n_end, w_bits) output-channel runs, validated
    # through `SegmentMap`; None means uniform w_bits
    segments: Optional[tuple] = None

    def __post_init__(self):
        if self.pipeline is not None:
            check_pipeline(self.pipeline)
        if self.segments is not None:
            object.__setattr__(self, "segments", SegmentMap(
                tuple(tuple(r) for r in self.segments)).runs)

    @property
    def enabled(self):
        return self.mode != "off"


QOFF = QuantConfig()


# Calibration tap: when set, dense_apply calls it with (params, x) before
# the matmul (host-side inspection passes, e.g. checking every dense call
# of a decode step against the plain version).
_DENSE_TAP: Optional[Callable] = None


@contextlib.contextmanager
def dense_tap(fn: Callable):
    """Install ``fn(params_dict, x)`` as the dense-apply observer."""
    global _DENSE_TAP
    prev = _DENSE_TAP
    _DENSE_TAP = fn
    try:
        yield
    finally:
        _DENSE_TAP = prev


# ---------------------------------------------------------------- dense ---

def dense_def(d_in: int, d_out: int, axes=("embed", "mlp"), *,
              bias: bool = False, qcfg: QuantConfig = QOFF,
              dtype=torch.float32, scale: float = 1.0):
    if qcfg.mode == "int" and qcfg.segments is not None:
        segmap = SegmentMap(qcfg.segments)
        if segmap.n != d_out:
            raise ValueError(
                f"segment map covers N={segmap.n} but d_out={d_out}")
        # flat segmented container (panel-major, exact bytes)
        p = {"w_packed": ParamDef((segmap.packed_bytes(d_in),), (None,),
                                  "zeros", torch.int8),
             "w_scale": ParamDef((d_out,), (axes[1],), "ones",
                                 torch.float32)}
    elif qcfg.mode == "int":
        kp = packing.padded_size(d_in) // packing.pack_factor(qcfg.w_bits)
        p = {"w_packed": ParamDef((kp, d_out), (axes[0], axes[1]),
                                  "zeros", torch.int8),
             "w_scale": ParamDef((d_out,), (axes[1],), "ones",
                                 torch.float32)}
    else:
        p = {"w": ParamDef((d_in, d_out), axes, "normal", dtype, scale)}
    if bias:
        p["b"] = ParamDef((d_out,), (axes[1],), "zeros", dtype)
    return p


def dense_apply(p, x, *, qcfg: QuantConfig = QOFF):
    """x: (..., d_in) bf16/f32 -> (..., d_out) in x's dtype."""
    if _DENSE_TAP is not None:
        _DENSE_TAP(p, x)
    if qcfg.mode == "int":
        y = _int_matmul(p, x, qcfg)
    elif qcfg.mode == "fake":
        w = p["w"]
        sw = QuantSpec.weight(qcfg.w_bits, 3.0 / (w.shape[0] ** 0.5))
        sa = QuantSpec(qcfg.a_bits, True, -qcfg.a_absmax, qcfg.a_absmax)
        y = torch.matmul(fake_quantize(x, sa).to(x.dtype),
                         fake_quantize(w, sw).to(x.dtype))
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


@functools.lru_cache(maxsize=256)
def const(v: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim constant on ``device``, made once and never written: built
    per call, each would be a host-to-device copy that waits for the
    stream."""
    return torch.tensor(v, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (held exactly by a Python float)."""
    return float(torch.tensor(v, dtype=dtype))


def _int_matmul(p, x, qcfg: QuantConfig):
    """W{8,4,2}A{8,4,2} integer GEMM with the per-channel dequant
    epilogue, written in x's dtype.

    Activations are quantized onto the signed a_bits grid (A8 caps at
    ±127) with the static scale absmax / a_max; the divisor is a float32
    tensor on x's device (a Python-scalar divisor would let CUDA multiply
    by its reciprocal and move codes that land on .5). The dequant scale
    is w_scale x a_scale in float32, with a_scale first rounded to
    w_scale's dtype: the reference's compiled rounding (a bfloat16 tree's
    w_scale meets a_scale as bfloat16, and XLA drops the product's round
    trip through bfloat16). A segmented container runs the mixed-operand GEMM in one launch, equal
    to the reference's per-run concatenation.
    """
    from repro_torch.core.quantize import SegmentedLinearParams
    from repro_torch.kernels.api import int_gemm

    absmax = qcfg.a_absmax or 4.0
    a_max = packing.int_range(qcfg.a_bits, True)[1]  # A8 caps at 127
    a_scale = const(absmax / a_max, torch.float32, x.device)
    k_logical = x.shape[-1]
    x_q = torch.clamp(torch.round(x.to(torch.float32) / a_scale), -a_max,
                      a_max).to(torch.int8)
    x_q = packing.pad_to_chunk(x_q, axis=-1)
    scale = p["w_scale"].to(torch.float32) * const(
        _rounded(absmax / a_max, p["w_scale"].dtype), torch.float32,
        x.device)
    if qcfg.segments is not None:
        w = SegmentedLinearParams(
            w_flat=p["w_packed"], segmap=SegmentMap(qcfg.segments),
            a_bits=qcfg.a_bits, a_signed=True, kappa=None, lam=None, m=None,
            d=0, out_bits=8, k_logical=k_logical)
        return int_gemm(x_q, w, a_bits=qcfg.a_bits, scale=scale,
                        out_dtype=x.dtype, pipeline=qcfg.pipeline)
    return int_gemm(x_q, p["w_packed"], a_bits=qcfg.a_bits,
                    w_bits=qcfg.w_bits, scale=scale, out_dtype=x.dtype,
                    pipeline=qcfg.pipeline, k_logical=k_logical)


def quantize_dense_weights(w, w_bits: int):
    """fp weights (..., K, N) -> (w_hat int8 in-range, w_scale (..., N))
    on per-output-channel symmetric grids. Leading dims (a stacked layer
    axis) broadcast, so the whole stack is range-checked before packing.
    Divisors are tensors, so the card gives the CPU's codes."""
    red = w.ndim - 2  # K axis
    absmax = torch.maximum(w.abs().amax(dim=red),
                           torch.tensor(1e-8, dtype=w.dtype,
                                        device=w.device))
    int_max = packing.int_range(w_bits, True)[1]
    w_scale = absmax / torch.tensor(int_max, dtype=w.dtype, device=w.device)
    w_hat = torch.clamp(torch.round(w / w_scale.unsqueeze(red)), -int_max,
                        int_max).to(torch.int8)
    return w_hat, w_scale


def pack_dense_weights(w, w_bits: int, *, assert_range: bool = False):
    """fp weights (K,N) or stacked (L,K,N) -> (w_packed, w_scale) for
    int-mode params. ``assert_range`` arms the truncation guard."""
    w_hat, w_scale = quantize_dense_weights(w, w_bits)
    red = w.ndim - 2
    w_hat = packing.pad_to_chunk(w_hat, axis=red)
    return packing.pack(w_hat, w_bits, axis=red,
                        assert_range=assert_range), w_scale


def pack_dense_weights_segmented(w, segments, *, assert_range: bool = False):
    """fp weights (K,N) or stacked (L,K,N) -> (w_flat, w_scale) at
    per-run widths: each output-channel run quantizes on its own
    per-channel symmetric grid at its own w_bits, then the runs pack into
    one flat segmented container (`packing.pack_segmented`). w_scale
    spans the full N."""
    segmap = (segments if isinstance(segments, SegmentMap)
              else SegmentMap(tuple(tuple(r) for r in segments)))
    if w.shape[-1] != segmap.n:
        raise ValueError(
            f"segment map covers N={segmap.n} but weights have "
            f"d_out={w.shape[-1]}")
    hats, scales = [], []
    for s, e, b in segmap.runs:
        h, sc = quantize_dense_weights(w[..., s:e], b)
        hats.append(h)
        scales.append(sc)
    w_hat = torch.cat(hats, dim=-1)
    w_scale = torch.cat(scales, dim=-1)
    return packing.pack_segmented(w_hat, segmap,
                                  assert_range=assert_range), w_scale


# ------------------------------------------------------------ embedding ---

VOCAB_PAD = 256  # vocab rows padded to a multiple of this


def padded_vocab(vocab: int) -> int:
    return vocab + (-vocab) % VOCAB_PAD


def embedding_def(vocab: int, d: int, dtype=torch.float32):
    return {"table": ParamDef((padded_vocab(vocab), d), ("vocab", "embed"),
                              "embed", dtype, scale=1.0)}


def embedding_apply(p, ids):
    return p["table"][ids.long()]


def embedding_logits(p, x, vocab: int = 0):
    """Tied output head: (..., d) @ (vocab_pad, d)^T. Padded rows are
    masked to -1e9 so the softmax ignores them."""
    lg = torch.matmul(x, p["table"].to(x.dtype).T)
    vp = p["table"].shape[0]
    if vocab and vp != vocab:
        mask = torch.arange(vp, device=lg.device) < vocab
        lg = torch.where(mask, lg, -1e9)      # -1e9 in lg's dtype
    return lg


# ---------------------------------------------------------------- norms ---

def norm_def(d: int, kind: str = "rmsnorm", dtype=torch.float32):
    if kind == "nonparam_ln":   # OLMo: non-parametric LayerNorm
        return {}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), "ones", dtype),
                "bias": ParamDef((d,), ("embed",), "zeros", dtype)}
    # rmsnorm / gemma_rmsnorm ((1+scale) form)
    return {"scale": ParamDef((d,), ("embed",),
                              "zeros" if kind == "gemma_rmsnorm" else "ones",
                              dtype)}


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p["scale"].to(torch.float32) + p["bias"].to(
                torch.float32)
        return y.to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    scale = p["scale"].to(torch.float32)
    if kind == "gemma_rmsnorm":
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


# ----------------------------------------------------------------- rope ---

@functools.lru_cache(maxsize=64)
def _freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """theta ** (-i / half) in float32, made once per (theta, half,
    device)."""
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0,
                dtype=torch.float32, device="cpu"):
    freqs = _freqs(float(theta), head_dim // 2, torch.device(device))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)            # (S, half)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x, c, s):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_apply(x, cos, sin):
    """x: (..., S, H, Dh); tables (S, Dh/2) broadcast over heads."""
    return _rotate(x, cos[:, None, :], sin[:, None, :])


def rope_apply_at(x, cos, sin, positions):
    """Decode-time RoPE: positions (B,) index the tables."""
    positions = positions.long()
    return _rotate(x, cos[positions][:, None, None, :],
                   sin[positions][:, None, None, :])


def rope_single(x, position, theta):
    """Table-free decode RoPE: x (B,1,H,Dh); position a scalar (wave
    decode: every row at the same step) or a (B,) vector (each slot at its
    own position). The per-element math is the same in both forms, so an
    all-equal vector gives the scalar's result bit for bit."""
    half = x.shape[-1] // 2
    freqs = _freqs(float(theta), half, x.device)
    if not torch.is_tensor(position) or position.dim() == 0:
        # float32(position) * freqs, with no tensor made from the host
        ang = freqs * float(position)                          # (half,)
        c = torch.cos(ang).to(x.dtype)[None, None, None, :]
        s = torch.sin(ang).to(x.dtype)[None, None, None, :]
    else:
        ang = position.to(torch.float32)[:, None] * freqs      # (B, half)
        c = torch.cos(ang).to(x.dtype)[:, None, None, :]
        s = torch.sin(ang).to(x.dtype)[:, None, None, :]
    return _rotate(x, c, s)
