"""Integer-image quantization algebra — paper §III-A, eqs. (1)-(4).

    t = alpha + eps * t_hat                                           (1)
    phi_hat   = sum_n w_hat[m,n] * x_hat[n]        (int32 accum)      (2)
    phi'_hat  = kappa_hat * phi_hat + lambda_hat   (int32, wraps)     (3)
    y_hat     = clip((m * phi'_hat) >> d, 0, 2^N-1)                   (4)

Every integer here matches ``repro.core.quantize`` exactly: the int32 wrap
of eq. 3, the floor of the hi/lo requant split, and the float32 division
that places codes on the grid (the reference divides in float32 because
jnp casts the Python-float eps to the array's dtype; so does `quantize`).
The BN fold is float64 host math (numpy), as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing

M_BITS = 15  # requant multiplier m in [0, 2^15)
D_MIN, D_MAX = 16, 31


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Affine quantization grid for one tensor (eq. 1)."""

    bits: int
    signed: bool
    alpha: float
    beta: float

    @property
    def eps(self) -> float:
        if self.signed:
            return self.beta / self.int_max
        return (self.beta - self.alpha) / self.int_max

    @property
    def int_min(self) -> int:
        if self.signed:
            return -self.int_max  # symmetric grid
        return packing.int_range(self.bits, self.signed)[0]

    @property
    def int_max(self) -> int:
        return packing.int_range(self.bits, self.signed)[1]

    @staticmethod
    def activation(bits: int, beta: float) -> "QuantSpec":
        return QuantSpec(bits=bits, signed=False, alpha=0.0, beta=beta)

    @staticmethod
    def weight(bits: int, absmax: float) -> "QuantSpec":
        return QuantSpec(bits=bits, signed=True, alpha=-absmax, beta=absmax)


def quantize(t: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Real tensor -> integer image (int8 container), eq. (1) inverted.

    The divisor is a float32 tensor on ``t``'s device: a Python-scalar
    divisor would let CUDA multiply by its reciprocal, which moves codes
    that land on .5 boundaries.
    """
    zero = 0.0 if spec.signed else spec.alpha
    eps = torch.tensor(spec.eps, dtype=torch.float32, device=t.device)
    t_hat = torch.round((t.to(torch.float32) - zero) / eps)
    t_hat = torch.clamp(t_hat, spec.int_min, spec.int_max)
    return t_hat.to(torch.int8)


def dequantize(t_hat: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    zero = 0.0 if spec.signed else spec.alpha
    return zero + spec.eps * t_hat.to(torch.float32)


def fake_quantize(t: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator (the QAT
    forward of the dense layer's 'fake' mode): the reference's values, in
    its types. The grid step is taken in ``t``'s dtype (the reference
    casts its Python-float eps to the array's dtype), the dequantized
    grid in float32, and the result is float32; the gradient is identity
    inside the representable range and zero outside."""
    def lit(v, dtype=t.dtype):
        return torch.tensor(v, dtype=dtype, device=t.device)

    zero = 0.0 if spec.signed else spec.alpha
    t_hat = torch.clamp(torch.round((t - lit(zero)) / lit(spec.eps)),
                        spec.int_min, spec.int_max).to(torch.int8)
    q = (lit(zero, torch.float32)
         + lit(spec.eps, torch.float32) * t_hat.to(torch.float32))
    lo = spec.alpha + spec.eps * spec.int_min if spec.signed else spec.alpha
    hi = spec.alpha + spec.eps * spec.int_max
    t_clip = torch.clamp(t, lit(lo), lit(hi))
    return t_clip + (q - t_clip).detach()


# --- int8 side-channel codecs (optimizer state, gradient wire) ---------
# Symmetric absmax int8 with tensor scales, the reference's codes and
# scales exactly: rowwise keeps the param shape (one scale per last-axis
# row: the optimizer's m), blockwise runs over the flat tensor in BLOCK
# runs (the gradient compression wire).

BLOCK = 256          # blockwise run length (gradient wire)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_int8_rowwise(x: torch.Tensor) -> dict:
    """Per-row (last axis) symmetric int8: {"codes", "scale"}."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / _f32(127.0, x)
    scale = torch.maximum(scale, _f32(1e-12, x))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale[..., 0]}


def dequantize_int8_rowwise(s: dict, shape=None) -> torch.Tensor:
    """Inverse of `quantize_int8_rowwise` (``shape`` is accepted as the
    log-scale codec takes it; the codes carry it)."""
    return s["codes"].to(torch.float32) * s["scale"][..., None]


def quantize_int8_blockwise(x: torch.Tensor):
    """Flat BLOCK-run symmetric int8 -> (codes (n/BLOCK, BLOCK), scale
    (n/BLOCK, 1))."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    xb = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.maximum(
        torch.amax(torch.abs(xb), dim=1, keepdim=True) / _f32(127.0, x),
        _f32(1e-12, x))
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                              shape) -> torch.Tensor:
    """Inverse of `quantize_int8_blockwise`, the pad cropped."""
    n = int(np.prod(shape, dtype=np.int64))
    x = codes.to(torch.float32) * scale
    return x.reshape(-1)[:n].reshape(tuple(shape))


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 into the int32 range (two's
    complement), still as int64 — how int32 arithmetic wraps."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lin(w_hat: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Eq. (2): int8 x (..., K) @ int8 w (K, N) -> int32 (..., N), exact
    (the kernels' plain integer contraction; int32 wraps as in the
    reference)."""
    from repro_torch.kernels.common import int_matmul  # imports this module
    x = x_hat.to(torch.int8)
    out = int_matmul(x.reshape(-1, x.shape[-1]), w_hat.to(torch.int8))
    return out.reshape(*x.shape[:-1], out.shape[-1])


def batchnorm_int(phi: torch.Tensor, kappa, lam) -> torch.Tensor:
    """Eq. (3): per-output-channel integer batch-norm with int32
    wraparound (the 32-bit RISC-V MAC's), kappa and lam cast to int32
    first as the reference casts them."""
    def i32(v):
        return torch.as_tensor(v, device=phi.device).to(torch.int32).to(
            torch.int64)
    return wrap_int32(phi.to(torch.int32).to(torch.int64) * i32(kappa)
                      + i32(lam)).to(torch.int32)


def requantize_shift(phi: torch.Tensor, m, d: int) -> torch.Tensor:
    """Exact ``(m * phi) >> d`` (floor) with the reference's int32 hi/lo
    split, for d in [16, 31]; every product wraps as int32 would.

    With hi = phi >> 16 and lo = phi & 0xFFFF,
    m*phi = (m*hi + ((m*lo) >> 16)) * 2^16 + ((m*lo) & 0xFFFF), so for
    s = d - 16 the floor of m*phi / 2^d is ``a >> s``.
    """
    phi = phi.to(torch.int64)
    m = torch.as_tensor(m, device=phi.device).to(torch.int64)
    hi = phi >> 16
    lo = phi & 0xFFFF
    mlo = wrap_int32(m * lo)
    a = wrap_int32(wrap_int32(m * hi) + (mlo >> 16))
    return (a >> (d - 16)).to(torch.int32)


def requantize_shift_i64(phi, m, d):
    """numpy int64 oracle for :func:`requantize_shift`."""
    phi = np.asarray(phi, dtype=np.int64)
    m = np.asarray(m, dtype=np.int64)
    return ((m * phi) >> d).astype(np.int64)


def qnt_act(phi_prime: torch.Tensor, m, d: int,
            out_bits: int) -> torch.Tensor:
    """Eq. (4): requantize + clip to the unsigned N-bit grid."""
    y = requantize_shift(phi_prime, m, d)
    hi = packing.int_range(out_bits, False)[1]
    return torch.clamp(y, 0, hi).to(torch.int8)


def pick_requant_md(ratio: float, d_min: int = D_MIN) -> tuple:
    """Largest-precision ``(m, d)`` with ``m = round(ratio * 2^d) < 2^15``."""
    ratio = float(ratio)
    if ratio <= 0:
        raise ValueError("invalid quanta")
    d = min(D_MAX, int(np.floor(np.log2((1 << M_BITS) - 1) - np.log2(ratio))))
    if d < d_min:
        raise ValueError(
            f"requant ratio {ratio} too large for int32 requant "
            f"(d={d} < {d_min}); re-calibrate output quantum")
    return int(np.round(ratio * (1 << d))), d


def fold_bn_requant(eps_w: float, eps_x: float, eps_y: float,
                    bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                    bits_out: int, kappa_bits: int = 8):
    """Integer BN + QNT/ACT parameters from real-valued BN (float64 host
    math). Returns (kappa i32[n], lambda i32[n], m i32[n], d) with the
    three vectors on ``bn_scale``'s device."""
    device = bn_scale.device
    bn_scale = bn_scale.detach().cpu().numpy().astype(np.float64)
    bn_bias = bn_bias.detach().cpu().numpy().astype(np.float64)
    eps_phi = float(eps_w) * float(eps_x)
    kmax = max(np.abs(bn_scale).max(), 1e-12)
    eps_kappa = kmax / ((1 << (kappa_bits - 1)) - 1)
    kappa_hat = np.round(bn_scale / eps_kappa).astype(np.int32)
    eps_phi_p = eps_phi * eps_kappa
    lambda_hat = np.round(bn_bias / eps_phi_p).astype(np.int32)
    m_scalar, d = pick_requant_md(eps_phi_p / float(eps_y))
    m = np.broadcast_to(np.int32(m_scalar), bn_scale.shape).copy()
    return (torch.from_numpy(kappa_hat).to(device),
            torch.from_numpy(lambda_hat).to(device),
            torch.from_numpy(m).to(device), d)


@dataclasses.dataclass(frozen=True)
class QuantizedLinearParams:
    """Everything the integer GEMM needs — the deployable artifact."""

    w_packed: torch.Tensor  # (K_pad/pf, N) int8 containers, chunk-planar
    w_bits: int
    a_bits: int
    a_signed: bool
    kappa: torch.Tensor     # (N,) int32
    lam: torch.Tensor       # (N,) int32
    m: torch.Tensor         # (N,) int32
    d: int
    out_bits: int
    k_logical: int          # pre-padding K


@dataclasses.dataclass(frozen=True)
class SegmentedLinearParams:
    """Mixed-width deployable artifact: per-output-channel-run containers.

    ``w_flat`` is a `packing.pack_segmented` buffer whose runs over the
    output-feature axis are named by ``segmap``; the epilogue vectors span
    the full N. `segment_params` views one run as a uniform
    `QuantizedLinearParams`: running each run through the uniform GEMM and
    concatenating along N is what the mixed-operand kernel must equal.
    """

    w_flat: torch.Tensor    # (total_bytes,) int8, panel-major segmented
    segmap: packing.SegmentMap
    a_bits: int
    a_signed: bool
    kappa: torch.Tensor     # (N,) int32
    lam: torch.Tensor       # (N,) int32
    m: torch.Tensor         # (N,) int32
    d: int
    out_bits: int
    k_logical: int          # pre-padding K

    @property
    def n(self) -> int:
        return self.segmap.n

    def segment_params(self, index: int) -> QuantizedLinearParams:
        s, e, b = self.segmap.runs[index]
        return QuantizedLinearParams(
            w_packed=packing.segment_packed(self.w_flat, self.segmap,
                                            index, self.k_logical),
            w_bits=b, a_bits=self.a_bits, a_signed=self.a_signed,
            kappa=self.kappa[s:e], lam=self.lam[s:e], m=self.m[s:e],
            d=self.d, out_bits=self.out_bits, k_logical=self.k_logical)


def quantize_linear_segmented(w_hat: torch.Tensor, segmap, kappa, lam, m,
                              *, a_bits: int, a_signed: bool, d: int,
                              out_bits: int, assert_range: bool = False
                              ) -> SegmentedLinearParams:
    """Pack already-quantized int8 weight values (K, N) at per-run widths.

    Values must already sit on each run's grid (``assert_range=True``
    checks it per run). The epilogue vectors go to ``w_hat``'s device.
    """
    dev = w_hat.device

    def vec(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.int32)

    return SegmentedLinearParams(
        w_flat=packing.pack_segmented(w_hat, segmap,
                                      assert_range=assert_range),
        segmap=segmap, a_bits=a_bits, a_signed=a_signed, kappa=vec(kappa),
        lam=vec(lam), m=vec(m), d=d, out_bits=out_bits,
        k_logical=int(w_hat.shape[-2]))


def quantize_linear(w: torch.Tensor, spec_w: QuantSpec, bn_scale, bn_bias,
                    spec_x: QuantSpec,
                    spec_y: QuantSpec) -> QuantizedLinearParams:
    """Full deployment quantization of one linear layer (the paper's
    pipeline): quantize the (K, N) weights (eq. 1), pad K to a CHUNK
    multiple, pack chunk-planar along K, and fold the real BN and the
    output grid into integer kappa / lambda / (m, d) (eqs. 3-4). Every
    tensor of the artifact lives on ``w``'s device."""
    w_hat = quantize(w, spec_w)                       # (K, N) int8
    k_logical = w_hat.shape[0]
    w_packed = packing.pack(packing.pad_to_chunk(w_hat, axis=0),
                            spec_w.bits, axis=0)
    kappa, lam, m, d = fold_bn_requant(
        spec_w.eps, spec_x.eps, spec_y.eps,
        torch.as_tensor(bn_scale, device=w.device),
        torch.as_tensor(bn_bias, device=w.device), spec_y.bits)
    return QuantizedLinearParams(
        w_packed=w_packed, w_bits=spec_w.bits, a_bits=spec_x.bits,
        a_signed=spec_x.signed, kappa=kappa, lam=lam, m=m, d=d,
        out_bits=spec_y.bits, k_logical=k_logical)
