"""Quantized HWC convolution artifacts (paper §III-C).

The conv is the implicit GEMM (N*Ho*Wo, fh*fw*Cin) @ (fh*fw*Cin, Cout).
`quantize_conv` packs the integer weights twice from one quantization
pass, exactly as the reference does: the flat im2col layout (K padded
once at the tail, in ``gemm.w_packed``) and the per-tap layout the fused
kernel gathers against (each tap's Cin padded to a CHUNK multiple,
tap-major, in ``w_packed_fused``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quantize import (QuantSpec, QuantizedLinearParams,
                                       fold_bn_requant, quantize)


def im2col_hwc(x: torch.Tensor, fh: int, fw: int, stride: int = 1,
               padding: int = 0):
    """(N, H, W, C) -> ((N, Ho, Wo, fh*fw*C), Ho, Wo); receptive field
    flattened in (dy, dx, c) order."""
    n, h, w, c = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    cols = [x[:, dy:dy + stride * ho:stride, dx:dx + stride * wo:stride]
            for dy in range(fh) for dx in range(fw)]
    return torch.cat(cols, dim=-1), ho, wo


@dataclasses.dataclass(frozen=True)
class QuantizedConvParams:
    """Deployable artifact for one quantized conv layer."""

    gemm: QuantizedLinearParams   # packed (fh*fw*cin -> cout) GEMM
    fh: int
    fw: int
    stride: int
    padding: int
    cin: int
    cout: int
    # fused layout: per-tap Cin padded to cin_pad, tap-major K
    w_packed_fused: torch.Tensor = None
    cin_pad: int = 0
    # filter groups; only 1 runs (grouped geometry is rejected by the op)
    groups: int = 1


def quantize_conv(w: torch.Tensor, spec_w: QuantSpec, bn_scale, bn_bias,
                  spec_x: QuantSpec, spec_y: QuantSpec, stride: int = 1,
                  padding: int = 1) -> QuantizedConvParams:
    """w: (fh, fw, cin, cout) real weights -> packed integer artifact on
    ``w``'s device."""
    fh, fw, cin, cout = w.shape
    w_hat = quantize(w.reshape(fh * fw * cin, cout), spec_w)
    k_logical = w_hat.shape[0]
    w_packed = packing.pack(packing.pad_to_chunk(w_hat, axis=0),
                            spec_w.bits, axis=0)
    cin_pad = packing.padded_size(cin)
    w_tap = F.pad(w_hat.reshape(fh * fw, cin, cout),
                  (0, 0, 0, cin_pad - cin))
    w_packed_fused = packing.pack(w_tap.reshape(fh * fw * cin_pad, cout),
                                  spec_w.bits, axis=0)
    kappa, lam, m, d = fold_bn_requant(
        spec_w.eps, spec_x.eps, spec_y.eps, bn_scale, bn_bias, spec_y.bits)
    gemm = QuantizedLinearParams(
        w_packed=w_packed, w_bits=spec_w.bits, a_bits=spec_x.bits,
        a_signed=spec_x.signed, kappa=kappa, lam=lam, m=m, d=d,
        out_bits=spec_y.bits, k_logical=k_logical)
    return QuantizedConvParams(gemm=gemm, fh=fh, fw=fw, stride=stride,
                               padding=padding, cin=cin, cout=cout,
                               w_packed_fused=w_packed_fused,
                               cin_pad=cin_pad)
