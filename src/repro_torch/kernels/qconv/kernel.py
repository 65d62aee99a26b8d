"""Fused implicit-GEMM quantized conv: the CUDA kernel and its plain
version.

`qconv2d_fused` pads the integer images spatially and per tap to
``cin_pad`` channels and packs them (plain torch, outside the kernel, as
the reference does outside its Pallas kernel), then dispatches on the
device: CUDA tensors launch the Hopper kernel (``csrc/qconv.cu``, STAGES
1 or 2 for pipeline 'off' or 'double_buffer'); CPU tensors run
`qconv_packed_torch`, the per-tap gather + contraction + epilogue in
torch. No fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quantize import wrap_int32
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (EPILOGUE_DTYPES, PIPELINE_STAGES,
                                        apply_epilogue, check_pipeline,
                                        matmul_planes)
from repro_torch.kernels.qmatmul.kernel import _check, epilogue_launch_args

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "qconv", "qconv.cu", "qconv_launch",
    [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P] + [_I] * 17 + [_P])


def conv_out_hw(h: int, w: int, fh: int, fw: int, stride: int,
                padding: int):
    return ((h + 2 * padding - fh) // stride + 1,
            (w + 2 * padding - fw) // stride + 1)


def pad_and_pack(x_hat: torch.Tensor, *, padding: int, cin_pad: int,
                 a_bits: int) -> torch.Tensor:
    """(N, H, W, Cin) int8 images -> (N, H+2p, W+2p, cin_pad/pf_a) packed."""
    cin = x_hat.shape[-1]
    x = F.pad(x_hat, (0, cin_pad - cin, padding, padding, padding, padding))
    return packing.pack(x, a_bits, axis=-1)


def qconv_packed_torch(xp, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                       fw: int, stride: int, ho: int, wo: int, cin_pad: int,
                       cout: int, a_bits: int, a_signed: bool, w_bits: int,
                       d: int, out_bits: int, epilogue: str = "int",
                       scale=1.0) -> torch.Tensor:
    """Plain version on the kernel's inputs: the sum over taps of each
    tap's strided patch @ its rows of the tap-major weight panel, then the
    epilogue. Returns (N, Ho, Wo, Cout)."""
    n, cp = xp.shape[0], xp.shape[-1]
    kpt = cin_pad // packing.pack_factor(w_bits)
    acc = torch.zeros((n * ho * wo, cout), dtype=torch.int64,
                      device=xp.device)
    for t in range(fh * fw):
        dy, dx = divmod(t, fw)
        patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                   dx:dx + stride * (wo - 1) + 1:stride, :]
        acc += matmul_planes(patch.reshape(-1, cp),
                             w_packed_fused[t * kpt:(t + 1) * kpt],
                             a_bits, a_signed, w_bits)
    y = apply_epilogue(wrap_int32(acc), kappa, lam, m_mul, d=d,
                       out_bits=out_bits, epilogue=epilogue, scale=scale)
    return y.reshape(n, ho, wo, cout)


def qconv_packed_cuda(xp, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                      fw: int, stride: int, ho: int, wo: int, cin_pad: int,
                      cout: int, a_bits: int, a_signed: bool, w_bits: int,
                      d: int, out_bits: int, epilogue: str = "int",
                      scale=1.0, pipeline: str = "off") -> torch.Tensor:
    """Launch the Hopper conv kernel on the packed, padded images ``xp``
    (N, hp, wp, cin_pad/pf_a); raises on anything it does not take."""
    stages = PIPELINE_STAGES[check_pipeline(pipeline)]
    dev = xp.device
    _check(xp, "xp", torch.int8, dev, 4)
    _check(w_packed_fused, "w_packed_fused", torch.int8, dev, 2)
    pf_a, pf_w = packing.pack_factor(a_bits), packing.pack_factor(w_bits)
    n, hp, wp, cp = xp.shape
    if cp * pf_a != cin_pad or cin_pad % packing.CHUNK:
        raise ValueError(f"packed image has {cp} bytes per pixel; expected "
                         f"cin_pad/pf_a with cin_pad={cin_pad} a CHUNK "
                         "multiple")
    if tuple(w_packed_fused.shape) != (fh * fw * cin_pad // pf_w, cout):
        raise ValueError(
            f"w_packed_fused {tuple(w_packed_fused.shape)} != "
            f"({fh * fw * cin_pad // pf_w}, {cout})")
    if (ho - 1) * stride + fh > hp or (wo - 1) * stride + fw > wp:
        raise ValueError(f"padded image {hp}x{wp} too small for a {ho}x{wo} "
                         f"output of a {fh}x{fw}/s{stride} conv")
    kappa, lam, m_mul, svec, sf, d, hi, code = epilogue_launch_args(
        kappa, lam, m_mul, n=cout, d=d, out_bits=out_bits,
        epilogue=epilogue, scale=scale, device=dev)
    out = torch.empty((n, ho, wo, cout), dtype=EPILOGUE_DTYPES[epilogue],
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(
            stages, xp.data_ptr(), w_packed_fused.data_ptr(),
            kappa.data_ptr(), lam.data_ptr(), m_mul.data_ptr(),
            None if svec is None else svec.data_ptr(), sf, out.data_ptr(),
            n, hp, wp, cin_pad, ho, wo, fh, fw, stride, cout, a_bits,
            w_bits, int(a_signed), d, hi, code, stages, stream)
    return out


def qconv2d_fused(x_hat, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                  fw: int, stride: int, padding: int, cin_pad: int,
                  cout: int, a_bits: int, a_signed: bool, w_bits: int,
                  d: int, out_bits: int, epilogue: str = "int", scale=1.0,
                  pipeline: str = "off") -> torch.Tensor:
    """Fused implicit-GEMM conv on integer images x_hat (N, H, W, Cin)
    int8 -> (N, Ho, Wo, Cout). ``w_packed_fused`` is the tap-major panel
    from `quantize_conv` (K = fh*fw*cin_pad)."""
    check_pipeline(pipeline)
    _, h, w_, cin = x_hat.shape
    if cin > cin_pad or cin_pad % packing.CHUNK:
        raise ValueError(f"cin={cin} does not fit cin_pad={cin_pad}")
    ho, wo = conv_out_hw(h, w_, fh, fw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty conv output {ho}x{wo}")
    xp = pad_and_pack(x_hat, padding=padding, cin_pad=cin_pad,
                      a_bits=a_bits)
    kw = dict(fh=fh, fw=fw, stride=stride, ho=ho, wo=wo, cin_pad=cin_pad,
              cout=cout, a_bits=a_bits, a_signed=a_signed, w_bits=w_bits,
              d=d, out_bits=out_bits, epilogue=epilogue, scale=scale)
    if xp.is_cuda:
        return qconv_packed_cuda(xp, w_packed_fused, kappa, lam, m_mul,
                                 pipeline=pipeline, **kw)
    return qconv_packed_torch(xp, w_packed_fused, kappa, lam, m_mul, **kw)
