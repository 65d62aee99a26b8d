"""Quantized-op API: one entry point per op.

``qdot`` (packed sub-byte GEMM, eq. 2-4; a `SegmentedLinearParams`
routes to the mixed-operand GEMM) and ``qconv`` (fused implicit-GEMM HWC
conv) pad and pack on the fly and call the kernel wrappers, which choose
by the tensor's device: CUDA tensors launch the hand-written Hopper
kernel (csrc/), CPU tensors run its plain torch version. That is the
only dispatch; nothing falls back from one to the other.

A backend *name* survives only where a plan JSON or the CLI carries one
(``cuda`` or ``torch``): `check_backend` holds it against the device the
net is placed on. Pipeline (the Mac&Load knob, STAGES of the kernels):
explicit ``pipeline=`` -> ``REPRO_QPIPELINE`` -> ``'off'``.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import SegmentedLinearParams
from repro_torch.kernels.common import check_pipeline
from repro_torch.kernels.qconv.kernel import qconv2d_fused
from repro_torch.kernels.qmatmul.kernel import (qmatmul_packed,
                                                qmatmul_segmented)

# the backend a plan or the CLI may name, by the device it runs on
BACKENDS = ("cuda", "torch")
ENV_PIPELINE = "REPRO_QPIPELINE"


def check_backend(backend: Optional[str],
                  device: Union[torch.device, str]) -> None:
    """Raise unless ``backend`` (None, or a name from a plan or the CLI)
    is the one that runs on ``device``: 'cuda' on a CUDA device, 'torch'
    on the CPU."""
    if backend is None:
        return
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not a backend of this port; the "
            f"port's backends are {list(BACKENDS)}")
    device = torch.device(device)
    if backend != ("cuda" if device.type == "cuda" else "torch"):
        raise ValueError(
            f"backend {backend!r} does not run on {device} ('cuda' runs "
            "CUDA tensors, 'torch' CPU tensors)")


def resolve_pipeline(pipeline: Optional[str] = None) -> str:
    """Explicit -> ``REPRO_QPIPELINE`` -> 'off'."""
    return check_pipeline(pipeline or os.environ.get(ENV_PIPELINE) or "off")


def qdot(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
         pipeline: Optional[str] = None) -> torch.Tensor:
    """Quantized dot: integer images x_hat (..., K_logical) int8 x packed
    weights (`QuantizedLinearParams` or `SegmentedLinearParams`). Leading
    dims are flattened for the GEMM and restored; K is padded to CHUNK
    and packed on the fly."""
    lead = x_hat.shape[:-1]
    x2 = packing.pad_to_chunk(x_hat.reshape(-1, x_hat.shape[-1]), axis=-1)
    xp = packing.pack(x2, params.a_bits, axis=-1)
    out = qdot_packed(params, xp, epilogue=epilogue, scale=scale,
                      pipeline=pipeline)
    return out.reshape(*lead, out.shape[-1])


def qdot_packed(params, x_packed: torch.Tensor, *, epilogue: str = "int",
                scale=1.0, pipeline: Optional[str] = None) -> torch.Tensor:
    """`qdot` over already-packed activations (M, K_pad/pf_a)."""
    pipeline = resolve_pipeline(pipeline)
    if isinstance(params, SegmentedLinearParams):
        return _qdot_mixed(params, x_packed, epilogue=epilogue, scale=scale,
                           pipeline=pipeline)
    return qmatmul_packed(
        x_packed, params.w_packed, params.kappa, params.lam, params.m,
        a_bits=params.a_bits, a_signed=params.a_signed,
        w_bits=params.w_bits, d=params.d, out_bits=params.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline,
        k_logical=params.k_logical)


def _pad_channels(v: torch.Tensor, n_pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, n_pad - v.shape[-1]))


def _qdot_mixed(params: SegmentedLinearParams, x_packed, *, epilogue,
                scale, pipeline: str) -> torch.Tensor:
    """Mixed-operand GEMM: zero-pad the ragged tail panel of the
    segmented container to a full CHUNK (`pad_segmented`; the artifact
    itself stays exact-bytes) and the per-channel vectors with it, run
    `qmatmul_segmented`, slice back to N."""
    n = params.segmap.n
    w_flat, segmap = packing.pad_segmented(params.w_flat, params.segmap,
                                           params.k_logical)
    n_pad = segmap.n
    kappa, lam, m_mul = (_pad_channels(v, n_pad)
                         for v in (params.kappa, params.lam, params.m))
    if not isinstance(scale, (int, float)):
        scale = torch.as_tensor(scale)
        if scale.dim() == 1:
            scale = _pad_channels(scale, n_pad)
    out = qmatmul_segmented(
        x_packed, w_flat, segmap, kappa, lam, m_mul,
        k_logical=params.k_logical, a_bits=params.a_bits,
        a_signed=params.a_signed, d=params.d, out_bits=params.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline)
    return out if n_pad == n else out[:, :n]


def qconv(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
          pipeline: Optional[str] = None) -> torch.Tensor:
    """Quantized HWC conv: (N, H, W, Cin) int8 images -> (N, Ho, Wo, Cout)
    through the fused implicit-GEMM route."""
    if params.groups != 1:
        raise ValueError(
            f"qconv does not support grouped conv (groups={params.groups}); "
            "lower depthwise/grouped layers via "
            "repro_torch.vision.layers.QDepthwiseConv2D (per-group qconv "
            "or block-diagonal im2col + qdot)")
    g = params.gemm
    return qconv2d_fused(
        x_hat, params.w_packed_fused, g.kappa, g.lam, g.m, fh=params.fh,
        fw=params.fw, stride=params.stride, padding=params.padding,
        cin_pad=params.cin_pad, cout=params.cout, a_bits=g.a_bits,
        a_signed=g.a_signed, w_bits=g.w_bits, d=g.d, out_bits=g.out_bits,
        epilogue=epilogue, scale=scale,
        pipeline=resolve_pipeline(pipeline))
