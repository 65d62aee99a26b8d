"""Quantized-op API: one registry, one entry point per op.

Ops ``qdot`` (packed sub-byte GEMM, eq. 2-4) and ``qconv`` (fused
implicit-GEMM HWC conv) each have two backends, keyed ``(op, backend)``:

  cuda    the hand-written Hopper kernel (csrc/); takes CUDA tensors only
  torch   the kernel's plain torch version; takes CPU tensors only

Each backend is tied to its device: there is no CPU fallback for a CUDA
tensor and no way to run the kernel on a CPU tensor. Resolution of the
backend for one call: explicit ``backend=`` -> plan hint ->
``REPRO_QBACKEND`` -> the device's own backend. A choice that does not
match the tensor's device raises. Pipeline (the Mac&Load knob, STAGES of
the kernels): explicit ``pipeline=`` -> plan hint -> ``REPRO_QPIPELINE``
-> ``'off'``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import QuantizedLinearParams
from repro_torch.kernels.common import check_pipeline
from repro_torch.kernels.qconv.kernel import qconv2d_fused
from repro_torch.kernels.qmatmul.kernel import qmatmul_packed

OPS = ("qdot", "qconv")
BACKENDS = ("cuda", "torch")
ENV_VAR = "REPRO_QBACKEND"
ENV_PIPELINE = "REPRO_QPIPELINE"


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    op: str
    name: str
    supports: Callable  # (tensor) -> bool
    run: Callable       # (params, x, *, epilogue, scale, pipeline)
    doc: str = ""


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _qdot_run(params: QuantizedLinearParams, x_packed, *, epilogue, scale,
              pipeline):
    return qmatmul_packed(
        x_packed, params.w_packed, params.kappa, params.lam, params.m,
        a_bits=params.a_bits, a_signed=params.a_signed,
        w_bits=params.w_bits, d=params.d, out_bits=params.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline)


def _qconv_run(params, x_hat, *, epilogue, scale, pipeline):
    g = params.gemm
    return qconv2d_fused(
        x_hat, params.w_packed_fused, g.kappa, g.lam, g.m, fh=params.fh,
        fw=params.fw, stride=params.stride, padding=params.padding,
        cin_pad=params.cin_pad, cout=params.cout, a_bits=g.a_bits,
        a_signed=g.a_signed, w_bits=g.w_bits, d=g.d, out_bits=g.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline)


# The wrappers (`qmatmul_packed`, `qconv2d_fused`) launch the kernel for
# CUDA tensors and run the plain version for CPU tensors; each backend
# admits only its own device, so the name and the code that runs agree.
_REGISTRY: Dict[Tuple[str, str], BackendSpec] = {
    ("qdot", "cuda"): BackendSpec("qdot", "cuda", _on_cuda, _qdot_run,
                                  "Hopper packed sub-byte GEMM kernel"),
    ("qdot", "torch"): BackendSpec("qdot", "torch", _on_cpu, _qdot_run,
                                   "plain torch unpack + int32 mm + epilogue"),
    ("qconv", "cuda"): BackendSpec("qconv", "cuda", _on_cuda, _qconv_run,
                                   "Hopper fused implicit-GEMM conv kernel"),
    ("qconv", "torch"): BackendSpec("qconv", "torch", _on_cpu, _qconv_run,
                                    "plain torch per-tap gather + mm + "
                                    "epilogue"),
}


def backends(op: str) -> Tuple[str, ...]:
    return tuple(sorted(n for (o, n) in _REGISTRY if o == op))


def get(op: str, name: str) -> BackendSpec:
    spec = _REGISTRY.get((op, name))
    if spec is None:
        raise ValueError(
            f"no backend {name!r} for op {op!r}; the port's backends are "
            f"{list(backends(op))}")
    return spec


def resolve(op: str, x: torch.Tensor, *, backend: Optional[str] = None,
            plan_hints: Optional[dict] = None) -> BackendSpec:
    """Backend for one call: explicit -> plan hint -> ``REPRO_QBACKEND``
    -> the device's own backend; a mismatch with ``x``'s device raises."""
    hints = plan_hints or {}
    requested = (backend or hints.get("backend")
                 or os.environ.get(ENV_VAR) or None)
    if requested is None:
        return get(op, "cuda" if x.is_cuda else "torch")
    spec = get(op, requested)
    if not spec.supports(x):
        raise ValueError(
            f"backend {requested!r} does not take {x.device} tensors "
            "('cuda' runs CUDA tensors, 'torch' CPU tensors)")
    return spec


def resolve_pipeline(pipeline: Optional[str] = None,
                     plan_hints: Optional[dict] = None) -> str:
    """Explicit -> plan hint -> ``REPRO_QPIPELINE`` -> 'off'."""
    hints = plan_hints or {}
    return check_pipeline(pipeline or hints.get("pipeline")
                          or os.environ.get(ENV_PIPELINE) or "off")


def qdot(params: QuantizedLinearParams, x_hat: torch.Tensor, *,
         epilogue: str = "int", scale=1.0, backend: Optional[str] = None,
         pipeline: Optional[str] = None,
         plan_hints: Optional[dict] = None) -> torch.Tensor:
    """Quantized dot: integer images x_hat (..., K_logical) int8 x packed
    weights. Leading dims are flattened for the GEMM and restored; K is
    padded to CHUNK and packed on the fly."""
    lead = x_hat.shape[:-1]
    x2 = packing.pad_to_chunk(x_hat.reshape(-1, x_hat.shape[-1]), axis=-1)
    xp = packing.pack(x2, params.a_bits, axis=-1)
    out = qdot_packed(params, xp, epilogue=epilogue, scale=scale,
                      backend=backend, pipeline=pipeline,
                      plan_hints=plan_hints)
    return out.reshape(*lead, out.shape[-1])


def qdot_packed(params: QuantizedLinearParams, x_packed: torch.Tensor, *,
                epilogue: str = "int", scale=1.0,
                backend: Optional[str] = None,
                pipeline: Optional[str] = None,
                plan_hints: Optional[dict] = None) -> torch.Tensor:
    """`qdot` over already-packed activations (M, K_pad/pf_a)."""
    spec = resolve("qdot", x_packed, backend=backend, plan_hints=plan_hints)
    return spec.run(params, x_packed, epilogue=epilogue, scale=scale,
                    pipeline=resolve_pipeline(pipeline, plan_hints))


def qconv(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
          backend: Optional[str] = None, pipeline: Optional[str] = None,
          plan_hints: Optional[dict] = None) -> torch.Tensor:
    """Quantized HWC conv: (N, H, W, Cin) int8 images -> (N, Ho, Wo, Cout)
    through the fused implicit-GEMM route."""
    spec = resolve("qconv", x_hat, backend=backend, plan_hints=plan_hints)
    if params.groups != 1:
        raise ValueError(
            f"qconv backend {spec.name!r} does not support grouped conv "
            f"(groups={params.groups}); depthwise/grouped layers are not "
            "ported yet")
    return spec.run(params, x_hat, epilogue=epilogue, scale=scale,
                    pipeline=resolve_pipeline(pipeline, plan_hints))
