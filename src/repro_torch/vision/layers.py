"""Quantized vision layers — the PULP-NN layer set over `kernels.api`.

Every compute layer keeps activations as integer images (uint{8,4,2}
values in int8 tensors) between layers, with int32 accumulation inside
and the eq. 3/4 requant epilogue at its output:

  QConv2D            one `api.qconv` call (fused implicit-GEMM kernel)
  QDepthwiseConv2D   depthwise conv lowered above the ops, two lowerings
                     from one quantization and one fold, identical bit
                     for bit: one block-diagonal im2col `api.qdot` GEMM,
                     or C per-channel `api.qconv` calls (cin = cout = 1)
  QSegmentedConv2D   one uniform `QConv2D` per output-channel run of a
                     fine-grain plan, outputs concatenated along Cout
  QLinear            `api.qdot` (classifier head; 'raw' int32 logits)
  QMaxPool2D         grid-preserving integer max — no requantization
  QAvgPool2D         int32 window sum + eq. 4 requant (`requantize_shift`)
  QResidualAdd       two-scale integer add: y = clip((m1*a + m2*b) >> d)

The fp applies (`conv2d_fp`, ...) are the calibration-time forward, in
NHWC like the reference; `conv_tap` lets the deploy calibrator observe
each conv's, depthwise conv's and the head's input.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.calibration import calibrate_weight
from repro_torch.core.quantize import (QuantSpec, QuantizedLinearParams,
                                       fold_bn_requant, pick_requant_md,
                                       quantize, requantize_shift,
                                       wrap_int32)
from repro_torch.kernels import api
from repro_torch.kernels.qconv.ops import (QuantizedConvParams, im2col_hwc,
                                           quantize_conv)

# Calibration tap: when set, the fp conv, depthwise and linear applies
# call it with (params dict, x) before the op (host-side calibration
# passes only).
_CONV_TAP: Optional[Callable] = None


@contextlib.contextmanager
def conv_tap(fn: Callable):
    """Install ``fn(params_dict, x)`` as the vision-layer observer."""
    global _CONV_TAP
    prev = _CONV_TAP
    _CONV_TAP = fn
    try:
        yield
    finally:
        _CONV_TAP = prev


# ------------------------------------------------------- fp reference ---


def conv2d_raw(x: torch.Tensor, w: torch.Tensor, *, stride: int,
               padding: int, groups: int = 1) -> torch.Tensor:
    """Raw fp conv: x (N,H,W,Cin) f32, w (fh,fw,Cin/groups,Cout) -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_fp(p: dict, x: torch.Tensor, *, stride: int, padding: int,
              relu: bool = True) -> torch.Tensor:
    """fp conv + BN + ReLU; p: {"w": (fh,fw,cin,cout), "bn_scale",
    "bn_bias"}. Calls the `conv_tap` observer."""
    if _CONV_TAP is not None:
        _CONV_TAP(p, x)
    y = conv2d_raw(x, p["w"], stride=stride, padding=padding)
    y = y * p["bn_scale"] + p["bn_bias"]
    return torch.clamp_min(y, 0.0) if relu else y


def depthwise_fp(p: dict, x: torch.Tensor, *, stride: int, padding: int,
                 relu: bool = True) -> torch.Tensor:
    """fp depthwise conv + BN + ReLU; p["w"]: (fh, fw, C). Calls the
    `conv_tap` observer."""
    if _CONV_TAP is not None:
        _CONV_TAP(p, x)
    w = p["w"]
    c = w.shape[-1]
    y = conv2d_raw(x, w.reshape(*w.shape[:2], 1, c), stride=stride,
                   padding=padding, groups=c)
    y = y * p["bn_scale"] + p["bn_bias"]
    return torch.clamp_min(y, 0.0) if relu else y


def linear_fp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """fp classifier head (no BN/activation); p["w"]: (d_in, classes).
    Calls the `conv_tap` observer."""
    if _CONV_TAP is not None:
        _CONV_TAP(p, x)
    return x @ p["w"]


def maxpool_fp(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avgpool_global_fp(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


# ----------------------------------------------------- requant folds ---

def fold_avgpool_requant(count: int, eps_x: float, eps_y: float):
    """(m, d) for integer average pooling over ``count`` elements."""
    return pick_requant_md(float(eps_x) / (float(eps_y) * count))


def fold_add_requant(eps_a: float, eps_b: float, eps_y: float):
    """(m1, m2, d) for the two-scale residual add; operands are < 2^8, so
    m*x fits int32 without the hi/lo split and d may go below 16."""
    r1 = float(eps_a) / float(eps_y)
    r2 = float(eps_b) / float(eps_y)
    _, d = pick_requant_md(max(r1, r2), d_min=0)
    return (int(np.round(r1 * (1 << d))), int(np.round(r2 * (1 << d))), d)


# -------------------------------------------------- quantized layers ---

def _windows(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, Ho, Wo, C, window, window) VALID windows."""
    return x.unfold(1, window, stride).unfold(2, window, stride)


@dataclasses.dataclass(frozen=True)
class QConv2D:
    """One quantized conv layer: `api.qconv` + fused eq. 3/4 epilogue.
    ``pipeline`` comes from the plan; a call-time value wins."""

    conv: QuantizedConvParams
    pipeline: Optional[str] = None

    def apply(self, x_hat, *, pipeline: Optional[str] = None, mesh=None):
        return api.qconv(self.conv, x_hat,
                         pipeline=pipeline or self.pipeline, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class QSegmentedConv2D:
    """Fine-grain mixed-precision conv: one uniform `QConv2D` per
    output-channel run, outputs concatenated along Cout.

    Each ``(n_start, n_end, w_bits)`` run is quantized as a uniform layer
    over its column slice (its own per-tensor weight grid and its own
    eq. 3/4 fold), which is what `SegmentedLinearParams.segment_params`
    defines a segmented container to mean. On a mesh each run shards
    on its own output channels."""

    runs: Tuple[Tuple[int, int, int], ...]
    parts: Tuple[QConv2D, ...]

    def apply(self, x_hat, *, pipeline: Optional[str] = None, mesh=None):
        return torch.cat([p.apply(x_hat, pipeline=pipeline, mesh=mesh)
                          for p in self.parts], dim=-1)


# The lowering `QDepthwiseConv2D.apply` takes for 'auto', on the CPU and
# on the card alike: one block-diagonal GEMM per layer. On an H100 it
# beats C per-channel convs by 10-28x per MobileNet layer at a wave of
# 64, host included (PERF.md §6).
AUTO_LOWERING = "qdot"
LOWERINGS = ("auto", "qdot", "per_group")


@dataclasses.dataclass(frozen=True)
class QDepthwiseConv2D:
    """Depthwise conv lowered onto the two ops (`api.qconv` refuses
    grouped params). Two lowerings from one quantization and one
    (kappa, lam, m, d) fold, identical bit for bit:

    * ``qdot``: one block-diagonal im2col GEMM, K = fh*fw*C with
      W[t*C + c, c'] = 0 unless c == c' (zero weights are zero MACs);
    * ``per_group``: C standard convs (cin = cout = 1) through
      `api.qconv`, each on its channel's slice of the shared fold.

    ``lowering='auto'`` is `AUTO_LOWERING`; on a mesh it is ``qdot``, and
    ``per_group`` is refused there (cout = 1 per-channel convs have no
    tensor-parallel axis). ``pipeline`` comes from the plan; a call-time
    value wins."""

    gemm: QuantizedLinearParams            # block-diagonal (fh*fw*C -> C)
    per_group: Tuple[QuantizedConvParams, ...]
    fh: int
    fw: int
    stride: int
    padding: int
    channels: int
    pipeline: Optional[str] = None

    def apply(self, x_hat, *, pipeline: Optional[str] = None,
              lowering: str = "auto", mesh=None):
        pipeline = pipeline or self.pipeline
        if lowering not in LOWERINGS:
            raise ValueError(f"unknown depthwise lowering {lowering!r}; "
                             "expected 'auto', 'qdot' or 'per_group'")
        if lowering == "auto":
            lowering = AUTO_LOWERING if mesh is None else "qdot"
        if lowering == "per_group":
            if mesh is not None:
                raise ValueError(
                    "depthwise lowering 'per_group' cannot run on a mesh "
                    "(cout=1 per-group convs have no tensor-parallel "
                    "axis); use lowering='qdot' or 'auto'")
            return torch.cat([api.qconv(pg, x_hat[..., c:c + 1],
                                        pipeline=pipeline)
                              for c, pg in enumerate(self.per_group)],
                             dim=-1)
        cols, _, _ = im2col_hwc(x_hat, self.fh, self.fw, self.stride,
                                self.padding)
        return api.qdot(self.gemm, cols, pipeline=pipeline, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class QLinear:
    """Quantized fully-connected head via `api.qdot`; 'raw' keeps int32
    logits (dequantize with the net's ``eps_logits``)."""

    gemm: QuantizedLinearParams
    epilogue: str = "raw"
    pipeline: Optional[str] = None

    def apply(self, x_hat, *, pipeline: Optional[str] = None, mesh=None):
        return api.qdot(self.gemm, x_hat, epilogue=self.epilogue,
                        pipeline=pipeline or self.pipeline, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class QMaxPool2D:
    """Integer max pooling: order-preserving on the uint grid, so the
    output keeps the input's grid (no requantization)."""

    window: int
    stride: int

    def apply(self, x_hat):
        return _windows(x_hat, self.window, self.stride).amax(dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class QAvgPool2D:
    """Integer average pooling: int32 window sum + eq. 4 requant (floor).
    ``window == 0`` means global pooling, returning (N, C)."""

    window: int
    stride: int
    m: int
    d: int
    out_bits: int

    def apply(self, x_hat):
        x64 = x_hat.to(torch.int64)
        if self.window == 0:
            s = x64.sum(dim=(1, 2))
        else:
            s = _windows(x64, self.window, self.stride).sum(dim=(-2, -1))
        y = requantize_shift(wrap_int32(s), self.m, self.d)
        hi = packing.int_range(self.out_bits, False)[1]
        return torch.clamp(y, 0, hi).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QResidualAdd:
    """Two-scale integer residual add: y = clip((m1*a + m2*b) >> d)."""

    m1: int
    m2: int
    d: int
    out_bits: int

    def apply(self, a_hat, b_hat):
        acc = (a_hat.to(torch.int32) * self.m1
               + b_hat.to(torch.int32) * self.m2) >> self.d
        hi = packing.int_range(self.out_bits, False)[1]
        return torch.clamp(acc, 0, hi).to(torch.int8)


# --------------------------------------------------- layer builders ---

def quantize_conv_layer(p: dict, spec_x: QuantSpec, spec_y: QuantSpec,
                        w_bits: int, *, stride: int, padding: int,
                        pipeline: Optional[str] = None) -> QConv2D:
    """fp conv node {"w","bn_scale","bn_bias"} -> deployable QConv2D."""
    spec_w = calibrate_weight(p["w"], w_bits)
    conv = quantize_conv(p["w"], spec_w, p["bn_scale"], p["bn_bias"],
                         spec_x, spec_y, stride, padding)
    return QConv2D(conv=conv, pipeline=pipeline)


def quantize_conv_layer_segmented(p: dict, spec_x: QuantSpec,
                                  spec_y: QuantSpec, runs, *, stride: int,
                                  padding: int,
                                  pipeline: Optional[str] = None
                                  ) -> QSegmentedConv2D:
    """fp conv node + plan segments -> per-run quantized conv. ``runs``
    are the CHUNK-aligned ``(n_start, n_end, w_bits)`` runs covering
    [0, cout) (`PlanRule.segments`); each run re-slices the BN fold."""
    runs = tuple(tuple(int(v) for v in r) for r in runs)
    cout = int(p["w"].shape[-1])
    if runs[0][0] != 0 or runs[-1][1] != cout or any(
            runs[i][1] != runs[i + 1][0] for i in range(len(runs) - 1)):
        raise ValueError(f"segments {runs} do not tile [0, {cout})")
    parts = []
    for s, e, b in runs:
        sub = {"w": p["w"][..., s:e], "bn_scale": p["bn_scale"][s:e],
               "bn_bias": p["bn_bias"][s:e]}
        parts.append(quantize_conv_layer(sub, spec_x, spec_y, b,
                                         stride=stride, padding=padding,
                                         pipeline=pipeline))
    return QSegmentedConv2D(runs=runs, parts=tuple(parts))


def quantize_depthwise(p: dict, spec_x: QuantSpec, spec_y: QuantSpec,
                       w_bits: int, *, stride: int, padding: int,
                       pipeline: Optional[str] = None) -> QDepthwiseConv2D:
    """fp depthwise node (w: (fh, fw, C)) -> QDepthwiseConv2D on ``w``'s
    device, both lowerings from ONE quantization and ONE fold; each
    channel's epilogue vectors are copies of its slice of the layer's (a
    re-fold per channel would pick other shifts d; a view would start
    where the conv kernel's 16-byte copies cannot)."""
    w = p["w"]
    fh, fw, c = w.shape
    dev = w.device
    spec_w = calibrate_weight(w, w_bits)
    taps = quantize(w, spec_w).reshape(fh * fw, c)
    kappa, lam, m, d = fold_bn_requant(
        spec_w.eps, spec_x.eps, spec_y.eps, p["bn_scale"], p["bn_bias"],
        spec_y.bits)

    # block-diagonal GEMM weights, K tap-major in im2col_hwc's (dy, dx, c)
    # order, N = C
    bd = torch.zeros((fh * fw, c, c), dtype=torch.int8, device=dev)
    ch = torch.arange(c, device=dev)
    bd[:, ch, ch] = taps
    k_logical = fh * fw * c
    gemm = QuantizedLinearParams(
        w_packed=packing.pack(packing.pad_to_chunk(
            bd.reshape(k_logical, c), axis=0), w_bits, axis=0),
        w_bits=w_bits, a_bits=spec_x.bits, a_signed=spec_x.signed,
        kappa=kappa, lam=lam, m=m, d=d, out_bits=spec_y.bits,
        k_logical=k_logical)

    # channel ci as a standard (cin=1, cout=1) conv
    cin_pad = packing.padded_size(1)
    per_group = []
    for ci in range(c):
        wc = taps[:, ci:ci + 1]                       # (fh*fw, 1)
        w_tap = torch.zeros((fh * fw, cin_pad, 1), dtype=torch.int8,
                            device=dev)
        w_tap[:, 0, 0] = wc[:, 0]
        g = QuantizedLinearParams(
            w_packed=packing.pack(packing.pad_to_chunk(wc, axis=0), w_bits,
                                  axis=0),
            w_bits=w_bits, a_bits=spec_x.bits, a_signed=spec_x.signed,
            kappa=kappa[ci:ci + 1].clone(), lam=lam[ci:ci + 1].clone(),
            m=m[ci:ci + 1].clone(), d=d, out_bits=spec_y.bits,
            k_logical=fh * fw)
        per_group.append(QuantizedConvParams(
            gemm=g, fh=fh, fw=fw, stride=stride, padding=padding, cin=1,
            cout=1, w_packed_fused=packing.pack(
                w_tap.reshape(fh * fw * cin_pad, 1), w_bits, axis=0),
            cin_pad=cin_pad))
    return QDepthwiseConv2D(
        gemm=gemm, per_group=tuple(per_group), fh=fh, fw=fw, stride=stride,
        padding=padding, channels=c, pipeline=pipeline)


def quantize_linear_head(p: dict, spec_x: QuantSpec, w_bits: int, *,
                         pipeline: Optional[str] = None):
    """fp head {"w": (d_in, classes)} -> (QLinear with raw int32 logits,
    eps_logits). kappa/lam/m are identity placeholders the 'raw' epilogue
    never reads."""
    w = p["w"]
    spec_w = calibrate_weight(w, w_bits)
    w_hat = quantize(w, spec_w)
    k_logical, n = w_hat.shape
    w_packed = packing.pack(packing.pad_to_chunk(w_hat, axis=0), w_bits,
                            axis=0)
    dev = w.device
    gemm = QuantizedLinearParams(
        w_packed=w_packed, w_bits=w_bits, a_bits=spec_x.bits,
        a_signed=spec_x.signed,
        kappa=torch.ones((n,), dtype=torch.int32, device=dev),
        lam=torch.zeros((n,), dtype=torch.int32, device=dev),
        m=torch.ones((n,), dtype=torch.int32, device=dev), d=16, out_bits=8,
        k_logical=k_logical)
    eps_logits = float(spec_w.eps) * float(spec_x.eps)
    return (QLinear(gemm=gemm, epilogue="raw", pipeline=pipeline),
            eps_logits)
