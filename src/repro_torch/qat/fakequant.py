"""STE fake-quantization primitives: the grid-matching half of QAT.

QAT simulates the deployed integer grids inside the float forward
(quantize-dequantize) and trains through the staircase with the
straight-through estimator; PACT learns the activation range. Every grid
here is bit-exactly the grid the deployment folds:

* `fake_quant_weight(w, bits)`: the per-tensor symmetric signed grid of
  `core.calibration.calibrate_weight` + `core.quantize.quantize` (absmax
  floor 1e-8, round then clip, int_min = -int_max: W2 is ternary);
  ``per_channel=True`` the LM layers' per-output-channel grids.
* `fake_quant_weight_segmented(w, runs)`: one per-tensor grid per
  output-channel run, as `quantize_conv_layer_segmented` packs them.
* `fake_quant_act(x, beta, bits)`: the unsigned alpha = 0 activation
  grid with `quantize_net`'s 1e-6 beta floor; the clip at zero is the
  ReLU the paper folds into QNT/ACT.

Gradients: `ste_quantize` is a `torch.autograd.Function` whose backward
is the clipped-identity surrogate (1/eps inside [lo*eps, hi*eps], 0
outside; none for eps). PACT's d/dbeta flows through the clip surrogate,
taken as ``minimum(maximum(x, 0), beta)``: at an exact tie the gradient
splits in halves between the two operands, as the reference's
``jnp.clip`` does (``torch.clamp`` would give all of it to x). Every
divisor is a float32 tensor on the input's device: a Python-float
divisor lets CUDA multiply by its reciprocal, which moves codes on .5
boundaries.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core import packing

WEIGHT_ABSMAX_FLOOR = 1e-8   # calibrate_weight's / quantize_dense_weights'
ACT_BETA_FLOOR = 1e-6        # quantize_net's absmax floor


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class _SteQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, eps, lo: int, hi: int):
        ctx.save_for_backward(t, eps)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(torch.round(t / eps), lo, hi)

    @staticmethod
    def backward(ctx, g):
        t, eps = ctx.saved_tensors
        inside = (t >= ctx.lo * eps) & (t <= ctx.hi * eps)
        dt = torch.where(inside, g / eps, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))
        return dt.to(t.dtype), None, None, None


def ste_quantize(t: torch.Tensor, eps, lo: int, hi: int) -> torch.Tensor:
    """Integer codes ``clamp(round(t / eps), lo, hi)`` as float32 values,
    with the straight-through gradient g / eps where lo*eps <= t <= hi*eps
    and 0 outside; ``eps`` (a scalar or a per-channel tensor broadcast
    against ``t``) gets none."""
    if not isinstance(eps, torch.Tensor):
        eps = _f32(eps, t)
    return _SteQuantize.apply(t, eps.detach(), lo, hi)


def weight_absmax(w: torch.Tensor, *, per_channel: bool = False):
    """The deployed grids' absmax, detached and floored: one scalar, or
    one per output channel (the last axis)."""
    a = w.detach().abs()
    a = (torch.amax(a, dim=tuple(range(w.dim() - 1))) if per_channel
         else torch.amax(a))
    return torch.maximum(a, _f32(WEIGHT_ABSMAX_FLOOR, w))


def fake_quant_weight(w: torch.Tensor, bits: int, *, absmax=None,
                      per_channel: bool = False) -> torch.Tensor:
    """Quantize-dequantize ``w`` on the deployed symmetric signed
    W{bits} grid, STE gradient. ``absmax`` overrides the observed
    statistic (already floored and detached by the caller)."""
    int_max = packing.int_range(bits, True)[1]
    if absmax is None:
        absmax = weight_absmax(w, per_channel=per_channel)
    eps = absmax / _f32(int_max, w)
    return eps * ste_quantize(w, eps, -int_max, int_max)


def fake_quant_weight_segmented(
        w: torch.Tensor, runs: Sequence[Tuple[int, int, int]]
) -> torch.Tensor:
    """One per-tensor grid per ``(n_start, n_end, bits)`` run over the last
    (output-channel) axis, as the segmented deployment packs each run."""
    return torch.cat([fake_quant_weight(w[..., s:e], b) for s, e, b in runs],
                     dim=-1)


def fake_quant_act(x: torch.Tensor, beta, bits: int, *,
                   learned: bool = False) -> torch.Tensor:
    """Unsigned alpha = 0 activation fake-quant. EMA mode: ``beta`` is a
    tracked range and gets no gradient. ``learned=True`` (PACT): beta's
    gradient comes through the clip surrogate."""
    int_max = packing.int_range(bits, False)[1]
    if not isinstance(beta, torch.Tensor):
        beta = _f32(beta, x)
    beta = torch.maximum(beta.to(torch.float32), _f32(ACT_BETA_FLOOR, x))
    if not learned:
        beta = beta.detach()
    eps = beta / _f32(int_max, x)
    x_c = torch.minimum(torch.maximum(x, _f32(0.0, x)), beta)
    q = eps.detach() * ste_quantize(x.detach(), eps.detach(), 0, int_max)
    return x_c + (q - x_c).detach()


def batch_absmax(t: torch.Tensor) -> torch.Tensor:
    """Observed |t| max for range tracking (a detached scalar)."""
    return torch.amax(torch.abs(t.detach()))


def ema_update(prev: torch.Tensor, observed: torch.Tensor,
               momentum: float = 0.9) -> torch.Tensor:
    """EMA absmax tracking; a zero range snaps to its first observation
    instead of averaging against 0."""
    observed = observed.detach()
    blended = (_f32(momentum, prev) * prev
               + _f32(1.0 - momentum, prev) * observed)
    return torch.where(prev > 0.0, blended, observed)
