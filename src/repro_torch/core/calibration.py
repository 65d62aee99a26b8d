"""Post-training-quantization range calibration -> QuantSpec.

Two estimators: absolute max for weights, and a percentile for
activations (robust to outliers), on the unsigned grid the paper gives
activations (alpha = 0). The percentile is numpy's, as the reference
takes it, so beta is the same float.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import QuantSpec


def calibrate_weight(w: torch.Tensor, bits: int) -> QuantSpec:
    absmax = max(float(torch.max(torch.abs(w))), 1e-8)
    return QuantSpec.weight(bits, absmax)


def _relu_host(samples) -> np.ndarray:
    """Samples (a tensor on any device, or an array) as flat float32 on
    the host, clipped at zero: activation grids start at 0."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().to("cpu", torch.float32).numpy()
    x = np.asarray(samples, dtype=np.float32).reshape(-1)
    return np.maximum(x, 0.0)


def calibrate_activation(samples, bits: int, percentile: float = 99.9,
                         ) -> QuantSpec:
    """Unsigned activation spec: beta is the ``percentile`` of the
    samples (their max at 100)."""
    x = _relu_host(samples)
    if percentile >= 100.0:
        beta = float(x.max())
    else:
        beta = float(np.percentile(x, percentile))
    return QuantSpec.activation(bits, max(beta, 1e-8))


class RunningCalibrator:
    """Streaming calibrator for an activation tap: each observation's
    percentile, folded into an exponential moving average."""

    def __init__(self, bits: int, momentum: float = 0.9,
                 percentile: float = 99.9):
        self.bits = bits
        self.momentum = momentum
        self.percentile = percentile
        self._beta = None

    def observe(self, x) -> None:
        x = _relu_host(x)
        b = float(np.percentile(x, self.percentile)) if x.size else 0.0
        if self._beta is None:
            self._beta = b
        else:
            self._beta = self.momentum * self._beta + (1 - self.momentum) * b

    def spec(self) -> QuantSpec:
        if self._beta is None:
            raise ValueError("no observations")
        return QuantSpec.activation(self.bits, max(self._beta, 1e-8))
