"""Weight range calibration -> QuantSpec."""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantSpec


def calibrate_weight(w: torch.Tensor, bits: int) -> QuantSpec:
    absmax = max(float(torch.max(torch.abs(w))), 1e-8)
    return QuantSpec.weight(bits, absmax)
