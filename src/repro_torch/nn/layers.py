"""Per-layer quantization settings (`QuantConfig`).

Only the frozen dataclass that plan resolution returns is ported; the
quantized dense layers of the LM zoo come with that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.packing import SegmentMap
from repro_torch.kernels.common import check_pipeline


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
