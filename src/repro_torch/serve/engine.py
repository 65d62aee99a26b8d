"""Batched quantized-CNN serving over fixed-size image waves.

`VisionEngine` is a `Scheduler` over a `VisionAdapter` pinned to
``policy="wave"`` (admit only when every slot is free): requests are
images, a wave is a ``batch_size`` slab of them, and a ragged last wave
runs with empty slots that never reach the results.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serve.runtime.adapters import VisionAdapter
from repro_torch.serve.runtime.scheduler import Scheduler

__all__ = ["VisionEngine"]


class VisionEngine:
    """Serve a `QuantizedVisionNet` in waves of ``batch_size`` images on
    ``device`` (default ``"cuda"``); the net must already live there."""

    def __init__(self, qnet, batch_size: int, *, device="cuda"):
        dev = resolve_device(device)
        if qnet.device.type != dev.type:
            raise ValueError(
                f"the net lives on {qnet.device}, the engine was asked to "
                f"serve on {dev}; quantize_net(..., device=) places it")
        self.qnet = qnet
        self.batch = batch_size
        self._adapter = VisionAdapter(qnet)
        self._sched = Scheduler(self._adapter, batch_size, policy="wave")

    @property
    def wave_stats(self) -> List[dict]:
        return self._sched.wave_stats

    def utilization_report(self) -> dict:
        return self._sched.utilization_report()

    def serving_report(self) -> dict:
        return self._sched.serving_report()

    def artifact_bytes(self) -> int:
        from repro_torch.vision.models import vision_artifact_bytes
        return vision_artifact_bytes(self.qnet)

    def run(self, images) -> np.ndarray:
        """Real images (M, H, W, C) -> int32 logits (M, classes), served
        in waves. Dequantize with ``qnet.eps_logits``."""
        images = np.asarray(images, np.float32)
        if len(images) == 0:
            return np.zeros((0, self.qnet.cfg.num_classes), np.int32)
        return np.stack(self._sched.serve(list(images)))
