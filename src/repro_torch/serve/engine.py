"""Batched serving engines over fixed-size waves.

`Engine` (LM) and `VisionEngine` (quantized CNN) are each a `Scheduler`
over the matching adapter pinned to ``policy="wave"`` (admit only when
every slot is free). `Engine`'s requests are prompts, served by prefill
plus streaming decode; `VisionEngine`'s are images. A ragged last wave
runs with empty slots that never reach the results. A `Scheduler` with
the default ``policy="continuous"`` over the same adapter re-admits
mid-wave and gives the same per-request outputs.

Cluster-parallel serving (paper fig. 9: one mesh position per core of
the 8-core cluster): with ``mesh=`` the wave's slots split into data
blocks over ``data``, a ragged batch padded with slots that are never
admitted, and the per-device utilization of each wave is recorded (an
idle core is a pad slot). `VisionEngine` also runs every conv and linear
tensor-parallel over ``model``; `Engine` splits each data block's decode
over its ``model`` positions (heads, MLP columns, experts, recurrence
channels and vocab rows; `LMDecodeAdapter`, `repro_torch.parallel.tp`),
the utilization report staying per data device.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serve.runtime.adapters import (LMDecodeAdapter, Request,
                                                VisionAdapter)
from repro_torch.serve.runtime.scheduler import Scheduler

__all__ = ["Engine", "Request", "VisionEngine"]


class _WaveShim:
    """The scheduler's wave-granular stats under the engines' names."""

    _sched: Scheduler

    @property
    def wave_stats(self) -> List[dict]:
        return self._sched.wave_stats

    @property
    def _dp(self) -> int:
        return self._sched._dp

    def utilization_report(self) -> dict:
        return self._sched.utilization_report()

    def serving_report(self) -> dict:
        return self._sched.serving_report()


class Engine(_WaveShim):
    """Batched LM serving on ``device`` (default ``"cuda"``): prefill +
    streaming decode over the Model API in synchronous waves of
    ``batch_size``. Weights may be packed sub-byte (QuantConfig
    mode='int'); the KV cache may be int8 (kv_quant_bits=8). The params
    must already live on ``device``. ``plan``: the `PrecisionPlan` the
    params were packed with, kept for introspection. ``mesh``: serve the
    waves data-parallel over ``data`` and each block's decode
    tensor-parallel over ``model`` (module docstring)."""

    def __init__(self, model, params, batch_size: int, max_len: int,
                 eos_id: int = 1, plan=None, *, device="cuda", mesh=None):
        dev = resolve_device(device)
        self._adapter = LMDecodeAdapter(model, params, max_len,
                                        eos_id=eos_id, plan=plan,
                                        mesh=mesh)
        if self._adapter.device.type != dev.type:
            raise ValueError(
                f"the params live on {self._adapter.device}, the engine "
                f"was asked to serve on {dev}")
        self.model = model
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.eos = eos_id
        self.plan = plan
        self.mesh = mesh
        self._sched = Scheduler(self._adapter, batch_size, policy="wave")

    def artifact_bytes(self) -> int:
        from repro_torch.nn.module import param_bytes
        return param_bytes(self.params)

    def generate(self, requests: List[Request], greedy: bool = True,
                 seed: int = 0) -> List[Request]:
        """Serve the requests in waves; returns the same `Request`
        objects, in order, with ``.out`` set."""
        return self._sched.serve(requests, greedy=greedy, seed=seed)


class VisionEngine(_WaveShim):
    """Serve a `QuantizedVisionNet` in waves of ``batch_size`` images on
    ``device`` (default ``"cuda"``); the net must already live there.
    ``mesh``: every conv and linear runs on the cluster path, the wave's
    images data-parallel over ``data`` (module docstring)."""

    def __init__(self, qnet, batch_size: int, *, device="cuda", mesh=None):
        dev = resolve_device(device)
        if qnet.device.type != dev.type:
            raise ValueError(
                f"the net lives on {qnet.device}, the engine was asked to "
                f"serve on {dev}; quantize_net(..., device=) places it")
        self.qnet = qnet
        self.batch = batch_size
        self.mesh = mesh
        self._adapter = VisionAdapter(qnet, mesh=mesh)
        self._sched = Scheduler(self._adapter, batch_size, policy="wave")

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
