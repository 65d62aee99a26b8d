"""Workload adapters for the serving runtime.

`WorkloadAdapter` is the contract between the scheduler (admission,
slots, stats) and a workload (what a request is and what one engine step
computes): ``init_state``/``reset_state`` for carried per-slot state,
``step(state, feed, positions)`` for one step over all slots, and the
request cursor hooks ``begin``/``feed``/``consume`` (whose return value
is the finished predicate). Every step must be row-independent, which
makes per-request outputs independent of batching and admission order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


class WorkloadAdapter:
    """Base contract; subclasses set ``name`` and ``max_len`` and
    implement the hooks below."""

    name: str = "?"
    max_len: int = 1

    def init_state(self, slots: int):
        return None

    def reset_state(self, state, slot_mask: np.ndarray):
        """Clear carried per-slot state where the mask is True."""
        return state

    def input_spec(self) -> Tuple[Tuple[int, ...], Any]:
        """(per-slot feed shape, dtype) of the scheduler's feed buffer."""
        raise NotImplementedError

    def step(self, state, feed: np.ndarray, positions: np.ndarray):
        """One step over all slots -> (per-slot host outputs, state)."""
        raise NotImplementedError

    def begin(self, payload, *, rid: int, greedy: bool = True,
              seed: int = 0):
        raise NotImplementedError

    def feed(self, cursor) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def consume(self, cursor, row) -> bool:
        raise NotImplementedError

    def finish(self, cursor):
        """Attach final outputs to the payload (called exactly once)."""

    def result(self, cursor):
        return cursor.payload

    def reserve_tokens(self, cursor) -> int:
        return self.max_len

    def prompt_len(self, cursor) -> int:
        return 1

    def tokens_out(self, cursor) -> int:
        return 0


@dataclasses.dataclass
class _VisionCursor:
    payload: np.ndarray             # quantized integer image (H, W, C)
    rid: int
    out: Optional[np.ndarray] = None
    done: bool = False


class VisionAdapter(WorkloadAdapter):
    """Stateless quantized-CNN classification: a request is one image,
    one step is one batched integer forward on the net's device, and every
    admitted request finishes after exactly one step. Images are quantized
    per request with the net's input spec (elementwise, so identical to a
    whole-batch quantize)."""

    name = "vision"
    max_len = 1

    def __init__(self, qnet):
        from repro_torch.vision.models import forward_int

        self.qnet = qnet
        self.device = qnet.device
        self._forward = forward_int
        self._spec = ((*qnet.cfg.in_hw, qnet.cfg.in_ch), np.int8)

    def input_spec(self):
        return self._spec

    def step(self, state, feed, positions):
        x = torch.from_numpy(feed).to(self.device)
        logits = self._forward(self.qnet, x)
        return logits.cpu().numpy(), state

    def begin(self, payload, *, rid: int, greedy: bool = True,
              seed: int = 0):
        from repro_torch.vision.models import quantize_input

        img = np.asarray(payload, np.float32)
        x_hat = quantize_input(self.qnet, img[None]).cpu().numpy()[0]
        return _VisionCursor(payload=x_hat, rid=rid)

    def reserve_tokens(self, cur) -> int:
        return 1

    def feed(self, cur: _VisionCursor):
        return cur.payload, 0

    def consume(self, cur: _VisionCursor, row) -> bool:
        cur.out = np.asarray(row)
        cur.done = True
        return True

    def result(self, cur: _VisionCursor):
        return cur.out

    def tokens_out(self, cur: _VisionCursor) -> int:
        return 1
