"""Fault-tolerant training runtime: checkpoint / restart loop, straggler
monitor, preemption handling.

Every state transition goes through the atomic checkpointer; an exception
inside a step (``RuntimeError``, which a CUDA fault raises, or
``FloatingPointError``) restores the latest checkpoint and replays from
it; SIGTERM (a preemption notice) writes a final synchronous checkpoint.
Data order survives a restart without persisting reader state: after a
restore the batch iterator is seeked to the restored step where it has a
``seek`` (`data.pipeline.SyntheticLM` does), so the replayed batches are
the ones the lost steps saw.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         restore)
from repro_torch.nn.module import tree_leaves


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0   # step > factor * median -> flagged


class StragglerMonitor:
    """Tracks step times and flags outliers (a step slower than
    ``factor`` x the window's median, once 5 steps are in). On one host
    the process's own step time stands in for the per-host times a
    multi-host deployment would compare."""

    def __init__(self, factor: float = 2.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times: list = []
        self.flags = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.flags += 1
                return True
        return False

    @property
    def median(self):
        return float(np.median(self.times)) if self.times else 0.0


def _sync(value) -> None:
    """Wait for the device ``value`` lives on (the step's end)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class Trainer:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` to
    ``cfg.total_steps``, restoring from ``cfg.ckpt_dir`` when it holds a
    checkpoint and calling ``init_fn(seed)`` otherwise. Checkpoints are
    restored onto ``device``, or placed per ``state_shardings``."""

    def __init__(self, init_fn, step_fn, batch_iter, cfg: TrainerConfig,
                 state_shardings=None, mesh=None, device="cuda"):
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.batch_iter = batch_iter
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.mesh = mesh
        self.device = device
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.monitor = StragglerMonitor(cfg.straggler_factor)
        self.metrics_log: list = []
        self.restored_step = None     # step and seconds of the last restore
        self.restore_s = None
        self._preempted = False

    def _install_preemption_handler(self):
        def _h(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, _h)
        except ValueError:
            pass  # not the main thread

    def _restore_or_init(self, seed):
        step = latest_step(self.cfg.ckpt_dir)
        if step is not None:
            t0 = time.perf_counter()
            state, step = restore(self.cfg.ckpt_dir, step,
                                  device=self.device,
                                  shardings=self.state_shardings)
            _sync(tree_leaves(state)[0])
            self.restore_s = time.perf_counter() - t0
            self.restored_step = step
        else:
            state, step = self.init_fn(seed), 0
        if hasattr(self.batch_iter, "seek"):
            self.batch_iter.seek(step)
        return state, step

    def run(self, seed: int = 0):
        """Run to total_steps with restart-on-failure. Returns (state,
        metrics_log)."""
        self._install_preemption_handler()
        restarts = 0
        state, step = self._restore_or_init(seed)
        while step < self.cfg.total_steps:
            try:
                batch = next(self.batch_iter)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                _sync(metrics["loss"])
                dt = time.perf_counter() - t0
                slow = self.monitor.record(dt)
                step += 1
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, dt=dt, straggler=slow)
                self.metrics_log.append(rec)
                if step % self.cfg.ckpt_every == 0 or \
                        step == self.cfg.total_steps:
                    self.ckpt.save_async(step, state)
                if self._preempted:
                    self.ckpt.wait()
                    self.ckpt.save_async(step, state)
                    self.ckpt.wait()
                    break
            except (FloatingPointError, RuntimeError):
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                # a failed device or a NaN blowup: restore and replay
                self.ckpt.wait()
                state, step = self._restore_or_init(seed)
        self.ckpt.wait()
        return state, self.metrics_log
