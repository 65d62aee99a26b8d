"""Event-driven serving scheduler: admission queue, per-slot occupancy,
mid-wave eviction.

Every `step()` runs the adapter's engine step once over the slot array,
feeds each occupied slot its next input, folds the per-slot outputs back
into the request cursors, and evicts finished slots at once. Under
``policy="continuous"`` a freed slot is re-admitted at the next step;
``policy="wave"`` admits only when every slot is free (the synchronous
wave engine). Both give the same per-request outputs: adapter steps are
row-independent.

Timestamps are injected (``submit(x, now=...)`` / ``step(now=...)``) for
a virtual clock; when omitted they come from ``self.clock`` (wall time,
seconds). A request finishes at the timestamp of the step that ran it;
a wave's latency (`utilization_report`) runs from its admission until
its results are back on the host, so it includes the device work.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.parallel.mesh import data_blocks
from repro_torch.serve.runtime.slots import SlotManager


class Backpressure(RuntimeError):
    """Admission queue is full; retry after requests drain."""


class WaveStats:
    """Per-wave per-device slot utilization + latency bookkeeping: device
    d of ``dp`` owns the contiguous slot range [d*B/dp, (d+1)*B/dp) and
    real slots fill from 0, so a padded slot is an idle cluster core (the
    paper's fig. 9 readout). ``clock`` is an instance-overridable
    callable so tests can inject a fake."""

    clock = staticmethod(time.perf_counter)   # seconds

    def __init__(self, batch: int = 0, dp: int = 1):
        self.batch = batch
        self._dp = dp
        self.wave_stats: List[dict] = []

    def _record_wave(self, n_real: int, queue_depth: int = 0):
        b_loc = self.batch // self._dp
        per_dev = [min(max(n_real - d * b_loc, 0), b_loc) / b_loc
                   for d in range(self._dp)]
        self.wave_stats.append({"n_real": n_real, "batch": self.batch,
                                "per_device": per_dev,
                                "queue_depth": queue_depth,
                                "t0": self.clock(), "latency_us": None})

    def _finish_wave(self):
        w = self.wave_stats[-1]
        w["latency_us"] = (self.clock() - w.pop("t0")) * 1e6
        obs.counter("engine.waves").add(1)
        obs.counter("engine.requests").add(w["n_real"])
        return w

    def utilization_report(self) -> dict:
        """Per-device slot utilization, wave-latency percentiles and queue
        depth over the waves served so far."""
        if not self.wave_stats:
            return {"devices": self._dp, "waves": 0, "mean_util": 0.0,
                    "per_device": [0.0] * self._dp, "latency_us": None,
                    "queue_depth": None, "occupancy_timeline": []}
        per_dev = [float(np.mean([w["per_device"][d]
                                  for w in self.wave_stats]))
                   for d in range(self._dp)]
        lats = [w["latency_us"] for w in self.wave_stats
                if w.get("latency_us") is not None]
        latency = None
        if lats:
            latency = {"p50": float(np.percentile(lats, 50)),
                       "p95": float(np.percentile(lats, 95)),
                       "p99": float(np.percentile(lats, 99)),
                       "mean": float(np.mean(lats)),
                       "max": float(np.max(lats)),
                       "waves": len(lats)}
        depths = [w.get("queue_depth", 0) for w in self.wave_stats]
        return {"devices": self._dp, "waves": len(self.wave_stats),
                "mean_util": float(np.mean(per_dev)),
                "per_device": per_dev,
                "latency_us": latency,
                "queue_depth": {"mean": float(np.mean(depths)),
                                "max": int(np.max(depths))},
                "occupancy_timeline": [list(w["per_device"])
                                       for w in self.wave_stats]}


@dataclasses.dataclass
class _Entry:
    """One submitted request's lifecycle record."""
    rid: int
    cursor: Any
    submit_t: float
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None
    sid: Optional[int] = None


class Scheduler(WaveStats):
    """Workload-agnostic serving loop over a `WorkloadAdapter`.

    ``num_slots`` is the number of real request slots (the wave's batch
    size). When the adapter serves on a mesh (``adapter.mesh``) the
    physical slot array is padded to a multiple of its ``data`` axis size
    and device *d* owns a contiguous block (a ragged ``num_slots % dp`` is
    absorbed by pad slots that are never admitted). ``max_queue``
    bounds the admission queue (`submit` raises `Backpressure` when it is
    full).
    """

    def __init__(self, adapter, num_slots: int, *,
                 policy: str = "continuous",
                 max_queue: Optional[int] = None, page_tokens: int = 16):
        if policy not in ("continuous", "wave"):
            raise ValueError(f"unknown policy {policy!r}")
        mesh = adapter.mesh
        dp = 1 if mesh is None else len(data_blocks(mesh))
        self.adapter = adapter
        self.policy = policy
        self.max_queue = max_queue
        self.slots = SlotManager(num_slots, adapter.max_len, dp=dp,
                                 page_tokens=page_tokens)
        # wave stats run over the physical array, so the per-device
        # columns line up with the mesh blocks
        super().__init__(batch=self.slots.phys, dp=dp)
        self.state = adapter.init_state(self.slots.phys)
        self._queue: Deque[_Entry] = collections.deque()
        self._entries: Dict[int, _Entry] = {}
        self.results: Dict[int, Any] = {}
        self.request_log: List[dict] = []
        self.step_log: List[dict] = []
        self._next_rid = 0
        self._rid0 = 0
        self._greedy = True
        self._seed = 0
        self._wave_live = 0

    @property
    def idle(self) -> bool:
        return not self._queue and not self.slots.active

    def submit(self, payload, now: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise Backpressure(
                f"admission queue full ({self.max_queue} pending)")
        now = self.clock() if now is None else now
        rid = self._next_rid
        self._next_rid += 1
        cur = self.adapter.begin(payload, rid=rid - self._rid0,
                                 greedy=self._greedy, seed=self._seed)
        self.slots.check_fits(self.adapter.prompt_len(cur))
        e = _Entry(rid=rid, cursor=cur, submit_t=now)
        self._entries[rid] = e
        if getattr(cur, "done", False):
            self._finish(e, now)      # completes without occupying a slot
        else:
            self._queue.append(e)
        return rid

    def _admit(self, now: float):
        admitted = []
        if self.policy == "wave":
            if self.slots.active or not self._queue:
                return
            n = min(self.slots.real, len(self._queue))
            for _ in range(n):
                admitted.append(self._admit_one(now))
            self._wave_live = n
            self._record_wave(n, queue_depth=len(self._queue))
        else:
            while self._queue and self.slots.free_slots:
                admitted.append(self._admit_one(now))
        if admitted:
            mask = np.zeros(self.slots.phys, bool)
            mask[[e.sid for e in admitted]] = True
            self.state = self.adapter.reset_state(self.state, mask)

    def _admit_one(self, now: float) -> _Entry:
        e = self._queue.popleft()
        e.sid = self.slots.admit(
            e.rid, self.adapter.reserve_tokens(e.cursor))
        e.admit_t = now
        return e

    def step(self, now: Optional[float] = None) -> List[int]:
        """Admit, run one engine step over the slot array, evict finished
        requests. Returns the finished rids."""
        now = self.clock() if now is None else now
        self._admit(now)
        active = self.slots.active
        if not active:
            return []
        shape, dtype = self.adapter.input_spec()
        feed = np.zeros((self.slots.phys, *shape), dtype)
        pos = np.zeros(self.slots.phys, np.int32)
        for s in active:
            row, p = self.adapter.feed(self._entries[s.rid].cursor)
            feed[s.sid] = row
            pos[s.sid] = p
        with obs.span("serve.step", cat="serve", active=len(active),
                      queue_depth=len(self._queue)):
            rows, self.state = self.adapter.step(self.state, feed, pos)
        finished: List[int] = []
        for s in active:
            e = self._entries[s.rid]
            self.slots.advance(s.sid, int(pos[s.sid]) + 1)
            if self.adapter.consume(e.cursor, rows[s.sid]):
                self._finish(e, now)
                finished.append(e.rid)
        self.step_log.append({
            "t": now, "active": len(active),
            "queue_depth": len(self._queue),
            "occupancy": self.slots.occupancy(),
            "per_device": self.slots.device_occupancy()})
        return finished

    def _finish(self, e: _Entry, now: float):
        self.adapter.finish(e.cursor)
        if e.sid is not None:
            self.slots.evict(e.sid)
        e.finish_t = now
        self.results[e.rid] = self.adapter.result(e.cursor)
        self.request_log.append({
            "rid": e.rid, "submit_t": e.submit_t, "admit_t": e.admit_t,
            "finish_t": now,
            "prompt_len": self.adapter.prompt_len(e.cursor),
            "tokens_out": self.adapter.tokens_out(e.cursor)})
        if self.policy == "wave":
            if e.sid is not None:
                self._wave_live -= 1
                if self._wave_live == 0:
                    self._finish_wave()
        else:
            obs.counter("engine.requests").add(1)

    def serve(self, payloads, greedy: bool = True, seed: int = 0) -> list:
        """Submit everything, run to drain, return per-request results in
        submission order."""
        self._greedy, self._seed = greedy, seed
        self._rid0 = self._next_rid
        rids = [self.submit(p) for p in payloads]
        self.drain()
        return [self.results[r] for r in rids]

    def drain(self):
        while not self.idle:
            self.step()

    def serving_report(self) -> dict:
        """Request-granular latency/occupancy stats, in the caller's time
        unit."""
        lats = [r["finish_t"] - r["submit_t"] for r in self.request_log]
        lat = None
        if lats:
            lat = {"p50": float(np.percentile(lats, 50)),
                   "p95": float(np.percentile(lats, 95)),
                   "p99": float(np.percentile(lats, 99)),
                   "mean": float(np.mean(lats)),
                   "max": float(np.max(lats))}
        depths = [s["queue_depth"] for s in self.step_log]
        occ = [s["occupancy"] for s in self.step_log]
        return {
            "policy": self.policy,
            "slots": self.slots.real,
            "devices": self._dp,
            "requests": len(self.request_log),
            "steps": len(self.step_log),
            "tokens_out": int(sum(r["tokens_out"]
                                  for r in self.request_log)),
            "latency": lat,
            "queue_depth": ({"mean": float(np.mean(depths)),
                             "max": int(np.max(depths))}
                            if depths else None),
            "occupancy": ({"mean": float(np.mean(occ)),
                           "min": float(np.min(occ))} if occ else None),
            "pages": {"per_slot": self.slots.pages_per_slot,
                      "capacity": self.slots.capacity_pages},
        }
