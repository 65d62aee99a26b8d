"""The traced run's reading of the device timeline.

`torch.profiler` records the window: the device's kernels, copies and
sets, and the harness's own host spans (`record_function`: one ``step``
around each unit of work, and the spans the system opens inside it).
Its Chrome trace is read once and reduced to:

- busy: the union of the device intervals inside the window (the first
  step's start to the last step's end), so overlapping work counts
  once;
- steps: each step's device records, for per-step kernel sums;
- the breakdown: the device operations that took most time, and the
  idle gaps of the window by the host span that was open at the gap.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "user_annotation"
STEP = "step"


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]             # us, trace clock
    device: List[Tuple[str, float, float]]  # (name, start, end) us
    spans: List[Tuple[str, float, float]]   # host spans (name, start, end)
    steps: List[Tuple[float, float]]        # each step's host range

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                     if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def step_records(self) -> List[List[Tuple[str, float, float]]]:
        """The device records of each step, by start time."""
        out = [[] for _ in self.steps]
        starts = [s for s, _ in self.steps]
        for rec in self.device:
            i = bisect.bisect_right(starts, rec[1]) - 1
            if i >= 0 and rec[1] < self.steps[i][1]:
                out[i].append(rec)
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        lo, hi = self.window
        for name, s, e in self.device:
            if e > lo and s < hi:
                tot[name] = tot.get(name, 0.0) + (min(e, hi) - max(s, lo))
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v / 1e6] for n, v in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time of the window split over the host spans open during
        it (the spans inside a step follow one another), summed by span
        name; idle time under no such span is ``between steps``."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        inner = sorted((sp for sp in self.spans if sp[0] != STEP),
                       key=lambda sp: sp[1])
        starts = [sp[1] for sp in inner]
        tot: Dict[str, float] = {}
        for s, e in gaps:
            left = e - s
            i = max(bisect.bisect_right(starts, s) - 1, 0)
            while i < len(inner) and inner[i][1] < e:
                name, a, b = inner[i]
                cut = min(b, e) - max(a, s)
                if cut > 0:
                    tot[name] = tot.get(name, 0.0) + cut
                    left -= cut
                i += 1
            if left > 0:
                tot["between steps"] = tot.get("between steps", 0.0) + left
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e6] for n, v in rows]


def parse(events: List[dict]) -> Trace:
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat in DEVICE_CATS:
            device.append((str(ev.get("name", "")), s, e))
        elif cat == HOST_CAT:
            spans.append((str(ev.get("name", "")), s, e))
    steps = sorted((s, e) for n, s, e in spans if n == STEP)
    if not steps:
        raise RuntimeError("the trace holds no 'step' span")
    device.sort(key=lambda r: r[1])
    return Trace(window=(steps[0][0], steps[-1][1]), device=device,
                 spans=spans, steps=steps)


def read_profile(prof) -> Trace:
    """Export ``prof``'s Chrome trace to a temporary file (under
    ``$TMPDIR``), read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return parse(events)


def matching_steps(trace: Trace, patterns) -> Tuple[int, float, int]:
    """(steps counted, device seconds, launches per step) of the kernels
    whose name holds one of ``patterns``, over the steps that hold the
    usual number of them. A profiler session may hold no record of a
    launch now and then; a step that lost one is left out, rather than
    counted short. (0, 0.0, 0) where no step holds such a kernel."""
    per = []
    for recs in trace.step_records():
        hits = [(e - s) for n, s, e in recs
                if any(p in n for p in patterns)]
        per.append((len(hits), sum(hits)))
    counts = [c for c, _ in per if c > 0]
    if not counts:
        return 0, 0.0, 0
    usual = max(set(counts), key=counts.count)
    full = [t for c, t in per if c == usual]
    return len(full), sum(full) / 1e6, usual
