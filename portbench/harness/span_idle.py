"""Device idle under the program's own spans.

The port opens a host span per layer of its step (``vision/<path>`` in
`forward_int` and ``vision/quantize``; ``lm/embed``, ``lm/attn.*``,
``lm/mlp``, ``lm/head`` in the LM prefill), which a traced run records as
`record_function` ranges on the profiler's clock. `idle_inside` is the
idle time of the traced window (the window less the union of the device
intervals, `Trace.busy_intervals`) that lies inside the union of those
spans whose name starts with a prefix: the time the card waited while
the host was in one of those layers.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def _union(ivs) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_inside(tr, prefix: str) -> Optional[float]:
    """Seconds of the window's idle time inside the union of the host
    spans whose name starts with ``prefix``; None where the window holds
    no such span (a program that opens none, as before the port had
    them, or one that lost them) or no device record, so the metric is
    left out of the result line rather than read as no idle or all."""
    lo, hi = tr.window
    spans = _union((max(s, lo), min(e, hi)) for n, s, e in tr.spans
                   if n.startswith(prefix) and e > lo and s < hi)
    if not spans or not tr.device:
        return None
    inside = sum(e - s for s, e in spans)
    return (inside - _overlap(spans, tr.busy_intervals())) / 1e6
