"""Spans and named counters — the subset the serving runtime calls.

Off by default: `span()` and `counter()` then return shared no-op
objects, and the hot path pays one predicate. ``REPRO_OBS`` (1/true/yes/
on) turns recording on at import; `enable()`/`disable()` switch it at run
time. Recorded spans land in a bounded ring buffer. Trace export, reports
and the dispatch log are not ported yet.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List

_TRUE = ("1", "true", "yes", "on")
_T0_NS = time.perf_counter_ns()
_LOCK = threading.Lock()
_EVENTS: deque = deque(maxlen=100_000)
_COUNTERS: Dict[str, "Counter"] = {}
_ENABLED = os.environ.get("REPRO_OBS", "").lower() in _TRUE


def _now_us() -> float:
    return (time.perf_counter_ns() - _T0_NS) / 1e3


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()
        _COUNTERS.clear()


class Span:
    """One timed region, recorded as a complete ("X") trace event."""

    __slots__ = ("name", "cat", "attrs", "_t0")

    def __init__(self, name: str, cat: str, attrs: Dict[str, Any]):
        self.name, self.cat, self.attrs = name, cat, attrs
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = _now_us()
        return self

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = _now_us() - self._t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        if _ENABLED:
            with _LOCK:
                _EVENTS.append({"name": self.name, "cat": self.cat,
                                "ph": "X", "ts": round(self._t0, 3),
                                "dur": round(dur, 3),
                                "args": dict(self.attrs)})
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def set(self, **attrs) -> None:
        pass

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "span", **attrs):
    """Context manager timing the enclosed block (no-op when disabled)."""
    if not _ENABLED:
        return _NULL_SPAN
    return Span(name, cat, attrs)


class Counter:
    """A named accumulating value; `add` is a no-op while disabled."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, v=1) -> "Counter":
        if _ENABLED:
            with _LOCK:
                self.value += v
        return self


class _NullCounter(Counter):
    __slots__ = ()

    def add(self, v=1):
        return self


_NULL_COUNTER = _NullCounter("<disabled>")


def counter(name: str) -> Counter:
    """The named counter (created on first use); a shared no-op when
    disabled."""
    if not _ENABLED:
        return _NULL_COUNTER
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name)
        return c


def counter_values() -> Dict[str, float]:
    with _LOCK:
        return {name: c.value for name, c in _COUNTERS.items()}


def spans(name: str = None) -> List[Dict[str, Any]]:
    with _LOCK:
        return [e for e in _EVENTS if name is None or e["name"] == name]
