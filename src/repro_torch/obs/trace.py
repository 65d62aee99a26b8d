"""Tracing core: spans, named counters, dispatch log, Chrome-trace export.

The software analogue of the paper's hardware performance-counter setup
(Sec. V): everything the runtime wants to measure funnels through this
module into one in-process ring buffer, and one exported artifact makes
a run auditable after the fact.

Design points:

* **Zero overhead when disabled.** `span()`/`counter()` return shared
  no-op singletons and `dispatch_event()` returns immediately; the only
  cost on the hot path is one module-global predicate (and, for a span,
  one ``sys.modules`` lookup for the profiler below). Enablement comes
  from the ``REPRO_OBS`` env at import (via `repro_torch.obs.env`) or
  programmatically via `enable()`/`disable()`.
* **Profiler pass-through.** While a `torch.profiler` session records,
  every span also opens `torch.profiler.record_function(name)` for its
  extent (the reference mirrors its spans into the XLA profile the same
  way), so the range sits on the profiler's own clock beside the
  kernels it launched. This holds with ``REPRO_OBS`` off too: the span
  is then a mirror only, writing nothing to the ring buffer, keeping no
  attributes and never synchronizing (``sync(v)`` returns ``v``). With
  neither on, `span()` returns the shared no-op and builds nothing. The
  profiler is found in ``sys.modules``, so this module never imports
  torch for it.
* **Thread-safe ring buffers.** Spans/instants land in a bounded
  `collections.deque` guarded by one lock; old events fall off the
  front instead of growing without bound under serving load.
* **Chrome trace-event export.** `chrome_trace()` renders the buffer as
  the trace-event JSON object form (openable in Perfetto /
  chrome://tracing); repo-specific payloads (generic counters, the
  per-(op, bits, backend, pipeline) op counters, the dispatch log) ride
  under a top-level ``"repro"`` key, which the format explicitly allows.
* **CUDA-aware.** `Span.sync` and `time_call` synchronize the CUDA
  device a result lives on, so a span or a timed call holds the device
  time of the work it launched. torch is imported lazily there only, so
  this module loads with the standard library alone.

Timestamps are microseconds relative to a module-load epoch
(`perf_counter_ns`), matching the trace-event format's ``ts``/``dur``
unit.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from repro_torch.obs import env as obsenv

TRACE_SCHEMA_VERSION = 1
DEFAULT_CAPACITY = 100_000

_T0_NS = time.perf_counter_ns()
_LOCK = threading.RLock()
_EVENTS: deque = deque(maxlen=DEFAULT_CAPACITY)
_DISPATCH: deque = deque(maxlen=DEFAULT_CAPACITY)
_COUNTERS: Dict[str, "Counter"] = {}
_TIDS: Dict[int, int] = {}
_ENABLED = obsenv.get_bool("REPRO_OBS")


def _now_us() -> float:
    return (time.perf_counter_ns() - _T0_NS) / 1e3


def _tid() -> int:
    """Small stable per-thread id (trace viewers want dense tids)."""
    ident = threading.get_ident()
    with _LOCK:
        tid = _TIDS.get(ident)
        if tid is None:
            tid = _TIDS[ident] = len(_TIDS)
        return tid


def _cuda_device(value):
    """The device of the first CUDA tensor in ``value`` (a tensor, or a
    tuple / list / dict holding some), or None."""
    if isinstance(value, (tuple, list)):
        items = value
    elif isinstance(value, dict):
        items = value.values()
    else:
        return value.device if getattr(value, "is_cuda", False) else None
    for v in items:
        dev = _cuda_device(v)
        if dev is not None:
            return dev
    return None


def _sync(value):
    """Wait for the CUDA device ``value`` lives on (no-op otherwise)."""
    dev = _cuda_device(value)
    if dev is not None:
        import torch
        torch.cuda.synchronize(dev)
    return value


# ------------------------------------------------------------- lifecycle ---

def enabled() -> bool:
    return _ENABLED


def enable(capacity: Optional[int] = None) -> None:
    """Turn observability on; optionally resize the ring buffers."""
    global _ENABLED, _EVENTS, _DISPATCH
    with _LOCK:
        if capacity is not None and capacity != _EVENTS.maxlen:
            _EVENTS = deque(_EVENTS, maxlen=capacity)
            _DISPATCH = deque(_DISPATCH, maxlen=capacity)
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop all recorded events, dispatch entries, and generic counters
    (op counters live in `repro_torch.obs.counters` —
    `repro_torch.obs.reset()` clears both)."""
    with _LOCK:
        _EVENTS.clear()
        _DISPATCH.clear()
        _COUNTERS.clear()


@contextmanager
def enabled_scope():
    """Force-enable observability inside the block, restoring the prior
    state on exit — how a measurement takes counter readings without
    requiring ``REPRO_OBS`` in the environment."""
    global _ENABLED
    prev = _ENABLED
    enable()
    try:
        yield
    finally:
        _ENABLED = prev


# ------------------------------------------------------------------ spans ---

def _recording_profiler():
    """torch's profiler module while a `torch.profiler` session records,
    else None; looked up in ``sys.modules``, so torch is never imported
    here."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return prof
    return None


class Span:
    """One timed region. ``with span("qdot", cat="kernel", w_bits=4):``
    records an "X" (complete) trace event on exit carrying the attrs as
    ``args``, and mirrors the region into a recording profiler. `set()`
    adds attrs mid-span; `sync(value)` waits for the CUDA device
    ``value`` lives on, so device time lands inside the span, and
    returns it."""

    __slots__ = ("name", "cat", "attrs", "_t0", "_range")

    def __init__(self, name: str, cat: str, attrs: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "Span":
        prof = _recording_profiler()
        if prof is not None:
            self._range = prof.record_function(self.name)
            self._range.__enter__()
        self._t0 = _now_us()
        return self

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        return _sync(value)

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = _now_us() - self._t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        if _ENABLED:
            with _LOCK:
                _EVENTS.append({
                    "name": self.name, "cat": self.cat, "ph": "X",
                    "ts": round(self._t0, 3), "dur": round(dur, 3),
                    "pid": 0, "tid": _tid(),
                    "args": dict(self.attrs)})
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


class _NullSpan:
    """Shared do-nothing span returned while observability is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, value):
        return value


_NULL_SPAN = _NullSpan()


class _ProfilerSpan(_NullSpan):
    """A span that is only a profiler range: observability off, a
    `torch.profiler` session recording. Nothing lands in the ring
    buffer, attributes are dropped, and ``sync`` does not wait."""

    __slots__ = ("_range",)

    def __init__(self, prof, name: str):
        self._range = prof.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False


def span(name: str, cat: str = "span", **attrs):
    """A context manager timing the enclosed block; extra keyword attrs
    land in the event's ``args``. Disabled, it is the no-op singleton,
    or a profiler range only while a `torch.profiler` session records."""
    if _ENABLED:
        return Span(name, cat, attrs)
    prof = _recording_profiler()
    if prof is None:
        return _NULL_SPAN
    return _ProfilerSpan(prof, name)


# --------------------------------------------------------------- counters ---

class Counter:
    """A named monotonically-accumulating value; `add` is a no-op while
    observability is off so handles can be cached across enable state."""

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
    observability is off, so the registry holds no disabled-mode state."""
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


# ----------------------------------------------------------- dispatch log ---

def dispatch_event(**fields) -> None:
    """Record one structured launch/pipeline dispatch decision
    (`kernels/api.py` calls this once per resolution). Also mirrored
    into the span stream as an instant event so trace viewers show the
    decision inline with the kernel spans."""
    if not _ENABLED:
        return
    ts = _now_us()
    with _LOCK:
        _DISPATCH.append(dict(fields, ts=round(ts, 3)))
        _EVENTS.append({
            "name": f"dispatch:{fields.get('op', '?')}",
            "cat": "dispatch", "ph": "i", "s": "t",
            "ts": round(ts, 3), "pid": 0, "tid": _tid(),
            "args": dict(fields)})


def dispatch_log() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_DISPATCH)


# -------------------------------------------------------------- rendering ---

def events() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_EVENTS)


def spans(name: Optional[str] = None,
          cat: Optional[str] = None) -> List[Dict[str, Any]]:
    return [e for e in events()
            if e["ph"] == "X"
            and (name is None or e["name"] == name)
            and (cat is None or e["cat"] == cat)]


def chrome_trace() -> Dict[str, Any]:
    """The full buffer as a Chrome trace-event JSON object. Repo payloads
    (counters, op counters, dispatch log) ride under ``"repro"`` — extra
    top-level keys are explicitly allowed by the object form."""
    from repro_torch.obs import counters as _opcounters
    return {
        "traceEvents": events(),
        "displayTimeUnit": "ms",
        "repro": {
            "version": TRACE_SCHEMA_VERSION,
            "counters": counter_values(),
            "op_counters": _opcounters.snapshot(),
            "dispatch": dispatch_log(),
        },
    }


def export_chrome_trace(path: str) -> str:
    with open(path, "w") as fh:
        json.dump(chrome_trace(), fh, indent=1, default=str)
    return path


def export_if_configured(default_path: Optional[str] = None) -> Optional[str]:
    """Export the trace when observability is on: to ``REPRO_OBS_TRACE``
    if set, else to ``default_path`` (no-op when neither). CLIs call
    this on exit so `REPRO_OBS=1 REPRO_OBS_TRACE=t.json <cli>` is the
    whole recipe."""
    if not _ENABLED:
        return None
    path = obsenv.get("REPRO_OBS_TRACE") or default_path
    if not path:
        return None
    return export_chrome_trace(path)


def summary() -> Dict[str, Any]:
    """Aggregate view: per-span-name {count, total_us, mean_us, max_us},
    generic counters, dispatch-event count."""
    agg: Dict[str, Dict[str, float]] = {}
    for e in spans():
        s = agg.setdefault(e["name"], {"count": 0, "total_us": 0.0,
                                       "max_us": 0.0})
        s["count"] += 1
        s["total_us"] += e["dur"]
        s["max_us"] = max(s["max_us"], e["dur"])
    for s in agg.values():
        s["mean_us"] = s["total_us"] / s["count"]
    return {"spans": agg, "counters": counter_values(),
            "dispatch_events": len(dispatch_log())}


# ------------------------------------------------------------ shared timer ---

def time_call(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Mean wall-clock µs per call of ``fn(*args)``.

    ``warmup`` calls, one sync on the last result, then ``iters``
    back-to-back calls with one sync on the last result: launches
    overlap inside the loop, the sync charges all device work to the
    measured window. A wall clock over short kernels measures the host's
    launch rate, not the device (`repro_torch.kernels.tune` ranks CUDA
    candidates by profiler device time instead).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e6
