"""One run of one cell: set up, warm up, measure, check, report.

A system module (``systems/<name>.py``) drives the port for a family of
configurations. It gives:

  setup(cell, seed, device, span) -> state   build, make inputs, warm up
  step(state, i, span) -> {unit: count}      one unit of work, ended on
                                             the host (its result read
                                             back or synchronised)
  outputs(state) -> outputs                  what the window produced
  check(cell, seed, device, outputs) -> {name: value}
                                             the reference's comparison,
                                             run once the program's state
                                             is freed

``span(name)`` opens a host span around a call into a layer; in a traced
run it is a `record_function` range the breakdown reads. The harness
adds a ``step`` span around each unit.
"""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time
from typing import Callable, Dict, List

import torch

from portbench.harness import peaks as peaks_mod
from portbench.harness import trace as trace_mod

# A traced run profiles a window of at most this length: reading a
# longer trace would outlast the run's time allowance.
TRACE_SECONDS = 10.0


def span_factory(traced: bool) -> Callable:
    """``span(name)``: a profiler range when traced, else nothing."""
    if not traced:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def power_limit_w():
    """The card's power limit from ``nvidia-smi`` (None where it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split("\n")[0]
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def set_numerics() -> None:
    """Float32 as the configurations state it: no TF32 in matmuls or
    convolutions, and cuDNN's deterministic algorithms, so the program's
    float calibration and the reference's read the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(system, state, seconds: float, span, device) -> Dict:
    """Closed loop: units one after another until ``seconds`` have
    passed; the window ends with the last unit."""
    steps: List[tuple] = []
    _sync(device)
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        with span(trace_mod.STEP):
            units = system.step(state, i, span)
        t1 = time.perf_counter()
        steps.append((t0, t1, units))
        i += 1
        if t1 - t_start >= seconds:
            break
    return {"steps": steps, "t_start": t_start, "t_end": steps[-1][1],
            "window_s": steps[-1][1] - t_start}


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> dict:
    """Everything of one run; returns the result line's object."""
    dev = torch.device(device)
    set_numerics()
    span = span_factory(traced)
    state = cell.system.setup(cell, seed, dev, span)
    _sync(dev)
    setup_s = time.perf_counter() - t_process
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        win = window(cell.system, state,
                     min(seconds, TRACE_SECONDS) if traced else seconds,
                     span, dev)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    tr = trace_mod.read_profile(prof) if prof is not None else None
    outputs = cell.system.outputs(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "steps": win["steps"], "window_s": win["window_s"],
           "setup_s": setup_s, "trace": tr, "device_name": name,
           "peaks": (peaks_mod.peaks_for(name) if dev.type == "cuda"
                     else None)}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.reader.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    checks = cell.system.check(cell, seed, dev, outputs)
    limits = cell.limits["limits"]
    compared = {k: {"value": float(checks[k]), "limit": float(limits[k])}
                for k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": (power_limit_w() if dev.type == "cuda"
                                     else None)}
    out = {"correct": bool(correct), "attempted": len(win["steps"]),
           "failed": 0, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = compared
    return out
