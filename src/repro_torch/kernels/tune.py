"""Measured launch cache: per-(op, shape, bits, backend) winners of the
kernels' runtime knobs.

The port's kernels have two knobs chosen at run time:
* the uniform GEMM's launch (`gemm_launch_plan`): how many blocks share
  one output tile's K stages (``splits``) and the register budget
  (``min_blocks``, resident blocks per SM), hand rules by default;
* every kernel's pipeline mode, 'off' or 'double_buffer' (STAGES=1 or
  STAGES=2, the Mac&Load knob).
The conv's tile and stage K are compile-time functions of Cout
(`conv_tile_n`, `conv_stage_k`), so its one runtime knob is the
pipeline; the mixed-operand GEMM's K split is hard-wired and it takes
its pipeline from the cache only.

`repro_torch.kernels.api` consults `get_entry` on every call: launch
tuned -> planned; pipeline explicit -> ``REPRO_QPIPELINE`` -> tuned ->
'off'. Loading no cache leaves every launch as `gemm_launch_plan` plans
it.

`autotune_qdot` / `autotune_qconv` time every candidate and record the
winner:
* on the card, every launch `gemm_launches` lists at each pipeline (the
  conv: each pipeline), ranked by **device time**: torch.profiler's
  records of the kernel, mean per launch over ``iters`` launches, the
  median of `DEVICE_ROUNDS` such sessions. A wrapper call costs tens of
  µs of host time against a few µs of device time for a small GEMM, so
  a wall clock would rank host noise. Integer
  partial sums add exactly in any order, so every candidate must return
  the planned launch's output at 'off'; one that differs cannot win,
  and the sweep's span says so (``exact``). Entries say ``"timer":
  "device"``;
* on the CPU there is no launch to tune: one candidate (``launch:
  null``, 'off'), timed by `repro_torch.obs.time_call`, ``"timer":
  "wall"``.

Cache key: ``op|MxKxN|a{a_bits}w{w_bits}|backend`` (qdot: K padded to
CHUNK; conv keys the full geometry tuple), backend ``cuda`` or
``torch``. Entry: ``{"launch": {"splits", "min_blocks"} | null,
"pipeline", "us", "timer"}``. The JSON artifact carries the port's own
version (the reference's caches hold TPU blocks: `load` refuses them);
``REPRO_QTUNE_CACHE=/path/to/cache.json`` preloads it at first lookup.

CLI:

    # targeted qdot tune on the card
    PYTHONPATH=src python -m repro_torch.kernels.tune \\
        --shapes 64x256x256,64x512x128 --bits 8x8,8x4 --out tune_cache.json

    # full measured sweep: qdot over --shapes and the built-in ladder,
    # qconv over the paper's fig.11 geometries, both pipelines
    PYTHONPATH=src python -m repro_torch.kernels.tune --device cuda \\
        --sweep --out tune_cache.json
"""
from __future__ import annotations

import json
import pathlib
import statistics
import warnings
from typing import Dict, Optional, Sequence

from repro_torch.kernels.common import PIPELINE_MODES
from repro_torch.obs import env as obsenv
from repro_torch.obs import trace as obs

# The port's own artifact version: its entries hold a CUDA launch where
# the reference's (version 3) hold a TPU block, so either package's
# `load` refuses the other's cache loudly.
CACHE_VERSION = "repro_torch-1"
CACHE_ENV = "REPRO_QTUNE_CACHE"
TIMERS = ("device", "wall")
# Profiler sessions per candidate on the card, of which the median counts:
# single sessions gave outliers of 2x either way on an H100 (a winner at
# half its re-timed device time), which a min over candidates picks.
DEVICE_ROUNDS = 3


def _key(op: str, shape: Sequence[int], a_bits: int, w_bits: int,
         backend: str) -> str:
    return (f"{op}|{'x'.join(str(int(s)) for s in shape)}"
            f"|a{a_bits}w{w_bits}|{backend}")


def _entry(launch=None, pipeline: str = "off", us=None,
           timer: Optional[str] = None) -> dict:
    """A checked, fresh cache entry."""
    if pipeline not in PIPELINE_MODES:
        raise ValueError(f"unknown pipeline mode {pipeline!r}")
    if timer is not None and timer not in TIMERS:
        raise ValueError(f"unknown timer {timer!r}; expected {TIMERS}")
    return {"launch": None if launch is None else {
                "splits": int(launch["splits"]),
                "min_blocks": int(launch["min_blocks"])},
            "pipeline": str(pipeline),
            "us": None if us is None else round(float(us), 3),
            "timer": timer}


class TuneCache:
    """In-memory measured-winner cache with a versioned JSON round-trip.

    Each entry: ``{"launch": {"splits", "min_blocks"} | None, "pipeline":
    "off"|"double_buffer", "us": float|None, "timer": "device"|"wall"|
    None}`` — the winning launch (None: the planned one; always None on
    the CPU and for the conv), the winning pipeline, the measured time
    that won and what measured it (None for hand-recorded entries).
    """

    def __init__(self):
        self.entries: Dict[str, dict] = {}

    def get(self, op, shape, a_bits, w_bits, backend) -> Optional[dict]:
        e = self.entries.get(_key(op, shape, a_bits, w_bits, backend))
        return None if e is None else _entry(**e)

    def put(self, op, shape, a_bits, w_bits, backend, launch=None,
            pipeline: str = "off", us: Optional[float] = None,
            timer: Optional[str] = None):
        self.entries[_key(op, shape, a_bits, w_bits, backend)] = _entry(
            launch, pipeline, us, timer)

    def to_json(self) -> str:
        return json.dumps({"version": CACHE_VERSION,
                           "entries": dict(sorted(self.entries.items()))},
                          indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "TuneCache":
        d = json.loads(text)
        if d.get("version") != CACHE_VERSION:
            raise ValueError(
                f"unsupported tune-cache version {d.get('version')!r} "
                f"(expected {CACHE_VERSION!r}); re-run "
                "`python -m repro_torch.kernels.tune --sweep` to "
                "regenerate")
        c = TuneCache()
        for k, e in d.get("entries", {}).items():
            c.entries[k] = _entry(e.get("launch"), e.get("pipeline", "off"),
                                  e.get("us"), e.get("timer"))
        return c


# module-level cache; REPRO_QTUNE_CACHE preloads it lazily on first lookup
_CACHE = TuneCache()
_ENV_LOADED = False


def _maybe_load_env():
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    path = obsenv.get(CACHE_ENV)
    if not path:
        return
    if pathlib.Path(path).exists():
        try:
            merge(load(path))
        except ValueError as e:
            warnings.warn(
                f"{CACHE_ENV}={path}: {e}; no tuned launches loaded — "
                "re-run `python -m repro_torch.kernels.tune` to regenerate",
                RuntimeWarning, stacklevel=2)
    else:
        warnings.warn(
            f"{CACHE_ENV}={path} does not exist; no tuned launches loaded "
            "(every launch is the planned one, every pipeline 'off')",
            RuntimeWarning, stacklevel=2)


def get_entry(op: str, shape, a_bits: int, w_bits: int,
              backend: str) -> Optional[dict]:
    """Full cached entry ({'launch', 'pipeline', 'us', 'timer'}) or
    None."""
    _maybe_load_env()
    return _CACHE.get(op, shape, a_bits, w_bits, backend)


def get_pipeline(op: str, shape, a_bits: int, w_bits: int,
                 backend: str) -> Optional[str]:
    """Cached measured pipeline winner, or None (-> 'off' upstream)."""
    e = get_entry(op, shape, a_bits, w_bits, backend)
    return None if e is None else e["pipeline"]


def record(op: str, shape, a_bits: int, w_bits: int, backend: str,
           launch=None, pipeline: str = "off", us: Optional[float] = None,
           timer: Optional[str] = None) -> None:
    _CACHE.put(op, shape, a_bits, w_bits, backend, launch, pipeline, us,
               timer)


def clear() -> None:
    _CACHE.entries.clear()


def save(path) -> None:
    pathlib.Path(path).write_text(_CACHE.to_json())


def load(path) -> TuneCache:
    return TuneCache.from_json(pathlib.Path(path).read_text())


def merge(other: TuneCache) -> None:
    """Merge ``other`` into the module cache; on a key conflict the
    *incoming* entry wins (last merge is the freshest measurement)."""
    _CACHE.entries.update(other.entries)


def entries() -> Dict[str, dict]:
    return {k: _entry(**e) for k, e in _CACHE.entries.items()}


# ---------------------------------------------------------------- tuning ---

def _device_us(fn, kernel: str, iters: int, tries: int = 5) -> float:
    """Mean device µs per launch of the CUDA kernels whose name holds
    ``kernel`` over ``iters`` calls of ``fn``, from torch.profiler's
    kernel records (a trace may miss a record; the mean does not depend
    on how many it holds). On an H100 the profiler has also returned
    traces with no record at all, several sessions in a row; when
    ``tries`` sessions hold none, the time comes from `_queued_event_us`
    instead (counted as ``tune.event_timed``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        n = sum(e.count for e in recs)
        if n:
            return sum(e.self_device_time_total for e in recs) / n
    obs.counter("tune.event_timed").add(1)
    return _queued_event_us(fn, iters)


# Cycles the stream spins (`torch.cuda._sleep`) while the host queues the
# launches `_queued_event_us` times: ~10 ms on an H100, longer than the
# host takes to queue tens of wrapper calls.
SPIN_CYCLES = 20_000_000


def _queued_event_us(fn, iters: int) -> float:
    """µs per call of ``fn`` between two CUDA events around ``iters``
    calls queued behind a spin on the stream, so the device runs them
    back to back: device time, with the gaps between launches (about a
    µs each) that the profiler's kernel records leave out."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _same(a, b) -> bool:
    """Identical outputs, bf16 bit for bit."""
    import torch
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


def _sweep(op: str, shape, a_bits: int, w_bits: int, backend: str, run,
           cands, iters: int, kernel: Optional[str]):
    """Time every (launch, pipeline) candidate — the first is the planned
    one — record and return the winner as (launch, pipeline).

    ``kernel`` (the CUDA kernel's name): rank by device time and refuse a
    candidate whose output differs from the first's. None (the CPU):
    rank by wall time."""
    timer = "wall" if kernel is None else "device"
    times, mismatched, want = [], [], None
    with obs.span("tune.sweep", cat="tune", op=op,
                  shape=tuple(int(s) for s in shape), a_bits=int(a_bits),
                  w_bits=int(w_bits), backend=backend,
                  candidates=len(cands), timer=timer) as sweep_span:
        for launch, pipe in cands:
            def fn(launch=launch, pipe=pipe):
                return run(launch, pipe)
            if kernel is None:
                times.append((obs.time_call(fn, warmup=1, iters=iters),
                              launch, pipe))
                continue
            out = fn()
            if want is None:
                want = out
            elif not _same(out, want):
                mismatched.append({"launch": launch, "pipeline": pipe})
                continue
            times.append((statistics.median(
                _device_us(fn, kernel, iters) for _ in range(DEVICE_ROUNDS)),
                launch, pipe))
        best_us, best_launch, best_pipe = min(times, key=lambda t: t[0])
        sweep_span.set(planned_launch=cands[0][0],
                       planned_pipeline=cands[0][1],
                       planned_us=round(times[0][0], 3),
                       winner_launch=best_launch, winner_pipeline=best_pipe,
                       winner_us=round(best_us, 3), exact=not mismatched,
                       mismatched=mismatched)
    record(op, shape, a_bits, w_bits, backend, best_launch, best_pipe,
           us=best_us, timer=timer)
    return best_launch, best_pipe


def autotune_qdot(params, x_packed, *, epilogue: str = "int",
                  iters: int = 10, pipelines=PIPELINE_MODES):
    """Time the uniform GEMM's candidate launches x pipeline modes for
    one packed shape (module docstring). Returns the winning ``(launch,
    pipeline)``; it also lands in the module cache under the key
    `api.qdot` looks up, so later calls at this shape take both."""
    from repro_torch.core import packing
    from repro_torch.kernels import api
    from repro_torch.kernels.qmatmul import kernel as gk

    m = x_packed.shape[0]
    k = x_packed.shape[1] * packing.pack_factor(params.a_bits)
    n = params.w_packed.shape[1]
    backend = api.device_backend(x_packed.device)

    def run(launch, pipe):
        return api.qdot_run(params, x_packed, epilogue=epilogue, scale=1.0,
                            pipeline=pipe, launch=launch)

    if backend == "torch":
        cands, kernel = [(None, "off")], None
    else:
        launches = gk.gemm_launches(m, n, params.k_logical, params.a_bits,
                                    gk.sm_count(x_packed.device))
        cands = [({"splits": L.splits, "min_blocks": L.min_blocks}, p)
                 for L in launches for p in pipelines]
        kernel = "qmatmul_kernel"
    return _sweep("qdot", (m, k, n), params.a_bits, params.w_bits, backend,
                  run, cands, iters, kernel)


def autotune_qconv(params, x_hat, *, epilogue: str = "int",
                   iters: int = 10, pipelines=PIPELINE_MODES):
    """Time the conv's pipeline modes for one image geometry (its one
    runtime knob). Returns the winning ``(None, pipeline)`` and records
    it under the shape key `api.qconv` looks up."""
    from repro_torch.kernels import api

    g = params.gemm
    shape = (*x_hat.shape, params.fh, params.fw, params.stride,
             params.padding, params.cout, params.groups)
    backend = api.device_backend(x_hat.device)

    def run(launch, pipe):
        return api.qconv_run(params, x_hat, epilogue=epilogue, scale=1.0,
                             pipeline=pipe)

    if backend == "torch":
        cands, kernel = [(None, "off")], None
    else:
        cands, kernel = [(None, p) for p in pipelines], "qconv_kernel"
    return _sweep("qconv", shape, g.a_bits, g.w_bits, backend, run, cands,
                  iters, kernel)


# ------------------------------------------------------------------- CLI ---

def _mk_qdot_artifact(gen, m, k, n, ab, wb, device="cpu"):
    """Seeded random (params, packed activations) of an (m, k, n) GEMM:
    K zero-padded to CHUNK and contracted over the real k, as `api.qdot`
    pads it."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.quantize import QuantizedLinearParams

    def ints(bits, signed, size):
        lo, hi = packing.int_range(bits, signed)
        return torch.randint(lo, hi + 1, size, generator=gen,
                             dtype=torch.int32).to(torch.int8).to(device)

    xp = packing.pack(packing.pad_to_chunk(ints(ab, False, (m, k))), ab)
    wp = packing.pack(packing.pad_to_chunk(ints(wb, True, (k, n)), axis=0),
                      wb, axis=0)
    params = QuantizedLinearParams(
        w_packed=wp, w_bits=wb, a_bits=ab, a_signed=False,
        kappa=torch.ones((n,), dtype=torch.int32, device=device),
        lam=torch.zeros((n,), dtype=torch.int32, device=device),
        m=torch.full((n,), 1 << 14, dtype=torch.int32, device=device), d=20,
        out_bits=8, k_logical=k)
    return params, xp


def _mk_qconv_artifact(gen, h, w, cin, cout, fh, fw, stride, padding, ab,
                       wb, batch=1, device="cpu"):
    """Seeded random (params, integer images) of one conv geometry."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels.qconv.ops import quantize_conv

    wgt = torch.randn((fh, fw, cin, cout), generator=gen) * 0.2
    params = quantize_conv(
        wgt.to(device), QuantSpec.weight(wb, 0.6),
        torch.ones((cout,), device=device),
        torch.zeros((cout,), device=device),
        QuantSpec.activation(ab, 2.0), QuantSpec.activation(ab, 2.0),
        stride=stride, padding=padding)
    lo, hi = packing.int_range(ab, False)
    x = torch.randint(lo, hi + 1, (batch, h, w, cin), generator=gen,
                      dtype=torch.int32).to(torch.int8).to(device)
    return params, x


# the paper's fig.11 conv geometries (16x16 / 32x32 IoT layers)
SWEEP_CONV_SHAPES = ((16, 16, 16, 64, 3, 3, 1, 1),
                     (32, 32, 16, 32, 3, 3, 1, 1))
SWEEP_GEMM_SHAPES = ((64, 256, 256), (64, 512, 128), (256, 4608, 256))


def main(argv=None):
    import argparse

    import torch

    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shapes", default="64x256x256",
                    help="comma-separated MxKxN GEMM shapes")
    ap.add_argument("--bits", default="8x8,4x4,2x2",
                    help="comma-separated AxW bit pairs")
    ap.add_argument("--iters", type=int, default=10,
                    help="launches timed per candidate")
    ap.add_argument("--out", default="tune_cache.json")
    ap.add_argument("--sweep", action="store_true",
                    help="full measured sweep: both ops (qdot over "
                         "--shapes plus the built-in ladder, qconv over "
                         "the paper's fig.11 geometries) x candidate "
                         "launches x pipeline modes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, device time) or cpu (the "
                         "plain versions: launch null, wall time)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    bit_pairs = [tuple(int(v) for v in pair.split("x"))
                 for pair in args.bits.split(",")]
    gemm_shapes = [tuple(int(v) for v in sh.split("x"))
                   for sh in args.shapes.split(",")]
    if args.sweep:
        gemm_shapes = sorted(set(gemm_shapes) | set(SWEEP_GEMM_SHAPES))

    with obs.enabled_scope():
        for m, k, n in gemm_shapes:
            for ab, wb in bit_pairs:
                params, xp = _mk_qdot_artifact(gen, m, k, n, ab, wb, device)
                launch, pipe = autotune_qdot(params, xp, iters=args.iters)
                sweep = obs.spans("tune.sweep")[-1]["args"]
                print(f"qdot {m}x{k}x{n} A{ab}W{wb} [{device.type}] -> "
                      f"launch={json.dumps(launch)} pipeline={pipe} "
                      f"{sweep['winner_us']} us ({sweep['timer']}; planned "
                      f"{sweep['planned_us']} us) exact={sweep['exact']}")
        if args.sweep:
            for h, w, cin, cout, fh, fw, stride, padding in \
                    SWEEP_CONV_SHAPES:
                for ab, wb in bit_pairs:
                    params, x = _mk_qconv_artifact(
                        gen, h, w, cin, cout, fh, fw, stride, padding, ab,
                        wb, device=device)
                    _, pipe = autotune_qconv(params, x, iters=args.iters)
                    sweep = obs.spans("tune.sweep")[-1]["args"]
                    print(f"qconv {h}x{w}x{cin}->{cout} {fh}x{fw}s{stride} "
                          f"A{ab}W{wb} [{device.type}] -> pipeline={pipe} "
                          f"{sweep['winner_us']} us ({sweep['timer']}) "
                          f"exact={sweep['exact']}")
    save(args.out)
    print(f"tune cache ({len(entries())} entries) -> {args.out}")


if __name__ == "__main__":
    main()
