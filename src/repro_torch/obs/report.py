"""Render a trace artifact: MAC/µs per bit-width, dispatch summary, top
spans.

    python -m repro_torch.obs.report [trace.json]

Reads the Chrome trace-event JSON written by `obs.export_chrome_trace`
(the vision CLI run with ``REPRO_OBS=1 REPRO_OBS_TRACE=trace.json``)
and prints

* **MAC/µs per bit-width** — kernel spans carry their MAC count and the
  resolved (backend, pipeline), so the table is measured throughput per
  (op, W, A, backend, pipeline) bucket, the software analogue of the
  paper's MAC/cycle-per-precision tables; packed-bytes and arithmetic
  intensity come from the op counters. A span's time is wall time on
  the host, synced: on the card it holds the wrapper's host time as
  well as the kernel's.
* **Dispatch summary** — how every resolution layer decided, tune-cache
  hit rate, final backend×pipeline histogram.
* **Top spans** — where the wall-clock went, by total span duration.
* **Serving runtime** — the scheduler's admission/eviction/page counters
  and `serve.step` span aggregate when the trace contains serving work,
  plus a policy-comparison table from ``BENCH_serving.json`` when that
  artifact sits next to the trace.

The same renderer as the reference's ``repro.obs.report``: both print
the same text for the same trace document. The path defaults to
``REPRO_OBS_TRACE`` then ``BENCH_trace.json``. Dependency-free (stdlib
only): runs anywhere the JSON artifact lands.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Any, Dict, List


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        doc = json.load(fh)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace-event object "
                         "(no 'traceEvents' key)")
    return doc


def _fmt_table(headers: List[str], rows: List[List[str]]) -> str:
    rows = [[str(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def kernel_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def mac_table(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Measured MAC/µs per (op, w_bits, a_bits, backend, pipeline), from
    kernel spans; packed bytes joined in from the op counters."""
    agg: Dict[tuple, Dict[str, float]] = defaultdict(
        lambda: {"calls": 0, "macs": 0.0, "us": 0.0})
    for e in kernel_spans(doc):
        a = e.get("args", {})
        k = (a.get("op") or e.get("name"), a.get("w_bits"),
             a.get("a_bits"), a.get("backend"), a.get("pipeline"))
        agg[k]["calls"] += 1
        agg[k]["macs"] += a.get("macs") or 0
        agg[k]["us"] += e.get("dur", 0.0)
    packed = {}
    for key, c in doc.get("repro", {}).get("op_counters", {}).items():
        op, bits, backend, pipeline = key.split("|")
        w, a = bits[1:].split("a")
        packed[(op, int(w), int(a), backend, pipeline)] = c
    rows = []
    for k in sorted(agg, key=lambda t: tuple(str(v) for v in t)):
        op, w, a, backend, pipeline = k
        v = agg[k]
        c = packed.get(k, {})
        pb = c.get("packed_bytes")
        rows.append({
            "op": op, "w_bits": w, "a_bits": a, "backend": backend,
            "pipeline": pipeline, "calls": v["calls"],
            "macs": int(v["macs"]), "us": v["us"],
            "macs_per_us": v["macs"] / v["us"] if v["us"] else 0.0,
            "packed_bytes": pb,
            "intensity": (int(v["macs"]) / pb if pb else None)})
    return rows


def dispatch_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    log = doc.get("repro", {}).get("dispatch", [])
    by_choice: Dict[str, int] = defaultdict(int)
    by_source: Dict[str, int] = defaultdict(int)
    hits = 0
    for d in log:
        by_choice[f"{d.get('op')}:{d.get('backend')}"
                  f"/{d.get('pipeline')}"] += 1
        by_source[f"backend<-{d.get('backend_source')}"] += 1
        by_source[f"pipeline<-{d.get('pipeline_source')}"] += 1
        hits += bool(d.get("tune_cache_hit"))
    return {"events": len(log), "tune_cache_hits": hits,
            "by_choice": dict(by_choice), "by_source": dict(by_source)}


def top_spans(doc: Dict[str, Any], n: int = 10) -> List[Dict[str, Any]]:
    agg: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "total_us": 0.0, "max_us": 0.0})
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        s = agg[e["name"]]
        s["count"] += 1
        s["total_us"] += e.get("dur", 0.0)
        s["max_us"] = max(s["max_us"], e.get("dur", 0.0))
    ranked = sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:n]
    return [dict(name=k, **v) for k, v in ranked]


def serving_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Serving-runtime activity in a trace: the scheduler's admission/
    eviction/page counters (`repro_torch.serve.runtime.slots`) and the
    aggregate of its per-step `serve.step` spans."""
    counters = doc.get("repro", {}).get("counters", {})
    serve = {k: counters[k] for k in sorted(counters)
             if k.startswith(("serve.", "engine."))}
    steps = [e for e in doc.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("name") == "serve.step"]
    span = None
    if steps:
        active = [e.get("args", {}).get("active", 0) for e in steps]
        depth = [e.get("args", {}).get("queue_depth", 0) for e in steps]
        span = {"steps": len(steps),
                "total_us": sum(e.get("dur", 0.0) for e in steps),
                "mean_active": sum(active) / len(steps),
                "max_queue_depth": max(depth)}
    return {"counters": serve, "steps": span}


def render_serving_bench(payload: Dict[str, Any]) -> str:
    """Render a BENCH_serving.json policy table (the reference's
    load generator writes one)."""
    out = ["== serving benchmark (BENCH_serving.json) =="]
    w = payload.get("workload", {})
    out.append(f"  workload: {w.get('requests')} requests @ "
               f"{w.get('qps')} req/s, {w.get('slots')} slots, "
               f"seed {w.get('seed')}")
    out.append(_fmt_table(
        ["policy", "req/s", "tok/s", "p50_s", "p99_s", "steps",
         "occupancy", "max_queue"],
        [[r["policy"], f"{r['throughput_rps']:.3f}",
          f"{r['throughput_tps']:.3f}", f"{r['latency_s']['p50']:.1f}",
          f"{r['latency_s']['p99']:.1f}", str(r["steps"]),
          f"{r['occupancy']['mean']:.0%}",
          str(r["queue_depth"]["max"])]
         for r in payload.get("rows", [])]))
    acc = payload.get("acceptance", {})
    if acc:
        out.append(f"  continuous vs wave: "
                   f"{acc.get('throughput_gain'):.2f}x throughput, "
                   f"{acc.get('p99_ratio'):.2f}x p99 latency")
    return "\n".join(out)


def render(doc: Dict[str, Any]) -> str:
    out = []
    rows = mac_table(doc)
    out.append("== MAC/us per bit-width (measured, from kernel spans) ==")
    if rows:
        out.append(_fmt_table(
            ["op", "W", "A", "backend", "pipeline", "calls", "MMACs",
             "us", "MAC/us", "packed_KiB", "MAC/byte"],
            [[r["op"], str(r["w_bits"]), str(r["a_bits"]), r["backend"],
              r["pipeline"], str(r["calls"]), f"{r['macs'] / 1e6:.2f}",
              f"{r['us']:.1f}", f"{r['macs_per_us']:.1f}",
              "-" if r["packed_bytes"] is None
              else f"{r['packed_bytes'] / 1024:.1f}",
              "-" if r["intensity"] is None else f"{r['intensity']:.2f}"]
             for r in rows]))
    else:
        out.append("(no kernel spans in trace)")
    ds = dispatch_summary(doc)
    out.append("")
    out.append(f"== dispatch decisions ({ds['events']} events, "
               f"{ds['tune_cache_hits']} tune-cache hits) ==")
    for k in sorted(ds["by_choice"]):
        out.append(f"  {k:<40s} x{ds['by_choice'][k]}")
    for k in sorted(ds["by_source"]):
        out.append(f"  {k:<40s} x{ds['by_source'][k]}")
    out.append("")
    out.append("== top spans by total duration ==")
    ts = top_spans(doc)
    if ts:
        out.append(_fmt_table(
            ["span", "count", "total_us", "max_us"],
            [[s["name"], str(s["count"]), f"{s['total_us']:.1f}",
              f"{s['max_us']:.1f}"] for s in ts]))
    else:
        out.append("(no spans in trace)")
    sv = serving_summary(doc)
    if sv["counters"] or sv["steps"]:
        out.append("")
        out.append("== serving runtime ==")
        for k, v in sv["counters"].items():
            out.append(f"  {k:<28s} {v}")
        if sv["steps"]:
            s = sv["steps"]
            out.append(f"  serve.step: {s['steps']} steps, "
                       f"{s['total_us']:.0f}us total, mean active "
                       f"{s['mean_active']:.2f} slots, max queue "
                       f"{s['max_queue_depth']}")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    from repro_torch.obs import env as obsenv

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__)
    ap.add_argument("trace", nargs="?",
                    default=obsenv.get("REPRO_OBS_TRACE")
                    or "BENCH_trace.json",
                    help="trace artifact path (default: $REPRO_OBS_TRACE "
                         "or BENCH_trace.json)")
    ap.add_argument("--top", type=int, default=10,
                    help="span rows to show")
    ap.add_argument("--serving", default="BENCH_serving.json",
                    help="serving benchmark artifact to summarize when "
                         "present")
    args = ap.parse_args(argv)
    try:
        doc = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"trace: {args.trace} "
          f"({len(doc.get('traceEvents', []))} events)")
    print(render(doc))
    try:
        with open(args.serving) as fh:
            print()
            print(render_serving_bench(json.load(fh)))
    except OSError:
        pass  # no serving artifact around — trace-only report
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
