"""Bit-width search: assign W{8,4,2} per compute layer (or per
CHUNK-wide output-channel group) to minimize packed weight bytes subject
to a total-sensitivity budget.

Objective: the packed weight bytes a forward streams (int8 containers
plus f32 per-channel scales, counted as numel x itemsize). Constraint:
the sum of per-path sensitivity proxies from `deploy.calibrate` stays
<= budget.

Search: greedy marginal-rate knapsack. Everything starts at the widest
candidate; the loop takes the one-step demotion (8->4 or 4->2) with the
best bytes-saved-per-sensitivity-added ratio that still fits the budget.

``granularity='layer'`` demotes whole paths; ``'channel_group'`` demotes
CHUNK-wide output-channel groups independently (signal:
`CalibStats.col_sens`, apportioned by width when absent), merges adjacent
equal-width groups into (n_start, n_end, w_bits) runs
(`PlanRule.segments`), and returns whichever of the fine and the
per-layer plan packs fewer bytes, so the fine plan is never worse. The
plan JSON is the reference's, key for key.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core import packing
from repro_torch.deploy.calibrate import CANDIDATE_BITS, CalibStats
from repro_torch.deploy.policy import PlanRule, PrecisionPlan
from repro_torch.obs import trace as obs

_S8, _F32 = 1, 4        # itemsizes of the containers and the scales


def packed_weight_bytes(layers: int, d_in: int, d_out: int,
                        w_bits: int) -> int:
    """Device bytes of one path's packed weights (int8 containers,
    chunk-planar along the padded K axis) + its f32 per-channel scales."""
    kp = packing.padded_size(d_in) // packing.pack_factor(w_bits)
    return layers * kp * d_out * _S8 + layers * d_out * _F32


def _path_bytes(st: CalibStats, bits: int) -> int:
    return packed_weight_bytes(st.layers, st.d_in, st.d_out, bits)


def segmented_path_bytes(layers: int, d_in: int, d_out: int, runs) -> int:
    """Device bytes of one path's *segmented* packed weights + scales.

    For a single uniform run this equals `packed_weight_bytes` exactly
    (the segmented container of one run is byte-identical to the uniform
    one), so per-layer and fine-grain plans are compared on one scale."""
    total = packing.SegmentMap(tuple(runs)).packed_bytes(d_in)
    return layers * total * _S8 + layers * d_out * _F32


def auto_budget(stats: Dict[str, CalibStats],
                candidates: Sequence[int] = CANDIDATE_BITS,
                frac: float = 0.5) -> float:
    """A budget `frac` of the way between the all-widest total sensitivity
    and the all-narrowest one — guaranteed to admit some demotions and
    (for any non-degenerate sensitivity spread) to forbid others."""
    hi_b, lo_b = max(candidates), min(candidates)
    base = sum(st.sens(hi_b) for st in stats.values())
    full = sum(st.sens(lo_b) for st in stats.values())
    return base + frac * (full - base)


def plan_mixed_precision(stats: Dict[str, CalibStats], budget: float, *,
                         candidates: Sequence[int] = CANDIDATE_BITS,
                         a_bits: int = 8, backend: Optional[str] = None,
                         meta: Optional[dict] = None,
                         granularity: str = "layer",
                         group_size: int = packing.CHUNK) -> PrecisionPlan:
    """Greedy knapsack over calibration stats -> serializable plan.

    ``backend`` is the name ('cuda' | 'torch') the plan's rules carry;
    None lets the device the net is placed on decide. ``granularity``
    selects the move set (module docstring): 'layer' demotes whole paths,
    'channel_group' demotes ``group_size``-wide output-channel groups and
    emits `PlanRule.segments` — never packing more bytes than the
    per-layer plan at the same budget.
    """
    cand = sorted(set(candidates), reverse=True)      # e.g. [8, 4, 2]
    if not cand:
        raise ValueError("no candidate bit-widths")
    if granularity == "channel_group":
        if group_size % packing.CHUNK:
            raise ValueError(
                f"group_size={group_size} must be a CHUNK "
                f"({packing.CHUNK}) multiple: SegmentMap requires "
                "CHUNK-aligned interior run boundaries")
        fine = _plan_channel_groups(stats, budget, cand, a_bits, backend,
                                    meta, group_size)
        coarse = _plan_layer(stats, budget, cand, a_bits, backend, meta)
        # greedy is a 2-approximation, not optimal: guarantee fine plans
        # never lose to per-layer at equal budget by taking the better
        if (coarse.meta["packed_weight_bytes"]
                < fine.meta["packed_weight_bytes"]):
            return coarse
        return fine
    if granularity != "layer":
        raise ValueError(
            f"unknown granularity {granularity!r}; expected 'layer' or "
            "'channel_group'")
    return _plan_layer(stats, budget, cand, a_bits, backend, meta)


def _plan_layer(stats: Dict[str, CalibStats], budget: float, cand,
                a_bits: int, backend: Optional[str],
                meta: Optional[dict]) -> PrecisionPlan:
    assign = {p: cand[0] for p in stats}
    total = sum(stats[p].sens(cand[0]) for p in stats)

    def next_bits(b: int) -> Optional[int]:
        i = cand.index(b)
        return cand[i + 1] if i + 1 < len(cand) else None

    with obs.span("plan.search", cat="deploy", paths=len(stats),
                  budget=float(budget)) as search_span:
        while True:
            best, best_rate = None, -1.0
            for p, b in assign.items():
                nb = next_bits(b)
                if nb is None:
                    continue
                d_sens = stats[p].sens(nb) - stats[p].sens(b)
                d_bytes = _path_bytes(stats[p], b) - _path_bytes(stats[p], nb)
                if d_bytes <= 0:
                    continue
                if total + max(d_sens, 0.0) > budget:
                    continue
                rate = d_bytes / max(d_sens, 1e-12)
                if rate > best_rate:
                    best, best_rate = (p, nb, d_sens), rate
            if best is None:
                break
            p, nb, d_sens = best
            assign[p] = nb
            total += d_sens
        search_span.set(
            total_sensitivity=total,
            demotions=sum(1 for p in assign if assign[p] != cand[0]))

    table = {p: {
        "w_bits": assign[p],
        "layers": stats[p].layers, "d_in": stats[p].d_in,
        "d_out": stats[p].d_out,
        "a_absmax": round(stats[p].a_absmax, 6),
        "sens": {str(b): stats[p].sens(b) for b in cand},
        "bytes": {str(b): _path_bytes(stats[p], b) for b in cand},
    } for p in sorted(stats)}
    plan_meta = {
        "budget": budget,
        "total_sensitivity": total,
        "packed_weight_bytes": sum(
            _path_bytes(stats[p], assign[p]) for p in stats),
        "uniform_w8_bytes": sum(
            _path_bytes(stats[p], cand[0]) for p in stats),
        "paths": table,
    }
    if meta:
        plan_meta.update(meta)
    rules = tuple(
        PlanRule(pattern=p, w_bits=assign[p], a_bits=a_bits,
                 backend=backend,
                 a_absmax=(round(stats[p].a_absmax, 6)
                           if stats[p].a_absmax > 0 else None))
        for p in sorted(stats))
    return PrecisionPlan(rules=rules, default_w_bits=cand[0],
                         default_a_bits=a_bits, meta=plan_meta)


def _plan_channel_groups(stats: Dict[str, CalibStats], budget: float, cand,
                         a_bits: int, backend: Optional[str],
                         meta: Optional[dict],
                         group_size: int) -> PrecisionPlan:
    """Channel-group knapsack: same greedy loop as `_plan_layer`, but the
    demotion items are (path, output-channel group) pairs."""
    groups = {}                  # (path, gi) -> (n_start, n_end)
    for p, st in stats.items():
        for gi, s in enumerate(range(0, st.d_out, group_size)):
            groups[(p, gi)] = (s, min(s + group_size, st.d_out))

    def g_sens(p, g, b):
        st = stats[p]
        cols = st.col_sens(b)
        s, e = g
        if cols is None:
            # no channel detail recorded: apportion the layer sensitivity
            # by group width (keeps group sums == layer sens, so the
            # budget means the same thing at both granularities)
            return st.sens(b) * (e - s) / max(st.d_out, 1)
        return float(cols[s:e].sum())

    def g_bytes(p, g, b):
        st = stats[p]
        s, e = g
        kp = packing.padded_size(st.d_in) // packing.pack_factor(b)
        return st.layers * kp * (e - s)   # scales don't vary with width

    def next_bits(b):
        i = cand.index(b)
        return cand[i + 1] if i + 1 < len(cand) else None

    assign = {k: cand[0] for k in groups}
    total = sum(g_sens(p, g, cand[0]) for (p, _), g in groups.items())

    with obs.span("plan.search", cat="deploy", paths=len(stats),
                  groups=len(groups), budget=float(budget),
                  granularity="channel_group") as search_span:
        while True:
            best, best_rate = None, -1.0
            for key, b in assign.items():
                nb = next_bits(b)
                if nb is None:
                    continue
                p, _ = key
                g = groups[key]
                d_sens = g_sens(p, g, nb) - g_sens(p, g, b)
                d_bytes = g_bytes(p, g, b) - g_bytes(p, g, nb)
                if d_bytes <= 0:
                    continue
                if total + max(d_sens, 0.0) > budget:
                    continue
                rate = d_bytes / max(d_sens, 1e-12)
                if rate > best_rate:
                    best, best_rate = (key, nb, d_sens), rate
            if best is None:
                break
            key, nb, d_sens = best
            assign[key] = nb
            total += d_sens
        search_span.set(
            total_sensitivity=total,
            demotions=sum(1 for k in assign if assign[k] != cand[0]))

    # merge adjacent equal-width groups into (n_start, n_end, w_bits) runs
    path_runs, path_bytes = {}, {}
    for p in sorted(stats):
        runs = []
        gi = 0
        while (p, gi) in groups:
            s, e = groups[(p, gi)]
            b = assign[(p, gi)]
            if runs and runs[-1][2] == b:
                runs[-1] = (runs[-1][0], e, b)
            else:
                runs.append((s, e, b))
            gi += 1
        path_runs[p] = tuple(runs)
        path_bytes[p] = segmented_path_bytes(
            stats[p].layers, stats[p].d_in, stats[p].d_out, runs)

    table = {p: {
        "w_bits": max(b for _, _, b in path_runs[p]),
        "segments": [list(r) for r in path_runs[p]],
        "layers": stats[p].layers, "d_in": stats[p].d_in,
        "d_out": stats[p].d_out,
        "a_absmax": round(stats[p].a_absmax, 6),
        "sens": {str(b): stats[p].sens(b) for b in cand},
        "bytes": path_bytes[p],
    } for p in sorted(stats)}
    plan_meta = {
        "budget": budget,
        "granularity": "channel_group",
        "group_size": group_size,
        "total_sensitivity": total,
        "packed_weight_bytes": sum(path_bytes.values()),
        "uniform_w8_bytes": sum(
            _path_bytes(stats[p], cand[0]) for p in stats),
        "paths": table,
    }
    if meta:
        plan_meta.update(meta)
    rules = tuple(
        PlanRule(pattern=p,
                 w_bits=max(b for _, _, b in path_runs[p]), a_bits=a_bits,
                 backend=backend,
                 a_absmax=(round(stats[p].a_absmax, 6)
                           if stats[p].a_absmax > 0 else None),
                 segments=(None if len(path_runs[p]) == 1
                           else path_runs[p]))
        for p in sorted(stats))
    return PrecisionPlan(rules=rules, default_w_bits=cand[0],
                         default_a_bits=a_bits, meta=plan_meta)
