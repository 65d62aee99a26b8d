"""Per-layer precision policy: param-path pattern -> {w_bits, a_bits, ...}.

A `PrecisionPlan` is the serializable artifact of the mixed-precision
flow. Each rule maps an fnmatch pattern over "/"-joined layer paths to
the widths that layer serves at, plus the op backend and kernel pipeline
it routes through. Plans round-trip through JSON in the reference's
schema (v1-v4), so a plan saved by ``repro`` loads unchanged, with one
exception: a rule whose ``backend`` names one of the reference's
backends (``pallas``, ``xla``, ...) raises, because the port runs only
its own (``cuda``, ``torch``); ``null`` resolves by device.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import pathlib
from typing import Optional, Tuple

from repro_torch.core.packing import SegmentMap
from repro_torch.kernels.api import BACKENDS
from repro_torch.kernels.common import check_pipeline
from repro_torch.nn.layers import QuantConfig

PLAN_VERSION = 4


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One policy entry: first matching pattern wins."""

    pattern: str
    w_bits: int
    a_bits: int = 8
    backend: Optional[str] = None      # 'cuda' | 'torch' | None
    a_absmax: Optional[float] = None
    pipeline: Optional[str] = None
    # (n_start, n_end, w_bits) output-channel runs; w_bits is the widest
    segments: Optional[Tuple[Tuple[int, int, int], ...]] = None

    def __post_init__(self):
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(
                f"plan rule {self.pattern!r}: backend {self.backend!r} is "
                f"not a backend of this port; use one of {list(BACKENDS)} "
                "or null (resolve by device)")
        if self.pipeline is not None:
            check_pipeline(self.pipeline)
        if self.segments is not None:
            runs = SegmentMap(tuple(tuple(r) for r in self.segments)).runs
            widest = max(b for _, _, b in runs)
            if self.w_bits != widest:
                raise ValueError(
                    f"rule w_bits={self.w_bits} must equal the widest "
                    f"segment width {widest} (runs: {runs})")
            object.__setattr__(self, "segments", runs)

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    rules: Tuple[PlanRule, ...] = ()
    default_w_bits: int = 8
    default_a_bits: int = 8
    meta: dict = dataclasses.field(default_factory=dict, compare=False)

    def rule_for(self, path: str) -> Optional[PlanRule]:
        for r in self.rules:
            if r.matches(path):
                return r
        return None

    def resolve(self, path: str, base: QuantConfig) -> QuantConfig:
        """QuantConfig for ``path``; ``base`` supplies mode and unset
        fields (no matching rule -> plan defaults)."""
        r = self.rule_for(path)
        if r is None:
            return dataclasses.replace(
                base, w_bits=self.default_w_bits, a_bits=self.default_a_bits,
                segments=None)
        return dataclasses.replace(
            base, w_bits=r.w_bits, a_bits=r.a_bits,
            backend=r.backend if r.backend is not None else base.backend,
            a_absmax=r.a_absmax if r.a_absmax is not None else base.a_absmax,
            pipeline=r.pipeline if r.pipeline is not None else base.pipeline,
            segments=r.segments)

    def distinct_w_bits(self) -> Tuple[int, ...]:
        seg = {b for r in self.rules if r.segments
               for _, _, b in r.segments}
        return tuple(sorted({r.w_bits for r in self.rules}
                            | {self.default_w_bits} | seg))

    def to_json(self) -> str:
        return json.dumps({
            "version": PLAN_VERSION,
            "default": {"w_bits": self.default_w_bits,
                        "a_bits": self.default_a_bits},
            "rules": [{
                "pattern": r.pattern, "w_bits": r.w_bits, "a_bits": r.a_bits,
                "backend": r.backend, "a_absmax": r.a_absmax,
                "pipeline": r.pipeline,
                "segments": (None if r.segments is None
                             else [list(run) for run in r.segments]),
            } for r in self.rules],
            "meta": self.meta,
        }, indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "PrecisionPlan":
        d = json.loads(text)
        version = d.get("version")
        if version not in (1, 2, 3, PLAN_VERSION):
            raise ValueError(f"unsupported plan version {version}")

        def _backend(r):
            if r.get("backend") is not None:
                return r["backend"]
            if "use_kernel" in r:   # v1 pinned a reference backend
                return "pallas_interpret" if r["use_kernel"] else "xla"
            return None

        rules = tuple(PlanRule(
            pattern=r["pattern"], w_bits=int(r["w_bits"]),
            a_bits=int(r.get("a_bits", 8)),
            backend=_backend(r),
            a_absmax=(None if r.get("a_absmax") is None
                      else float(r["a_absmax"])),
            pipeline=r.get("pipeline"),
            segments=(None if r.get("segments") is None
                      else tuple(tuple(int(v) for v in run)
                                 for run in r["segments"])),
        ) for r in d.get("rules", []))
        default = d.get("default", {})
        return PrecisionPlan(
            rules=rules,
            default_w_bits=int(default.get("w_bits", 8)),
            default_a_bits=int(default.get("a_bits", 8)),
            meta=d.get("meta", {}))


def resolve_qcfg(plan: Optional[PrecisionPlan], path: str,
                 base: QuantConfig) -> QuantConfig:
    """Per-layer QuantConfig: identity when no plan is active."""
    if plan is None:
        return base
    return plan.resolve(path, base)


def save_plan(plan: PrecisionPlan, path) -> None:
    pathlib.Path(path).write_text(plan.to_json())


def load_plan(path) -> PrecisionPlan:
    return PrecisionPlan.from_json(pathlib.Path(path).read_text())
