"""Central registry of the port's ``REPRO_*`` environment knobs.

Every env knob the port honours is declared here with its type, its
validated value space, and a one-line doc. Call sites read through
:func:`get` / :func:`get_bool` instead of ``os.environ`` so that

* a typo'd knob (``REPRO_QPIPLINE=off``) warns instead of being silently
  ignored — :func:`warn_unknown` scans the process environment for
  ``REPRO_*`` names that no knob declares. The reference's
  ``REPRO_QBACKEND`` (the port's backend is the tensor's device) and
  ``REPRO_EXTRA_XLA`` (there is no XLA) are not knobs of the port, so
  setting either warns as unknown;
* an invalid *value* for a choice knob raises immediately with the list
  of accepted values;
* the README's knob table is generated (``python -m repro_torch.obs.env``)
  rather than hand-maintained.

Import-light on purpose: standard library only, nothing from
``repro_torch.kernels``; `repro_torch.obs.trace` imports it to decide
whether observability is on.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    doc: str
    kind: str = "str"          # 'str' | 'bool' | 'path' | 'choice'
    choices: Tuple[str, ...] = ()   # for kind='choice'


KNOBS = {k.name: k for k in (
    Knob("REPRO_QPIPELINE",
         "Force the kernels' pipeline mode (STAGES=1 / STAGES=2) for every "
         "`qdot`/`qconv` call that names none.",
         kind="choice", choices=("off", "double_buffer")),
    Knob("REPRO_QTUNE_CACHE",
         "Path to a tune-cache JSON preloaded at first lookup (launch + "
         "pipeline winners from `python -m repro_torch.kernels.tune`).",
         kind="path"),
    Knob("REPRO_OBS",
         "Enable the observability layer (`repro_torch.obs`): spans, "
         "MAC/byte counters, dispatch decision log. Off by default — "
         "disabled mode records nothing and adds one predicate per call.",
         kind="bool"),
    Knob("REPRO_OBS_TRACE",
         "Path where the vision and serve CLIs export the Chrome "
         "trace-event JSON artifact on exit (implies nothing unless "
         "REPRO_OBS is on).",
         kind="path"),
    Knob("REPRO_TORCH_BUILD_DIR",
         "Directory for the CUDA kernels nvcc builds (default: "
         "`build/repro_torch_kernels/` of the checkout).", kind="path"),
)}

_warned_unknown = False
_scanned = False


def warn_unknown() -> Tuple[str, ...]:
    """Warn (once) about ``REPRO_*`` env vars no knob declares.

    Returns the offending names so tests can assert on them without
    capturing warnings."""
    global _warned_unknown
    unknown = tuple(sorted(
        n for n in os.environ if n.startswith("REPRO_") and n not in KNOBS))
    if unknown and not _warned_unknown:
        _warned_unknown = True
        warnings.warn(
            f"unrecognized REPRO_* environment variable(s): "
            f"{', '.join(unknown)}; known knobs: {', '.join(sorted(KNOBS))}",
            stacklevel=2)
    return unknown


def get(name: str) -> Optional[str]:
    """The validated value of knob ``name``, or None when unset/empty.

    Unknown ``name`` raises (call sites must declare their knobs);
    invalid values for choice and bool knobs raise ValueError. The first
    read scans the environment for undeclared ``REPRO_*`` names (once per
    process: the scan costs tens of µs, and kernel calls read knobs)."""
    global _scanned
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(
            f"undeclared env knob {name!r}; declare it in "
            f"repro_torch.obs.env.KNOBS (known: {sorted(KNOBS)})")
    if not _scanned:
        _scanned = True
        warn_unknown()
    raw = os.environ.get(name)
    if not raw:
        return None
    if knob.kind == "choice" and raw not in knob.choices:
        raise ValueError(
            f"{name}={raw!r} is not a valid value; choices: {knob.choices}")
    if knob.kind == "bool" and raw.lower() not in _TRUE + _FALSE:
        raise ValueError(
            f"{name}={raw!r} is not boolean; use one of {_TRUE + _FALSE}")
    return raw


def get_bool(name: str) -> bool:
    raw = get(name)
    return raw is not None and raw.lower() in _TRUE


def table() -> str:
    """The README knob table (GitHub markdown), generated from KNOBS."""
    rows = ["| Variable | Type | Meaning |", "| --- | --- | --- |"]
    for knob in sorted(KNOBS.values(), key=lambda k: k.name):
        kind = ("/".join(knob.choices) if knob.kind == "choice"
                else knob.kind)
        rows.append(f"| `{knob.name}` | {kind} | {knob.doc} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(table())
