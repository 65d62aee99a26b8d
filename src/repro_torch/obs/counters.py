"""Software performance counters: MACs and bytes per quantized op call.

The paper reports MAC/cycle per bit-width from RI5CY hardware counters
(Sec. V); this is the software analogue. `repro_torch.kernels.api` calls
:func:`record` at every `qdot`/`qconv`/`int_gemm` entry so effective
MAC/µs and arithmetic intensity per bit-width fall out of any
instrumented run.

Accounting is keyed by ``(op, w_bits, a_bits, backend, pipeline)`` —
rendered as ``"{op}|w{w}a{a}|{backend}|{pipeline}"``, with the port's
backend names ``cuda`` (CUDA tensors, the Hopper kernels) and ``torch``
(CPU tensors, the plain versions) — and each bucket accumulates

    calls           number of recorded entry-point calls
    macs            multiply-accumulates: m*k*n (qdot, K padded to CHUNK;
                    int_gemm, the dense layer's real K),
                    n*ho*wo*fh*fw*(cin/groups)*cout (qconv, the image's
                    real Cin)
    logical_bytes   one byte per logical int8 element moved (activations
                    + weights + output) — the unpacked traffic a W8A8
                    kernel would move
    packed_bytes    the same traffic in packed containers: sub-byte
                    operands shrink by 8/bits — the memory-roofline term
                    the paper's sub-byte speedup comes from

The cost model is the reference's, number for number, so counters from
the two packages compare directly (the reference counts no
``int_gemm``). qdot's K is the K padded to CHUNK that the reference's
kernel contracts; the port's GEMM kernel contracts only the real K
rounded up to 32, so for a ragged K these MACs exceed the kernel's. A depthwise layer lowered ``per_group`` is C convs with
cin = 1.

``logical/packed`` per bucket is the measured container-compression
ratio; ``macs/packed_bytes`` is the arithmetic intensity a roofline
plots. Recording is a no-op unless `repro_torch.obs.trace` is enabled.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.obs import trace

_LOCK = threading.Lock()
_OPS: Dict[str, Dict[str, int]] = {}

_FIELDS = ("calls", "macs", "logical_bytes", "packed_bytes")

# ops keyed by an (m, k, n) GEMM shape; every other op is a conv
GEMM_OPS = ("qdot", "qdot_mixed", "int_gemm")


def _pack_factor(bits: int) -> int:
    return 8 // int(bits)


def key(op: str, w_bits: int, a_bits: int, backend: str,
        pipeline: str) -> str:
    return f"{op}|w{int(w_bits)}a{int(a_bits)}|{backend}|{pipeline}"


def parse_key(k: str) -> Dict[str, object]:
    op, bits, backend, pipeline = k.split("|")
    w, a = bits[1:].split("a")
    return {"op": op, "w_bits": int(w), "a_bits": int(a),
            "backend": backend, "pipeline": pipeline}


def conv_out_hw(h, w, fh, fw, stride, padding):
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    return ho, wo


def qdot_costs(shape, a_bits: int, w_bits: int) -> Dict[str, int]:
    """(m, k, n) GEMM cost model; k is the K the caller keys (qdot's
    padded to CHUNK, int_gemm's real one)."""
    m, k, n = (int(s) for s in shape[:3])
    macs = m * k * n
    logical = m * k + k * n + m * n
    packed = (m * k // _pack_factor(a_bits)
              + k * n // _pack_factor(w_bits) + m * n)
    return {"calls": 1, "macs": macs, "logical_bytes": logical,
            "packed_bytes": packed}


def qconv_costs(shape, a_bits: int, w_bits: int) -> Dict[str, int]:
    """Conv shape key -> costs. ``shape`` is the 9/10-tuple
    (n, h, w, cin, fh, fw, stride, padding, cout[, groups])."""
    n, h, w, cin, fh, fw, stride, padding, cout = (
        int(s) for s in shape[:9])
    groups = int(shape[9]) if len(shape) > 9 else 1
    ho, wo = conv_out_hw(h, w, fh, fw, stride, padding)
    k = fh * fw * (cin // groups)          # contraction depth per out pixel
    macs = n * ho * wo * k * cout
    logical = n * h * w * cin + k * cout + n * ho * wo * cout
    packed = (n * h * w * cin // _pack_factor(a_bits)
              + k * cout // _pack_factor(w_bits) + n * ho * wo * cout)
    return {"calls": 1, "macs": macs, "logical_bytes": logical,
            "packed_bytes": packed}


def record(op: str, shape, a_bits: int, w_bits: int, *, backend: str,
           pipeline: str,
           w_packed_bytes: Optional[int] = None) -> Optional[Dict[str, int]]:
    """Bump the (op, bits, backend, pipeline) bucket for one call; returns
    the per-call deltas (None when observability is off).

    The `GEMM_OPS` share the (m, k, n) cost model; everything else is
    the conv key. ``w_packed_bytes`` replaces the uniform-container
    weight term of ``packed_bytes`` — segmented containers stream
    exactly their per-run byte count, not k*n/pf at one width."""
    if not trace.enabled():
        return None
    costs = (qdot_costs if op in GEMM_OPS else qconv_costs)(
        shape, a_bits, w_bits)
    if w_packed_bytes is not None:
        m, kdim, n = (int(s) for s in shape[:3])
        costs["packed_bytes"] = (m * kdim // _pack_factor(a_bits)
                                 + int(w_packed_bytes) + m * n)
    k = key(op, w_bits, a_bits, backend, pipeline)
    with _LOCK:
        bucket = _OPS.setdefault(k, dict.fromkeys(_FIELDS, 0))
        for f in _FIELDS:
            bucket[f] += costs[f]
    return costs


def snapshot() -> Dict[str, Dict[str, int]]:
    with _LOCK:
        return {k: dict(v) for k, v in _OPS.items()}


def reset() -> None:
    with _LOCK:
        _OPS.clear()


def delta(after: Dict[str, Dict[str, int]],
          before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """Per-bucket ``after - before`` (buckets with no change dropped) —
    how a measurement attributes counts to one timed region."""
    out: Dict[str, Dict[str, int]] = {}
    for k, av in after.items():
        bv = before.get(k, {})
        d = {f: av[f] - bv.get(f, 0) for f in _FIELDS}
        if any(d.values()):
            out[k] = d
    return out
